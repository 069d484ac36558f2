"""Whether the timed path's outputs are correct, by the plain reference.

The harness records, at every step from the reset on, the outputs of a
sample of boards drawn from the seed (``harness.Recorder``).  The check
works out, with the reference alone and from the seed alone, the reset of
those boards and every policy key of the run, and holds the program to
them:

* the start: each sampled board's reset (board, key, timer, mask) against
  the reference's ``reset`` of key ``split(k0, B)[row]``;
* every step t of every sampled board: from the board the program handed
  on at step t - 1 (its board, moves left, key and mask), the reference
  draws the action (``jax.random.categorical``'s word for that row of the
  batch, from its own key chain), steps the board, auto-resetting a
  finished one, and every output the program gave at step t must equal
  the reference's: the action, board, moves left, key, reward, done and
  next mask.

Step t starts from the program's own state at t - 1, so that every step is
checked at once in blocks of rows; the chain is closed by the start, which
the reference makes from the seed, so that a sampled board's whole run
equals the reference's own replay from the seed exactly when every one of
its steps passes.

One output is left out where the game does not define it: the mask of a
board that the step hands on with a line still on it.  The game never
hands on such a board; only a cascade cut at ``max_cascades`` trips does
(the configuration's cap, flagged ``truncated`` and counted in
``failed``), and the program's mask of it is the settled mask, which its
own engine documents as not exact where lines remain.  The reference
decides where this applies, from the board it makes itself; every other
output of that step, and the next step's from the program's state, is
still compared.  ``checked`` counts these board-steps
(``mask_not_compared_lines_left``).

The number compared is ``mismatches``: the sampled boards whose start
differs, plus the sampled board-steps with any output that differs.  The
game is integer arithmetic on threefry words, so the program and the
reference agree bit for bit or not at all: its limit is 0.  The check also
requires that at least one auto-reset step is among those checked
(``autoreset_steps_checked`` >= 1), so that regeneration is always held to
the reference.
"""

from __future__ import annotations

import torch

from .reference import engine as ref
from .reference import random as rrandom
from .reference.config import EnvConfig
from .reference.lines import has_any_line

FIELDS = ("action", "board", "moves_left", "key", "reward", "done", "mask")
BOARDS = 32  # boards of each run that the check samples from the seed
CHUNK = 16384  # board-steps of one block of the reference


def _bad(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bool[N]: rows of a and b that differ anywhere."""
    d = a != b
    return d.reshape(d.shape[0], -1).any(-1)


def compare(config: dict, seed: int, rec, device, chunk: int = CHUNK):
    """(the numbers compared, each ``{"name", "value", "limit", "kind"}``
    with ``kind`` "max" or "min"; what was checked, with the mismatches by
    output), the reference run in blocks of ``chunk`` board-steps."""
    cfg = EnvConfig.create(
        config["num_rows"], config["num_cols"], config["num_colours"], config["num_moves"],
        colourless_specials=tuple(config["colourless_specials"]),
        colour_specials=tuple(config["colour_specials"]))
    got = rec.stacked()
    rows = rec.rows
    T = got["action"].shape[0]
    S = rows.shape[0]

    # the policy keys of the run, from the seed: key, k0 = split(seed's key);
    # then key, ka = split(key) each step
    both = rrandom.split(rrandom.key_of_seed(seed, "cpu"))
    key, k0 = both[0], both[1]
    kas = []
    for _ in range(T):
        both = rrandom.split(key)
        key = both[0]
        kas.append(both[1])
    kas = torch.stack(kas).to(device)

    with torch.no_grad():
        states, mask, _ = ref.reset(cfg, rrandom.split_at(k0.to(device), rows))
        start = (_bad(torch.stack([states.colour, states.kind], 1), got["board"][0])
                 | _bad(states.key, got["key"][0]) | _bad(mask, got["mask"][0])
                 | (cfg.num_moves - states.timer != got["moves_left"][0]))

        per_field = dict.fromkeys(FIELDS, 0)
        bad_steps = lines_left_steps = 0
        N = T * S
        flat = {f: got[f][:-1].reshape(N, *got[f].shape[2:]) for f in ("board", "moves_left", "key", "mask")}
        out = {f: got[f][1:].reshape(N, *got[f].shape[2:]) for f in FIELDS if f != "action"}
        out["action"] = got["action"].reshape(N)
        pair_rows = rows.repeat(T)
        pair_keys = kas.repeat_interleave(S, dim=0)
        for lo in range(0, N, chunk):
            sl = slice(lo, min(lo + chunk, N))
            board = flat["board"][sl]
            st = ref.EnvState(board[:, 0].contiguous(), board[:, 1].contiguous(),
                              (cfg.num_moves - flat["moves_left"][sl]).to(torch.int32),
                              flat["key"][sl])
            m = flat["mask"][sl]
            a = rrandom.masked_categorical_rows(pair_keys[sl], m, pair_rows[sl])
            nxt, info = ref.step(cfg, st, a, m)
            mine = {"action": a, "board": torch.stack([nxt.colour, nxt.kind], 1),
                    "moves_left": cfg.num_moves - nxt.timer, "key": nxt.key,
                    "reward": info["reward"], "done": info["done"], "mask": info["mask"]}
            # a board handed on with a line left: its mask is not the game's
            lines_left = has_any_line(cfg, nxt.colour)
            lines_left_steps += int(lines_left.sum())
            any_bad = torch.zeros(sl.stop - sl.start, dtype=torch.bool, device=device)
            for f in FIELDS:
                b = _bad(mine[f].reshape(any_bad.shape[0], -1), out[f][sl].reshape(any_bad.shape[0], -1))
                if f == "mask":
                    b &= ~lines_left
                per_field[f] += int(b.sum())
                any_bad |= b
            bad_steps += int(any_bad.sum())
        resets = int(got["done"][1:].any(-1).sum())

    per_field["start"] = int(start.sum())
    return [
        {"name": "mismatches", "value": per_field["start"] + bad_steps, "limit": 0, "kind": "max"},
        {"name": "autoreset_steps_checked", "value": resets, "limit": 1, "kind": "min"},
    ], {"board_steps_checked": N, "boards": S, "steps": T, "mismatches_by_field": per_field,
        "mask_not_compared_lines_left": lines_left_steps}


def passed(checks: list) -> bool:
    return all((c["value"] <= c["limit"]) if c["kind"] == "max" else (c["value"] >= c["limit"])
               for c in checks)
