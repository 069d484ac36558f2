"""Record JAX rollouts that the PyTorch port must replay bit for bit.

Runs the JAX package on the CPU under a deterministic policy both packages
compute alike — board b at step t takes the ((7t + b) mod n_eff)-th of its
n_eff effective actions, action 0 if it has none — and writes every state
and TimeStep field of every step:

* ``tests/data/torch_port_fixture_cfg1.npz``: config 1 of ``bench.py``
  (10x10 boards, 4 colours, 30 moves, no specials), 64 boards, 40
  auto-resetting steps (one reset at step 30);
* ``tests/data/torch_port_fixture_cfg3.npz``: config 3 (the same with the
  cookie, both lasers and the bomb), 32 boards, 35 steps (one reset at step
  30);
* ``tests/data/torch_port_fixture_nobomb.npz``: config 3 without the bomb
  (cookie and both lasers), 32 boards, 35 steps.  On the CPU the JAX
  batched env steps through ``jax.vmap(engine.step)``, the full
  classify/resolve machinery on every trip, and not through its Pallas
  kernel, so this rollout is the machinery's;
* ``tests/data/torch_port_gym_episodes.json``: single-board episodes of the
  JAX Gym adapter ``TileMatchEnv`` at 10x10, 4 colours, 8 moves, in both
  RNG modes ("threefry" and "numpy"), for four special sets — all, none,
  both lasers, cookie only — under the same policy with board b = the
  episode's index.

    JAX_PLATFORMS=cpu python tools/make_torch_port_fixture.py

``tests/test_torch_envs.py``, ``tests/test_torch_envs_sp.py`` and
``tests/test_torch_gym.py`` replay the files through the port and check
that this script still writes the same arrays; ``chip_smoke.py`` replays
them on the card.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_fixture_cfg1.npz")
FIXTURE_CFG3 = os.path.join(ROOT, "tests", "data", "torch_port_fixture_cfg3.npz")
CONFIG = dict(num_rows=10, num_cols=10, num_colours=4, num_moves=30)
BATCH = 64
STEPS = 40
SEED = 2024
# config 3: cookie, vertical laser, horizontal laser, bomb
SPECIALS_CFG3 = ("cookie", "vertical_laser", "horizontal_laser", "bomb")
BATCH_CFG3 = 32
STEPS_CFG3 = 35
FIXTURE_NOBOMB = os.path.join(ROOT, "tests", "data", "torch_port_fixture_nobomb.npz")
SPECIALS_NOBOMB = ("cookie", "vertical_laser", "horizontal_laser")
FIXTURE_GYM = os.path.join(ROOT, "tests", "data", "torch_port_gym_episodes.json")
# special sets of the Gym episodes: (name, colourless specials, colour specials)
GYM_SETS = (
    ("all", ("cookie",), ("vertical_laser", "horizontal_laser", "bomb")),
    ("none", (), ()),
    ("lasers", (), ("vertical_laser", "horizontal_laser")),
    ("cookie", ("cookie",), ()),
)
GYM_CONFIG = (10, 10, 4, 8)  # rows, cols, colours, moves
GYM_SEED = 7

# Stored narrower than their working dtype to keep the file small; values
# are compared, not bytes.
NARROW = {
    "colour": np.int8, "kind": np.int8, "timer": np.int8,
    "obs_board": np.int8, "obs_moves_left": np.int8,
    "num_new_specials": np.int8, "num_specials_activated": np.int8,
    "cascade_trips": np.int8, "actions": np.int16,
}
INFO_FIELDS = (
    "is_combination_match", "num_new_specials", "num_specials_activated",
    "shuffled", "effective_actions", "truncated", "cascade_trips",
)


def policy_actions(t: int, mask: np.ndarray) -> np.ndarray:
    """The ((7t + b) mod n_eff)-th effective action of each board b."""
    n_eff = mask.sum(-1)
    cums = np.cumsum(mask, axis=-1)
    pick = (7 * t + np.arange(mask.shape[0])) % np.maximum(n_eff, 1)
    hit = mask & (cums == pick[:, None] + 1)
    return np.where(n_eff > 0, hit.argmax(-1), 0).astype(np.int32)


def record(batch: int = BATCH, steps: int = STEPS, specials=()) -> dict:
    """Run the JAX package and return the fixture's arrays, each stacked
    over steps 0..steps (step 0 is the reset).  ``specials``: the enabled
    special names; with any, the file also holds their flags under
    "specials" (cookie, vertical laser, horizontal laser, bomb)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import jax

    from tile_match_tpu.config import EnvConfig
    from tile_match_tpu.envs.batched import BatchedTileMatchEnv

    cfg = EnvConfig.create(
        **CONFIG,
        colourless_specials=tuple(n for n in specials if n == "cookie"),
        colour_specials=tuple(n for n in specials if n != "cookie"),
    )
    env = BatchedTileMatchEnv(cfg, batch)
    states, ts = env.reset(jax.random.PRNGKey(SEED))
    rows = []
    actions = []
    for t in range(steps + 1):
        row = {
            "colour": states.colour, "kind": states.kind,
            "timer": states.timer, "key": states.key,
            "obs_board": ts.obs_board, "obs_moves_left": ts.obs_moves_left,
            "reward": ts.reward, "done": ts.done,
        }
        row.update({f: getattr(ts.info, f) for f in INFO_FIELDS})
        rows.append({k: np.asarray(v) for k, v in row.items()})
        if t == steps:
            break
        acts = policy_actions(t, np.asarray(ts.info.effective_actions))
        actions.append(acts)
        states, ts = env.step(states, jax.numpy.asarray(acts))
    out = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    out["actions"] = np.stack(actions)
    out["seed"] = np.asarray(SEED, np.int32)
    out["config"] = np.asarray(
        [CONFIG[k] for k in ("num_rows", "num_cols", "num_colours", "num_moves")],
        np.int32,
    )
    if specials:
        out["specials"] = np.asarray(
            [n in specials for n in ("cookie", "vertical_laser", "horizontal_laser", "bomb")],
            np.int8,
        )
    return {k: v.astype(NARROW.get(k, v.dtype)) for k, v in out.items()}


def record_gym(modes=("threefry", "numpy")) -> list:
    """Run the JAX Gym adapter: one episode per RNG mode and special set.
    Each holds its config, seed, special set and mode, the reset board and
    effective actions, and per step the action, reward, done, board and
    info dict."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from tile_match_tpu.envs.gym_env import TileMatchEnv

    R, C, K, M = GYM_CONFIG
    episodes = []
    for rng_mode in modes:
        for i, (name, colourless, colour) in enumerate(GYM_SETS):
            env = TileMatchEnv(R, C, K, M, list(colourless), list(colour), seed=GYM_SEED + i,
                               rng_mode=rng_mode)
            obs, info = env.reset()
            ep = {
                "config": [R, C, K, M], "seed": GYM_SEED + i, "rng_mode": rng_mode,
                "specials": [list(colourless), list(colour)], "name": name,
                "reset_board": obs["board"].tolist(),
                "reset_effective": [int(a) for a in info["effective_actions"]],
                "steps": [],
            }
            for t in range(M):
                mask = np.zeros((1, env.num_actions), bool)
                mask[0, info["effective_actions"]] = True
                action = int(policy_actions(t + i, mask)[0])
                obs, reward, done, _trunc, info = env.step(action)
                info = {k: (list(map(int, v)) if k == "effective_actions" else v)
                        for k, v in info.items()}
                ep["steps"].append({"action": action, "reward": int(reward), "done": bool(done),
                                    "board": obs["board"].tolist(), "info": info})
            episodes.append(ep)
    return episodes


def main() -> None:
    os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
    for path, arrays in (
        (FIXTURE, record()),
        (FIXTURE_CFG3, record(BATCH_CFG3, STEPS_CFG3, SPECIALS_CFG3)),
        (FIXTURE_NOBOMB, record(BATCH_CFG3, STEPS_CFG3, SPECIALS_NOBOMB)),
    ):
        np.savez_compressed(path, **arrays)
        print(f"wrote {path}: {os.path.getsize(path)} bytes")
    with open(FIXTURE_GYM, "w") as f:
        json.dump(record_gym(), f, separators=(",", ":"))
    print(f"wrote {FIXTURE_GYM}: {os.path.getsize(FIXTURE_GYM)} bytes")


if __name__ == "__main__":
    main()
