"""Parity of the port's kernels and step on the card (counterpart of the
JAX package's ``tools/tpu_parity_check.py`` and ``bench.parity_spot_check``).

    python -m tile_match_tpu_torch.tools.parity_check [--device cuda|cpu]

runs every check and exits 0 only when each holds; a check raises on the
first field that differs.

* ``check_cascade``: K1 (``ops.cascade.fused_cascade``) against its plain
  version (``cascade_reference``) on the same device, in every output.
* ``check_step`` / ``check_sp_step``: the batched step on the card against
  the same step on the CPU (the kernels against their plain versions,
  through the whole step) from the same boards, keys and actions, for a
  few steps; the specials check first pokes specials into the boards.
* ``replay_fixture``: a recorded JAX rollout (``tests/data/
  torch_port_fixture_cfg*.npz``, written by ``tools/make_torch_port_
  fixture.py``) replayed bit for bit.
* ``gate(config, device, batch)``: the port bench's gate, the recorded
  rollout of the config, then the step check on it, and without specials
  ``check_cascade`` at the bench's batch (K1 takes four warps a board
  below 8,192 boards a launch and one from there, so the gate holds the
  variant the bench times).

Needs no JAX.  On the card the checks also require that the kernels
launched.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA = os.path.join(ROOT, "tests", "data")
# the recorded JAX rollout of each of the bench's configs
FIXTURES = {i: os.path.join(DATA, f"torch_port_fixture_cfg{i}.npz") for i in range(5)}
# the gate's step check: batch of each config
GATE_BATCH = {0: 256, 1: 256, 2: 256, 3: 256, 4: 64}
STEP_FIELDS = ("colour", "kind", "key", "reward", "mask", "activated", "new", "trips")


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def replay_fixture(device, path: str = FIXTURES[1]) -> int:
    """Replay a recorded JAX rollout through ``BatchedTileMatchEnv`` on
    ``device``; raises on the first field that differs.  Returns the number
    of steps replayed."""
    import torch

    from .. import random as trandom
    from ..config import EnvConfig
    from ..envs.batched import BatchedTileMatchEnv
    from ..interop import state_to_numpy, timestep_to_numpy

    d = np.load(path)
    R, C, K, moves = (int(v) for v in d["config"])
    # (cookie, vertical laser, horizontal laser, bomb)
    flags = (bool(f) for f in (d["specials"] if "specials" in d.files else (0, 0, 0, 0)))
    cfg = EnvConfig(R, C, K, moves, **dict(zip(
        ("cookie", "vertical_laser", "horizontal_laser", "bomb"), flags)))
    env = BatchedTileMatchEnv(cfg, d["colour"].shape[1], device=device)

    def compare(t, states, ts):
        got = state_to_numpy(states)
        tsn = timestep_to_numpy(ts)
        got.update({k: v for k, v in tsn.items() if k != "info"})
        got.update(tsn["info"])
        for name, value in got.items():
            check(
                np.array_equal(value, d[name][t]),
                f"fixture step {t}: field {name} differs from the JAX rollout",
            )

    states, ts = env.reset(trandom.PRNGKey(int(d["seed"]), device))
    compare(0, states, ts)
    actions = d["actions"]
    for t in range(actions.shape[0]):
        acts = torch.as_tensor(actions[t].astype(np.int64), device=device)
        states, ts = env.step(states, acts)
        compare(t + 1, states, ts)
    return actions.shape[0]


def _launches() -> dict:
    from ..cuda_build import launches

    return dict(launches)


def _launched(device, before: dict, names, tag: str) -> None:
    """On the card, each kernel in ``names`` launched since ``before``."""
    if device.type != "cuda":
        return
    now = _launches()
    for name in names:
        check(now[name] > before[name], f"{tag}: kernel {name} was not launched")


def cascade_inputs(seed: int, B: int, R: int, C: int, K: int, device):
    """``check_cascade``'s boards int32[B, R, C], uniform from
    ``default_rng(seed)``, and keys int64[B, 2], board b's
    ``PRNGKey(seed * 10000 + b)``, which is [0, seed * 10000 + b]."""
    import torch

    rng = np.random.default_rng(seed)
    colour = torch.as_tensor(rng.integers(1, K + 1, size=(B, R, C)).astype(np.int32),
                             device=device)
    keys = torch.zeros(B, 2, dtype=torch.int64, device=device)
    keys[:, 1] = torch.arange(B, device=device) + seed * 10_000
    return colour, keys


def check_cascade(seed: int, B: int, R: int, C: int, K: int, device) -> str:
    """K1 against its plain version on ``device``, on ``cascade_inputs``."""
    import torch

    from ..config import EnvConfig
    from ..ops.cascade import cascade_reference, fused_cascade

    cfg = EnvConfig.create(R, C, K, 30, colourless_specials=(), colour_specials=())
    colour, keys = cascade_inputs(seed, B, R, C, K, device)
    before = _launches()
    got = fused_cascade(cfg, colour, keys)
    _launched(device, before, ("fused_cascade",), f"cascade {R}x{C}x{K} B={B}")
    want = cascade_reference(cfg, colour, keys)
    for g, w, name in zip(got, want, ("colour", "elim", "trips", "trunc", "mask")):
        check(torch.equal(g, w), f"cascade {name} diverges (seed {seed}, {R}x{C}x{K}, B={B})")
    return f"cascade parity OK: {R}x{C}x{K} B={B} (max trips {int(got[2].max())})"


def poked_states(cfg, seed: int, B: int, device):
    """``batched_reset(cfg, PRNGKey(seed), B)`` with 1-5 specials poked into
    each board from ``default_rng(seed)`` as ``tools/tpu_parity_check.py``
    pokes them (lasers 2 and 3, bombs 4, cookies -1 of colour 0; only the
    config's kinds).  Returns the states and their masks
    (``settled_mask_sp``: K3 on the card)."""
    import torch

    from .. import random as trandom
    from ..envs.batched import batched_reset
    from ..ops.mask_sp import settled_mask_sp

    states, _ = batched_reset(cfg, trandom.PRNGKey(seed, device), B)
    kinds = [k for k, on in ((2, cfg.vertical_laser), (3, cfg.horizontal_laser), (4, cfg.bomb),
                             (-1, cfg.cookie)) if on]
    rng = np.random.default_rng(seed)
    colour = states.colour.cpu().numpy().copy()
    kind = states.kind.cpu().numpy().copy()
    R, C = cfg.num_rows, cfg.num_cols
    for b in range(B):
        for _ in range(rng.integers(1, 6)):
            r, c = rng.integers(0, R), rng.integers(0, C)
            k = int(rng.choice(kinds))
            kind[b, r, c] = k
            if k == -1:
                colour[b, r, c] = 0
    states.colour = torch.as_tensor(colour, device=device)
    states.kind = torch.as_tensor(kind, device=device)
    mask = settled_mask_sp(cfg, states.colour, states.kind)
    return states, mask


def _to_cpu(states):
    import dataclasses

    return dataclasses.replace(states, **{f.name: getattr(states, f.name).cpu()
                                          for f in dataclasses.fields(states)})


def _step_pair(cfg, states, mask, key, device, tag):
    """One step on ``device`` and the same step on the CPU, compared in
    ``STEP_FIELDS``.  Returns the device's states, mask and key."""
    import torch

    from .. import random as trandom
    from ..envs.batched import masked_categorical
    from ..envs.fused import batched_step_fused

    key, ka = trandom.split(key)
    acts = masked_categorical(ka, mask)
    before = _launches()
    got = batched_step_fused(cfg, states, acts, mask)
    required = ("cascade_sp_chunk", "settled_mask_sp") if cfg.any_special else ("fused_cascade",)
    if bool(mask.any()):  # a board moves: its cascade runs on the kernels
        _launched(device, before, required, tag)
    want = batched_step_fused(cfg, _to_cpu(states), acts.cpu(), mask.cpu())

    def fields(out):
        s, r, _, info = out
        return (s.colour, s.kind, s.key, r, info.effective_actions,
                info.num_specials_activated, info.num_new_specials, info.cascade_trips)

    for g, w, name in zip(fields(got), fields(want), STEP_FIELDS):
        check(torch.equal(g.cpu(), w), f"{tag}: {name} diverges")
    return got[0], got[3].effective_actions, key


def check_step(cfg, seed: int, B: int, device, steps: int = 3) -> str:
    """The no-specials step on ``device`` against the CPU's: reset from
    ``PRNGKey(seed)``, actions drawn from ``PRNGKey(seed + 77)``."""
    from .. import random as trandom
    from ..envs.batched import batched_reset

    states, ts = batched_reset(cfg, trandom.PRNGKey(seed, device), B)
    mask, key = ts.info.effective_actions, trandom.PRNGKey(seed + 77, device)
    for i in range(steps):
        states, mask, key = _step_pair(cfg, states, mask, key, device, f"step {i}")
    return f"fused step parity OK: {steps} steps, B={B}"


def check_sp_step(cfg, seed: int, B: int, device, steps: int = 2) -> str:
    """The specials step on ``device`` against the CPU's, from boards with
    poked specials (``poked_states``), actions drawn from
    ``PRNGKey(seed + 9)``; the poked boards' mask (K3) against the plain
    one too."""
    import torch

    from .. import random as trandom
    from ..ops.mask_sp import settled_mask_sp

    states, mask = poked_states(cfg, seed, B, device)
    want = settled_mask_sp(cfg, states.colour.cpu(), states.kind.cpu())
    check(torch.equal(mask.cpu(), want), "sp step: the poked boards' mask diverges")
    key = trandom.PRNGKey(seed + 9, device)
    for i in range(steps):
        states, mask, key = _step_pair(cfg, states, mask, key, device, f"sp step {i}")
    return f"fused SPECIALS step parity OK: {steps} steps, B={B}"


def gate(config: int, device, batch: int | None = None) -> None:
    """The port bench's parity gate for ``bench.CONFIGS[config]`` at
    ``batch`` boards (default the config's bench batch): the recorded JAX
    rollout replays bit for bit, then the step on ``device`` equals the
    CPU's at ``GATE_BATCH[config]`` boards, and without specials K1 equals
    its plain version at ``batch`` boards.  Prints a line a check; raises
    on the first difference.  Nothing skips it."""
    from ..bench import CONFIG_BATCH, CONFIGS, make_config

    n = replay_fixture(device, FIXTURES[config])
    print(f"gate: config {config}: replayed {n} steps of "
          f"{os.path.basename(FIXTURES[config])} bit for bit", flush=True)
    cfg = make_config(config)
    B = GATE_BATCH[config]
    line = check_sp_step(cfg, 4, B, device) if cfg.any_special else check_step(cfg, 3, B, device)
    print(f"gate: config {config}: {line}", flush=True)
    if not cfg.any_special:
        R, C, K = CONFIGS[config][:3]
        line = check_cascade(config, batch or CONFIG_BATCH[config], R, C, K, device)
        print(f"gate: config {config}: {line}", flush=True)


def main(argv=None) -> int:
    from ..bench import make_config
    from ..cuda_build import resolve_device

    ap = argparse.ArgumentParser(description="the port's parity checks")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for seed, B, R, C, K in ((0, 256, 10, 10, 4), (1, 1024, 10, 10, 4), (2, 512, 5, 5, 3)):
        print(check_cascade(seed, B, R, C, K, device), flush=True)
    print(check_step(make_config(1), 3, 256, device), flush=True)
    print(check_sp_step(make_config(3), 4, 256, device), flush=True)
    print("ALL PARITY CHECKS PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
