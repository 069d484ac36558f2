"""Record a JAX rollout that the PyTorch port must replay bit for bit.

Runs the JAX package on the CPU: config 1 of ``bench.py`` (10x10 boards,
4 colours, 30 moves, no specials), 64 boards, 40 auto-resetting steps (one
reset at step 30) under a deterministic policy both packages compute alike
— board b at step t takes the ((7t + b) mod n_eff)-th of its n_eff
effective actions, action 0 if it has none — and writes every state and
TimeStep field of every step to ``tests/data/torch_port_fixture_cfg1.npz``.

    JAX_PLATFORMS=cpu python tools/make_torch_port_fixture.py

``tests/test_torch_envs.py`` replays the file through the port and checks
that this script still writes the same arrays; ``chip_smoke.py`` replays it
on the card.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_fixture_cfg1.npz")
CONFIG = dict(num_rows=10, num_cols=10, num_colours=4, num_moves=30)
BATCH = 64
STEPS = 40
SEED = 2024

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


def record(batch: int = BATCH, steps: int = STEPS) -> dict:
    """Run the JAX package and return the fixture's arrays, each stacked
    over steps 0..steps (step 0 is the reset)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import jax

    from tile_match_tpu.config import EnvConfig
    from tile_match_tpu.envs.batched import BatchedTileMatchEnv

    cfg = EnvConfig.create(**CONFIG, colourless_specials=(), colour_specials=())
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
    return {k: v.astype(NARROW.get(k, v.dtype)) for k, v in out.items()}


def main() -> None:
    arrays = record()
    os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
    np.savez_compressed(FIXTURE, **arrays)
    print(f"wrote {FIXTURE}: {os.path.getsize(FIXTURE)} bytes")


if __name__ == "__main__":
    main()
