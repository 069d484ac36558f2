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
* ``tests/data/torch_port_fixture_cfg0.npz``, ``_cfg2.npz``, ``_cfg4.npz``:
  the other configs of ``bench.py``, so that the port bench's gate replays
  a JAX rollout of every config: config 0 (5x5, 3 colours, 10 moves, no
  specials) at 64 boards for 12 steps (one reset at step 10), config 2
  (10x10, 4 colours, both lasers and the bomb) at 32 boards for 12 steps,
  config 4 (20x20, 6 colours, 100 moves, every special) at 16 boards for
  8 steps;
* ``tests/data/torch_port_gym_episodes.json``: single-board episodes of the
  JAX Gym adapter ``TileMatchEnv`` at 10x10, 4 colours, 8 moves, in both
  RNG modes ("threefry" and "numpy"), for four special sets — all, none,
  both lasers, cookie only — under the same policy with board b = the
  episode's index.
* ``tests/data/torch_port_fixture_dqn.npz``: the training path's draws
  and a DQN run.  ``jax.random.uniform`` over [16384] and
  ``jax.random.categorical`` over a [16384, 180] effective-action mask
  (threefry bits, one row in 97 with no effective action): the draw,
  the first 64 rows of its uniforms and a digest of them all; 40
  ``make_dqn`` train steps on config 1 at batch 256 and hidden 512 with
  epsilon held at 1, so that actions depend on the keys alone, from
  weights drawn from a numpy seed (``seeded_qnet_params``), not flax's
  own: each step's actions, env rewards and dones, loss and mean |TD|, the
  final env state and mask, and after steps 1, 5 and 40 Adam's first
  moment and the weights' change from the seeded start at 512 entries of
  each leaf (``learner_samples``); and the flax ``QNetwork``'s Q on 64 of
  the final boards under the seeded weights.
* ``tests/data/torch_port_fixture_sharded.npz``: the scale-out layer on a
  one-device mesh.  ``parallel.sharded_rollout`` of config 3 at 64 boards
  for 8 steps from ``PRNGKey(SHARDED_SEED)`` (per-board rewards, the final
  state, the stats), and two ``parallel.sharded_train_step``s on config 1
  at batch 256, hidden 512, epsilon held at 1, keys ``split(PRNGKey(
  SHARDED_SEED), 3)`` (init, then a key a step), from the seeded weights:
  each step's loss, mean |TD| and reward mean, Adam's first moment and the
  weights' change at 512 entries of each leaf, and the final env state
  and mask.

    JAX_PLATFORMS=cpu python tools/make_torch_port_fixture.py [NAME ...]

writes every file, or those named (``cfg0``, ``cfg1``, ``cfg2``, ``cfg3``,
``cfg4``, ``nobomb``, ``dqn``, ``gym``, ``sharded``).

``tests/test_torch_envs.py``, ``tests/test_torch_envs_sp.py``,
``tests/test_torch_gym.py``, ``tests/test_torch_models_fixture.py`` and
``tests/test_torch_sharded_fixture.py`` replay the files through the port and check that this script still writes
the same arrays; ``chip_smoke.py`` replays them on the card.
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
# configs 0, 2 and 4 of bench.py: name -> (file, config, specials, boards, steps)
BENCH_FIXTURES = {
    "cfg0": (os.path.join(ROOT, "tests", "data", "torch_port_fixture_cfg0.npz"),
             dict(num_rows=5, num_cols=5, num_colours=3, num_moves=10), (), 64, 12),
    "cfg2": (os.path.join(ROOT, "tests", "data", "torch_port_fixture_cfg2.npz"), CONFIG,
             ("vertical_laser", "horizontal_laser", "bomb"), 32, 12),
    "cfg4": (os.path.join(ROOT, "tests", "data", "torch_port_fixture_cfg4.npz"),
             dict(num_rows=20, num_cols=20, num_colours=6, num_moves=100), SPECIALS_CFG3, 16, 8),
}
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
FIXTURE_DQN = os.path.join(ROOT, "tests", "data", "torch_port_fixture_dqn.npz")
# the draws: (boards, actions) of the categorical
DRAW_SHAPE = (16384, 180)
DRAW_SEED = 31
DRAW_ROWS = 64  # rows of the categorical's uniforms stored in full
# the DQN run: config 1, make_dqn's default batch, hidden 512
DQN_BATCH = 256
DQN_HIDDEN = 512
DQN_STEPS = 40
DQN_SEED = 5
QNET_SEED = 11
Q_BOARDS = 64
# the DQN run's learner: loss and |TD| every step; after these steps, Adam's
# first moment and each weight's change from the seeded start, at
# LEARNER_SAMPLES entries of each leaf drawn from LEARNER_SEED
FIXTURE_SHARDED = os.path.join(ROOT, "tests", "data", "torch_port_fixture_sharded.npz")
SHARDED_BATCH = 64
SHARDED_STEPS = 8
SHARDED_TRAIN_STEPS = 2
SHARDED_SEED = 17
LEARNER_STEPS = (1, 5, 40)
LEARNER_SAMPLES = 512
LEARNER_SEED = 13

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


def record(batch: int = BATCH, steps: int = STEPS, specials=(), config=None) -> dict:
    """Run the JAX package and return the fixture's arrays, each stacked
    over steps 0..steps (step 0 is the reset).  ``specials``: the enabled
    special names; with any, the file also holds their flags under
    "specials" (cookie, vertical laser, horizontal laser, bomb).
    ``config``: rows, cols, colours and moves (default ``CONFIG``)."""
    config = config or CONFIG
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import jax

    from tile_match_tpu.config import EnvConfig
    from tile_match_tpu.envs.batched import BatchedTileMatchEnv

    cfg = EnvConfig.create(
        **config,
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
        [config[k] for k in ("num_rows", "num_cols", "num_colours", "num_moves")],
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


def seeded_qnet_params(in_features: int, hidden: int, num_actions: int, seed: int) -> dict:
    """QNetwork parameters in flax's layout ({"params": {"dense1": {"kernel"
    [in, out], "bias"}, "dense2", "head"}}, float32 numpy) drawn from a
    numpy seed: kernels uniform in +-sqrt(3 / fan-in), biases in +-0.1."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, (n_in, n_out) in (("dense1", (in_features, hidden)), ("dense2", (hidden, hidden)),
                                ("head", (hidden, num_actions))):
        lim = np.sqrt(3.0 / n_in)
        params[name] = {
            "kernel": ((rng.random((n_in, n_out)) * 2 - 1) * lim).astype(np.float32),
            "bias": ((rng.random(n_out) * 2 - 1) * 0.1).astype(np.float32),
        }
    return {"params": params}


def port_leaves(tree) -> dict:
    """A QNetwork's flax parameters (or an optax moment of them) as numpy
    arrays named and shaped as the port's state dict: each kernel [in,
    out] a weight [out, in]."""
    out = {}
    for name, layer in tree["params"].items():
        out[f"{name}.weight"] = np.asarray(layer["kernel"], np.float32).T
        out[f"{name}.bias"] = np.asarray(layer["bias"], np.float32)
    return out


def learner_samples(leaves: dict) -> dict:
    """The recorded entries of each leaf (port names and shapes): up to
    LEARNER_SAMPLES flat indices of each, drawn in the order of the port's
    state dict from LEARNER_SEED."""
    rng = np.random.default_rng(LEARNER_SEED)
    out = {}
    for name in ("dense1.weight", "dense1.bias", "dense2.weight", "dense2.bias",
                 "head.weight", "head.bias"):
        flat = np.asarray(leaves[name], np.float32).reshape(-1)
        idx = np.sort(rng.choice(flat.size, min(flat.size, LEARNER_SAMPLES), replace=False))
        out[name] = flat[idx]
    return out


def record_draws() -> dict:
    """The draws: keys (mask, categorical, uniform) from ``split(PRNGKey(
    DRAW_SEED), 3)``; the mask has a fifth of the actions effective and
    none in every 97th row."""
    import jax
    import jax.numpy as jnp

    k_mask, k_cat, k_unif = jax.random.split(jax.random.PRNGKey(DRAW_SEED), 3)
    mask = np.asarray(jax.random.bits(k_mask, DRAW_SHAPE, np.uint32)) % 5 == 0
    mask[::97] = False
    tiny = np.finfo(np.float32).tiny
    u = np.asarray(jax.random.uniform(k_cat, DRAW_SHAPE, minval=tiny, maxval=1.0))
    bits = u.view(np.uint32).astype(np.uint64)
    return {
        "draw_uniform": np.asarray(jax.random.uniform(k_unif, DRAW_SHAPE[:1])),
        "draw_categorical": np.asarray(
            jax.random.categorical(k_cat, jnp.where(jnp.asarray(mask), 0.0, -jnp.inf), axis=-1)
        ).astype(np.int16),
        "draw_cat_uniform_rows": u[:DRAW_ROWS],
        "draw_cat_uniform_digest": np.asarray(
            [int(bits.sum()) % (1 << 63), int(np.bitwise_xor.reduce(bits.reshape(-1)))], np.int64
        ),
    }


def dqn_config():
    """Config 1 (no specials) of the JAX package."""
    from tile_match_tpu.config import EnvConfig

    return EnvConfig.create(**CONFIG, colourless_specials=(), colour_specials=())


def record_dqn() -> dict:
    """The JAX DQN run at epsilon 1 and the seeded-weight flax Q."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import jax

    from tile_match_tpu.envs.batched import batched_step
    from tile_match_tpu.models.dqn import QNetwork, _encode, make_dqn

    cfg = dqn_config()
    init_fn, train_step, act_fn = make_dqn(cfg, batch_size=DQN_BATCH, hidden=DQN_HIDDEN,
                                           eps_start=1.0, eps_end=1.0)
    step = jax.jit(train_step)
    act = jax.jit(act_fn)
    env_step = jax.jit(lambda s, a, m: batched_step(cfg, s, a, eff_mask=m))
    key = jax.random.PRNGKey(DQN_SEED)
    key, k_init = jax.random.split(key)
    state = jax.jit(init_fn)(k_init)
    params = seeded_qnet_params(int(np.prod(state.obs_planes.shape[1:])) + 1, DQN_HIDDEN,
                                cfg.num_actions, QNET_SEED)
    seeded = jax.tree.map(jax.numpy.asarray, params)
    # the learner starts from the seeded weights (Adam's zero moments do not
    # depend on them); at epsilon 1 the actions do not either
    state = state._replace(params=seeded, target_params=seeded)
    start = port_leaves(params)
    actions, rewards, dones, losses, tds, mu, change = [], [], [], [], [], [], []
    for t in range(DQN_STEPS):
        key, k = jax.random.split(key)
        a = act(state.params, state.obs_planes, state.obs_moves, state.eff_mask,
                jax.random.split(k)[1], 1.0)
        _, ts = env_step(state.env_states, a, state.eff_mask)
        state, metrics = step(state, k)
        actions.append(np.asarray(a))
        rewards.append(np.asarray(ts.reward))
        dones.append(np.asarray(ts.done))
        losses.append(float(metrics["loss"]))
        tds.append(float(metrics["td_abs"]))
        if t + 1 in LEARNER_STEPS:
            now = port_leaves(jax.tree.map(np.asarray, state.params))
            mu.append(learner_samples(port_leaves(jax.tree.map(np.asarray, state.opt_state[0].mu))))
            change.append(learner_samples({n: now[n] - start[n] for n in now}))
    final = state.env_states
    net = QNetwork(num_actions=cfg.num_actions, hidden=DQN_HIDDEN)
    planes, moves = _encode(cfg, jax.tree.map(lambda x: x[:Q_BOARDS], final))
    q = net.apply(seeded, planes, moves)
    out = {
        "dqn_actions": np.stack(actions).astype(np.int16),
        "dqn_rewards": np.stack(rewards),
        "dqn_dones": np.stack(dones),
        "dqn_colour": np.asarray(final.colour).astype(np.int8),
        "dqn_kind": np.asarray(final.kind).astype(np.int8),
        "dqn_timer": np.asarray(final.timer).astype(np.int8),
        "dqn_key": np.asarray(final.key),
        "dqn_eff_mask": np.asarray(state.eff_mask),
        "flax_q": np.asarray(q),
        "dqn_loss": np.asarray(losses, np.float32),
        "dqn_td_abs": np.asarray(tds, np.float32),
    }
    for name in mu[0]:
        out[f"dqn_mu_{name}"] = np.stack([m[name] for m in mu])
        out[f"dqn_change_{name}"] = np.stack([c[name] for c in change])
    out.update(record_draws())
    out.update(record_entry())
    return out


def record_entry() -> dict:
    """``__graft_entry__.entry``'s forward (config 3, 64 boards reset from key
    0, action 0) under the seeded weights: the reset boards, Q, rewards and
    next boards."""
    import jax

    import __graft_entry__

    forward, (params, states, actions) = __graft_entry__.entry()
    layers = params["params"]
    seeded = seeded_qnet_params(layers["dense1"]["kernel"].shape[0], DQN_HIDDEN,
                                layers["head"]["kernel"].shape[1], QNET_SEED)
    q, reward, nxt = jax.jit(forward)(jax.tree.map(jax.numpy.asarray, seeded), states, actions)
    out = {"entry_q": np.asarray(q), "entry_reward": np.asarray(reward)}
    for prefix, st in (("entry_reset", states), ("entry_next", nxt)):
        out[f"{prefix}_colour"] = np.asarray(st.colour).astype(np.int8)
        out[f"{prefix}_kind"] = np.asarray(st.kind).astype(np.int8)
        out[f"{prefix}_timer"] = np.asarray(st.timer).astype(np.int8)
        out[f"{prefix}_key"] = np.asarray(st.key)
    return out


def record_sharded() -> dict:
    """The JAX package's sharded rollout (config 3) and two sharded DQN train
    steps (config 1, seeded weights, epsilon 1) on a one-device mesh."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import jax

    from tile_match_tpu.config import EnvConfig
    from tile_match_tpu.parallel.sharding import make_mesh, sharded_rollout, sharded_train_step

    mesh = make_mesh(jax.devices()[:1], dp=1, tp=1)
    states, rew, stats = sharded_rollout(
        EnvConfig.create(**CONFIG), mesh, SHARDED_BATCH, SHARDED_STEPS
    )(jax.random.PRNGKey(SHARDED_SEED))
    out = {
        "rollout_reward": np.asarray(rew),
        "rollout_colour": np.asarray(states.colour).astype(np.int8),
        "rollout_kind": np.asarray(states.kind).astype(np.int8),
        "rollout_timer": np.asarray(states.timer).astype(np.int8),
        "rollout_key": np.asarray(states.key),
        "rollout_steps_done": np.asarray(stats["steps_done"]),
        "rollout_trips_sum": np.asarray(stats["trips_sum"]),
        "rollout_shard_max_trips": np.asarray(stats["shard_max_trips"]),
    }
    cfg = dqn_config()
    init, step = sharded_train_step(cfg, mesh, make_dqn_kwargs=dict(
        batch_size=DQN_BATCH, hidden=DQN_HIDDEN, eps_start=1.0, eps_end=1.0))
    keys = jax.random.split(jax.random.PRNGKey(SHARDED_SEED), SHARDED_TRAIN_STEPS + 1)
    metrics, mu, change = [], [], []
    with mesh:
        state = init(keys[0])
        params = seeded_qnet_params(int(np.prod(state.obs_planes.shape[1:])) + 1, DQN_HIDDEN,
                                    cfg.num_actions, QNET_SEED)
        seeded = jax.tree.map(jax.numpy.asarray, params)
        state = state._replace(params=seeded, target_params=seeded)
        start = port_leaves(params)
        for k in keys[1:]:
            state, m = step(state, k)
            metrics.append([float(m[n]) for n in ("loss", "td_abs", "reward_mean")])
            now = port_leaves(jax.tree.map(np.asarray, state.params))
            mu.append(learner_samples(port_leaves(jax.tree.map(np.asarray, state.opt_state[0].mu))))
            change.append(learner_samples({n: now[n] - start[n] for n in now}))
    final = state.env_states
    out.update({
        "train_metrics": np.asarray(metrics, np.float32),
        "train_colour": np.asarray(final.colour).astype(np.int8),
        "train_kind": np.asarray(final.kind).astype(np.int8),
        "train_timer": np.asarray(final.timer).astype(np.int8),
        "train_key": np.asarray(final.key),
        "train_eff_mask": np.asarray(state.eff_mask),
    })
    for name in mu[0]:
        out[f"train_mu_{name}"] = np.stack([m[name] for m in mu])
        out[f"train_change_{name}"] = np.stack([c[name] for c in change])
    return out


def main(names=None) -> None:
    recorders = {
        "cfg1": (FIXTURE, record),
        "cfg3": (FIXTURE_CFG3, lambda: record(BATCH_CFG3, STEPS_CFG3, SPECIALS_CFG3)),
        "nobomb": (FIXTURE_NOBOMB, lambda: record(BATCH_CFG3, STEPS_CFG3, SPECIALS_NOBOMB)),
        "dqn": (FIXTURE_DQN, record_dqn),
        "sharded": (FIXTURE_SHARDED, record_sharded),
        **{name: (path, lambda c=config, sp=specials, b=batch, t=steps: record(b, t, sp, c))
           for name, (path, config, specials, batch, steps) in BENCH_FIXTURES.items()},
    }
    names = names or [*recorders, "gym"]
    os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
    for name in names:
        if name == "gym":
            with open(FIXTURE_GYM, "w") as f:
                json.dump(record_gym(), f, separators=(",", ":"))
            print(f"wrote {FIXTURE_GYM}: {os.path.getsize(FIXTURE_GYM)} bytes")
            continue
        path, fn = recorders[name]
        np.savez_compressed(path, **fn())
        print(f"wrote {path}: {os.path.getsize(path)} bytes")


if __name__ == "__main__":
    main(sys.argv[1:])
