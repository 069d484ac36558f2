"""The port's engine equals the JAX package's, exactly: reset and step
against ``jax.vmap(engine.step)`` (no-op moves and boards that gave up
included); and the port imports no JAX."""

import functools
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.torch_port_helpers import assert_info, assert_state, cfgs, policy_np
from tile_match_tpu import engine as je
from tile_match_tpu_torch import engine as te
from tile_match_tpu_torch import random as trandom
from tile_match_tpu_torch.config import EnvConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tkeys(keys):
    return torch.from_numpy(np.asarray(keys).astype(np.int64))


@functools.lru_cache(maxsize=None)
def _jax_step(jc):
    return jax.jit(jax.vmap(lambda s, a, m: je.step(jc, s, a, eff_mask=m)))


@functools.lru_cache(maxsize=None)
def _jax_reset(jc):
    return jax.jit(jax.vmap(lambda k: je.reset(jc, k)))


@pytest.mark.parametrize("idx", [0, 1])
@pytest.mark.parametrize("seed", [0, 1])
def test_reset_and_step_match_jax(idx, seed):
    jc, tc = cfgs(idx)
    B = 130
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    jstate, jinfo = _jax_reset(jc)(keys)
    tstate, tinfo = te.reset(tc, _tkeys(keys))
    assert_state(tstate, jstate, "reset")
    assert_info(tinfo, jinfo, "reset")
    for t in range(4):
        acts = policy_np(t, np.asarray(jinfo.effective_actions))
        jstate, jr, jd, jinfo = _jax_step(jc)(jstate, jnp.asarray(acts), jinfo.effective_actions)
        tstate, tr, td, tinfo = te.step(tc, tstate, torch.from_numpy(acts), eff_mask=tinfo.effective_actions)
        assert_state(tstate, jstate, t)
        assert_info(tinfo, jinfo, t)
        assert np.array_equal(tr.numpy(), np.asarray(jr)) and np.array_equal(td.numpy(), np.asarray(jd))
        assert (tr > 0).all()


def test_step_without_mask_and_observe():
    jc, tc = cfgs(0)
    keys = jax.random.split(jax.random.PRNGKey(5), 40)
    jstate, jinfo = _jax_reset(jc)(keys)
    tstate, _ = te.reset(tc, _tkeys(keys))
    acts = policy_np(0, np.asarray(jinfo.effective_actions))
    jout = jax.jit(jax.vmap(lambda s, a: je.step(jc, s, a)))(jstate, jnp.asarray(acts))
    tout = te.step(tc, tstate, torch.from_numpy(acts))
    assert_state(tout[0], jout[0], "no mask")
    assert_info(tout[3], jout[3], "no mask")
    jobs = jax.jit(jax.vmap(lambda s: je.observe(jc, s)))(jout[0])
    tobs = te.observe(tc, tout[0])
    for k in ("board", "num_moves_left"):
        assert np.array_equal(tobs[k].numpy(), np.asarray(jobs[k]))


def test_no_op_moves_keep_board_key_and_mask():
    jc, tc = cfgs(1)
    B = 64
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    jstate, jinfo = _jax_reset(jc)(keys)
    tstate, tinfo = te.reset(tc, _tkeys(keys))
    mask = np.asarray(jinfo.effective_actions)
    noop = np.arange(B) % 2 == 0
    acts = np.where(noop, (~mask).argmax(-1), policy_np(0, mask)).astype(np.int32)
    assert not mask[np.arange(B), acts][noop].any()
    jout = _jax_step(jc)(jstate, jnp.asarray(acts), jinfo.effective_actions)
    tout = te.step(tc, tstate, torch.from_numpy(acts), eff_mask=tinfo.effective_actions)
    assert_state(tout[0], jout[0], "no-op")
    assert_info(tout[3], jout[3], "no-op")
    for f in ("colour", "kind", "key"):
        assert torch.equal(getattr(tout[0], f)[noop], getattr(tstate, f)[noop])
    assert torch.equal(tout[3].effective_actions[noop], tinfo.effective_actions[noop])
    assert (tout[1][noop] == 0).all() and (tout[1][~noop] > 0).all()


def test_gave_up_boards_match_jax():
    """With a tiny regeneration budget most boards give up: all-false mask,
    truncated set, and every later move a no-op."""
    jc, tc = cfgs(1, max_regen_iters=2)
    keys = jax.random.split(jax.random.PRNGKey(4), 48)
    jstate, jinfo = _jax_reset(jc)(keys)
    tstate, tinfo = te.reset(tc, _tkeys(keys))
    assert_state(tstate, jstate, "reset")
    assert_info(tinfo, jinfo, "reset")
    gave_up = tinfo.truncated
    assert gave_up.any() and not tinfo.effective_actions[gave_up].any()
    acts = policy_np(0, np.asarray(jinfo.effective_actions))
    jout = _jax_step(jc)(jstate, jnp.asarray(acts), jinfo.effective_actions)
    tout = te.step(tc, tstate, torch.from_numpy(acts), eff_mask=tinfo.effective_actions)
    assert_state(tout[0], jout[0], "step")
    assert_info(tout[3], jout[3], "step")


def test_every_special_set_runs():
    """Every special set runs, without the bomb too (K2's no-bomb case
    table)."""
    keys = trandom.split(trandom.PRNGKey(0, "cpu"), 2)
    te.reset(EnvConfig.create(6, 6, 4), keys)
    no_bomb = EnvConfig.create(6, 6, 4, colour_specials=("vertical_laser", "horizontal_laser"))
    state, info = te.reset(no_bomb, keys)
    assert info.effective_actions.any(-1).all() and not info.truncated.any()
    acts = info.effective_actions.to(torch.int64).argmax(-1)
    _, reward, _, _ = te.step(no_bomb, state, acts, eff_mask=info.effective_actions)
    assert (reward > 0).all()


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'orbax.checkpoint'):\n"
        "    sys.modules[name] = None\n"
        "import tile_match_tpu_torch, tile_match_tpu_torch.envs.batched\n"
        "import tile_match_tpu_torch.models.replay, tile_match_tpu_torch.models.dqn\n"
        "import tile_match_tpu_torch.models.dqn_replay, tile_match_tpu_torch.models.qrdqn\n"
        "import tile_match_tpu_torch.models.random_agent, tile_match_tpu_torch.models.q_learning\n"
        "import tile_match_tpu_torch.checkpoint, tile_match_tpu_torch.entry\n"
        "import chip_smoke\n"
        "chip_smoke._fixture_tool()\n"
        "import tile_match_tpu_torch.interop, tile_match_tpu_torch.cuda_build\n"
        "import tile_match_tpu_torch.parity, tile_match_tpu_torch.envs._threefry_driver\n"
        "import tile_match_tpu_torch.envs.gym_env, tile_match_tpu_torch.envs.spaces\n"
        "import tile_match_tpu_torch.wrappers, tile_match_tpu_torch.rendering.pygame_renderer\n"
        "import tile_match_tpu_torch.parallel, tile_match_tpu_torch.parallel.sharding\n"
        "import tile_match_tpu_torch.debug, tile_match_tpu_torch.profiling\n"
        "import tile_match_tpu_torch.utils, tile_match_tpu_torch.native\n"
        "import tile_match_tpu_torch.examples.random_baseline, tile_match_tpu_torch.examples.play\n"
        "import tile_match_tpu_torch.examples.q_learning_sweep, tile_match_tpu_torch.examples.dqn_train\n"
        "import tile_match_tpu_torch.examples.scaling\n"
        "import tile_match_tpu_torch.bench, tile_match_tpu_torch.tools.parity_check\n"
        "import tile_match_tpu_torch.tools.kernel_coverage\n"
        "import tile_match_tpu_torch.tools.truncation_audit\n"
        "assert not any(m.startswith('tile_match_tpu.') or m == 'tile_match_tpu' for m in sys.modules)\n"
        "print('imported')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


def test_port_sources_never_import_jax():
    pattern = re.compile(
        r"^\s*(?:from|import)\s+(?:jax\b|jaxlib\b|flax\b|optax\b|orbax\b|tile_match_tpu(?!_torch))",
        re.M,
    )
    pkg = os.path.join(ROOT, "tile_match_tpu_torch")
    sources = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(pkg):
        sources += [os.path.join(dirpath, n) for n in files if n.endswith(".py")]
    assert len(sources) > 10
    for path in sources:
        with open(path) as f:
            assert not pattern.search(f.read()), path
