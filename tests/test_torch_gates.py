"""The port's gate tools against the JAX package's: ``kernel_coverage``
equals ``tools/kernel_coverage.py`` (run on the CPU, its kernel in
interpret mode) in every key but the loop's rounds; ``truncation_audit``
equals ``tools/truncation_audit.py``, and a JAX rollout's count where a cut
``max_cascades`` makes truncation fire; ``parity_check``'s poked boards
and the port's step on them equal ``tools/tpu_parity_check.py``'s boards
and JAX's ``batched_step_fused_sp(..., interpret=True)``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tile_match_tpu.config import EnvConfig as JaxConfig
from tile_match_tpu.envs.batched import batched_reset as jax_reset
from tile_match_tpu.envs.batched import batched_step as jax_step
from tile_match_tpu.envs.fused import batched_step_fused_sp as jax_fused_sp
from tile_match_tpu.ops.effective import effective_mask_settled as jax_mask
from tile_match_tpu_torch import bench
from tile_match_tpu_torch import random as trandom
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.envs.batched import masked_categorical
from tile_match_tpu_torch.envs.fused import batched_step_fused_sp
from tile_match_tpu_torch.tools import kernel_coverage, parity_check, truncation_audit

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (config, batch, steps) of each coverage comparison
COVERAGE_RUNS = ((3, 64, 8), (2, 32, 4))
# config 4: at more than 256 cells a board the JAX kernel freezes on its
# lean predicate, so only the trips agree
COVERAGE_LEAN = (4, 8, 3)
AUDIT_RUN = (3, 64, 8)


def _jax_tool(name, *args):
    """Start ``tools/<name>.py`` of the JAX package on the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    return subprocess.Popen([sys.executable, os.path.join(ROOT, "tools", f"{name}.py"),
                             *map(str, args)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _result(proc) -> dict:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out[out.index("{"):])


@pytest.fixture(scope="module")
def jax_tools():
    """The JAX tools' JSON, their processes started together."""
    procs = {("coverage", *run): _jax_tool("kernel_coverage", "--config", run[0], "--batch",
                                           run[1], "--steps", run[2])
             for run in (*COVERAGE_RUNS, COVERAGE_LEAN)}
    procs[("audit", *AUDIT_RUN)] = _jax_tool("truncation_audit", "--config", AUDIT_RUN[0],
                                             "--batch", AUDIT_RUN[1], "--steps", AUDIT_RUN[2])
    return {key: _result(p) for key, p in procs.items()}


@pytest.mark.parametrize("run", COVERAGE_RUNS, ids=lambda r: f"config{r[0]}-b{r[1]}-s{r[2]}")
def test_kernel_coverage_equals_jax_tool(run, jax_tools):
    config, batch, steps = run
    got = {"config": config, **kernel_coverage.coverage(bench.make_config(config), batch, steps,
                                                        "cpu")}
    want = jax_tools[("coverage", *run)]
    assert set(got) == set(want)
    rounds = {"rounds_total", "rounds_mean_per_step"}
    assert {k: v for k, v in got.items() if k not in rounds} == {
        k: v for k, v in want.items() if k not in rounds}
    assert got["trips_full_machinery"] > 0 and got["frozen_board_steps"] > 0


def test_kernel_coverage_config4_differs_by_design(jax_tools):
    """At 20x20 the JAX kernel's lean predicate freezes boards that K2's
    case table takes: the trips are equal, the port freezes no more."""
    config, batch, steps = COVERAGE_LEAN
    got = kernel_coverage.coverage(bench.make_config(config), batch, steps, "cpu")
    want = jax_tools[("coverage", *COVERAGE_LEAN)]
    assert (got["trips_total"], got["board_steps"]) == (want["trips_total"], want["board_steps"])
    assert got["trips_full_machinery"] <= want["trips_full_machinery"]
    assert got["frozen_board_steps"] < want["frozen_board_steps"]


def test_truncation_audit_equals_jax_tool(jax_tools):
    config, batch, steps = AUDIT_RUN
    want = jax_tools[("audit", *AUDIT_RUN)]
    got = truncation_audit.audit(bench.make_config(config), batch, steps, "cpu")
    assert got == want["truncated_board_steps"]
    assert (want["board_steps"], want["batch"], want["steps"]) == (batch * steps, batch, steps)


def test_truncation_audit_cli_keys(capsys):
    assert truncation_audit.main(["--config", "1", "--batch", "8", "--steps", "2",
                                  "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert list(out) == ["config", "batch", "steps", "board_steps", "truncated_board_steps",
                         "backend"]
    assert out["backend"] == "cpu" and out["board_steps"] == 16


def test_truncation_fires_with_a_cut_cascade_cap():
    """``max_cascades`` cut so that cascades hit the cap: the port's count
    equals the JAX rollout's (the tool's loop), and is above 0."""
    idx, max_cascades = 1, 1
    R, C, K, moves, colourless, colour = bench.CONFIGS[idx]
    kw = dict(colourless_specials=colourless, colour_specials=colour,
              max_cascades=max_cascades)
    jcfg = JaxConfig.create(R, C, K, moves, **kw)
    batch, steps = 32, 4

    @jax.jit
    def one_step(states, mask, key):
        key, ka = jax.random.split(key)
        logits = jnp.where(mask, 0.0, -jnp.inf)
        acts = jnp.where(
            mask.any(-1), jax.random.categorical(ka, logits, axis=-1), 0
        ).astype(jnp.int32)
        states, ts = jax_step(jcfg, states, acts, eff_mask=mask)
        return states, ts.info.effective_actions, key, ts.info.truncated.sum()

    key, k0 = jax.random.split(jax.random.PRNGKey(0))
    states, ts = jax_reset(jcfg, k0, batch)
    mask, want = ts.info.effective_actions, 0
    for _ in range(steps):
        states, mask, key, n = one_step(states, mask, key)
        want += int(n)
    cfg = EnvConfig.create(R, C, K, moves, **kw)
    assert truncation_audit.audit(cfg, batch, steps, "cpu") == want > 0


def test_kernel_coverage_refuses_configs_without_specials():
    with pytest.raises(ValueError, match="specials configs"):
        kernel_coverage.coverage(bench.make_config(1), 8, 1, "cpu")


@pytest.mark.parametrize("case", [(0, 256, 10, 10, 4), (1, 1024, 10, 10, 4), (2, 512, 5, 5, 3),
                                  (0, 32768, 5, 5, 3)])
def test_cascade_inputs_equal_jax_tool(case):
    """``check_cascade``'s boards and keys are ``tools/tpu_parity_check.py``'s
    (``:43-46``), at its three cases and config 0's bench batch."""
    seed, B, R, C, K = case
    colour, keys = parity_check.cascade_inputs(seed, B, R, C, K, "cpu")
    rng = np.random.default_rng(seed)
    assert np.array_equal(colour.numpy(), rng.integers(1, K + 1, size=(B, R, C)))
    jkeys = jax.vmap(jax.random.PRNGKey)(jnp.arange(seed * 10_000, seed * 10_000 + B))
    assert np.array_equal(keys.numpy(), np.asarray(jkeys).astype(np.int64))


def test_poked_boards_and_step_equal_jax():
    """``tools/tpu_parity_check.py:101-111``'s boards (config 3, seed 4),
    their mask, and two steps of JAX's fused specials step in interpret
    mode from them, against ``parity_check.poked_states`` and the port's
    step, every field that tool compares."""
    seed, B = 4, 32
    R, C, K, moves, colourless, colour = bench.CONFIGS[3]
    jcfg = JaxConfig.create(R, C, K, moves, colourless_specials=colourless,
                            colour_specials=colour)
    jstates, _ = jax_reset(jcfg, jax.random.PRNGKey(seed), B)
    rng = np.random.default_rng(seed)
    jcolour = np.asarray(jstates.colour).copy()
    jkind = np.asarray(jstates.kind).copy()
    for b in range(B):
        for _ in range(rng.integers(1, 6)):
            r, c = rng.integers(0, 10), rng.integers(0, 10)
            k = int(rng.choice([2, 3, 4, -1]))
            jkind[b, r, c] = k
            if k == -1:
                jcolour[b, r, c] = 0
    jstates = jstates.replace(colour=jnp.asarray(jcolour), kind=jnp.asarray(jkind))
    jm = jax.jit(jax.vmap(lambda s: jax_mask(jcfg, s.colour, s.kind)))(jstates)

    cfg = bench.make_config(3)
    states, mask = parity_check.poked_states(cfg, seed, B, "cpu")
    assert np.array_equal(states.colour.numpy(), jcolour)
    assert np.array_equal(states.kind.numpy(), jkind)
    assert np.array_equal(mask.numpy(), np.asarray(jm))

    key, jkey = trandom.PRNGKey(seed + 9, "cpu"), jax.random.PRNGKey(seed + 9)
    jstep = jax.jit(lambda s, a, m: jax_fused_sp(jcfg, s, a, m, interpret=True))
    for i in range(2):
        key, ka = trandom.split(key)
        jkey, jka = jax.random.split(jkey)
        acts = masked_categorical(ka, mask)
        logits = jnp.where(jm, 0.0, -jnp.inf)
        jacts = jnp.where(
            jm.any(-1), jax.random.categorical(jka, logits, axis=-1), 0
        ).astype(jnp.int32)
        assert np.array_equal(acts.numpy(), np.asarray(jacts)), i
        states, rew, _, info = batched_step_fused_sp(cfg, states, acts, mask)
        jstates, jrew, _, jinfo = jstep(jstates, jacts, jm)
        for got, want, name in [
            (states.colour, jstates.colour, "colour"), (states.kind, jstates.kind, "kind"),
            (states.key.to(torch.int64), np.asarray(jstates.key).astype(np.int64), "key"),
            (rew, jrew, "reward"), (info.effective_actions, jinfo.effective_actions, "mask"),
            (info.num_specials_activated, jinfo.num_specials_activated, "act"),
            (info.num_new_specials, jinfo.num_new_specials, "new"),
            (info.cascade_trips, jinfo.cascade_trips, "trips"),
        ]:
            assert np.array_equal(got.numpy(), np.asarray(want)), f"step {i}: {name}"
        mask, jm = info.effective_actions, jinfo.effective_actions
    assert info.num_specials_activated.sum() > 0
