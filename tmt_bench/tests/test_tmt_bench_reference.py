"""The plain reference equals the port's CPU step, and the harness's check
passes the port, on configs 1 and 3 at a tiny batch, across an auto-reset."""

from __future__ import annotations

import pytest
import torch

from tmt_bench.program import PortProgram, ReferenceProgram
from tmt_bench.reference import engine as ref
from tmt_bench.reference import random as rrandom
from tmt_bench.reference.config import EnvConfig as RefConfig

from .helpers import tiny_run

INFO = ("is_combination_match", "num_new_specials", "num_specials_activated", "shuffled",
        "truncated", "cascade_trips")


@pytest.mark.parametrize("idx", [1, 3])
def test_reference_step_equals_the_ports_cpu_step(idx):
    from tile_match_tpu_torch import random as trandom
    from tile_match_tpu_torch.bench import make_config
    from tile_match_tpu_torch.envs.batched import batched_reset, batched_step, random_effective

    cfg = make_config(idx)
    rcfg = RefConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    B = 6
    key, k0 = trandom.split(trandom.PRNGKey(idx + 40, "cpu"))
    states, ts = batched_reset(cfg, k0, B)
    rs, rmask, _ = ref.reset(rcfg, rrandom.split(k0, B))
    assert torch.equal(rs.colour, states.colour) and torch.equal(rs.key, states.key)
    assert torch.equal(rmask, ts.info.effective_actions)
    resets = 0
    for t in range(31):
        key, ka = trandom.split(key)
        a = random_effective(ka, ts)
        assert torch.equal(a, rrandom.masked_categorical_rows(ka.expand(B, 2), rmask, torch.arange(B)))
        prev = ref.EnvState(states.colour, states.kind, states.timer, states.key)
        states, ts = batched_step(cfg, states, a, eff_mask=ts.info.effective_actions)
        rs, info = ref.step(rcfg, prev, a, rmask)
        for name in ("colour", "kind", "timer", "key"):
            assert torch.equal(getattr(rs, name), getattr(states, name)), (t, name)
        assert torch.equal(info["reward"], ts.reward) and torch.equal(info["done"], ts.done)
        assert torch.equal(info["mask"], ts.info.effective_actions), t
        for name in INFO:
            assert torch.equal(info[name], getattr(ts.info, name)), (t, name)
        resets += int(ts.done.any())
        rmask = info["mask"]
    assert resets == 1


@pytest.mark.parametrize("workload", ["c1_rollout_b256", "c3_rollout_b16384"])
def test_the_check_passes_the_port(workload):
    res = tiny_run(workload, PortProgram, steps=1)
    assert res["correct"], res["checks"]
    assert res["checked"]["steps"] == 31 and res["checked"]["boards"] == 4
    assert sum(res["checked"]["mismatches_by_field"].values()) == 0


def test_the_reference_in_the_programs_place_passes():
    res = tiny_run("c1_rollout_b256", ReferenceProgram, warmup_episodes=0, steps=31)
    assert res["correct"], res["checks"]
