"""The check reads a broken timed path as not correct, and the control as
not correct: a whole run on the CPU (no look for a card) with the program
broken underneath.

The faults a cell of this benchmark can have: a step that returns its
state unchanged; half of the batch left out of the step; an answer altered
where it is produced (a board's cell, or its next mask).  (No cell spans
chips, so none can leave out an exchange between them.)  The control is
the reference in the program's place with its actions drawn from torch's
Philox generator in place of the threefry key.  A cascade cut at its cap
leaves only the mask of the board it hands on uncompared."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from tmt_bench.control import control_run
from tmt_bench.program import PortProgram, ReferenceProgram

from .helpers import BOARDS, CHUNK, CPU, tiny_cell, tiny_run


class Unchanged(PortProgram):
    """The step hands back the state and outputs it was given."""

    def step(self, states, ts, actions):
        return states, ts


class HalfBatch(PortProgram):
    """Only the first half of the batch is stepped; the other half comes back
    as it went in."""

    def step(self, states, ts, actions):
        new_states, new_ts = super().step(states, ts, actions)
        h = actions.shape[0] // 2

        def keep(new, old):
            return torch.cat([new[:h], old[h:]])

        s = type(states)(*(keep(getattr(new_states, f), getattr(states, f))
                           for f in ("colour", "kind", "timer", "key")))
        info = dataclasses.replace(new_ts.info, effective_actions=keep(
            new_ts.info.effective_actions, ts.info.effective_actions))
        return s, dataclasses.replace(
            new_ts, obs_board=s.board, obs_moves_left=keep(new_ts.obs_moves_left, ts.obs_moves_left),
            reward=keep(new_ts.reward, ts.reward), done=keep(new_ts.done, ts.done), info=info)


class Altered(PortProgram):
    """One cell of every board altered where the step produces it, once."""

    steps = 0

    def step(self, states, ts, actions):
        states, ts = super().step(states, ts, actions)
        self.steps += 1
        if self.steps == 3:
            colour = states.colour.clone()
            colour[:, 0, 0] = colour[:, 0, 0] % self.cfg.num_colours + 1
            states = dataclasses.replace(states, colour=colour)
            ts = dataclasses.replace(ts, obs_board=states.board)
        return states, ts


class AlteredMask(PortProgram):
    """Every board's next-move mask altered where the step produces it,
    once: the first action flipped."""

    steps = 0

    def step(self, states, ts, actions):
        states, ts = super().step(states, ts, actions)
        self.steps += 1
        if self.steps == 3:
            mask = ts.info.effective_actions.clone()
            mask[:, 0] = ~mask[:, 0]
            ts = dataclasses.replace(ts, info=dataclasses.replace(ts.info, effective_actions=mask))
        return states, ts


class Capped(PortProgram):
    """The port with its cascade cut after one trip, so that most steps hand
    on a board with a line left."""

    def __init__(self, config, device, seed):
        super().__init__(config, device, seed)
        self.cfg = dataclasses.replace(self.cfg, max_cascades=1)


def _cap_the_reference(monkeypatch):
    """The check's reference with the same cap as ``Capped``."""
    from tmt_bench import check

    create = check.EnvConfig.create

    class CappedConfig:
        @staticmethod
        def create(*args, **kwargs):
            return dataclasses.replace(create(*args, **kwargs), max_cascades=1)

    monkeypatch.setattr(check, "EnvConfig", CappedConfig)
    return check


def test_a_sound_run_is_correct():
    res = tiny_run("c1_rollout_b256", PortProgram, steps=2)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [Unchanged, HalfBatch, Altered, AlteredMask],
                         ids=lambda f: f.__name__)
def test_a_broken_step_is_not_correct(fault):
    res = tiny_run("c1_rollout_b256", fault, steps=2)
    assert not res["correct"]
    assert next(c for c in res["checks"] if c["name"] == "mismatches")["value"] > 0


@pytest.mark.parametrize("workload", ["c1_rollout_b256", "c3_rollout_b256"])
def test_a_capped_cascade_leaves_only_its_mask_uncompared(workload, monkeypatch):
    """A board handed on with a line left (the cascade's cap fired) is still
    held to the reference in every output but its mask, which the game does
    not define there and the program's settled mask does not state exactly:
    compared, those masks are the only outputs that differ."""
    check = _cap_the_reference(monkeypatch)
    res = tiny_run(workload, Capped, steps=2)
    assert res["correct"], res["checked"]
    left = res["checked"]["mask_not_compared_lines_left"]
    assert left > 0
    monkeypatch.setattr(check, "has_any_line",
                        lambda cfg, c: torch.zeros(c.shape[0], dtype=torch.bool, device=c.device))
    bare = tiny_run(workload, Capped, steps=2)
    assert not bare["correct"]
    by_field = bare["checked"]["mismatches_by_field"]
    assert by_field["mask"] == left
    assert sum(by_field.values()) == left


def test_the_control_is_not_correct():
    cell = tiny_cell("c1_rollout_b256")
    out = control_run(cell, 2**31 + 5, 31, CPU, draw="philox", check_boards=BOARDS,
                      check_chunk=CHUNK)
    assert not out["correct"]
    assert out["checks"]["mismatches"] > 0


def test_the_reference_itself_passes_through_the_control_runner():
    cell = tiny_cell("c1_rollout_b256")
    out = control_run(cell, 2**31 + 5, 31, CPU, draw="threefry", check_boards=BOARDS,
                      check_chunk=CHUNK)
    assert out["correct"], out


def test_the_control_fails_on_config_3_too():
    cell = tiny_cell("c3_rollout_b256", batch=4)
    out = control_run(cell, 77, 3, CPU, draw="philox", check_boards=2, check_chunk=CHUNK)
    assert not out["correct"]


def test_reference_program_outputs_match_the_ports_fields():
    ref = ReferenceProgram(tiny_cell("c1_rollout_b256")["config"], CPU, 1)
    assert set(ref.outputs(*ref.reset(torch.tensor([0, 5]), 2))) == {
        "board", "moves_left", "key", "reward", "done", "mask", "truncated"}
