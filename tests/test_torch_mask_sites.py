"""Every settled mask of the port's engine and batched env goes through
K3's wrapper ``ops.mask_sp.settled_mask_sp``, with specials and without.

On the card the wrapper launches the CUDA kernel; here, on CPU tensors, it
runs the plain version, so these outputs are what they were and the
differential tests against the JAX package hold them.  This checks the
four call sites: ``batched_step`` and ``engine.step`` called without the
current mask, ``generate_board``'s first mask (``make_playable`` with no
incoming mask) and the mask after each shuffle of ``make_playable``.  A
call of the plain version from those modules, around the wrapper, fails.
"""

import sys

import pytest
import torch

from tile_match_tpu_torch import engine
from tile_match_tpu_torch import random as trandom
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.envs import batched
from tile_match_tpu_torch.ops import mask_sp
from tile_match_tpu_torch.ops.effective import effective_mask_settled

torch.set_num_threads(1)

CONFIGS = {
    "no-specials": EnvConfig.create(6, 6, 4, 10, colourless_specials=(), colour_specials=()),
    "specials": EnvConfig.create(6, 6, 4, 10),
}


@pytest.fixture
def callers(monkeypatch):
    """The name of the function that called the wrapper, one entry a call."""
    seen = []
    wrapper = mask_sp.settled_mask_sp

    def counting(cfg, colour, kind):
        seen.append(sys._getframe(1).f_code.co_name)
        return wrapper(cfg, colour, kind)

    def around(*args, **kwargs):
        raise AssertionError("the plain settled mask was called around the wrapper")

    for module in (engine, batched):
        monkeypatch.setattr(module, "settled_mask_sp", counting)
        monkeypatch.setattr(module, "effective_mask_settled", around, raising=False)
    return seen


def _states(cfg, B, seed):
    states, _ = engine.reset(cfg, trandom.split(trandom.PRNGKey(seed, "cpu"), B))
    return states


@pytest.mark.parametrize("name", CONFIGS)
def test_generate_board_reaches_the_wrapper(callers, name):
    cfg = CONFIGS[name]
    colour, kind, _, mask, gave_up = engine.generate_board(
        cfg, trandom.split(trandom.PRNGKey(1, "cpu"), 12))
    assert callers and set(callers) == {"make_playable"}
    assert not gave_up.any()
    assert torch.equal(mask, effective_mask_settled(cfg, colour, kind))


@pytest.mark.parametrize("name", CONFIGS)
def test_make_playable_shuffle_reaches_the_wrapper(callers, name):
    """With an incoming mask that has no effective action every board
    shuffles, and the mask after the shuffle is the wrapper's."""
    cfg = CONFIGS[name]
    states = _states(cfg, 12, seed=2)
    false = torch.zeros(12, dtype=torch.bool)
    none = torch.zeros(12, cfg.num_actions, dtype=torch.bool)
    callers.clear()
    colour, kind, _, shuffled, mask, gave_up = engine.make_playable(
        cfg, states.colour, states.kind, states.key, false, mask0=none)
    assert shuffled.all() and not gave_up.any()
    assert callers and set(callers) == {"make_playable"}
    assert torch.equal(mask, effective_mask_settled(cfg, colour, kind))


@pytest.mark.parametrize("name", CONFIGS)
def test_steps_without_a_mask_reach_the_wrapper(callers, name):
    """``batched_step`` and ``engine.step`` called without the current mask
    compute it through the wrapper, and step as when given it."""
    cfg = CONFIGS[name]
    states = _states(cfg, 12, seed=3)
    mask = effective_mask_settled(cfg, states.colour, states.kind)
    actions = mask.to(torch.int32).argmax(-1)
    given = batched.batched_step(cfg, states, actions, eff_mask=mask)
    callers.clear()
    got = batched.batched_step(cfg, states, actions)
    assert callers[0] == "batched_step"
    for a, b in ((got[0].colour, given[0].colour), (got[0].kind, given[0].kind),
                 (got[1].reward, given[1].reward),
                 (got[1].info.effective_actions, given[1].info.effective_actions)):
        assert torch.equal(a, b)
    callers.clear()
    out = engine.step(cfg, states, actions)
    assert callers[0] == "step"
    want = engine.step(cfg, states, actions, eff_mask=mask)
    assert torch.equal(out[0].colour, want[0].colour) and torch.equal(out[1], want[1])
