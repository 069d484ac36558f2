"""``debug_checks`` and ``debug.py`` of the port against the JAX package's.

The cases of ``tests/test_overflow_checks.py`` and ``test_aux_subsystems.
py``'s ``validate_state`` / ``checked_step``: each forces a capacity cap to
overflow (or stays within it), runs the JAX function under ``checkify``
and the port's on the same board, and requires the port to raise a
``RuntimeError`` with the JAX message exactly where checkify reports one,
and to stay silent where checkify does.  With ``debug_checks`` on, a
rollout with every special equals the rollout without it.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental import checkify

from tile_match_tpu import debug as jdebug
from tile_match_tpu import engine as jengine
from tile_match_tpu.config import EnvConfig as JaxConfig
from tile_match_tpu.ops import activate as jact
from tile_match_tpu.ops.classify import process_colour_lines as j_classify
from tile_match_tpu.ops.lines import LineSet as JLineSet
from tile_match_tpu.ops.lines import get_colour_lines as j_lines
from tile_match_tpu_torch import debug as tdebug
from tile_match_tpu_torch import engine as tengine
from tile_match_tpu_torch import random as trandom
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.envs.batched import rollout
from tile_match_tpu_torch.ops import activate as tact
from tile_match_tpu_torch.ops.classify import process_colour_lines
from tile_match_tpu_torch.ops.lines import LineSet, get_colour_lines
from tile_match_tpu_torch.state import EnvState

torch.set_num_threads(1)


def _jax_error(fn, *args) -> str:
    """checkify's message for ``fn(*args)``, '' when no check failed."""
    err, _ = checkify.checkify(fn)(*args)
    try:
        err.throw()
    except Exception as e:  # checkify.JaxRuntimeError
        return str(e)
    return ""


def _port_error(fn, *args) -> str:
    try:
        fn(*args)
    except RuntimeError as e:
        return str(e)
    return ""


def _same_outcome(jmsg: str, tmsg: str, expect) -> None:
    """Both clean, or both failed with ``expect`` (the port's message being
    the first line of checkify's, which appends where it fired)."""
    if expect is None:
        assert jmsg == "" and tmsg == "", (jmsg, tmsg)
    else:
        assert expect in jmsg, jmsg
        assert expect in tmsg and tmsg in jmsg, (tmsg, jmsg)


def _no_line_filler(R, C):
    """A match-free colour grid (period-2 checker of 3 colours)."""
    r = np.arange(R)[:, None]
    c = np.arange(C)[None, :]
    return (((r % 2) * 2 + (c % 2)) % 3 + 1).astype(np.int32)


@pytest.mark.parametrize("max_lines,columns,expect", [
    (1, (0, 2), "lines_max overflow: 2 detected lines exceed capacity 1"),
    (0, (0,), None),
], ids=["overflow", "within_cap"])
def test_lines_max_check(max_lines, columns, expect):
    colour = _no_line_filler(5, 5)
    for c in columns:
        colour[2:5, c] = 4
    kind = np.ones((5, 5), np.int32)
    jc = JaxConfig(5, 5, 4, max_lines=max_lines, debug_checks=True)
    tc = EnvConfig(5, 5, 4, max_lines=max_lines, debug_checks=True)
    jmsg = _jax_error(lambda c, k: j_lines(jc, c, k), jnp.asarray(colour), jnp.asarray(kind))
    tmsg = _port_error(get_colour_lines, tc, torch.from_numpy(colour)[None])
    _same_outcome(jmsg, tmsg, expect)
    if expect is None:
        assert int(get_colour_lines(tc, torch.from_numpy(colour)[None]).count[0]) == 1


def _chain_board():
    """All-normal colour-1 board with a v-laser at (2,2) and a bomb at (0,2)."""
    colour = np.ones((5, 5), np.int32)
    kind = np.ones((5, 5), np.int32)
    kind[2, 2] = 2
    kind[0, 2] = 4
    return colour, kind


def _jax_chain(cfg):
    colour, kind = _chain_board()
    st = jact.machine_init(cfg, jnp.asarray(colour), jnp.asarray(kind))
    st = jact.push_frame(st, jact.OP_V_LASER, 2, 2, counted=1)
    return jact.run_machine(cfg, st)


def _port_chain(cfg):
    colour, kind = _chain_board()
    st = tact.machine_init(cfg, torch.from_numpy(colour)[None], torch.from_numpy(kind)[None])
    two = torch.tensor([2], dtype=torch.int32)
    st = tact.push_frame(st, tact.OP_V_LASER, two, two, 1, pred=True)
    return tact.run_machine(cfg, st)


@pytest.mark.parametrize("caps,expect", [
    (dict(max_stack=1), "stack_max overflow: activation frame dropped at depth 1"),
    (dict(max_activation_steps=1), "activation_steps_max exceeded: chain truncated with"),
    ({}, None),
], ids=["stack_max", "activation_steps", "within_caps"])
def test_activation_caps_check(caps, expect):
    jc = JaxConfig(5, 5, 4, debug_checks=True, **caps)
    tc = EnvConfig(5, 5, 4, debug_checks=True, **caps)
    jmsg = _jax_error(lambda: _jax_chain(jc))
    tmsg = _port_error(_port_chain, tc)
    _same_outcome(jmsg, tmsg, expect)
    if expect is None:
        assert int(_port_chain(tc).sp[0]) == 0  # stack drained


def _crossing_cookie_lines():
    """Two crossing 13-long colour-1 lines (column 0 and row 6) on a
    colour-2 13x13 board, as a line set of two slots."""
    colour = np.full((13, 13), 2, np.int32)
    colour[:, 0] = 1
    colour[6, :] = 1
    coords = np.full((2, 13, 2), -1, np.int32)
    coords[0, :, 0] = np.arange(13)
    coords[0, :, 1] = 0
    coords[1, :, 0] = 6
    coords[1, :, 1] = np.arange(13)
    return colour, coords


@pytest.mark.parametrize("max_lines,expect", [
    (2, "classify queue overflow: cookie remainder dropped"),
    (0, None),
], ids=["overflow", "within_cap"])
def test_classify_append_check(max_lines, expect):
    """Both crossing lines pop as cookies and re-append their 8-long
    remainders; at max_lines 2 (four queue slots) the first remainder's
    own remainder finds the queue full."""
    colour, coords = _crossing_cookie_lines()
    jc = JaxConfig(13, 13, 2, max_lines=max_lines, debug_checks=True)
    tc = EnvConfig(13, 13, 2, max_lines=max_lines, debug_checks=True)
    LM = tc.lines_max
    jcoords = np.full((LM, 13, 2), -1, np.int32)
    jcoords[:2] = coords
    length = np.zeros(LM, np.int32)
    length[:2] = 13
    jls = JLineSet(coords=jnp.asarray(jcoords), length=jnp.asarray(length), count=jnp.int32(2))
    tls = LineSet(
        coords=torch.from_numpy(jcoords)[None], length=torch.from_numpy(length)[None],
        count=torch.tensor([2], dtype=torch.int32), ovf=torch.zeros(1, dtype=torch.bool),
    )
    jmsg = _jax_error(lambda c: j_classify(jc, c, jls), jnp.asarray(colour))
    tmsg = _port_error(process_colour_lines, tc, torch.from_numpy(colour)[None], tls)
    _same_outcome(jmsg, tmsg, expect)


def _pair(max_cascades=64, specials=False):
    common = dict(num_moves=10, max_cascades=max_cascades)
    if not specials:
        common.update(cookie=False, vertical_laser=False, horizontal_laser=False, bomb=False)
    return JaxConfig(5, 5, 3, **common), EnvConfig(5, 5, 3, **common)


def _reset_both(jc, tc, seed):
    """One board reset from PRNGKey(seed) in both packages."""
    key = jax.random.PRNGKey(seed)
    jstate, jinfo = jengine.reset(jc, key)
    tkey = torch.from_numpy(np.asarray(key).astype(np.int64))[None]
    tstate, tinfo = tengine.reset(tc, tkey)
    assert np.array_equal(tstate.colour[0].numpy(), np.asarray(jstate.colour))
    return jstate, jinfo, tstate, tinfo


def test_truncated_flag_set_on_cascade_cap():
    """Without debug_checks, max_cascades=0 leaves the post-swap match
    unresolved and both packages set ``truncated``."""
    jc, tc = _pair(max_cascades=0)
    jstate, jinfo, tstate, tinfo = _reset_both(jc, tc, 0)
    assert not bool(jinfo.truncated) and not bool(tinfo.truncated[0])
    action = int(np.flatnonzero(np.asarray(jinfo.effective_actions))[0])
    _, _, _, jinfo2 = jax.jit(lambda s, a: jengine.step(jc, s, a))(jstate, jnp.int32(action))
    _, _, _, tinfo2 = tengine.step(tc, tstate, torch.tensor([action]))
    assert bool(jinfo2.truncated) and bool(tinfo2.truncated[0])


def test_truncated_flag_clean_on_normal_step():
    jc, tc = _pair(specials=True)
    jstate, jinfo, tstate, tinfo = _reset_both(jc, tc, 1)
    assert not bool(tinfo.truncated[0])
    jstep = jax.jit(lambda s, a: jengine.step(jc, s, a))
    for _ in range(5):
        mask = np.asarray(jinfo.effective_actions)
        action = int(np.flatnonzero(mask)[0]) if mask.any() else 0
        jstate, _, _, jinfo = jstep(jstate, jnp.int32(action))
        tstate, _, _, tinfo = tengine.step(tc, tstate, torch.tensor([action]))
        assert not bool(jinfo.truncated) and not bool(tinfo.truncated[0])
        assert np.array_equal(tstate.colour[0].numpy(), np.asarray(jstate.colour))


@pytest.mark.parametrize("max_cascades,seed,expect", [
    (0, 0, "matches remain after step"),
    (64, 2, None),
], ids=["cascade_cap", "clean"])
def test_checked_step(max_cascades, seed, expect):
    """``checked_step``'s post-step invariants: a cascade cut at
    max_cascades=0 leaves matches (both packages report it); a normal step
    passes, with the JAX package's reward."""
    jc, tc = _pair(max_cascades=max_cascades, specials=max_cascades > 0)
    jstate, jinfo, tstate, _ = _reset_both(jc, tc, seed)
    action = int(np.flatnonzero(np.asarray(jinfo.effective_actions))[0])
    err, (_, jreward, _, _) = jdebug.checked_step(jc)(jstate, jnp.int32(action))
    try:
        err.throw()
        jmsg = ""
    except Exception as e:  # checkify.JaxRuntimeError
        jmsg = str(e)
    fn = tdebug.checked_step(tc)
    tmsg = _port_error(fn, tstate, torch.tensor([action]))
    _same_outcome(jmsg, tmsg, expect)
    if expect is None:
        _, treward, _, _ = fn(tstate, torch.tensor([action]))
        assert int(treward[0]) == int(jreward) >= 3


def test_validate_state():
    jc, tc = _pair(specials=True)
    jstate, _, tstate, _ = _reset_both(jc, tc, 1)
    jdebug.validate_state(jc, jstate.colour, jstate.kind)
    tdebug.validate_state(tc, tstate.colour[0], tstate.kind[0])
    bad = tstate.colour[0].numpy().copy()
    bad[0, 0] = 0  # break coupling
    for validate, cfg in ((jdebug.validate_state, jc), (tdebug.validate_state, tc)):
        with pytest.raises(AssertionError, match="colour/kind coupling"):
            validate(cfg, bad, tstate.kind[0].numpy())
    lined = tstate.colour[0].numpy().copy()
    lined[0, :3] = lined[0, 0]
    for validate, cfg in ((jdebug.validate_state, jc), (tdebug.validate_state, tc)):
        with pytest.raises(AssertionError, match="board has matches"):
            validate(cfg, lined, tstate.kind[0].numpy())


def test_debug_checks_leave_the_rollout_unchanged():
    """With every special, ``debug_checks`` on raises nothing and changes
    no board of a rollout."""
    cfg = EnvConfig(6, 6, 4, 5)
    key = trandom.PRNGKey(3, "cpu")
    plain = rollout(cfg, key, 16, 8)
    checked = rollout(dataclasses.replace(cfg, debug_checks=True), key, 16, 8)
    for a, b in zip(dataclasses.astuple(plain[0]), dataclasses.astuple(checked[0])):
        assert torch.equal(a, b)
    assert torch.equal(plain[1], checked[1]) and torch.equal(plain[2], checked[2])
    assert isinstance(checked[0], EnvState)
