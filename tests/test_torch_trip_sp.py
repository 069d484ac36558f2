"""One full-machinery trip of the specials cascade (K4): the port's plain
trip against the JAX package's, and K4's board program built for the host
against the plain trip.

``engine.specials_cascade_trip`` (lines, classification, resolution with
the activation machine, gravity, refill) equals the JAX package's
``specials_cascade_trip`` (jitted, board by board) in every output, with every
special set ``EnvConfig.create`` accepts, on the boards K2 freezes (random
boards with sprinkled specials, and painted boards for each freeze reason)
and on boards K2 never saw.  ``csrc/trip_sp.cu`` compiled as plain C++
(``-DTMT_HOST_BUILD``, as ``test_torch_kernels_host.py`` builds K1-K3) and run by the wrapper itself
through the host seam equals the plain trip on the same boards, with caps tight enough that each
fires, at 36x36 (the library of any shape) and in fixed-shape libraries;
its cap flags raise the plain trip's ``debug_checks`` messages.
``test_torch_kernels_cuda.py`` holds the kernel itself on the card.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_trip_sp.py -q
"""

import ctypes
import dataclasses
import functools
import itertools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chip_smoke import CAPS, cap_board
from tests.ops.test_rich_trips import CASES as PAINTED
from tests.ops.test_rich_trips import hline, shape_batch, vline
from tests.test_torch_kernels_host import H100_SMEM_OPTIN
from tests.test_torch_specials import sprinkled
from tests.torch_port_helpers import host_build, host_kernels  # noqa: F401  (a fixture)
from tile_match_tpu import engine as jengine
from tile_match_tpu.config import EnvConfig as JaxConfig
from tile_match_tpu_torch import cuda_build
from tile_match_tpu_torch import engine
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.ops import trip_sp
from tile_match_tpu_torch.ops.cascade_sp import (
    REASON_COOKIE_HIT, REASON_CROSS, REASON_EXT4, REASON_EXT_BOMB, REASON_LEN5, REASON_MULTI,
    cascade_sp_reference,
)

torch.set_num_threads(1)

NAMES = ["colour", "kind", "elim", "act", "new", "ovf"]
B = 130
# every special set EnvConfig.create accepts: (colourless, colour specials)
SETS = [(cl, co) for cl in ((), ("cookie",))
        for r in range(4) for co in itertools.combinations(
            ("vertical_laser", "horizontal_laser", "bomb"), r)]
SET_IDS = ["+".join(s[0] + s[1]) or "none" for s in SETS]
# board shapes the sets cycle through, 6x6 to 10x10
SIZES = [(10, 10, 4), (6, 6, 2), (7, 9, 3), (8, 8, 3), (9, 10, 4)]
ALL = SETS[-1]
# two more painted shapes beside tests/ops/test_rich_trips.py's: a v-line of
# 4 crossed one below its top by an h-extension of 4 (K2's primary plus
# extension table has no case for it), and an h-line holding a vertical
# laser whose column holds a cookie (the activation hits a cookie)
EXTRA = {
    "v4_star": lambda i, rng, pc: [(vline(3, 4, 4), pc), (hline(4, 2 + (i % 2), 4), pc)],
    "cookie_hit": lambda i, rng, pc: [(hline(5, 2 + (i % 3), 3), pc)],
}
EVERY_REASON = (REASON_LEN5, REASON_EXT4, REASON_EXT_BOMB, REASON_COOKIE_HIT, REASON_CROSS,
                REASON_MULTI)


def _cfgs(R, C, K, specials, **kw):
    kw = dict(colourless_specials=specials[0], colour_specials=specials[1], **kw)
    return JaxConfig.create(R, C, K, 30, **kw), EnvConfig.create(R, C, K, 30, **kw)


def _kinds(cfg):
    return [k for k, on in ((2, cfg.vertical_laser), (3, cfg.horizontal_laser), (4, cfg.bomb),
                            (-1, cfg.cookie)) if on]


def _painted(cfg, seed):
    """Painted boards of every shape, two of each, some with random
    specials on them."""
    cols, kinds = [], []
    shapes = {**PAINTED, **EXTRA}
    for i, name in enumerate(sorted(shapes)):
        c, k = shape_batch(cfg, shapes[name], 2, seed=seed + i, specials=i % 3)
        if name == "cookie_hit":
            r, c0 = 5, 3
            k[:, r, c0] = 2 if cfg.vertical_laser else 1
            k[:, 1, c0] = -1 if cfg.cookie else k[:, 1, c0]
            c[:, 1, c0] = 0 if cfg.cookie else c[:, 1, c0]
        cols.append(c)
        kinds.append(k)
    return np.concatenate(cols), np.concatenate(kinds)


def _frozen(cfg, colour, kind, keys):
    """K2's plain version on the boards: (colour, kind, trips, reasons) of
    the boards it froze, as it left them."""
    n = colour.shape[0]
    z = torch.zeros(n, dtype=torch.int32)
    out = cascade_sp_reference(cfg, torch.from_numpy(colour), torch.from_numpy(kind),
                               torch.from_numpy(keys.astype(np.int64)), z, z, z,
                               limit=cfg.max_cascades)
    f = (out[6] > 0).numpy()
    return out[0].numpy()[f], out[1].numpy()[f], out[2].numpy()[f], out[8].numpy()[f]


@functools.lru_cache(maxsize=None)
def trip_inputs(jc, tc, seed, n=B):
    """n boards for one trip: painted boards K2 froze (10x10 and up), random
    boards with sprinkled specials K2 froze, then raw random boards.
    Returns (colour, kind, keys uint32[n, 2], trips, the frozen boards'
    reason bits); cached, read-only."""
    R, C, K = tc.num_rows, tc.num_cols, tc.num_colours
    rng = np.random.default_rng(seed)
    kinds = _kinds(tc)
    if kinds:
        colour, kind = sprinkled(R, C, K, 3 * n, seed, n_max=10, kinds=kinds)
    else:
        colour = rng.integers(1, K + 1, size=(3 * n, R, C)).astype(np.int32)
        kind = np.ones_like(colour)
    keys = rng.integers(0, 1 << 32, size=(3 * n, 2), dtype=np.uint64).astype(np.uint32)
    trips = rng.integers(0, 6, size=3 * n).astype(np.int32)
    parts = []
    if tc.any_special:
        if R >= 10 and C >= 10:
            pc, pk = _painted(jc, seed)
            parts.append(_frozen(tc, pc, pk, keys[: len(pc)]))
        parts.append(_frozen(tc, colour, kind, keys))
    parts.append((colour, kind, trips, np.zeros(3 * n, np.int32)))
    cat = [np.concatenate(x)[:n] for x in zip(*parts)]
    return cat[0], cat[1], keys[:n], cat[2], cat[3]


@functools.lru_cache(maxsize=None)
def _jax_trip(jc):
    """JAX's trip of one board, jitted (board by board: a vmapped trip
    takes twice as long to compile on the CPU)."""
    return jax.jit(lambda c, k, s, t: jengine.specials_cascade_trip(jc, c, k, s, t))


def _jax_trips(jc, colour, kind, keys, trips):
    fn = _jax_trip(jc)
    outs = [fn(*(jnp.asarray(a[b]) for a in (colour, kind, keys, trips))) for b in range(len(colour))]
    return [np.stack([np.asarray(o[f]) for o in outs]) for f in range(len(NAMES))]


def _set_cfgs(i, **kw):
    R, C, K = SIZES[i % len(SIZES)]
    return _cfgs(R, C, K, SETS[i], **kw)


def _plain(tc, colour, kind, keys, trips):
    return engine.specials_cascade_trip(
        tc, torch.from_numpy(colour), torch.from_numpy(kind),
        torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(trips))


@pytest.mark.parametrize("i", range(len(SETS)), ids=SET_IDS)
def test_trip_matches_jax(i):
    jc, tc = _set_cfgs(i)
    colour, kind, keys, trips, reasons = trip_inputs(jc, tc, seed=100 + i)
    want = _jax_trips(jc, colour, kind, keys, trips)
    got = _plain(tc, colour, kind, keys, trips)
    for name, g, w in zip(NAMES, got, want):
        g = g.numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), f"{SET_IDS[i]}: {name}"
    if tc.any_special:
        assert int((reasons > 0).sum()) > 0  # K2 froze some of the boards
    if SETS[i] == ALL:  # the painted boards freeze for every reason
        for bit in EVERY_REASON:
            assert ((reasons & bit) > 0).any(), bit
        assert int(got[3].sum()) > 0 and int(got[4].sum()) > 0


# ---- K4's board program, built for the host ---------------------------------


@pytest.fixture
def host_k4(host_kernels):
    """K4's wrapper on the host build of any board shape."""
    host_kernels("specials_trip", shape=None)


def run_k4(cfg, colour, kind, keys, trips):
    """K4's wrapper on numpy inputs, on the host build the seam points it
    at: (the six outputs, cap bits, lines detected), torch tensors; the
    caps and lines are those the wrapper reads back with ``debug_checks``
    on, recorded in place of its raising."""
    t = (torch.from_numpy(colour), torch.from_numpy(kind), torch.from_numpy(keys.astype(np.int64)),
         torch.from_numpy(trips))
    read = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trip_sp, "raise_caps", lambda cfg, caps, lines: read.append((caps, lines)))
        got = trip_sp.specials_trip(dataclasses.replace(cfg, debug_checks=True), *t)
    ((caps, lines),) = read
    return got, caps, lines


def _assert_equal(got, want, tag):
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), f"{tag}: {name}"


@pytest.mark.parametrize("i", range(len(SETS)), ids=SET_IDS)
def test_board_program_matches_plain(host_k4, i):
    jc, tc = _set_cfgs(i)
    inputs = trip_inputs(jc, tc, seed=100 + i)[:4]
    got, caps, _ = run_k4(tc, *inputs)
    _assert_equal(got, _plain(tc, *inputs), SET_IDS[i])
    assert int(caps.sum()) == 0


@pytest.mark.parametrize("R,C,K,specials", [(10, 10, 4, ALL),
                                            (9, 7, 2, (("cookie",), ("vertical_laser",)))])
def test_fixed_shape_library_matches_plain(host_kernels, R, C, K, specials):
    """The libraries of one board shape (geometry fixed at compile time), as
    the card builds them for boards up to 32 by 32."""
    host_kernels("specials_trip", shape=(R, C))
    jc, tc = _cfgs(R, C, K, specials)
    inputs = trip_inputs(jc, tc, seed=R * C)[:4]
    got, _, _ = run_k4(tc, *inputs)
    _assert_equal(got, _plain(tc, *inputs), f"{R}x{C}")
    narrow = _cfgs(R, C - 1, K, specials)[1]
    with pytest.raises(RuntimeError, match="error -1"):  # another shape is refused
        run_k4(narrow, *(np.ascontiguousarray(a[:, :, :-1]) if a.ndim == 3 else a for a in inputs))


def test_board_program_36x36(host_k4):
    """Above 32x32: the library whose geometry is read at run time."""
    jc, tc = _cfgs(36, 36, 6, ALL)
    inputs = trip_inputs(jc, tc, seed=36, n=24)[:4]
    got, _, _ = run_k4(tc, *inputs)
    _assert_equal(got, _plain(tc, *inputs), "36x36")
    assert int(got[3].sum()) > 0


CAP_BITS = {"lines": trip_sp.CAP_LINES, "queue": trip_sp.CAP_QUEUE, "emit": trip_sp.CAP_EMIT,
            "stack": trip_sp.CAP_STACK}


def _plain_error(tc, inputs):
    try:
        _plain(dataclasses.replace(tc, debug_checks=True), *inputs)
    except RuntimeError as e:
        return str(e)
    return ""


def _k4_error(tc, caps, lines):
    try:
        trip_sp.raise_caps(dataclasses.replace(tc, debug_checks=True), caps, lines)
    except RuntimeError as e:
        return str(e)
    return ""


@pytest.mark.parametrize("cap", CAPS)
def test_painted_cap_fires_as_in_plain(host_k4, cap):
    """Each cap on a painted board: the same outputs and ``ovf`` in K4, the
    plain trip and JAX's, the cap's flag, and the plain trip's
    ``debug_checks`` message."""
    R, C, K, kw, colour, kind = cap_board(cap)
    jc, tc = _cfgs(R, C, K, ALL, **kw)
    inputs = (colour[None], kind[None], np.array([[3, 4]], np.uint32), np.zeros(1, np.int32))
    got, caps, lines = run_k4(tc, *inputs)
    want = _plain(tc, *inputs)
    _assert_equal(got, want, cap)
    for name, g, w in zip(NAMES, want, _jax_trips(jc, *inputs)):
        assert np.array_equal(g.numpy(), w), f"{cap}: {name} differs from JAX's"
    assert bool(got[5][0]) and int(caps[0]) == CAP_BITS[cap]
    message = _plain_error(tc, inputs)
    assert message and _k4_error(tc, caps, lines) == message


@pytest.mark.parametrize("kw", [dict(max_lines=1), dict(max_lines=2), dict(max_stack=1),
                                dict(max_stack=2), dict(max_lines=1, max_stack=1),
                                dict(max_activation_steps=1)],
                         ids=["lines1", "lines2", "stack1", "stack2", "lines1-stack1", "steps1"])
def test_tight_caps_match_plain(host_k4, kw):
    """Random frozen boards under tight caps: ``ovf`` and the boards equal
    where caps fire; the first cap's message is the plain trip's.  A trip
    has no step budget, so ``max_activation_steps`` changes nothing."""
    jc, tc = _cfgs(8, 8, 2, ALL, **kw)
    inputs = trip_inputs(jc, tc, seed=7)[:4]
    got, caps, lines = run_k4(tc, *inputs)
    _assert_equal(got, _plain(tc, *inputs), str(kw))
    assert _k4_error(tc, caps, lines) == _plain_error(tc, inputs)
    fired = int((caps != 0).sum())
    assert (fired > 0) == ("max_activation_steps" not in kw)
    assert int(got[5].sum()) == fired


def test_size_limits(tmp_path_factory, host_k4):
    """K4 takes boards of up to 65,535 cells; its scratch lies in shared
    memory up to the block's limit and in device memory beyond."""
    smem = cuda_build.c_function(host_build(tmp_path_factory, "trip_sp"), "tmt_specials_trip_smem",
                                 [ctypes.c_int] * 5, ctypes.c_longlong)

    def default(R, C, K=6):
        return smem(R, C, K, R + C, R * C + 8)

    assert default(10, 10, 4) < 48 * 1024 < default(36, 36) < H100_SMEM_OPTIN < default(86, 86)
    cuda_build.check_fits("specials_trip", 255, 257)
    with pytest.raises(ValueError, match="65535 cells"):
        cuda_build.check_fits("specials_trip", 256, 256)
    tc = EnvConfig.create(256, 256, 4, 30)
    board = torch.ones((1, 256, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="65535 cells"):  # the wrapper's check
        trip_sp.specials_trip(tc, board, board, torch.zeros((1, 2), dtype=torch.int64),
                              torch.zeros(1, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="error -1"):  # the library refuses it too
        cuda_build.launch("tmt_specials_trip", board.device, None, *[None] * 13, 1, 256, 256, 4,
                          tc.lines_max, tc.stack_max, 1, 1, 1, 1)


def test_wrapper_runs_the_plain_trip_on_the_cpu():
    jc, tc = _set_cfgs(len(SETS) - 1)
    colour, kind, keys, trips, _ = trip_inputs(jc, tc, seed=3, n=40)
    t = (torch.from_numpy(colour), torch.from_numpy(kind), torch.from_numpy(keys.astype(np.int64)),
         torch.from_numpy(trips))
    before = cuda_build.launches["specials_trip"]
    _assert_equal(trip_sp.specials_trip(tc, *t), engine.specials_cascade_trip(tc, *t), "cpu")
    assert cuda_build.launches["specials_trip"] == before
    with pytest.raises(ValueError, match="unsupported device"):
        trip_sp.specials_trip(tc, *(x.to("meta") for x in t))
