"""K2's no-bomb case table: its plain version against the JAX package.

Three no-bomb special sets: cookie with both lasers, both lasers, cookie
only.  K2's plain version equals ``cascade_sp_chunk`` (Pallas, interpret
mode) in all nine outputs on boards whose lines share no cell; the whole
cascade (``fused_specials_cascade``, K2 plus the machinery) equals the JAX
machinery (``cascade_twin``, the vmapped cascade loop of ``engine_move``)
on all 16 painted shapes of tests/ops/test_rich_trips.py and on random
boards; and on the painted boards where the reference kernel keeps a
cookie line's tail cell that a crossing line deletes, the port follows the
machinery.  The CUDA kernel is held against the plain version in
``test_torch_kernels_host.py`` and ``test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chip_smoke import corner_boards
from tests.ops.test_rich_trips import CASES as PAINTED, cascade_twin, hline, shape_batch, vline
from tests.test_torch_specials import sprinkled
from tile_match_tpu.config import EnvConfig as JaxConfig
from tile_match_tpu.envs.fused import fused_specials_cascade as jax_fused
from tile_match_tpu.ops import pallas_cascade as jpc
from tile_match_tpu_torch import engine as te
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.ops import cascade_sp as tsp

torch.set_num_threads(1)

SETS = {
    "cookie-lasers": (("cookie",), ("vertical_laser", "horizontal_laser")),
    "lasers": ((), ("vertical_laser", "horizontal_laser")),
    "cookie": (("cookie",), ()),
}
K2_NAMES = ["colour", "kind", "trips", "elim", "new", "act", "frozen", "active", "reasons"]
CASCADE_NAMES = ["colour", "kind", "elim", "act", "new", "trips", "trunc"]


@pytest.fixture(autouse=True)
def _clear_xla_caches():
    jax.clear_caches()
    yield


def _cfgs(R, K, name, moves=6):
    kw = dict(colourless_specials=SETS[name][0], colour_specials=SETS[name][1])
    return JaxConfig.create(R, R, K, moves, **kw), EnvConfig.create(R, R, K, moves, **kw)


def _kinds(tc):
    return [k for k, on in ((2, tc.vertical_laser), (3, tc.horizontal_laser), (-1, tc.cookie)) if on]


def _unshared(jc, seed):
    """Boards whose lines share no cell: one painted line each, of length
    3 to 8, horizontal or vertical, on a line-free base."""
    def one_line(i, rng, pc):
        n = 3 + i % 6
        if i % 2:
            return [(hline(int(rng.integers(0, 8)), int(rng.integers(0, 9 - n)), n), pc)]
        return [(vline(int(rng.integers(0, 9 - n)), int(rng.integers(0, 8)), n), pc)]

    plain = shape_batch(jc, one_line, 24, seed=seed)
    dotted = shape_batch(jc, one_line, 24, seed=seed + 1, specials=2)
    return tuple(np.concatenate(a) for a in zip(plain, dotted))


@pytest.mark.parametrize("name", sorted(SETS))
def test_k2_plain_matches_jax_chunk_on_unshared_lines(name):
    jc, tc = _cfgs(8, 4, name)
    colour, kind = _unshared(jc, seed=len(name))
    kind = np.where(np.isin(kind, _kinds(tc) + [1]), kind, 1)  # no kind the set lacks
    colour = np.where(kind == -1, 0, np.where(colour == 0, 1, colour)).astype(np.int32)
    B = colour.shape[0]
    rng = np.random.default_rng(B)
    keys = rng.integers(0, 1 << 32, size=(B, 2), dtype=np.uint64).astype(np.uint32)
    z = np.zeros(B, np.int32)
    want = jpc.cascade_sp_chunk(jc, *(jnp.asarray(a) for a in (colour, kind, keys, z, z, z)),
                                interpret=True)
    got = tsp.cascade_sp_chunk(tc, torch.from_numpy(colour), torch.from_numpy(kind),
                               torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(z),
                               torch.from_numpy(z), torch.from_numpy(z), limit=8)
    for n, g, w in zip(K2_NAMES, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w), n
    # most boards took their first trips in closed form, making lasers or
    # cookies, and some froze
    assert int((got[2] >= 1).sum()) > B // 2 and int(got[4].sum()) > 0 and int(got[6].sum()) > 0


def _crossings(B, seed, kinds):
    """1-3 lines of one colour, lengths 3 to 8, at random places on a
    line-free two-colour base, crossing or touching where they fall, and
    0-2 specials of ``kinds``."""
    rng = np.random.default_rng(seed)
    rows, cols = np.indices((8, 8))
    colour = np.where((rows + cols) % 2 == 0, 1, 2)[None].repeat(B, 0).astype(np.int32)
    kind = np.ones_like(colour)
    for b in range(B):
        pc = int(rng.integers(3, 5))
        for _ in range(int(rng.integers(1, 4))):
            n = int(rng.integers(3, 9))
            r, c = (int(v) for v in rng.integers(0, [8, 9 - n]))
            if rng.random() < 0.5:
                colour[b, r, c : c + n] = pc
            else:
                colour[b, c : c + n, r] = pc
        for _ in range(int(rng.integers(0, 3))):
            r, c = (int(v) for v in rng.integers(0, 8, size=2))
            kind[b, r, c] = int(rng.choice(kinds))
            colour[b, r, c] = 0 if kind[b, r, c] == -1 else colour[b, r, c]
    return colour, kind


def _painted_and_random(jc, tc, seed):
    """Every painted shape (with and without specials on the board), random
    crossings of long lines, and random boards with sprinkled specials of
    the set's kinds."""
    cols, kinds = [], []
    for i, case in enumerate(sorted(PAINTED)):
        for dots in (None, 3):
            c, k = shape_batch(jc, PAINTED[case], 4, seed=seed + 7 * i + (dots or 0), specials=dots)
            cols.append(c)
            kinds.append(k)
    c, k = sprinkled(8, 8, 4, 48, seed=seed, kinds=_kinds(tc))
    x, xk = _crossings(192, seed, _kinds(tc))
    colour, kind = np.concatenate(cols + [c, x]), np.concatenate(kinds + [k, xk])
    # the painted boards' specials may be bombs: keep only the set's kinds
    bad = ~np.isin(kind, _kinds(tc) + [1])
    colour = np.where(bad & (colour == 0), 1, colour).astype(np.int32)
    return colour, np.where(bad, 1, kind).astype(np.int32)


@pytest.mark.parametrize("name,seed", [("cookie-lasers", 100), ("lasers", 200), ("cookie", 300)])
def test_fused_cascade_matches_machinery(name, seed):
    jc, tc = _cfgs(8, 4, name)
    colour, kind = _painted_and_random(jc, tc, seed)
    B = colour.shape[0]
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(seed * 1000, seed * 1000 + B))
    want = cascade_twin(jc, jnp.asarray(colour), jnp.asarray(kind), keys)
    te.reset_cascade_stats()
    got = te.fused_specials_cascade(tc, torch.from_numpy(colour), torch.from_numpy(kind),
                                    torch.from_numpy(np.asarray(keys).astype(np.int64)))
    for n, g, w in zip(CASCADE_NAMES, got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), n
    stats = te.cascade_stats
    assert 0 < stats["full_trips"] < int(got[5].sum()) // 2
    # length >= 4 extensions froze boards (bit 1 of some board's reasons)
    assert bool(((te.last_cascade["reasons"] >> 1) & 1).any())


def test_crossing_tails_survive():
    """The corner shared by the tails of two crossing 6- or 7-lines is in
    no match and survives, as in the machinery."""
    jc, tc = _cfgs(8, 4, "cookie-lasers")
    colour, kind = corner_boards(16, seed=3)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(16))
    want = cascade_twin(jc, jnp.asarray(colour), jnp.asarray(kind), keys)
    tkeys = torch.from_numpy(np.asarray(keys).astype(np.int64))
    got = te.fused_specials_cascade(tc, torch.from_numpy(colour), torch.from_numpy(kind), tkeys)
    for n, g, w in zip(CASCADE_NAMES, got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), n
    z = torch.zeros(16, dtype=torch.int32)
    first = tsp.cascade_sp_reference(tc, torch.from_numpy(colour), torch.from_numpy(kind), tkeys,
                                     z, z, z, limit=1)
    assert (first[2] == 1).all() and (first[4] == 2).all()  # both cookies made in closed form


@pytest.mark.parametrize("seed", [18, 24])
def test_reference_kernel_fault_is_not_copied(seed):
    """On these painted cookie_h boards the reference's no-bomb K2 keeps a
    6- or 7-line's tail cell that a crossing line deletes: the JAX fused
    cascade (Pallas K2 in interpret mode, then the machinery) differs from
    the machinery alone.  The port equals the machinery."""
    jc, tc = _cfgs(8, 4, "cookie-lasers")
    colour, kind = shape_batch(jc, PAINTED["cookie_h"], 10, seed=seed)
    B = colour.shape[0]
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(9 * 10000, 9 * 10000 + B))
    args = (jnp.asarray(colour), jnp.asarray(kind), keys)
    want = [np.asarray(w) for w in cascade_twin(jc, *args)]
    reference = [np.asarray(r) for r in jax_fused(jc, *args, interpret=True)]
    assert not all(np.array_equal(r, w) for r, w in zip(reference, want))
    got = te.fused_specials_cascade(tc, torch.from_numpy(colour), torch.from_numpy(kind),
                                    torch.from_numpy(np.asarray(keys).astype(np.int64)))
    for n, g, w in zip(CASCADE_NAMES, got, want):
        assert np.array_equal(g.numpy(), w), n
