"""The port's specials cascade equals the JAX package's, exactly: K2's plain
version against ``cascade_sp_chunk`` (Pallas, interpret mode on the CPU)
with a limit of 8 trips, K3's plain version against ``settled_mask_sp``,
and the whole batch-level cascade (``fused_specials_cascade``, K2 plus the
machinery) against the vmapped JAX cascade loop.  The CUDA kernels are held
against the plain versions in ``test_torch_kernels_cuda.py`` and, built for
the host, in ``test_torch_kernels_host.py``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.ops.test_rich_trips import CASES as PAINTED, cascade_twin, shape_batch
from tests.test_torch_specials import sprinkled
from tile_match_tpu.config import EnvConfig as JaxConfig
from tile_match_tpu.ops import pallas_cascade as jpc
from tile_match_tpu_torch import engine as te
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.ops import cascade_sp as tsp
from tile_match_tpu_torch.ops.mask_sp import settled_mask_sp

torch.set_num_threads(1)

ALL = (("cookie",), ("vertical_laser", "horizontal_laser", "bomb"))
LASERS_BOMB = ((), ("vertical_laser", "horizontal_laser", "bomb"))
K2_NAMES = ["colour", "kind", "trips", "elim", "new", "act", "frozen", "active", "reasons"]
CASCADE_NAMES = ["colour", "kind", "elim", "act", "new", "trips", "trunc"]


@pytest.fixture(autouse=True)
def _clear_xla_caches():
    """Interpret-mode programs are large; drop compiled executables around
    each test, as the JAX package's own kernel tests do."""
    jax.clear_caches()
    yield


def _cfgs(R, C, K, specials, moves=6):
    kw = dict(colourless_specials=specials[0], colour_specials=specials[1])
    return JaxConfig.create(R, C, K, moves, **kw), EnvConfig.create(R, C, K, moves, **kw)


def _painted(R, specials, seed, variants=2):
    """Boards of each painted shape of tests/ops/test_rich_trips.py: bomb
    pairs, stars, length-4 partners, lasers and cookies."""
    jc, _ = _cfgs(R, R, 4, specials)
    cols, kinds = [], []
    for i, case in enumerate(sorted(PAINTED)):
        c, k = shape_batch(jc, PAINTED[case], variants, seed=seed + i, specials=i % 3)
        cols.append(c)
        kinds.append(k)
    return np.concatenate(cols), np.concatenate(kinds)


def _k2_inputs(B, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 32, size=(B, 2), dtype=np.uint64).astype(np.uint32)
    trips = rng.integers(0, 3, size=B).astype(np.int32)
    elim = rng.integers(0, 50, size=B).astype(np.int32)
    frozen = (rng.random(B) < 0.1).astype(np.int32)
    return keys, trips, elim, frozen


def _assert_k2(jc, tc, colour, kind, seed, tag):
    B = colour.shape[0]
    keys, trips, elim, frozen = _k2_inputs(B, seed)
    want = jpc.cascade_sp_chunk(
        jc, *(jnp.asarray(a) for a in (colour, kind, keys, trips, elim, frozen)), interpret=True
    )
    got = tsp.cascade_sp_chunk(
        tc, torch.from_numpy(colour), torch.from_numpy(kind),
        torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(trips),
        torch.from_numpy(elim), torch.from_numpy(frozen), limit=8,
    )
    for name, g, w in zip(K2_NAMES, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w), f"{tag}: {name}"
    return got


@pytest.mark.parametrize(
    "R,specials,painted",
    [(8, ALL, True), (8, LASERS_BOMB, True), (6, ALL, False), (8, LASERS_BOMB, False)],
    ids=["8x8-all-painted", "8x8-lasers-bomb-painted", "6x6-all-random", "8x8-lasers-bomb-random"],
)
def test_k2_plain_matches_jax_chunk(R, specials, painted):
    jc, tc = _cfgs(R, R, 4 if painted else 3, specials)
    if painted:  # one board of each of the 16 shapes
        colour, kind = _painted(R, specials, seed=17 if specials == ALL else 31, variants=1)
    else:
        colour, kind = sprinkled(R, R, 3, 20, seed=R + 3)
    got = _assert_k2(jc, tc, colour, kind, seed=R, tag=f"{R}x{R}")
    # the kernel both takes trips and freezes boards with reasons here
    assert int((got[2] > 0).sum()) > 0 and int(got[6].sum()) > 0 and int(got[8].sum()) > 0


def test_k2_plain_frozen_boards_and_budget():
    """Boards frozen on entry stay as they are; a board at max_cascades
    takes no trip and is not frozen."""
    _, tc = _cfgs(6, 6, 3, ALL)
    colour, kind = sprinkled(6, 6, 3, 12, seed=9)
    keys = torch.arange(24, dtype=torch.int64).reshape(12, 2)
    frozen = torch.tensor([1] * 6 + [0] * 6, dtype=torch.int32)
    trips = torch.tensor([0] * 6 + [64] * 6, dtype=torch.int32)
    out = tsp.cascade_sp_chunk(tc, torch.from_numpy(colour), torch.from_numpy(kind), keys, trips,
                               torch.zeros(12, dtype=torch.int32), frozen, limit=8)
    assert torch.equal(out[0], torch.from_numpy(colour)) and torch.equal(out[1], torch.from_numpy(kind))
    assert torch.equal(out[2], trips) and torch.equal(out[6], frozen)
    assert int(out[8].sum()) == 0


def test_k2_refuses_configs_without_bomb():
    """K2 refuses only configs without any special; a config without the
    bomb runs its no-bomb case table and freezes nothing it can take."""
    z = torch.zeros(2, dtype=torch.int32)
    keys = torch.zeros((2, 2), dtype=torch.int64)
    colour, kind = (torch.from_numpy(a) for a in sprinkled(6, 6, 3, 2, seed=0, kinds=(2,)))
    _, none = _cfgs(6, 6, 3, ((), ()))
    with pytest.raises(ValueError):
        tsp.cascade_sp_reference(none, colour, kind, keys, z, z, z, limit=8)
    _, tc = _cfgs(6, 6, 3, (("cookie",), ("vertical_laser",)))
    out = tsp.cascade_sp_reference(tc, colour, kind, keys, z, z, z, limit=8)
    assert int(out[2].sum()) > 0  # trips taken in closed form


@pytest.mark.parametrize("R,K", [(6, 3), (8, 4)])
def test_k3_plain_matches_jax(R, K):
    jc, tc = _cfgs(R, R, K, ALL)
    colour, kind = sprinkled(R, R, K, 40, seed=R * K, n_max=10)
    want = np.asarray(jpc.settled_mask_sp(jc, jnp.asarray(colour), jnp.asarray(kind), interpret=True))
    got = settled_mask_sp(tc, torch.from_numpy(colour), torch.from_numpy(kind))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "R,K,specials,painted,seed",
    [(8, 4, ALL, True, 3), (8, 4, LASERS_BOMB, True, 7), (10, 4, ALL, False, 21)],
    ids=["8x8-all-painted", "8x8-lasers-bomb-painted", "10x10-all-random"],
)
def test_fused_specials_cascade_matches_jax_loop(R, K, specials, painted, seed):
    jc, tc = _cfgs(R, R, K, specials)
    if painted:
        colour, kind = _painted(R, specials, seed=seed)
    else:
        colour, kind = sprinkled(R, R, K, 48, seed=seed)
    B = colour.shape[0]
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(seed * 10000, seed * 10000 + B))
    want = cascade_twin(jc, jnp.asarray(colour), jnp.asarray(kind), keys)
    tkeys = torch.from_numpy(np.asarray(keys).astype(np.int64))
    te.reset_cascade_stats()
    got = te.fused_specials_cascade(tc, torch.from_numpy(colour), torch.from_numpy(kind), tkeys)
    for name, g, w in zip(CASCADE_NAMES, got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    # the kernel took most trips and the machinery the rest, each after a
    # freeze with a reason
    stats = te.cascade_stats
    assert 0 < stats["full_trips"] < int(got[5].sum())
    assert stats["rounds"] <= tc.max_cascades
    last = te.last_cascade
    assert bool(((last["full_trips"] == 0) | (last["reasons"] != 0)).all())
