"""The port's cascade equals the JAX package's K1 ``fused_cascade`` (Pallas,
interpret mode on the CPU) and its XLA twin ``cascade_reference``, exactly.
The CUDA kernel is held against the plain version in
``test_torch_kernels_cuda.py``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tile_match_tpu.config import EnvConfig as JaxConfig
from tile_match_tpu.ops import pallas_cascade as jpc
from tile_match_tpu_torch import cuda_build
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.ops import cascade as tcas

torch.set_num_threads(1)

JCFG = JaxConfig.create(6, 6, 3, 10, colourless_specials=(), colour_specials=())
TCFG = EnvConfig.create(6, 6, 3, 10, colourless_specials=(), colour_specials=())
NAMES = ["colour", "elim", "trips", "trunc", "mask"]


def _boards(seed, B, R=6, C=6, K=3):
    """The inputs of tests/ops/test_pallas_cascade.py, in both packages."""
    rng = np.random.default_rng(seed)
    colour = rng.integers(1, K + 1, size=(B, R, C)).astype(np.int32)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(seed * 1000, seed * 1000 + B))
    return (
        (jnp.asarray(colour), keys),
        (torch.from_numpy(colour), torch.from_numpy(np.asarray(keys).astype(np.int64))),
    )


def _assert_equal(got, want, tag):
    for g, w, name in zip(got, want, NAMES):
        assert np.array_equal(g.numpy(), np.asarray(w)), f"{name} diverges at {tag}"


@pytest.mark.parametrize("seed", range(6))
def test_cascade_reference_matches_jax(seed):
    B = 16 if seed % 2 else 130
    (jc, jk), (tc, tk) = _boards(seed, B)
    got = tcas.cascade_reference(TCFG, tc, tk)
    _assert_equal(got, jpc.fused_cascade(JCFG, jc, jk, interpret=True), f"seed {seed} (Pallas)")
    _assert_equal(got, jpc.cascade_reference(JCFG, jc, jk), f"seed {seed} (XLA)")
    assert got[0].dtype == torch.int32 and got[3].dtype == torch.bool


@pytest.mark.parametrize("R,C,K", [(10, 10, 4), (7, 9, 4)])
def test_cascade_reference_matches_jax_wider(R, C, K):
    jcfg = JaxConfig.create(R, C, K, 30, colourless_specials=(), colour_specials=())
    tcfg = EnvConfig.create(R, C, K, 30, colourless_specials=(), colour_specials=())
    (jc, jk), (tc, tk) = _boards(R * C, 40, R, C, K)
    _assert_equal(
        tcas.cascade_reference(tcfg, tc, tk), jpc.cascade_reference(jcfg, jc, jk), (R, C)
    )


def test_cascade_cap_truncates_like_jax():
    jcfg = JaxConfig.create(6, 6, 3, 10, colourless_specials=(), colour_specials=(), max_cascades=1)
    tcfg = EnvConfig.create(6, 6, 3, 10, colourless_specials=(), colour_specials=(), max_cascades=1)
    (jc, jk), (tc, tk) = _boards(9, 64)
    got = tcas.cascade_reference(tcfg, tc, tk)
    _assert_equal(got, jpc.cascade_reference(jcfg, jc, jk), "max_cascades=1")
    assert got[3].any()


def test_line_free_is_identity():
    colour = torch.from_numpy(
        np.tile(
            np.array([[1, 2, 3], [2, 3, 1], [3, 1, 2]], np.int32).repeat(2, 0).repeat(2, 1),
            (4, 1, 1),
        )
    )
    keys = torch.from_numpy(np.asarray(jax.vmap(jax.random.PRNGKey)(jnp.arange(4))).astype(np.int64))
    out, elim, trips, trunc, mask = tcas.fused_cascade(TCFG, colour, keys)
    assert torch.equal(out, colour)
    assert int(elim.sum()) == 0 and int(trips.sum()) == 0
    assert not trunc.any()
    want = jpc.cascade_reference(JCFG, jnp.asarray(colour.numpy()), jnp.asarray(keys.numpy().astype(np.uint32)))
    assert np.array_equal(mask.numpy(), np.asarray(want[4]))


def test_cpu_tensors_take_the_plain_version():
    (_, _), (tc, tk) = _boards(2, 8)
    before = cuda_build.launches["fused_cascade"]
    got = tcas.fused_cascade(TCFG, tc, tk)
    assert cuda_build.launches["fused_cascade"] == before
    _assert_equal(got, [w.numpy() for w in tcas.cascade_reference(TCFG, tc, tk)], "cpu dispatch")


def test_other_devices_raise():
    colour = torch.ones((2, 6, 6), dtype=torch.int32, device="meta")
    keys = torch.zeros((2, 2), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        tcas.fused_cascade(TCFG, colour, keys)
