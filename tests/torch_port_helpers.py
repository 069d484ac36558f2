"""Shared by the tests that hold the PyTorch port against the JAX package:
paired configs, field-by-field comparison, the deterministic policy, the
learners' leaf-by-leaf gaps, and the host seam that runs the kernel
wrappers on the CUDA sources built for the host."""

import ctypes
import dataclasses
import math
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tile_match_tpu.config import EnvConfig as JaxConfig
from tile_match_tpu_torch import cuda_build
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.state import StepInfo
from tools.make_torch_port_fixture import policy_actions as policy_np  # noqa: F401

# configs 0 and 1 of bench.py: no specials
CONFIGS = {0: (5, 5, 3, 10), 1: (10, 10, 4, 30)}
STATE_FIELDS = ("colour", "kind", "timer", "key")
INFO_FIELDS = tuple(f.name for f in dataclasses.fields(StepInfo))


def cfgs(idx, **kw):
    """(JAX config, port config) of bench.py config ``idx``."""
    R, C, K, M = CONFIGS[idx]
    common = dict(colourless_specials=(), colour_specials=(), **kw)
    return JaxConfig.create(R, C, K, M, **common), EnvConfig.create(R, C, K, M, **common)


def assert_state(tstate, jstate, tag):
    for f in STATE_FIELDS:
        assert np.array_equal(getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f))), f"{f} @ {tag}"


def assert_info(tinfo, jinfo, tag):
    for f in INFO_FIELDS:
        assert np.array_equal(getattr(tinfo, f).numpy(), np.asarray(getattr(jinfo, f))), f"{f} @ {tag}"


# The learners against the JAX agents, leaf by leaf and by relative norm.
# Adam's first moment (a running mean of the gradients): the bfloat16
# hidden layers round the two packages' products at different places
# (up to 0.044 over ten seeds of the 4x4x3x5 tests); a gradient of the
# wrong sign, zero or twice as large is off by 1 or more.
MU_REL = 8e-2


def rel_gap(got, want) -> float:
    """|got - want| / |want| in float64 (|got| where want is 0)."""
    got = torch.as_tensor(got).detach().double()
    want = torch.as_tensor(want).detach().double()
    scale = want.norm()
    return float((got - want).norm() / scale) if scale > 0 else float(got.norm())


def change_tol(n: int) -> float:
    """Tolerance of the change of a leaf of n entries from its start:
    MU_REL, or about three of its entries moving the other way.  Adam
    moves an entry by about lr sign(g), so an entry whose gradient lies
    within rounding of 0 may go either way, each adding 2 lr to a change
    of norm about lr sqrt(n) (one such entry of a 128-entry bias: 0.18)."""
    return max(MU_REL, 3.5 / math.sqrt(n))


def assert_moments(mu: dict, jmu: dict, tag) -> None:
    """The port's Adam first moments (by parameter name) against optax's
    ``mu`` in the port's layout."""
    for name, want in jmu.items():
        assert float(want.norm()) > 0, (tag, name)
        gap = rel_gap(mu[name], want)
        assert gap < MU_REL, (tag, name, gap)


def assert_changes(params: dict, jparams: dict, start: dict, tag) -> None:
    """Each leaf's change from the common start against the JAX agent's."""
    for name, want in jparams.items():
        gap = rel_gap(params[name] - start[name], want - start[name])
        assert gap < change_tol(want.numel()), (tag, name, gap)


def port_moments(net, opt) -> dict:
    """Adam's first moment of each of ``net``'s parameters, by name."""
    return {n: opt.state[p]["exp_avg"].clone() for n, p in net.named_parameters()}


# ---- the kernels' host builds and the host seam ------------------------------

_HOST_BUILDS: dict = {}


def host_build(tmp_path_factory, source: str, shape=None) -> ctypes.CDLL:
    """``csrc/<source>.cu`` built for the host (``g++ -DTMT_HOST_BUILD``: the
    board programs as loops over the cells, each entry point's ``_host``
    twin in place of the launch): with ``shape`` = (R, C) the library of
    that board shape (its geometry fixed at compile time, as the card's
    libraries of boards up to 32 by 32), else the one whose geometry is read
    at run time (any board).  Built once a test run; skips without g++."""
    key = (source, shape)
    if key not in _HOST_BUILDS:
        gxx = shutil.which("g++")
        if gxx is None:
            pytest.skip("needs g++ to build the kernels' board programs for the host")
        defines = [] if shape is None else [f"-DTMT_ROWS={shape[0]}", f"-DTMT_COLS={shape[1]}"]
        so = tmp_path_factory.mktemp("host_build") / f"lib{source}_host.so"
        subprocess.run(
            [gxx, "-O2", "-std=c++17", "-x", "c++", "-DTMT_HOST_BUILD", *defines, "-shared", "-fPIC",
             "-I", str(cuda_build.CSRC), "-o", str(so), str(cuda_build.CSRC / f"{source}.cu")],
            check=True, capture_output=True, text=True,
        )
        _HOST_BUILDS[key] = ctypes.CDLL(str(so))
    return _HOST_BUILDS[key]


_CARD = object()  # the library the card would load for the board


@pytest.fixture
def host_kernels(tmp_path_factory, monkeypatch):
    """The host seam: ``host_kernels(*names, shape=...)`` points the launch
    path (``cuda_build``) at the host builds, so that the wrappers of the
    kernels ``names``, called on CPU tensors, marshal their arguments and
    launch their entry points' host twins as they launch the kernels on the
    card.  The library is the one the card loads for the board
    (``cuda_build.shape_of``), or with ``shape`` the one of that board
    shape (None: of any shape) whatever the board.  A host build has no
    shared memory: K4's and K5's scratch lies in the buffers their wrappers
    allocate.  Undone at the test's end."""

    def seam(*names, shape=_CARD):
        def library(source, board):
            if shape is not _CARD:
                return host_build(tmp_path_factory, source, shape)
            return host_build(tmp_path_factory, source,
                              None if board is None else cuda_build.shape_of(*board))

        for name in names:
            monkeypatch.setitem(cuda_build._host, name, library)

    return seam
