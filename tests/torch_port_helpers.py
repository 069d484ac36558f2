"""Shared by the tests that hold the PyTorch port against the JAX package:
paired configs, field-by-field comparison and the deterministic policy."""

import dataclasses

import numpy as np

from tile_match_tpu.config import EnvConfig as JaxConfig
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
