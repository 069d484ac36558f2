"""tile_match_tpu_torch — the tile-matching engine of ``tile_match_tpu`` in
PyTorch, with its TPU kernels rewritten as CUDA kernels for Hopper.

Same configs, boards and threefry keys give the same outputs as the JAX
package, bit for bit.  This package imports no JAX.  Ported so far: the
batched step of every bench config — no specials, and specials with the
bomb enabled — with its three TPU kernels as CUDA kernels.
"""

from .config import EnvConfig, TILE_TYPES
from .state import EnvState, StepInfo, action_table
from .engine import reset, step, observe

__version__ = "0.1.0"

__all__ = [
    "EnvConfig",
    "EnvState",
    "StepInfo",
    "TILE_TYPES",
    "action_table",
    "reset",
    "step",
    "observe",
]
