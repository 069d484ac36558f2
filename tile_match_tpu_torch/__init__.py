"""tile_match_tpu_torch — the tile-matching engine of ``tile_match_tpu`` in
PyTorch, with its TPU kernels rewritten as CUDA kernels for Hopper.

Same configs, boards and threefry keys give the same outputs as the JAX
package, bit for bit.  This package imports no JAX.  Ported: the batched
step and env of every special set, with the three TPU kernels as CUDA
kernels, the Gymnasium adapter ``envs.gym_env.TileMatchEnv`` in both RNG
modes, the agents (``models``), the scale-out layer (``parallel``),
``debug``, ``profiling``, ``utils``, the C++ engine's loader (``native``)
and the examples.

The adapter is registered with gymnasium as ``TileMatchTorch-v0``.
Importing this package does not import gymnasium: the id is registered
here when gymnasium is already imported, and by ``envs.gym_env`` itself
otherwise (``gym.make("tile_match_tpu_torch.envs.gym_env:TileMatchTorch-v0")``).
"""

import sys

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


def register_envs() -> None:
    """Register ``TileMatchTorch-v0`` with gymnasium, once; a no-op without
    gymnasium."""
    try:
        from gymnasium.envs.registration import register, registry
    except ImportError:
        return
    if "TileMatchTorch-v0" not in registry:
        register(id="TileMatchTorch-v0", entry_point="tile_match_tpu_torch.envs.gym_env:TileMatchEnv")


if sys.modules.get("gymnasium") is not None:
    register_envs()
