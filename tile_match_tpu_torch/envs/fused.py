"""Batch-level fused step (counterpart of ``batched_step_fused`` in
``tile_match_tpu.envs.fused``).

In the JAX package this module re-expresses the vmapped per-board step at
batch level so that the cascade runs as one Pallas kernel.  The port's
engine is batch-level already and its move runs the cascade through
``ops.cascade.fused_cascade`` — the CUDA kernel on a card — so the fused
step is ``engine.step`` with the incoming mask: swap, ``key, sub =
split(key)``, the fused cascade, the playability loop seeded with the
kernel's mask, and the info.  The specials fused step on the kernels K2 and
K3 will join it here.
"""

from __future__ import annotations

from ..config import EnvConfig
from ..engine import step
from ..state import EnvState


def batched_step_fused(
    cfg: EnvConfig,
    states: EnvState,
    actions,
    eff_mask,
    compute_post_mask: bool = True,
):
    """``step`` for a no-specials batch given its current mask bool[B, A].
    Returns (next_states, rewards, dones, infos)."""
    if cfg.any_special:
        raise NotImplementedError(
            "the specials fused step (kernels K2 and K3) is not ported yet "
            "(ROADMAP Queue 1 item 8)"
        )
    B = states.colour.shape[0]
    if eff_mask.shape != (B, cfg.num_actions) or actions.shape != (B,):
        raise ValueError("actions must be [B] and eff_mask [B, num_actions]")
    return step(cfg, states, actions, eff_mask=eff_mask, compute_post_mask=compute_post_mask)
