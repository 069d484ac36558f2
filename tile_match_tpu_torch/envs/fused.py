"""Batch-level fused step (counterpart of ``batched_step_fused`` and
``batched_step_fused_sp`` in ``tile_match_tpu.envs.fused``).

The port's engine is batch-level already and runs its cascade on the
kernels, so the fused step is ``engine.step`` with the incoming mask: K1
without specials; with specials, K2 with the full machinery
(``engine.fused_specials_cascade``) and K3's settled mask.
"""

from __future__ import annotations

from ..config import EnvConfig
from ..engine import step
from ..state import EnvState


def batched_step_fused_sp(
    cfg: EnvConfig, states: EnvState, actions, eff_mask, compute_post_mask: bool = True
):
    """``step`` for a specials batch given its current mask bool[B, A].
    Returns (next_states, rewards, dones, infos)."""
    if not cfg.any_special:
        raise ValueError("batched_step_fused_sp runs configs with specials")
    return step(cfg, states, actions, eff_mask=eff_mask, compute_post_mask=compute_post_mask)


def batched_step_fused(
    cfg: EnvConfig, states: EnvState, actions, eff_mask, compute_post_mask: bool = True
):
    """``step`` for a batch given its current mask bool[B, A], on the
    kernels.  Returns (next_states, rewards, dones, infos)."""
    B = states.colour.shape[0]
    if eff_mask.shape != (B, cfg.num_actions) or actions.shape != (B,):
        raise ValueError("actions must be [B] and eff_mask [B, num_actions]")
    if cfg.any_special:
        return batched_step_fused_sp(cfg, states, actions, eff_mask, compute_post_mask)
    return step(cfg, states, actions, eff_mask=eff_mask, compute_post_mask=compute_post_mask)
