"""Batched, auto-resetting environment (counterpart of
``tile_match_tpu.envs.batched``).

A batch of boards stepped together.  Every tensor lives on the device the
caller chose (by default the card): on a CUDA device the step's kernels
(the cascade and the settled mask) are the CUDA kernels, on the CPU their
plain PyTorch versions, through the same code.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from .. import random as trandom
from ..config import EnvConfig
from ..cuda_build import resolve_device
from ..engine import generate_board, reset
from ..ops.mask_sp import settled_mask_sp
from ..profiling import span
from ..state import EnvState, StepInfo
from .fused import batched_step_fused


@dataclasses.dataclass
class TimeStep:
    obs_board: torch.Tensor  # int32[B, 2, R, C]
    obs_moves_left: torch.Tensor  # int32[B]
    reward: torch.Tensor  # float32[B]
    done: torch.Tensor  # bool[B]
    info: StepInfo


def batched_reset(
    cfg: EnvConfig, key, batch_size: int, offset: int = 0
) -> Tuple[EnvState, TimeStep]:
    """Reset ``batch_size`` boards from one key int64[2]: board b starts from
    ``split(key, batch_size)[b]``, or with ``offset`` from key ``offset + b``
    of a larger split (a rank's slice of a global batch)."""
    states, infos = reset(cfg, trandom.split(key, batch_size, offset))
    ts = TimeStep(
        obs_board=states.board,
        obs_moves_left=cfg.num_moves - states.timer,
        reward=torch.zeros(batch_size, dtype=torch.float32, device=key.device),
        done=torch.zeros(batch_size, dtype=torch.bool, device=key.device),
        info=infos,
    )
    return states, ts


def batched_step(
    cfg: EnvConfig,
    states: EnvState,
    actions,
    auto_reset: bool = True,
    eff_mask=None,
) -> Tuple[EnvState, TimeStep]:
    """Step every board; with ``auto_reset``, regenerate finished episodes.

    A done board is replaced by ``generate_board(split(key)[1])`` (new
    episode, timer 0); the returned observation and mask are the new
    episode's, while reward and done refer to the finished one.
    ``eff_mask``: the previous TimeStep's ``info.effective_actions``, to skip
    recomputing the current mask.

    Runs in span ``batched_step`` with ``boards`` and ``regenerated``.
    """
    with span("batched_step", boards=states.colour.shape[0], regenerated=0) as sp:
        if eff_mask is None:
            eff_mask = settled_mask_sp(cfg, states.colour.contiguous(), states.kind.contiguous())
        next_states, rewards, dones, infos = batched_step_fused(
            cfg, states, actions, eff_mask, compute_post_mask=not auto_reset
        )

        if auto_reset and bool(dones.any()):
            idx = dones.nonzero()[:, 0]
            k = trandom.split(next_states.key[idx])[:, 1]
            colour, kind, key, mask, _gave_up = generate_board(cfg, k)
            next_states = EnvState(
                colour=next_states.colour.index_copy(0, idx, colour),
                kind=next_states.kind.index_copy(0, idx, kind),
                timer=next_states.timer.index_fill(0, idx, 0),
                key=next_states.key.index_copy(0, idx, key),
            )
            infos = dataclasses.replace(
                infos, effective_actions=infos.effective_actions.index_copy(0, idx, mask)
            )
            sp.set(regenerated=idx.numel())

    ts = TimeStep(
        obs_board=next_states.board,
        obs_moves_left=cfg.num_moves - next_states.timer,
        reward=rewards.to(torch.float32),
        done=dones,
        info=infos,
    )
    return next_states, ts


def random_effective(key, ts: TimeStep, offset: int = 0) -> torch.Tensor:
    """A uniform draw among each board's effective actions, action 0 where
    a board has none: ``jax.random.categorical`` over the masked logits
    from one key int64[2], as the JAX ``rollout``'s default policy draws.
    ``offset``: the global index of the first board, where these are a
    rank's rows of a larger batch.  Runs in span ``draw``."""
    with span("draw"):
        return masked_categorical(key, ts.info.effective_actions, offset)


def masked_categorical(key, mask, offset: int = 0) -> torch.Tensor:
    """``random_effective``'s draw from the mask bool[B, A] itself."""
    logits = torch.where(mask, 0.0, -torch.inf)
    acts = trandom.categorical(key, logits, axis=-1, offset=offset * mask.shape[-1])
    return torch.where(mask.any(-1), acts, 0).to(torch.int32)


def rollout(
    cfg: EnvConfig,
    key,
    batch_size: int,
    num_steps: int,
    policy: Optional[Callable] = None,
    auto_reset: bool = True,
):
    """Run a whole batched rollout.  ``policy(key, ts) -> actions`` defaults
    to ``random_effective``.  Returns the final state plus the stacked
    rewards float32[T, B] and dones bool[T, B]."""
    policy = policy or random_effective
    both = trandom.split(key)
    key, k0 = both[0], both[1]
    states, ts = batched_reset(cfg, k0, batch_size)
    rewards, dones = [], []
    for _ in range(num_steps):
        both = trandom.split(key)
        key, ka = both[0], both[1]
        actions = policy(ka, ts)
        states, ts = batched_step(
            cfg, states, actions, auto_reset=auto_reset,
            eff_mask=ts.info.effective_actions,
        )
        rewards.append(ts.reward)
        dones.append(ts.done)
    return states, torch.stack(rewards), torch.stack(dones)


class BatchedTileMatchEnv:
    """Object facade over the functional batched API on one device:
    ``device=None`` means the card, and raises when there is none."""

    def __init__(
        self, cfg: EnvConfig, batch_size: int, auto_reset: bool = True, *, device=None
    ):
        self.cfg = cfg
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.auto_reset = auto_reset

    def reset(self, key) -> Tuple[EnvState, TimeStep]:
        return batched_reset(self.cfg, key.to(self.device), self.batch_size)

    def step(self, states: EnvState, actions) -> Tuple[EnvState, TimeStep]:
        return batched_step(self.cfg, states, actions, auto_reset=self.auto_reset)
