"""Device-resident ring replay buffer (counterpart of
``tile_match_tpu.models.replay``).

Transitions are stored compactly (int8 boards and moves, not one-hot
planes: a 50,000-transition buffer of 10x10 boards is ~30 MB) and encoded
to network inputs at sample time.  ``replay_add`` writes into the buffer's
storage in place, where the JAX package returns a new buffer: a functional
copy would move the whole buffer every step.  The pointer and the fill
level depend only on how many transitions were added, so they are host
ints: adding, sampling and the learner's ``size >= learning_starts`` gate
read them without a host sync.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import random as trandom
from ..config import EnvConfig


@dataclasses.dataclass
class Replay:
    boards: torch.Tensor  # int8[N, 2, R, C]
    moves: torch.Tensor  # int8[N]
    actions: torch.Tensor  # int32[N]
    rewards: torch.Tensor  # float32[N]
    dones: torch.Tensor  # bool[N]
    next_boards: torch.Tensor  # int8[N, 2, R, C]
    next_moves: torch.Tensor  # int8[N]
    next_eff: torch.Tensor  # bool[N, A]
    ptr: int  # next slot to write
    size: int  # transitions held


def replay_init(cfg: EnvConfig, capacity: int, device) -> Replay:
    R, C, A = cfg.num_rows, cfg.num_cols, cfg.num_actions

    def zeros(*shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return Replay(
        boards=zeros(capacity, 2, R, C, dtype=torch.int8),
        moves=zeros(capacity, dtype=torch.int8),
        actions=zeros(capacity, dtype=torch.int32),
        rewards=zeros(capacity, dtype=torch.float32),
        dones=zeros(capacity, dtype=torch.bool),
        next_boards=zeros(capacity, 2, R, C, dtype=torch.int8),
        next_moves=zeros(capacity, dtype=torch.int8),
        next_eff=zeros(capacity, A, dtype=torch.bool),
        ptr=0,
        size=0,
    )


def replay_add(rb: Replay, batch: dict) -> Replay:
    """Insert a batch of B transitions at the ring pointer (B at most the
    capacity), writing ``rb``'s storage in place."""
    B = batch["actions"].shape[0]
    N = rb.boards.shape[0]
    idx = torch.arange(rb.ptr, rb.ptr + B, dtype=torch.int64, device=rb.actions.device) % N
    for name in ("boards", "moves", "actions", "rewards", "dones", "next_boards",
                 "next_moves", "next_eff"):
        store = getattr(rb, name)
        store.index_copy_(0, idx, batch[name].to(store.dtype))
    return dataclasses.replace(rb, ptr=(rb.ptr + B) % N, size=min(rb.size + B, N))


def replay_sample(rb: Replay, key, batch_size: int) -> dict:
    """Uniform sample of stored transitions (with replacement)."""
    idx = trandom.randint(key, (batch_size,), 0, max(rb.size, 1)).to(torch.int64)
    return {
        "boards": rb.boards[idx].to(torch.int32),
        "moves": rb.moves[idx].to(torch.int32),
        "actions": rb.actions[idx],
        "rewards": rb.rewards[idx],
        "dones": rb.dones[idx],
        "next_boards": rb.next_boards[idx].to(torch.int32),
        "next_moves": rb.next_moves[idx].to(torch.int32),
        "next_eff": rb.next_eff[idx],
    }
