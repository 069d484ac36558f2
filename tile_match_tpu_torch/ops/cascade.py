"""The fused no-specials cascade: its CUDA kernel's wrapper and its plain
PyTorch version (counterpart of ``fused_cascade`` / ``cascade_reference`` in
``tile_match_tpu.ops.pallas_cascade``).

One call runs, for every board, the whole cascade of a move with every
special disabled (`board.py:367-376` of the original game): delete the union
of the detected lines, apply gravity, refill from threefry — trip t of board
b draws ``draw_colour_grid(fold_in(sub_b, t))`` — until the board is
line-free or ``cfg.max_cascades`` trips have run; then the settled
effective-action mask of the result.

``fused_cascade`` launches the CUDA kernel (``csrc/cascade.cu``) on CUDA
tensors and runs ``cascade_reference`` on CPU tensors.
"""

from __future__ import annotations

import torch

from .. import cuda_build
from .. import random as trandom
from ..config import EnvConfig
from ..profiling import kernel_span
from .board_ops import apply_refill, draw_colour_grid, gravity
from .effective import effective_mask_settled
from .lines import line_union_mask, plain_has_any_line


def cascade_reference(cfg: EnvConfig, colour: torch.Tensor, sub_keys: torch.Tensor):
    """Plain PyTorch cascade.  colour int32[B, R, C] (all-normal boards),
    sub_keys int64[B, 2].  Returns (colour int32[B, R, C], elim int32[B],
    trips int32[B], truncated bool[B], mask bool[B, A]).

    Boards run in lockstep: a board that is line-free stays so, and its
    trip count stops, so the lockstep trip index is every running board's
    own trip index."""
    B = colour.shape[0]
    kind = torch.ones_like(colour)
    elim = torch.zeros(B, dtype=torch.int32, device=colour.device)
    trips = torch.zeros(B, dtype=torch.int32, device=colour.device)
    for t in range(cfg.max_cascades):
        active = plain_has_any_line(cfg, colour)
        if not bool(active.any()):
            break
        dmask = line_union_mask(cfg, colour) & active[:, None, None]
        colour = torch.where(dmask, 0, colour)
        kind = torch.where(dmask, 0, kind)
        elim += dmask.flatten(1).sum(-1, dtype=torch.int32)
        colour, kind = gravity(colour, kind)
        grid = draw_colour_grid(trandom.fold_in(sub_keys, t), cfg)
        colour, kind = apply_refill(colour, kind, grid)
        trips += active.to(torch.int32)
    truncated = plain_has_any_line(cfg, colour)
    mask = effective_mask_settled(cfg, colour, kind)
    return colour, elim, trips, truncated, mask


@kernel_span("fused_cascade")
def fused_cascade(cfg: EnvConfig, colour: torch.Tensor, sub_keys: torch.Tensor):
    """The cascade of ``cascade_reference``, as one CUDA kernel launch on a
    CUDA device; on CPU tensors, ``cascade_reference`` itself."""
    if not cuda_build.on_card("fused_cascade", colour):
        return cascade_reference(cfg, colour, sub_keys)
    if cfg.any_special:
        raise ValueError("fused_cascade runs no-specials configs only")
    B, R, C = colour.shape
    cuda_build.check_inputs("fused_cascade", cfg, (("colour", colour, torch.int32, (B, R, C)),
                                                   ("sub_keys", sub_keys, torch.int64, (B, 2))))
    dev = colour.device
    out = torch.empty_like(colour)
    elim = torch.empty(B, dtype=torch.int32, device=dev)
    trips = torch.empty(B, dtype=torch.int32, device=dev)
    truncated = torch.empty(B, dtype=torch.bool, device=dev)
    mask = torch.empty(B, cfg.num_actions, dtype=torch.bool, device=dev)
    cuda_build.launch(
        "tmt_fused_cascade", dev, (R, C), colour.data_ptr(), sub_keys.data_ptr(), out.data_ptr(),
        elim.data_ptr(), trips.data_ptr(), truncated.data_ptr(), mask.data_ptr(),
        B, R, C, cfg.num_colours, cfg.max_cascades,
    )
    return out, elim, trips, truncated, mask
