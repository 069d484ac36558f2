"""Run-extent primitives (counterpart of ``tile_match_tpu.ops.runs``).

Per-cell extents of maximal equal-colour runs, as cumulative max/min scans
over boards of shape [..., R, C].  ``axis`` is -1 for runs along a row
(horizontal) and -2 for runs along a column (vertical).
"""

from __future__ import annotations

import torch

# Large sentinel for masked min/max scan keys.
BIG = 1 << 30


def _iota_like(x: torch.Tensor, axis: int) -> torch.Tensor:
    n = x.shape[axis]
    shape = [1] * x.ndim
    shape[axis] = n
    idx = torch.arange(n, dtype=torch.int32, device=x.device).reshape(shape)
    return idx.expand(x.shape)


def _shift(x: torch.Tensor, axis: int, offset: int, fill) -> torch.Tensor:
    """Shift ``x`` along ``axis`` by ``offset`` (positive -> toward higher
    index), filling vacated entries with ``fill``."""
    n = x.shape[axis]
    k = min(abs(offset), n)
    pad_shape = list(x.shape)
    pad_shape[axis] = k
    pad = torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)
    if offset > 0:
        return torch.cat([pad, x.narrow(axis, 0, n - k)], dim=axis)
    return torch.cat([x.narrow(axis, k, n - k), pad], dim=axis)


def _cummax(x: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.cummax(x, dim=axis).values


def _cummin_rev(x: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.cummin(x.flip(axis), dim=axis).values.flip(axis)


def colour_run_extents(colour: torch.Tensor, axis: int):
    """Per-cell (start, end, length) of the maximal run of equal non-zero
    colour containing the cell, along ``axis``.  Values at zero-colour cells
    are (i, i, 1) and must be masked by callers."""
    valid = colour > 0
    idx = _iota_like(colour, axis)

    same_prev = (colour == _shift(colour, axis, 1, -1)) & valid
    start = _cummax(torch.where(~same_prev, idx, -1), axis)

    same_next = (colour == _shift(colour, axis, -1, -1)) & valid
    end = _cummin_rev(torch.where(~same_next, idx, BIG), axis)

    return start, end, end - start + 1


def true_run_extents(flag: torch.Tensor, axis: int):
    """Per-cell (start, end) of the maximal run of True containing the cell."""
    idx = _iota_like(flag, axis)
    is_start = flag & ~_shift(flag, axis, 1, False)
    start = _cummax(torch.where(is_start, idx, -1), axis)
    is_end = flag & ~_shift(flag, axis, -1, False)
    end = _cummin_rev(torch.where(is_end, idx, BIG), axis)
    return start, end
