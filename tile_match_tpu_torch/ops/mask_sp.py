"""The settled effective-action mask: its CUDA kernel's wrapper
(counterpart of ``settled_mask_sp`` in
``tile_match_tpu.ops.pallas_cascade``).  The plain version is
``ops.effective.effective_mask_settled``.

``settled_mask_sp`` serves boards with specials and without (the config's
``any_special`` turns the special-pair and cookie terms on): every settled
mask of the engine and the batched env goes through it.  It launches the
CUDA kernel (``csrc/mask_sp.cu``, one library a board shape of at most 32
by 32) on CUDA tensors and runs ``effective_mask_settled`` on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import cuda_build
from ..config import EnvConfig
from ..profiling import kernel_span
from .effective import effective_mask_settled

# Kernel launches so far; a run resets it to see which kernels it went through.
launches = 0


@functools.lru_cache(maxsize=None)
def _kernel(R: int, C: int, device: int):
    """The launch function for R x C boards on card ``device``, after the
    fit check: both once per shape and card."""
    lib = cuda_build.load("mask_sp", cuda_build.shape_of(R, C))
    cuda_build.check_fits(lib, "settled_mask_sp", R, C, "settled_mask_sp")
    fn = lib.tmt_settled_mask_sp
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@kernel_span("settled_mask_sp")
def settled_mask_sp(cfg: EnvConfig, colour: torch.Tensor, kind: torch.Tensor) -> torch.Tensor:
    """bool[B, A]: ``effective_mask_settled`` of settled boards, with or
    without specials, as one CUDA kernel launch on a CUDA device; on CPU
    tensors, ``effective_mask_settled`` itself."""
    if colour.device.type == "cpu":
        return effective_mask_settled(cfg, colour, kind)
    if colour.device.type != "cuda":
        raise ValueError(f"settled_mask_sp: unsupported device {colour.device}")
    B, R, C = colour.shape
    if (R, C) != (cfg.num_rows, cfg.num_cols):
        raise ValueError(f"board shape {(R, C)} does not match the config")
    for name, t in (("colour", colour), ("kind", kind)):
        if (
            t.dtype != torch.int32 or tuple(t.shape) != (B, R, C)
            or t.device != colour.device or not t.is_contiguous()
        ):
            raise ValueError(f"{name} must be a contiguous int32[B, R, C] tensor on {colour.device}")
    mask = torch.empty(B, cfg.num_actions, dtype=torch.bool, device=colour.device)
    with torch.cuda.device(colour.device):
        fn = _kernel(R, C, colour.device.index)
        err = fn(
            colour.data_ptr(), kind.data_ptr(), mask.data_ptr(), B, R, C,
            int(cfg.any_special), torch.cuda.current_stream(colour.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"settled_mask_sp kernel launch failed: cudaError_t {err}")
    global launches
    launches += 1
    return mask
