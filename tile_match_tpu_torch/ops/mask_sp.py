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

import torch

from .. import cuda_build
from ..config import EnvConfig
from ..profiling import kernel_span
from .effective import effective_mask_settled


@kernel_span("settled_mask_sp")
def settled_mask_sp(cfg: EnvConfig, colour: torch.Tensor, kind: torch.Tensor) -> torch.Tensor:
    """bool[B, A]: ``effective_mask_settled`` of settled boards, with or
    without specials, as one CUDA kernel launch on a CUDA device; on CPU
    tensors, ``effective_mask_settled`` itself."""
    if not cuda_build.on_card("settled_mask_sp", colour):
        return effective_mask_settled(cfg, colour, kind)
    B, R, C = colour.shape
    cuda_build.check_inputs("settled_mask_sp", cfg, (("colour", colour, torch.int32, (B, R, C)),
                                                     ("kind", kind, torch.int32, (B, R, C))))
    mask = torch.empty(B, cfg.num_actions, dtype=torch.bool, device=colour.device)
    cuda_build.launch("tmt_settled_mask_sp", colour.device, (R, C), colour.data_ptr(),
                      kind.data_ptr(), mask.data_ptr(), B, R, C, int(cfg.any_special))
    return mask
