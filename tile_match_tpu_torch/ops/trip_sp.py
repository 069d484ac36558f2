"""One full-machinery trip of the specials cascade: its CUDA kernel's
wrapper (K4; in the JAX package the XLA program
``engine.specials_cascade_trip_grid``, which ``fused_specials_cascade``
runs on the frozen boards of each round).  The plain version is
``engine.specials_cascade_trip``.

``specials_trip`` launches the CUDA kernel (``csrc/trip_sp.cu``, one
library a board shape of at most 32 by 32) on CUDA tensors and runs the
plain trip on CPU tensors.  Each board's scratch (line queue, matches,
activation stack), sized from the config's caps, lies in shared memory
where it fits a block and in a device buffer where it does not.  With
``cfg.debug_checks`` on, the wrapper reads back which capacity cap fired on
each board and raises the JAX package's message of that site.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import cuda_build
from ..config import EnvConfig
from ..profiling import kernel_span

# the cap bits the kernel returns per board (csrc/trip_sp.cu kCap*), in the
# order the plain trip meets their checks
CAP_LINES, CAP_QUEUE, CAP_EMIT, CAP_STACK = 1, 2, 4, 8


@functools.lru_cache(maxsize=None)
def _scratch_bytes(lib, device, R: int, C: int, K: int, LM: int, SM: int) -> int:
    """The bytes of device memory one board's scratch takes with ``lib`` on
    ``device``: 0 where it fits a block's shared memory.  Once per library,
    card and sizes."""
    smem = cuda_build.c_function(lib, "tmt_specials_trip_smem", [ctypes.c_int] * 5,
                                 ctypes.c_longlong)
    need = smem(R, C, K, LM, SM)
    return 0 if need <= cuda_build.smem_optin(lib, device) else need


def raise_caps(cfg: EnvConfig, caps: torch.Tensor, lines: torch.Tensor) -> None:
    """Raise the JAX package's ``debug_checks`` message for the first cap
    that fired, in the order the plain trip checks them (all boards' lines,
    then classification's queue and emissions, then the activation stack);
    caps, lines: int32[n] on the host."""
    if bool((caps & CAP_LINES).any()):
        n = int(lines[(caps & CAP_LINES) > 0][0])
        raise RuntimeError(f"lines_max overflow: {n} detected lines exceed capacity {cfg.lines_max}")
    if bool((caps & CAP_QUEUE).any()):
        raise RuntimeError("classify queue overflow: cookie remainder dropped")
    if bool((caps & CAP_EMIT).any()):
        raise RuntimeError("classify emission overflow: more than MM live matches")
    if bool((caps & CAP_STACK).any()):
        raise RuntimeError(
            f"stack_max overflow: activation frame dropped at depth {cfg.stack_max}"
        )


@kernel_span("specials_trip")
def specials_trip(cfg: EnvConfig, colour, kind, sub, trips):
    """One full-machinery trip of n boards: colour, kind int32[n, R, C], sub
    int64[n, 2] threefry keys, trips int32[n] (each board's trips so far,
    the refill's ``fold_in``).  Returns (colour, kind, elim, activated, new
    int32[n], ovf bool[n]), equal to ``engine.specials_cascade_trip``'s:
    the CUDA kernel on a CUDA device, the plain trip on CPU tensors."""
    if not cuda_build.on_card("specials_trip", colour):
        from .. import engine

        return engine.specials_cascade_trip(cfg, colour, kind, sub, trips)
    n, R, C = colour.shape
    cuda_build.check_inputs("specials_trip", cfg, (
        ("colour", colour, torch.int32, (n, R, C)), ("kind", kind, torch.int32, (n, R, C)),
        ("sub", sub, torch.int64, (n, 2)), ("trips", trips, torch.int32, (n,)),
    ))
    dev = colour.device
    out = [torch.empty_like(colour), torch.empty_like(kind)]
    out += [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(3)]
    ovf = torch.empty(n, dtype=torch.bool, device=dev)
    caps = torch.empty(n, dtype=torch.int32, device=dev)
    lines = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return (*out, ovf)
    K, LM, SM = cfg.num_colours, cfg.lines_max, cfg.stack_max
    lib = cuda_build.library("specials_trip", dev, (R, C))
    bytes_ = _scratch_bytes(lib, dev, R, C, K, LM, SM)
    scratch = None if bytes_ == 0 else torch.empty(n * bytes_, dtype=torch.uint8, device=dev)
    cuda_build.launch(
        "tmt_specials_trip", dev, (R, C), colour.data_ptr(), kind.data_ptr(), sub.data_ptr(),
        trips.data_ptr(), *(t.data_ptr() for t in out), ovf.data_ptr(), caps.data_ptr(),
        lines.data_ptr(), None if scratch is None else scratch.data_ptr(),
        n, R, C, K, LM, SM, int(cfg.cookie), int(cfg.vertical_laser), int(cfg.horizontal_laser),
        int(cfg.bomb),
    )
    if cfg.debug_checks:
        raise_caps(cfg, caps.cpu(), lines.cpu())
    return (*out, ovf)
