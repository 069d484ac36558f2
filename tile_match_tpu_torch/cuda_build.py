"""Build the package's CUDA sources with nvcc at first use and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface, is compiled for
Hopper (``sm_90a``) into ``_build/lib<name>[-RxC]-<hash>.so`` — the hash is
of the source, of every ``csrc/*.cuh`` header it includes (directly or
through another header) and of the flags, so an edited source or shared
header is rebuilt — and is loaded with ``ctypes``.  The kernels (K1 to
K5) take their board shape at compile time: a library is built for each
board shape of at most 32 by 32 that runs (``-DTMT_ROWS=R -DTMT_COLS=C``),
and one without a shape serves every larger board (``shape_of``).  A
source that reads no board shape (``takes_shape``: the threefry words and
the line test) is built once, without one, whatever shape it is asked
for.
``build_all`` compiles several libraries at once, one ``nvcc`` each.
Nothing here runs at import time: the CPU-only test machines import every
module but never build.

This module is also the kernel wrappers' one seam to ``csrc/``.
``KERNELS`` is the table of the port's kernels: each one's source, its
device name in a profile, its C entry points with their argument types,
and its shared-memory fit function.  Every reader of which kernels the
port has reads it.  ``on_card`` is the device route of every wrapper (a
CUDA tensor launches the kernel, a CPU tensor runs the plain version).
``check_inputs`` and ``check_fits`` are the wrappers' input and size
checks.  ``launch`` binds an entry once per board shape and card, calls it
on the current stream, raises on an error and counts the launch in
``launches``, the one mapping of launch counts by kernel name.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
    "-I", str(CSRC),
)
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)

_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # compiler output (ptxas resource use) per source


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every ``csrc`` header it includes, directly or
    through another header."""
    todo = [CSRC / f"{name}.cu"]
    seen: list[Path] = []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            if (CSRC / inc).exists():
                todo.append(CSRC / inc)
    return seen


def takes_shape(name: str) -> bool:
    """Whether ``csrc/<name>.cu`` or a header it includes reads the board
    shape it is compiled for (``TMT_ROWS``)."""
    return any("TMT_ROWS" in path.read_text() for path in sources(name))


def _shape(name: str, shape):
    return shape if shape is not None and takes_shape(name) else None


def shape_of(R: int, C: int):
    """The board shape the kernels' library for an R x C board is built
    for: (R, C) when both are at most 32, else None (the library whose
    geometry is read at run time)."""
    return (R, C) if R <= 32 and C <= 32 else None


def _flags(shape) -> tuple:
    if shape is None:
        return NVCC_FLAGS
    return (*NVCC_FLAGS, f"-DTMT_ROWS={shape[0]}", f"-DTMT_COLS={shape[1]}")


def _stem(name: str, shape) -> str:
    return name if shape is None else f"{name}-{shape[0]}x{shape[1]}"


def digest(name: str, shape=None) -> str:
    """Hash of the flags (with the board shape, if any), ``csrc/<name>.cu``
    and every header it includes."""
    shape = _shape(name, shape)
    h = hashlib.sha1(" ".join(_flags(shape)).encode())
    for path in sorted(sources(name)):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:12]


def build(name: str, shape=None) -> Path:
    """Compile ``csrc/<name>.cu`` (for board shape ``shape`` = (R, C), or
    for any) unless an up-to-date library exists."""
    shape = _shape(name, shape)
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{_stem(name, shape)}-{digest(name, shape)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *_flags(shape), "-o", str(tmp), str(src)],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
    build_logs[_stem(name, shape)] = proc.stdout + proc.stderr
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out


def load(name: str, shape=None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` for board shape ``shape``
    (or for any), built if needed."""
    shape = _shape(name, shape)
    stem = _stem(name, shape)
    lib = _loaded.get(stem)
    if lib is None:
        lib = ctypes.CDLL(str(build(name, shape)))
        _loaded[stem] = lib
    return lib


def ptxas_summary(log: str) -> list:
    """[kernel instance (its board shape "RxC", or "any" for the geometry
    read at run time, and its warps a board if it takes them, or K5's
    words of a board's bit plane a lane and where its scratch lies),
    registers, spill stores, spill loads] for each kernel in nvcc's
    ``-Xptxas=-v`` output."""
    out, shape, spill = [], "?", [0, 0]
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"LinesILi(\d+)ELi(\d+)EEE(?:Li(\d+)E)?(?:Lb([01])E)?", ln)
            shape = (f"{m[1]}x{m[2]}" if m[1] != "0" else "any") if m else "any"
            if m and m[4]:
                shape += f" {m[3]} words a lane, scratch in {'shared' if m[4] == '1' else 'device'} memory"
            elif m and m[3]:
                shape += f" {m[3]} warps"
        elif "spill stores" in ln:
            spill = [int(v) for v in re.findall(r"(\d+) bytes spill", ln)]
        elif "Used" in ln and "registers" in ln:
            out.append([shape, int(re.search(r"Used (\d+) registers", ln)[1]), *spill])
    return out


def build_all(libs) -> None:
    """Build several libraries at once, one ``nvcc`` process each: each
    item a source name, or (name, shape); an item named twice is built
    once."""
    libs = [(lib, None) if isinstance(lib, str) else tuple(lib) for lib in libs]
    libs = list(dict.fromkeys((name, _shape(name, shape)) for name, shape in libs))
    with ThreadPoolExecutor(max_workers=max(1, len(libs))) as pool:
        for _ in pool.map(lambda lib: build(*lib), libs):
            pass


# ---- the entry points and the launch path --------------------------------------

_P, _I, _L, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A hand-written kernel of the port: its source ``csrc/<source>.cu``;
    ``device_name``, a substring of the name a profile gives its device
    kernel; ``entries``, its C entry points, each symbol with the ctypes of
    its arguments but the last, the stream it launches on (each returns a
    cudaError_t, and its host build's ``<symbol>_host`` twin takes the same
    arguments but the stream); ``smem``, where a board lies in a block's
    shared memory, the C function (R, C) -> the bytes a block needs."""

    source: str
    device_name: str
    entries: dict
    smem: str | None = None


# The port's kernels, by the name their launches are counted under.
KERNELS = {
    "fused_cascade": Kernel("cascade", "cascade_kernel",
                            {"tmt_fused_cascade": (_P,) * 7 + (_I,) * 5}, "tmt_fused_cascade_smem"),
    "cascade_sp_chunk": Kernel("cascade_sp", "cascade_sp_kernel",
                               {"tmt_cascade_sp": (_P,) * 15 + (_I,) * 10},
                               "tmt_cascade_sp_chunk_smem"),
    "settled_mask_sp": Kernel("mask_sp", "mask_sp_kernel",
                              {"tmt_settled_mask_sp": (_P,) * 3 + (_I,) * 4},
                              "tmt_settled_mask_sp_smem"),
    # K4 and K5 put a board's scratch in device memory where it overflows a block
    "specials_trip": Kernel("trip_sp", "specials_trip_kernel",
                            {"tmt_specials_trip": (_P,) * 13 + (_I,) * 10}),
    "combination_trip": Kernel("combination", "combination_trip_kernel",
                               {"tmt_combination_trip": (_P,) * 13 + (_I,) * 8}),
    "threefry_words": Kernel("threefry_words", "threefry_", {
        "tmt_threefry_words": (_P, _L, _L, _L, _U, _I, _P),
        "tmt_threefry_uniform": (_P, _L, _L, _L, _U, ctypes.c_float, ctypes.c_double,
                                 ctypes.c_double, _P),
        "tmt_threefry_fold_in": (_P, _L, _P, _L, _I, _U, _L, _P),
        "tmt_threefry_randint": (_P, _L, _L, _L, _U, _L, _P),
    }),
    "line_test": Kernel("line_test", "line_test_", {"tmt_line_test_member": (_P, _P, _I, _I, _I),
                                                    "tmt_line_test_any": (_P, _P, _I, _I, _I)}),
}
# entry point -> (its kernel's name, its arguments' ctypes but the stream)
ENTRIES = {symbol: (name, args)
           for name, k in KERNELS.items() for symbol, args in k.entries.items()}
MAX_CELLS = 65535  # every board kernel holds a cell index in 16 bits

# Each kernel's launches so far, by name; a run reads the difference.
launches = dict.fromkeys(KERNELS, 0)

# The tests' host seam (tests/torch_port_helpers.py): kernel name -> a
# function (source, board) -> that source's library built for the host.  A
# kernel named here launches its host twins on CPU tensors.
_host: dict = {}


def resolve_device(device) -> torch.device:
    """The device of a Gym entry point: the card unless the caller names
    another.  Raises when no card is there; nothing falls back."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def on_card(name: str, t: torch.Tensor) -> bool:
    """Whether kernel ``name``'s wrapper, called on ``t``, launches the
    kernel (a CUDA tensor) or runs its plain version (a CPU tensor); any
    other device raises."""
    kind = t.device.type
    if kind == "cuda":
        return True
    if kind == "cpu":
        return name in _host
    raise ValueError(f"{name}: unsupported device {t.device}")


def check_fits(name: str, R: int, C: int, need: int = 0, limit: int = 0) -> None:
    """Raise ValueError, with the sizes, for an R x C board that kernel
    ``name`` does not take: more cells than its 16-bit cell indices hold, or
    ``need`` bytes of shared memory a block above the card's opt-in
    ``limit``."""
    if R < 1 or C < 1 or R * C > MAX_CELLS:
        raise ValueError(f"{name}: a {R}x{C} board ({R * C} cells) is beyond the kernel's "
                         f"{MAX_CELLS} cells")
    if need > limit:
        raise ValueError(f"{name}: a {R}x{C} board needs {need} bytes of shared memory a block; "
                         f"the card allows {limit} bytes")


def check_inputs(name: str, cfg, specs) -> None:
    """Raise ValueError where a launch of kernel ``name`` would read what it
    does not take: boards (the first spec's tensor, [B, R, C]) of another
    shape than ``cfg``'s or beyond ``check_fits``'s cells, or a tensor of
    ``specs`` [(argument, tensor, dtype, shape)] of another dtype or shape,
    not contiguous, or off the boards' device."""
    _, R, C = specs[0][1].shape
    if (R, C) != (cfg.num_rows, cfg.num_cols):
        raise ValueError(f"board shape {(R, C)} does not match the config")
    check_fits(name, R, C)
    device = specs[0][1].device
    for arg, t, dtype, shape in specs:
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != device
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {arg} must be a contiguous {dtype}{list(shape)} tensor "
                             f"on {device}")


def library(name: str, device: torch.device, board=None) -> ctypes.CDLL:
    """The library a launch of kernel ``name`` on ``device`` runs, for an R
    x C ``board`` (None: a source that reads no board shape): the card's,
    or on the CPU the host build of the tests' seam."""
    if device.type == "cpu":
        return _host[name](KERNELS[name].source, board)
    return _card_library(name, board)


@functools.lru_cache(maxsize=None)
def _card_library(name: str, board) -> ctypes.CDLL:
    return load(KERNELS[name].source, None if board is None else shape_of(*board))


def c_function(lib: ctypes.CDLL, symbol: str, argtypes, restype=ctypes.c_int):
    """C function ``symbol`` of ``lib``, typed."""
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def smem_optin(lib: ctypes.CDLL, device: torch.device) -> int:
    """The shared memory one block may opt in to on ``device`` (``lib``'s
    ``tmt_smem_optin``), in bytes; 0 on the CPU, whose host builds have
    none."""
    if device.type != "cuda":
        return 0
    with torch.cuda.device(device):
        return c_function(lib, "tmt_smem_optin", ())()


@functools.lru_cache(maxsize=None)
def _card_entry(symbol: str, board, index: int):
    """Entry point ``symbol`` of its library for ``board`` on card
    ``index``, typed with the stream last, after its kernel's fit check:
    once per entry, board and card."""
    name, args = ENTRIES[symbol]
    device = torch.device("cuda", index)
    lib = library(name, device, board)
    smem = KERNELS[name].smem
    if smem is not None:
        need = c_function(lib, smem, (_I, _I), _L)(*board)
        check_fits(name, *board, need, smem_optin(lib, device))
    return c_function(lib, symbol, (*args, _P))


def launch(symbol: str, device: torch.device, board, *args) -> None:
    """Launch C entry point ``symbol`` with ``args`` on ``device``'s current
    stream (passed last), for an R x C ``board`` (None: a source that reads
    no board shape), and count the launch under its kernel; raise
    RuntimeError, naming the entry and the code, where it returned an
    error.  On the CPU the entry's host twin runs, with no stream."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            err = _card_entry(symbol, board, device.index)(
                *args, torch.cuda.current_stream(device).cuda_stream)
    else:
        name, argtypes = ENTRIES[symbol]
        err = c_function(library(name, device, board), f"{symbol}_host", argtypes)(*args)
    if err != 0:
        raise RuntimeError(f"{symbol}: launch failed with error {err}")
    launches[ENTRIES[symbol][0]] += 1
