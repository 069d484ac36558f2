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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

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


def check_fits(lib: ctypes.CDLL, name: str, R: int, C: int, kernel: str) -> None:
    """Raise ValueError, with the sizes, if an R x C board is beyond what
    kernel ``name`` of ``lib`` takes on the current device: its shared
    memory (``tmt_<name>_smem``) over the block's opt-in limit, or more
    cells than a 16-bit cell index holds."""
    smem = getattr(lib, f"tmt_{name}_smem")
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    smem.restype = ctypes.c_longlong
    lib.tmt_smem_optin.argtypes = []
    lib.tmt_smem_optin.restype = ctypes.c_int
    need, limit = smem(R, C), lib.tmt_smem_optin()
    if need > limit or R * C > 65535:
        raise ValueError(
            f"{kernel}: a {R}x{C} board ({R * C} cells) needs {need} bytes of shared memory "
            f"a block; the card allows {limit} bytes and at most 65535 cells"
        )


def build_all(libs) -> None:
    """Build several libraries at once, one ``nvcc`` process each: each
    item a source name, or (name, shape); an item named twice is built
    once."""
    libs = [(lib, None) if isinstance(lib, str) else tuple(lib) for lib in libs]
    libs = list(dict.fromkeys((name, _shape(name, shape)) for name, shape in libs))
    with ThreadPoolExecutor(max_workers=max(1, len(libs))) as pool:
        for _ in pool.map(lambda lib: build(*lib), libs):
            pass
