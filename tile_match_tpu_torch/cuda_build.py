"""Build the package's CUDA sources with nvcc at first use and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface, is compiled for
Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so`` — the hash is of the
source, of every ``csrc/*.cuh`` header it includes (directly or through
another header) and of the flags, so an edited source or shared header is
rebuilt — and is loaded with ``ctypes``.  ``build_all`` compiles several
sources at once, one ``nvcc`` each.  Nothing here runs at import time: the
CPU-only test machines import every module but never build.
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


def digest(name: str) -> str:
    """Hash of the flags, ``csrc/<name>.cu`` and every header it includes."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sorted(sources(name)):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:12]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}-{digest(name)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
    build_logs[name] = proc.stdout + proc.stderr
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib


def build_all(names) -> None:
    """Build several sources at once, one ``nvcc`` process each."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        for _ in pool.map(build, names):
            pass
