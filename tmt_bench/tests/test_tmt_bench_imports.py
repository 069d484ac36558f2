"""What the benchmark imports: no JAX and no JAX package anywhere, and
nothing of the program in its reference, by whole top-level names."""

from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys

import pytest

from tmt_bench import manifest
from tmt_bench.run import FORBIDDEN, forbidden_modules

BENCH_DIR = pathlib.Path(manifest.ROOT) / "tmt_bench"
FILES = sorted(p for p in BENCH_DIR.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: pathlib.Path) -> set:
    """Top-level names of the absolute imports of a file; relative imports
    as ``.``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." if node.level else node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & set(FORBIDDEN), path


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", ".", "torch", "numpy", "dataclasses",
                                       "functools", "math", "typing"}, path


def test_the_program_is_not_the_jax_package(monkeypatch):
    """Compared whole: the port's name begins with the JAX package's."""
    import tile_match_tpu_torch.envs.batched  # noqa: F401

    before = forbidden_modules()
    assert "tile_match_tpu" not in before
    monkeypatch.setitem(sys.modules, "tile_match_tpu.engine", sys.modules["tile_match_tpu_torch.engine"])
    assert forbidden_modules() == sorted(set(before) | {"tile_match_tpu"})


def test_a_run_on_the_cpu_loads_no_jax():
    """The harness, the program and the reference through a tiny run, in a
    process of their own: no JAX module is loaded afterwards."""
    code = (
        "import sys, time, torch\n"
        "from tmt_bench import harness\n"
        "from tmt_bench.program import PortProgram\n"
        "from tmt_bench.tests.helpers import tiny_cell\n"
        "cell = tiny_cell('c1_rollout_b256')\n"
        "cell['traffic']['warmup_episodes'] = 0\n"
        "res = harness.run_cell(cell, 5, 0, False, torch.device('cpu'), PortProgram, time.time(),"
        " max_steps=2, check_boards=4, check_chunk=64)\n"
        "from tmt_bench.run import forbidden_modules\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax')),"
        " forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[] []"
