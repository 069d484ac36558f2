#!/usr/bin/env python3
"""Count the SASS opcodes of each kernel instance in the port's kernel
libraries, for the port package of one or more checkouts.

    python tools/torch_kernel_sass.py ROOT [ROOT ...]

For each ROOT (the root of a checkout whose ``tile_match_tpu_torch`` is
imported and built), builds K1 (``csrc/cascade.cu``), K2
(``csrc/cascade_sp.cu``) and K3 (``csrc/mask_sp.cu``) for 10x10 boards,
disassembles them with ``cuobjdump -sass`` (beside ``nvcc``) and prints,
for every kernel instance, its instruction count and the counts of a few
opcodes: shared (``LDS``/``STS``), generic (``LD``/``ST``) and local
(``LDL``/``STL``) memory instructions among them.  A pointer whose shared address space the
compiler has lost turns its shared loads into generic ones.  Needs a CUDA
toolkit; imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys

OPS = ("LDS", "STS", "LD", "ST", "LDL", "STL", "IMAD", "IADD3", "LEA", "SHF", "LOP3", "ISETP",
       "SEL", "VOTE", "BRA", "POPC", "FLO", "BAR", "WARPSYNC", "SHFL", "REDUX", "MOV")


def histograms(sass: str) -> dict:
    """{kernel instance: Counter of opcodes} of cuobjdump's SASS listing."""
    out, hist = {}, None
    for ln in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            hist = out.setdefault(m[1], collections.Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", ln)
        if m and hist is not None:
            hist[m[2].split(".")[0]] += 1
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args()
    for root in args.roots:
        sys.path.insert(0, os.path.abspath(root))
        for name in [m for m in sys.modules if m.startswith("tile_match_tpu_torch")]:
            del sys.modules[name]
        from tile_match_tpu_torch import cuda_build

        cuobjdump = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
        for src in ("cascade", "cascade_sp", "mask_sp"):
            lib = cuda_build.build(src, (10, 10))
            sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                                  check=True).stdout
            for fn, hist in histograms(sass).items():
                counts = {op: hist.get(op, 0) for op in OPS}
                print(f"{root}:{fn} total {sum(hist.values())} {counts}")
        sys.path.pop(0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
