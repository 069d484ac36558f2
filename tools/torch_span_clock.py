"""The program spans' clock against the card's, on the card.

    python tools/torch_span_clock.py [--workload c3_rollout_b16384] [--seed N] [--seconds 5]

Runs one traced run of a benchmark cell in this process
(``tmt_bench.harness.run_cell``, as ``tmt_bench/run.py --trace 1`` runs it)
and, for each kernel wrapper, pairs the n-th span of the wrapper's name in
the profiled episode with the n-th kernel of its device name.  A span's
times are ``time.time_ns()`` and the profile's are kineto's; if they share
a base, no kernel starts on the device before the call that launched it.
Prints one JSON line a wrapper: the pairs, the largest lead (how far a
kernel started before its span; negative when none did) and the median lag
(kernel start after span start), in us; then the card.  Exits 1 when the
counts differ or a lead passes 50 us.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the kernels whose wrapper's span bears the kernel's name and covers the
# whole call (K1-K5)
WRAPPED = ("cascade_sp_chunk", "specials_trip", "settled_mask_sp", "combination_trip",
           "fused_cascade")
LEAD_LIMIT_US = 50.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="c3_rollout_b16384")
    ap.add_argument("--seed", type=int, default=2**31 + 101)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)

    import torch

    from tile_match_tpu_torch import cuda_build, profiling
    from tmt_bench import check, harness, manifest
    from tmt_bench.program import PortProgram
    from tmt_bench.run import card_line

    if not torch.cuda.is_available():
        print("torch_span_clock: needs a CUDA card", file=sys.stderr)
        return 1
    cell = manifest.cell(manifest.load(), args.workload)
    profiling.clear_spans()
    res = harness.run_cell(cell, args.seed, args.seconds, True, torch.device("cuda", 0),
                           PortProgram, time.time())
    ops = res["profile"]["ops"]
    ok = True
    for wrapper in WRAPPED:
        kernel = cuda_build.KERNELS[wrapper].device_name
        spans = [s for s in profiling.spans() if s.name == wrapper]
        starts = sorted(s for n, s, _ in ops if kernel in n)
        if not spans and not starts:
            continue
        out = {"wrapper": wrapper, "kernel": kernel, "spans": len(spans), "kernels": len(starts)}
        if len(spans) != len(starts):
            ok = False
        else:
            lags = [k - s.start_ns / 1e3 for s, k in zip(spans, starts)]
            out.update(lead_max_us=-min(lags), lag_median_us=statistics.median(lags),
                       lag_max_us=max(lags))
            ok &= out["lead_max_us"] <= LEAD_LIMIT_US
        print(json.dumps(out))
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "correct": check.passed(res["checks"]), "card": card_line(),
                      "torch": torch.__version__}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
