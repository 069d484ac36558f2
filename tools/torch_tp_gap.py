#!/usr/bin/env python3
"""How far the sharded train step's tp split moves the learner, and why.

    python tools/torch_tp_gap.py [--device cuda|cpu]

Runs ``chip_smoke.py``'s phase-18 trainer (config 1, B=256, hidden 512,
epsilon 1, the seeded weights and recorded keys, two steps) four ways,
every rank over gloo on the one device:

* ``(1, 1)``: one rank, the whole network;
* ``(1, 2)``: two ranks, the network split over tp;
* ``halves``: one rank whose network does ``(1, 2)``'s arithmetic with no
  collective: dense1 as its two row halves, dense2 as the float32
  products of its two column halves summed, its bias added once;
* ``dense2 halves``: ``halves`` with dense1 whole, so only dense2's
  product is split.

For each pair and leaf it reports the relative norm gap of the step-1
gradient (Adam's first moment after step 1, over 1 - beta1), the number
of entries whose step-1 gradient has the other sign (Adam moves an entry
by about lr times that sign at first), and the gap of the change from
the seeded start after the two steps.  If ``halves`` equals ``(1, 2)``
and lies as far from ``(1, 1)`` as ``(1, 2)`` does, the gap is the order
of the split's arithmetic, not the collective; ``dense2 halves`` says
which layer's split it comes from.  Prints one JSON line
with the device's name (and the card's power limit).  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE]  # also in the spawned ranks, which import this file

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke  # noqa: E402
from tile_match_tpu_torch.models import dqn  # noqa: E402
from tile_match_tpu_torch.parallel import launch, make_mesh  # noqa: E402

BETA1 = 0.9


class HalvesQNetwork(dqn.QNetwork):
    """``QNetwork`` doing tp = 2's arithmetic in one process: each half's
    products on the shapes a tp rank has, the two dense2 partial sums
    added in float32, the bias once, one bfloat16 rounding.  With
    ``split_dense1`` False, dense1 is the whole layer's product."""

    split_dense1 = True

    def forward(self, board_planes: torch.Tensor, moves_left: torch.Tensor) -> torch.Tensor:
        bf16 = torch.bfloat16
        feats = dqn._features(board_planes, moves_left).to(bf16)
        d1, d2 = self.dense1, self.dense2
        h = d1.weight.shape[0] // 2
        y = 0
        whole = None if self.split_dense1 else F.relu(d1(feats))
        for t in range(2):
            rows = slice(t * h, (t + 1) * h)
            if whole is None:
                x = F.relu(F.linear(feats, d1.weight[rows].to(bf16), d1.bias[rows].to(bf16)))
            else:
                x = whole[:, rows]
            w = d2.weight[:, rows].contiguous().to(bf16)
            y = y + F.linear(x.float(), w.float())
        x = F.relu((y + d2.bias.to(bf16).float()).to(bf16))
        return self.head(x)


class Dense2HalvesQNetwork(HalvesQNetwork):
    split_dense1 = False


def rank(variant: str, device_type: str) -> dict:
    """In each rank: the two steps; this rank's step-1 gradient and
    weights after step 2 (numpy), by name."""
    import torch.distributed as dist

    if variant != "whole":  # make_dqn's network in this process
        dqn.QNetwork = {"halves": HalvesQNetwork, "dense2 halves": Dense2HalvesQNetwork}[variant]
    tp = dist.get_world_size()
    mesh = make_mesh([device_type] * tp, dp=1, tp=tp)
    state, step, keys, _ = chip_smoke._sharded_trainer(mesh, chip_smoke._fixture_tool())
    grads = None
    for k in keys[1:]:
        state, _ = step(state, k)
        if grads is None:
            opt = state.opt_state
            grads = {n: opt.state[p]["exp_avg"].cpu().numpy() / (1 - BETA1)
                     for n, p in state.params.named_parameters()}
    params = {n: v.detach().cpu().numpy() for n, v in state.params.state_dict().items()}
    return {"grads": grads, "params": params, "tp_rank": mesh.get_local_rank("tp")}


def _whole(outs: list) -> dict:
    outs = sorted(outs, key=lambda o: o["tp_rank"])
    return {k: chip_smoke._whole_params([o[k] for o in outs]) for k in ("grads", "params")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("torch_tp_gap: needs a CUDA card (or --device cpu)", file=sys.stderr)
            return 1
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
    else:
        smi = "cpu"
    runs = {
        "(1, 1)": _whole(launch(1, rank, "whole", args.device, backend="gloo", timeout=600)),
        "(1, 2)": _whole(launch(2, rank, "whole", args.device, backend="gloo", timeout=600)),
    }
    for variant in ("halves", "dense2 halves"):
        runs[variant] = _whole(launch(1, rank, variant, args.device, backend="gloo", timeout=600))
    f = chip_smoke._fixture_tool()
    ref = runs["(1, 1)"]["params"]
    seeded = f.port_leaves(f.seeded_qnet_params(ref["dense1.weight"].shape[1], f.DQN_HIDDEN,
                                                ref["head.weight"].shape[0], f.QNET_SEED))
    pairs = {}
    for a, b in (("(1, 2)", "(1, 1)"), ("halves", "(1, 1)"), ("halves", "(1, 2)"),
                 ("dense2 halves", "(1, 1)"), ("dense2 halves", "(1, 2)")):
        ga, gb = runs[a]["grads"], runs[b]["grads"]
        pa, pb = runs[a]["params"], runs[b]["params"]
        pairs[f"{a} vs {b}"] = {
            "equal": all(np.array_equal(pa[n], pb[n]) for n in pb),
            "leaves": {n: {
                "entries": int(pb[n].size),
                "grad_gap": chip_smoke._rel_gap(ga[n], gb[n]),
                "sign_flips": int((np.sign(ga[n]) != np.sign(gb[n])).sum()),
                "change_gap": chip_smoke._rel_gap(pa[n] - seeded[n], pb[n] - seeded[n]),
            } for n in pb},
        }
    print(json.dumps({"smi": smi, "device": args.device, "pairs": pairs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
