"""Driver entry points (counterparts of ``__graft_entry__``).

``entry()``: forward step of the flagship pipeline, one batched env step
fused with the DQN Q-network forward on the resulting observations.

``dryrun_multichip(n)``: the sharded rollout and one sharded DQN train step
over n ranks, on tiny shapes.

    python -m tile_match_tpu_torch.entry [--device cpu] [--dryrun-multichip N]

``entry()`` builds the reference's inputs — ``EnvConfig(10, 10, 4, 30)``
(every special on, as the config's defaults have it), 64 boards reset from
key 0, a hidden-512 ``QNetwork`` drawn from key 1 — and returns
``(forward, (net, states, actions))``; ``forward`` returns
``(q, reward, next_states)``.
"""

from __future__ import annotations

import argparse
import math

import torch

from . import random as trandom
from .config import EnvConfig
from .cuda_build import resolve_device
from .envs.batched import batched_reset, batched_step
from .models.dqn import QNetwork, _encode, init_params, input_size
from .parallel import gather_boards, launch, make_mesh, sharded_rollout, sharded_train_step
from .parallel.distributed import default_backend
from .parallel.sharding import mesh_device


def entry(device=None):
    device = resolve_device(device)
    cfg = EnvConfig(10, 10, 4, 30)
    B = 64
    states, _ = batched_reset(cfg, trandom.PRNGKey(0, device), B)
    net = QNetwork(cfg.num_actions, hidden=512, in_features=input_size(cfg), device=device)
    init_params(net, trandom.PRNGKey(1, device))

    @torch.no_grad()
    def forward(net, states, actions):
        next_states, ts = batched_step(cfg, states, actions)
        planes, moves = _encode(cfg, next_states)
        q = net(planes, moves)
        return q, ts.reward, next_states

    actions = torch.zeros((B,), dtype=torch.int32, device=device)
    return forward, (net, states, actions)


def _dryrun_rank(n: int, device_type: str) -> None:
    """``dryrun_multichip``'s checks on one of its ranks."""
    tp = 2 if n % 2 == 0 and n >= 2 else 1
    devices = [device_type] * n
    mesh = make_mesh(devices, dp=n // tp, tp=tp)
    # every rank builds the one-rank mesh; rank 0 alone is in it
    mesh1 = make_mesh(devices[:1], dp=1, tp=1)
    device = mesh_device(mesh)

    cfg = EnvConfig(5, 5, 3, 4)  # tiny shapes; every special on
    batch = 4 * n

    # Correctness, not just liveness: sharding over the full mesh must not
    # change rollout semantics: the same key gives identical per-board
    # rewards and final states to the one-rank mesh's.
    s_n, rew_n, _ = sharded_rollout(cfg, mesh, batch, 4)(trandom.PRNGKey(7, device))
    s_n, rew_n = gather_boards(s_n, mesh), gather_boards(rew_n, mesh)
    if mesh1.get_coordinate() is not None:
        s_1, rew_1, _ = sharded_rollout(cfg, mesh1, batch, 4)(trandom.PRNGKey(7, device))
        if not torch.equal(rew_n, rew_1):
            raise RuntimeError(
                "sharded rollout diverges: per-board rewards differ between the "
                f"dp={n // tp} mesh and the single-rank mesh"
            )
        for f in ("colour", "kind", "timer", "key"):
            if not torch.equal(getattr(s_n, f), getattr(s_1, f)):
                raise RuntimeError(
                    f"sharded rollout diverges: final EnvState {f} differs between the "
                    "dp mesh and the single-rank mesh"
                )

    init, step = sharded_train_step(cfg, mesh, make_dqn_kwargs=dict(batch_size=batch, hidden=256))
    state = init(trandom.PRNGKey(0, device))
    state, metrics = step(state, trandom.PRNGKey(1, device))
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise RuntimeError(f"sharded train step: loss {loss}")


def dryrun_multichip(n_devices: int, device=None, timeout: float = 600.0) -> None:
    """The sharded rollout and one sharded DQN train step over ``n_devices``
    ranks spawned by ``parallel.launch`` (tp = 2 when n is even): on
    ``EnvConfig(5, 5, 3, 4)`` at batch 4n, the (n/tp, tp) mesh and a
    one-rank mesh give equal per-board rewards and final states, and the
    train step (hidden 256) a finite loss.  On the card (``device=None``)
    the ranks use NCCL when there is a card for each, else share the
    cards over gloo; on the CPU, gloo.  Raises on the first failed check."""
    device = resolve_device(device)
    launch(n_devices, _dryrun_rank, n_devices, device.type,
           backend=default_backend(n_devices, device.type), timeout=timeout)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    parser.add_argument("--dryrun-multichip", type=int, default=0, metavar="N",
                        help="run dryrun_multichip over N ranks instead")
    args = parser.parse_args()
    if args.dryrun_multichip:
        dryrun_multichip(args.dryrun_multichip, args.device)
        print(f"dryrun_multichip({args.dryrun_multichip}) OK")
        return
    fn, fn_args = entry(args.device)
    q, reward, _ = fn(*fn_args)
    print("entry OK:", tuple(q.shape), tuple(reward.shape))


if __name__ == "__main__":
    main()
