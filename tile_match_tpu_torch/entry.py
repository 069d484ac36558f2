"""Forward step of the flagship pipeline (counterpart of
``__graft_entry__.entry``): one batched env step fused with the DQN
Q-network forward on the resulting observations.

    python -m tile_match_tpu_torch.entry [--device cpu]

``entry()`` builds the reference's inputs — ``EnvConfig(10, 10, 4, 30)``
(every special on, as the config's defaults have it), 64 boards reset from
key 0, a hidden-512 ``QNetwork`` drawn from key 1 — and returns
``(forward, (net, states, actions))``; ``forward`` returns
``(q, reward, next_states)``.
"""

from __future__ import annotations

import argparse

import torch

from . import random as trandom
from .config import EnvConfig
from .envs.batched import batched_reset, batched_step
from .models.dqn import QNetwork, _encode, init_params, input_size
from .parity import resolve_device


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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = parser.parse_args()
    fn, fn_args = entry(args.device)
    q, reward, _ = fn(*fn_args)
    print("entry OK:", tuple(q.shape), tuple(reward.shape))


if __name__ == "__main__":
    main()
