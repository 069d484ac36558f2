"""The system under test, as the harness drives it, and the control.

``PortProgram`` is the port (``tile_match_tpu_torch``): its batched,
auto-resetting step (``envs.batched.batched_step`` with the previous
step's mask), its policy draw (``envs.batched.random_effective``, keyed as
``envs.batched.rollout`` keys it: ``key, ka = split(key)`` each step) and
its reset.  The port is imported inside the methods, never at import time:
the benchmark's other modules and its reference load without it.

``ReferenceProgram`` puts the benchmark's plain reference in the port's
place.  With ``draw="philox"`` it is the control: every action is drawn
from torch's Philox generator seeded from the run's seed, not from the
threefry key, which breaks the configurations' first guarantee (the same
seed gives the same actions as ``jax.random``), the step a later change
would be tempted to take to save the threefry draw's launches.

A program's ``outputs(states, ts)`` are what the harness records and the
check compares: the observed board int32[B, 2, R, C], moves left int32[B],
each board's key int64[B, 2], reward float32[B], done bool[B] and the next
effective-action mask bool[B, A], with ``truncated`` bool[B] for the
failed count.
"""

from __future__ import annotations

import torch


def game_args(config: dict) -> tuple:
    """(rows, cols, colours, moves) and the special lists of a
    configuration file."""
    return ((config["num_rows"], config["num_cols"], config["num_colours"], config["num_moves"]),
            dict(colourless_specials=tuple(config["colourless_specials"]),
                 colour_specials=tuple(config["colour_specials"])))


class PortProgram:
    def __init__(self, config: dict, device, seed: int):
        from tile_match_tpu_torch.config import EnvConfig

        sizes, specials = game_args(config)
        self.cfg = EnvConfig.create(*sizes, **specials)
        self.device = device

    def build(self) -> None:
        """Build every CUDA source of the program for this board shape, in
        parallel, into the program's build directory (inside the
        checkout); a later run finds them built."""
        if self.device.type != "cuda":
            return
        from tile_match_tpu_torch import cuda_build

        shape = cuda_build.shape_of(self.cfg.num_rows, self.cfg.num_cols)
        cuda_build.build_all([(p.stem, shape) for p in sorted(cuda_build.CSRC.glob("*.cu"))])

    def split(self, key):
        from tile_match_tpu_torch import random as trandom

        both = trandom.split(key)
        return both[0], both[1]

    def reset(self, key, batch: int):
        from tile_match_tpu_torch.envs.batched import batched_reset

        return batched_reset(self.cfg, key, batch)

    def draw(self, key, ts):
        from tile_match_tpu_torch.envs.batched import random_effective

        return random_effective(key, ts)

    def step(self, states, ts, actions):
        from tile_match_tpu_torch.envs.batched import batched_step

        return batched_step(self.cfg, states, actions, auto_reset=True,
                            eff_mask=ts.info.effective_actions)

    @staticmethod
    def outputs(states, ts) -> dict:
        return {"board": ts.obs_board, "moves_left": ts.obs_moves_left, "key": states.key,
                "reward": ts.reward, "done": ts.done, "mask": ts.info.effective_actions,
                "truncated": ts.info.truncated}

    @staticmethod
    def counters() -> dict:
        """The program's own counters the per-layer metrics read."""
        from tile_match_tpu_torch import engine

        return {"cascade_rounds": engine.cascade_stats["rounds"]}


class ReferenceProgram:
    """The plain reference in the program's place (see the module's
    docstring); ``draw`` is ``"threefry"`` or ``"philox"``."""

    def __init__(self, config: dict, device, seed: int, draw: str = "threefry"):
        from .reference.config import EnvConfig

        sizes, specials = game_args(config)
        self.cfg = EnvConfig.create(*sizes, **specials)
        self.device = device
        self.draw_kind = draw
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed & ((1 << 63) - 1))

    def build(self) -> None:
        pass

    def split(self, key):
        from .reference import random as rrandom

        both = rrandom.split(key)
        return both[0], both[1]

    def reset(self, key, batch: int):
        from .reference import engine, random as rrandom

        states, mask, gave_up = engine.reset(self.cfg, rrandom.split(key, batch))
        zero = torch.zeros(batch, device=key.device)
        return states, {"mask": mask, "reward": zero, "done": zero.bool(), "truncated": gave_up}

    def draw(self, key, ts):
        from .reference import random as rrandom

        mask = ts["mask"]
        if self.draw_kind == "philox":
            scores = torch.rand(mask.shape, generator=self.gen, device=mask.device)
            return torch.where(mask, scores, -1.0).argmax(-1).to(torch.int32)
        rows = torch.arange(mask.shape[0], device=mask.device)
        return rrandom.masked_categorical_rows(key.expand(mask.shape[0], 2), mask, rows)

    def step(self, states, ts, actions):
        from .reference import engine

        return engine.step(self.cfg, states, actions, ts["mask"])

    def outputs(self, states, ts) -> dict:
        return {"board": torch.stack([states.colour, states.kind], dim=1),
                "moves_left": self.cfg.num_moves - states.timer, "key": states.key,
                "reward": ts["reward"].to(torch.float32), "done": ts["done"], "mask": ts["mask"],
                "truncated": ts["truncated"]}

    @staticmethod
    def counters() -> dict:
        return {}
