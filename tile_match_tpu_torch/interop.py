"""Carrying state between the JAX package and the port as numpy arrays.

The JAX package's ``EnvState`` (batched under vmap) converts losslessly:
colour and kind int32[B, R, C], timer int32[B], key uint32[B, 2] (the port
holds the key words as int64).  ``timestep_to_numpy`` / ``info_to_numpy``
give the same field names as the JAX ``TimeStep`` / ``StepInfo``.
``load_engine_state`` carries the state of one of the JAX Gym adapter's
engines into the port's counterpart.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .state import EnvState, StepInfo


def state_from_numpy(colour, kind, timer, key, device) -> EnvState:
    key = np.asarray(key)
    if key.dtype != np.uint32:
        raise ValueError(f"key must be uint32 threefry words, got {key.dtype}")
    return EnvState(
        colour=torch.as_tensor(np.array(colour, np.int32), device=device),
        kind=torch.as_tensor(np.array(kind, np.int32), device=device),
        timer=torch.as_tensor(np.array(timer, np.int32), device=device),
        key=torch.as_tensor(key.astype(np.int64), device=device),
    )


def load_engine_state(engine, board, rng) -> None:
    """Give a port Gym engine the state of a JAX one: ``board`` is the
    [2, R, C] board (``engine.board`` there), ``rng`` the randomness — for
    a ``ThreefryDriver`` its key, uint32[2] (``engine.key``); for a
    ``ParityEngine`` its ``np.random.Generator``, whose state is copied
    into a generator of the same bit generator."""
    engine.board[...] = np.asarray(board, np.int32)
    if isinstance(rng, np.random.Generator):
        bits = type(rng.bit_generator)()
        bits.state = rng.bit_generator.state
        engine.np_random = np.random.Generator(bits)
        return
    key = np.asarray(rng)
    if key.dtype != np.uint32 or key.shape != (2,):
        raise ValueError(f"key must be uint32[2] threefry words, got {key.dtype}{list(key.shape)}")
    engine.key = torch.as_tensor(key.astype(np.int64), device=engine.key.device)


def state_to_numpy(state: EnvState) -> dict:
    return {
        "colour": state.colour.cpu().numpy().astype(np.int32),
        "kind": state.kind.cpu().numpy().astype(np.int32),
        "timer": state.timer.cpu().numpy().astype(np.int32),
        "key": state.key.cpu().numpy().astype(np.uint32),
    }


def info_to_numpy(info: StepInfo) -> dict:
    return {
        f.name: getattr(info, f.name).cpu().numpy()
        for f in dataclasses.fields(info)
    }


def timestep_to_numpy(ts) -> dict:
    """TimeStep -> {"obs_board", "obs_moves_left", "reward", "done", "info"}."""
    return {
        "obs_board": ts.obs_board.cpu().numpy(),
        "obs_moves_left": ts.obs_moves_left.cpu().numpy(),
        "reward": ts.reward.cpu().numpy(),
        "done": ts.done.cpu().numpy(),
        "info": info_to_numpy(ts.info),
    }
