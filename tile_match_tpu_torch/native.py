"""ctypes bindings for the native C++ engine ``csrc/tmt_engine.cpp``: the
port's own copy of ``tile_match_tpu.native``, which imports no JAX but
lives in a package that does.

The shared library is built on demand with g++ (no external deps) into
``tile_match_tpu_torch/_build/`` — not next to the source, where the JAX
package builds its own — and without ``-march=native``, so that a library
built on one host loads on another.  The native engine is a host-side engine with its
own xorshift RNG: CPU serving and data generation, and a third oracle of
the deterministic sub-steps (effective mask, resolution, combination,
gravity).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_DIR), "csrc", "tmt_engine.cpp")
_BUILD = os.path.join(_DIR, "_build")
_CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None

FLAG_COOKIE, FLAG_VLASER, FLAG_HLASER, FLAG_BOMB = 1, 2, 4, 8


def _flags(cfg) -> int:
    return (
        (FLAG_COOKIE if cfg.cookie else 0)
        | (FLAG_VLASER if cfg.vertical_laser else 0)
        | (FLAG_HLASER if cfg.horizontal_laser else 0)
        | (FLAG_BOMB if cfg.bomb else 0)
    )


def build(force: bool = False) -> str:
    """Compile ``csrc/tmt_engine.cpp`` into ``_build/`` unless an
    up-to-date library is there (its name carries a hash of the source and
    the flags); under a file lock, so that processes building at once
    compile it once."""
    with open(_SRC, "rb") as f:
        h = hashlib.sha1(" ".join(_CXX_FLAGS).encode() + b"\0" + f.read()).hexdigest()[:12]
    lib = os.path.join(_BUILD, f"libtmt-{h}.so")
    os.makedirs(_BUILD, exist_ok=True)
    with open(os.path.join(_BUILD, "libtmt.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if force or not os.path.exists(lib):
            tmp = f"{lib}.{os.getpid()}.tmp"
            subprocess.run(["g++", *_CXX_FLAGS, "-o", tmp, _SRC], check=True)
            os.replace(tmp, lib)
    return lib


def load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        ip = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        ci = ctypes.c_int

        lib.tmt_num_actions.argtypes = [ci, ci]
        lib.tmt_num_actions.restype = ci
        lib.tmt_effective_mask.argtypes = [i32p, i32p, ci, ci, u8p]
        lib.tmt_gravity.argtypes = [i32p, i32p, ci, ci]
        lib.tmt_apply_refill.argtypes = [i32p, i32p, i32p, ci, ci]
        lib.tmt_swap.argtypes = [i32p, i32p, ci, ci, ci, ci, ci, ci]
        lib.tmt_resolve_once.argtypes = [i32p, i32p, ci, ci, ci, ip]
        lib.tmt_resolve_once.restype = ci
        lib.tmt_is_combination.argtypes = [i32p, i32p, ci, ci, ci, ci, ci, ci]
        lib.tmt_is_combination.restype = ci
        lib.tmt_combination.argtypes = [i32p, i32p, ci, ci, ci, ci, ci, ci]
        lib.tmt_combination.restype = ci
        lib.tmt_move.argtypes = [
            i32p, i32p, ci, ci, ci, ci, ci, ci, ci, ci, u64p, ip,
        ]
        lib.tmt_move.restype = ci
        lib.tmt_generate.argtypes = [i32p, i32p, ci, ci, ci, ci, u64p]
        lib.tmt_possible_move.argtypes = [i32p, i32p, ci, ci]
        lib.tmt_possible_move.restype = ci
        lib.tmt_has_any_line.argtypes = [i32p, i32p, ci, ci]
        lib.tmt_has_any_line.restype = ci
        lib.tmt_batch_generate.argtypes = [i32p, i32p, ci, ci, ci, ci, ci, u64p]
        lib.tmt_batch_move.argtypes = [
            i32p, i32p, ci, ci, ci, ci, ci, i32p, u64p, i32p, i32p,
        ]
        lib.tmt_batch_effective_mask.argtypes = [i32p, i32p, ci, ci, ci, u8p]
        _lib = lib
        return lib


class NativeEngine:
    """Host-side engine with its own xorshift RNG stream (CPU counterpart of
    the JAX engine's threefry mode)."""

    def __init__(self, cfg, seed: int = 0):
        self.cfg = cfg
        self.lib = load()
        self._board = np.zeros((2, cfg.num_rows, cfg.num_cols), np.int32)
        self._board[1] = 1
        self.rng = np.array([seed * 2654435761 + 1], np.uint64)
        self.flags = _flags(cfg)

    @property
    def colour(self) -> np.ndarray:
        return self._board[0]

    @property
    def kind(self) -> np.ndarray:
        return self._board[1]

    def generate_board(self):
        self.lib.tmt_generate(
            self.colour, self.kind, self.cfg.num_rows, self.cfg.num_cols,
            self.flags, self.cfg.num_colours, self.rng,
        )

    def effective_mask(self) -> np.ndarray:
        out = np.zeros((self.cfg.num_actions,), np.uint8)
        self.lib.tmt_effective_mask(
            self.colour, self.kind, self.cfg.num_rows, self.cfg.num_cols, out
        )
        return out.astype(bool)

    def move(self, coord1, coord2):
        stats = np.zeros((4,), np.int32)
        elim = self.lib.tmt_move(
            self.colour, self.kind, self.cfg.num_rows, self.cfg.num_cols,
            self.flags, self.cfg.num_colours,
            int(coord1[0]), int(coord1[1]), int(coord2[0]), int(coord2[1]),
            self.rng, stats,
        )
        return int(elim), bool(stats[0]), int(stats[1]), int(stats[2]), bool(stats[3])

    @property
    def board(self) -> np.ndarray:
        """The live [2, R, C] buffer (mutations are honoured)."""
        return self._board


class NativeBatchEngine:
    """Env-pool-style CPU batch: B independent boards stepped with OpenMP.

    The CPU counterpart of envs/batched.py — auto-reset, per-board xorshift
    streams, reference-layout stats.
    """

    def __init__(self, cfg, batch_size: int, seed: int = 0):
        self.cfg = cfg
        self.B = batch_size
        self.lib = load()
        self.flags = _flags(cfg)
        R, C = cfg.num_rows, cfg.num_cols
        self.colour = np.zeros((batch_size, R, C), np.int32)
        self.kind = np.ones((batch_size, R, C), np.int32)
        self.timer = np.zeros((batch_size,), np.int32)
        self.rng = (
            np.arange(1, batch_size + 1, dtype=np.uint64) * np.uint64(2654435761)
            + np.uint64(seed * 97 + 1)
        )

    def reset(self) -> np.ndarray:
        self.lib.tmt_batch_generate(
            self.colour, self.kind, self.B, self.cfg.num_rows,
            self.cfg.num_cols, self.flags, self.cfg.num_colours, self.rng,
        )
        self.timer[:] = 0
        return self.effective_mask()

    def effective_mask(self) -> np.ndarray:
        out = np.zeros((self.B, self.cfg.num_actions), np.uint8)
        self.lib.tmt_batch_effective_mask(
            self.colour, self.kind, self.B, self.cfg.num_rows,
            self.cfg.num_cols, out,
        )
        return out.astype(bool)

    def step(self, actions: np.ndarray):
        """Returns (rewards, dones, stats[B,4]); auto-resets finished boards."""
        rewards = np.zeros((self.B,), np.int32)
        stats = np.zeros((self.B, 4), np.int32)
        self.lib.tmt_batch_move(
            self.colour, self.kind, self.B, self.cfg.num_rows,
            self.cfg.num_cols, self.flags, self.cfg.num_colours,
            np.ascontiguousarray(actions, np.int32), self.rng, rewards, stats,
        )
        self.timer += 1
        dones = self.timer >= self.cfg.num_moves
        if dones.any():
            idx = np.nonzero(dones)[0].astype(np.int32)
            sub_c = np.ascontiguousarray(self.colour[idx])
            sub_k = np.ascontiguousarray(self.kind[idx])
            sub_r = np.ascontiguousarray(self.rng[idx])
            self.lib.tmt_batch_generate(
                sub_c, sub_k, len(idx), self.cfg.num_rows, self.cfg.num_cols,
                self.flags, self.cfg.num_colours, sub_r,
            )
            self.colour[idx] = sub_c
            self.kind[idx] = sub_k
            self.rng[idx] = sub_r
            self.timer[idx] = 0
        return rewards, dones, stats
