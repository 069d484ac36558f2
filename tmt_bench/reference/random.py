"""Batched threefry-2x32, word for word equal to ``jax.random``.

The JAX package draws every random number of the game from per-board
threefry keys (``jax.random.split`` / ``fold_in`` / ``randint`` /
``permutation`` with ``jax_threefry_partitionable`` on, the default since
JAX 0.5).  Threefry is pure 32-bit integer arithmetic, so these functions
reproduce JAX's bits exactly; no ``torch.Generator`` is involved.
``uniform`` is exact too (integer-derived floats); ``categorical`` takes
two logarithms of those uniforms, which may differ from XLA's by an ulp,
so its argmax can flip only where two draws lie within an ulp.

A key is the pair of raw uint32 words JAX stores, held as int64 values in
[0, 2**32) with the key words on the last dimension: ``keys[..., 2]``.
All arithmetic runs in int64 and is masked back to 32 bits after each add
and shift (torch's ``>>`` on int32 is arithmetic, not logical).  Every
function is batched over the leading dimensions of ``keys``.

With ``jax_threefry_partitionable`` word ``i`` of a draw depends on its
flat index ``i`` alone, so a slice of a draw is computed on its own:
``split``, ``random_bits``, ``uniform`` and ``categorical`` take an
``offset``, the flat index of their first word in the whole draw.  A rank
that holds boards ``[o, o + b)`` of a batch draws exactly their words.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: int, device) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for an int32 seed: int64[2]."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed must fit in int32, got {seed}")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds, JAX's schedule; int64 in, int64 out."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def _counters(n: int, offset: int, device) -> torch.Tensor:
    if offset < 0 or offset + n > (1 << 32):
        raise ValueError(f"counters [{offset}, {offset + n}) outside [0, 2**32)")
    return torch.arange(offset, offset + n, dtype=torch.int64, device=device)


def split(keys: torch.Tensor, num: int = 2, offset: int = 0) -> torch.Tensor:
    """``jax.random.split``: int64[..., 2] -> int64[..., num, 2]; keys
    ``[offset, offset + num)`` of a larger split."""
    counts = _counters(num, offset, keys.device)
    b0, b1 = threefry2x32(
        keys[..., 0, None], keys[..., 1, None], torch.zeros_like(counts), counts
    )
    return torch.stack([b0, b1], dim=-1)


def split_at(key: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Keys ``idx`` int64[N] of ``split(key, num)`` for one key int64[2]:
    int64[N, 2]."""
    counts = idx.to(torch.int64)
    b0, b1 = threefry2x32(key[0], key[1], torch.zeros_like(counts), counts)
    return torch.stack([b0, b1], dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``data`` is an int or an integer tensor that
    broadcasts against ``keys[..., 0]``."""
    if not torch.is_tensor(data):
        data = torch.tensor(data, dtype=torch.int64, device=keys.device)
    data = data.to(torch.int64) & MASK32
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(keys: torch.Tensor, shape: Sequence[int], offset: int = 0) -> torch.Tensor:
    """32 random bits per element: int64[..., *shape] of uint32 values,
    the words from flat index ``offset`` on."""
    counts = _counters(math.prod(shape), offset, keys.device)
    b0, b1 = threefry2x32(
        keys[..., 0, None], keys[..., 1, None], torch.zeros_like(counts), counts
    )
    return (b0 ^ b1).reshape(*keys.shape[:-1], *shape)


def randint(keys: torch.Tensor, shape: Sequence[int], minval: int, maxval) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``.

    ``maxval`` is an int or an integer tensor that broadcasts against
    ``shape`` (a bound computed on the card, read without a host sync)."""
    if torch.is_tensor(maxval):
        span = maxval.to(torch.int64) - minval
        span = torch.where(span <= 0, 1, span)
    else:
        span = max(maxval - minval, 1)
        if span > (1 << 31):
            raise ValueError(f"span {span} too wide for int32 randint")
    halves = split(keys)
    hi = random_bits(halves[..., 0, :], shape)
    lo = random_bits(halves[..., 1, :], shape)
    # JAX's unsigned double-width remainder in uint32 arithmetic: every
    # product is wrapped to 32 bits (products stay below 2**62 in int64).
    mult = (((65536 % span) ** 2) & MASK32) % span
    off = (((hi % span) * mult) & MASK32) + (lo % span)
    off = (off & MASK32) % span
    return (minval + off).to(torch.int32)


def uniform(
    keys: torch.Tensor, shape: Sequence[int], minval=0.0, maxval=1.0, offset: int = 0
) -> torch.Tensor:
    """``jax.random.uniform(key, shape, jnp.float32, minval, maxval)``: the
    top 23 bits of each word as the mantissa of a float in [1, 2), minus 1,
    scaled into [minval, maxval).

    XLA contracts the scaling ``u * (maxval - minval) + minval`` into one
    fused multiply-add in float32.  The product of two float32 values is
    exact in float64, so the sum is taken there and rounded to float32
    once more; that equals the fused result except where the float64 sum
    lands on a float32 tie, which cannot happen for [0, 1) or [tiny, 1)."""
    return _floats(random_bits(keys, shape, offset), minval, maxval)


def _floats(words: torch.Tensor, minval, maxval) -> torch.Tensor:
    """``uniform``'s floats from its words."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (words >> 9) | 0x3F800000  # below 2**31
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    scaled = (floats.to(torch.float64) * float(hi - lo) + float(lo)).to(torch.float32)
    return torch.clamp_min(scaled, float(lo))


def categorical(
    keys: torch.Tensor, logits: torch.Tensor, axis: int = -1, offset: int = 0
) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)`` with one key int64[2]:
    jax's default ``mode="low"`` Gumbel-max draw, the argmax of ``logits``
    plus ``-log(-log(u))`` for u uniform in [tiny, 1), one word per logit
    counted in row-major order from ``offset`` (rows ``[o, o + b)`` of a
    [B, A] draw: ``offset = o * A``).  Returns int64 indices."""
    u = uniform(keys, logits.shape, minval=np.finfo(np.float32).tiny, maxval=1.0, offset=offset)
    return torch.argmax(-torch.log(-torch.log(u)) + logits, dim=axis)


def masked_categorical_rows(keys: torch.Tensor, mask: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """A uniform draw among the effective actions of rows ``rows`` int64[N]
    of a batch, as ``jax.random.categorical`` draws over the whole batch's
    logits (0 where ``mask``, -inf elsewhere) from one key: row ``rows[i]``
    with key ``keys[i]`` int64[N, 2] and mask ``mask[i]`` bool[N, A].  Its
    words are those of flat indices ``rows[i] * A + a``.  Action 0 where a
    row has none; int32[N]."""
    A = mask.shape[-1]
    counts = rows.to(torch.int64)[:, None] * A + torch.arange(A, dtype=torch.int64, device=mask.device)
    b0, b1 = threefry2x32(keys[:, 0, None], keys[:, 1, None], torch.zeros_like(counts), counts)
    u = _floats(b0 ^ b1, np.finfo(np.float32).tiny, 1.0)
    logits = torch.where(mask, 0.0, -torch.inf)
    acts = torch.argmax(-torch.log(-torch.log(u)) + logits, dim=-1)
    return torch.where(mask.any(-1), acts, 0).to(torch.int32)


def key_of_seed(seed: int, device) -> torch.Tensor:
    """The threefry key of a 64-bit seed, as ``jax.random.PRNGKey`` makes
    it with 64-bit integers on: its high and low 32-bit words, int64[2]."""
    seed = int(seed) & ((1 << 64) - 1)
    return torch.tensor([seed >> 32, seed & MASK32], dtype=torch.int64, device=device)


def permutation(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: int64[..., n].

    JAX shuffles by sorting on fresh 32-bit keys, ceil(3 ln n / ln(2**32-1))
    rounds (one round for every n below ~1600); the sort is stable.
    """
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(MASK32)))
    x = torch.arange(n, dtype=torch.int64, device=keys.device)
    x = x.expand(*keys.shape[:-1], n)
    for _ in range(rounds):
        both = split(keys)
        keys, sub = both[..., 0, :], both[..., 1, :]
        order = torch.sort(random_bits(sub, (n,)), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x
