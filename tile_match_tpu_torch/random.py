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

On CUDA tensors ``split``, ``fold_in``, ``random_bits``, ``uniform`` and
``randint`` with an integer ``maxval`` compute their words in one launch of
a CUDA kernel (``csrc/threefry_words.cu``, built at first use), and
``categorical`` and ``permutation`` take their words from them; ``randint``
with a tensor ``maxval`` takes its words from the kernel and its remainder
from torch.  On CPU tensors the plain version runs: the ``plain_*``
functions, int64 torch ops on any device, which the tests hold against
``jax.random`` and the kernel against.  Any other device raises.
``cuda_build.launches["threefry_words"]`` counts the kernel's launches;
each runs in program span ``threefry`` with ``words``, the 32-bit words it
writes.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from . import cuda_build
from .profiling import span as program_span

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_SPLIT, _BITS = 0, 1  # tmt_threefry_words' modes

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


def _flat_keys(keys: torch.Tensor):
    """``keys`` int64[..., 2] as (k, M): M keys, key m at ``k[m]``, its two
    words adjacent (a strided view where one describes them, else a copy)."""
    if keys.dtype != torch.int64 or keys.dim() < 1 or keys.shape[-1] != 2:
        raise ValueError(f"keys must be an int64[..., 2] tensor, got {keys.dtype}{list(keys.shape)}")
    k = keys.reshape(-1, 2)
    if k.stride(1) != 1:
        k = k.contiguous()
    return k, k.shape[0]


def _launch(name: str, device: torch.device, words: int, *args) -> None:
    """Entry point ``name`` of the kernel on ``device``, in span ``threefry``."""
    with program_span("threefry", words=words):
        cuda_build.launch(name, device, None, *args)


def _words(keys: torch.Tensor, n: int, offset: int, mode: int) -> torch.Tensor:
    """The kernel's words of keys int64[..., 2] at counters ``[offset,
    offset + n)``: int64[..., n, 2] pairs (``_SPLIT``) or int64[..., n]
    (``_BITS``)."""
    _check_counters(n, offset)
    k, M = _flat_keys(keys)
    out = torch.empty(*keys.shape[:-1], n, *((2,) if mode == _SPLIT else ()),
                      dtype=torch.int64, device=keys.device)
    if out.numel():
        _launch("tmt_threefry_words", keys.device, out.numel(),
                k.data_ptr(), k.stride(0), M, n, offset, mode, out.data_ptr())
    return out


def _check_counters(n: int, offset: int) -> None:
    if offset < 0 or offset + n > (1 << 32):
        raise ValueError(f"counters [{offset}, {offset + n}) outside [0, 2**32)")


def _counters(n: int, offset: int, device) -> torch.Tensor:
    _check_counters(n, offset)
    return torch.arange(offset, offset + n, dtype=torch.int64, device=device)


def split(keys: torch.Tensor, num: int = 2, offset: int = 0) -> torch.Tensor:
    """``jax.random.split``: int64[..., 2] -> int64[..., num, 2]; keys
    ``[offset, offset + num)`` of a larger split."""
    if cuda_build.on_card("threefry_words", keys):
        return _words(keys, num, offset, _SPLIT)
    return plain_split(keys, num, offset)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``data`` is an int or an integer tensor that
    broadcasts against ``keys[..., 0]``."""
    if not cuda_build.on_card("threefry_words", keys):
        return plain_fold_in(keys, data)
    # an int is passed as a value, an int32 or int64 tensor where it lies
    # (broadcast by strides)
    if torch.is_tensor(data):
        if data.device != keys.device:
            raise ValueError(f"fold_in: data on {data.device}, keys on {keys.device}")
        lead = torch.broadcast_shapes(keys.shape[:-1], data.shape)
        if data.dtype not in (torch.int32, torch.int64):
            data = data.to(torch.int64)
        d = data.expand(lead).reshape(-1)
        keys = keys.expand(*lead, 2)
        ptr, d_stride, d_bytes, scalar = d.data_ptr(), d.stride(0), d.element_size(), 0
    else:
        lead = keys.shape[:-1]
        ptr, d_stride, d_bytes, scalar = None, 0, 8, int(data) & MASK32
    k, N = _flat_keys(keys)
    out = torch.empty(*lead, 2, dtype=torch.int64, device=keys.device)
    if N:
        _launch("tmt_threefry_fold_in", keys.device, 2 * N,
                k.data_ptr(), k.stride(0), ptr, d_stride, d_bytes, scalar, N, out.data_ptr())
    return out


def random_bits(keys: torch.Tensor, shape: Sequence[int], offset: int = 0) -> torch.Tensor:
    """32 random bits per element: int64[..., *shape] of uint32 values,
    the words from flat index ``offset`` on."""
    if cuda_build.on_card("threefry_words", keys):
        return _words(keys, math.prod(shape), offset, _BITS).reshape(*keys.shape[:-1], *shape)
    return plain_random_bits(keys, shape, offset)


def randint(keys: torch.Tensor, shape: Sequence[int], minval: int, maxval) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``.

    ``maxval`` is an int or an integer tensor that broadcasts against
    ``shape`` (a bound computed on the card, read without a host sync)."""
    span = _randint_span(minval, maxval)
    if not cuda_build.on_card("threefry_words", keys):
        return plain_randint(keys, shape, minval, maxval)
    if torch.is_tensor(span):
        halves = split(keys)
        return _randint_from(random_bits(halves[..., 0, :], shape),
                             random_bits(halves[..., 1, :], shape), minval, span)
    n = math.prod(shape)
    k, M = _flat_keys(keys)
    out = torch.empty(*keys.shape[:-1], *shape, dtype=torch.int32, device=keys.device)
    if out.numel():
        _launch("tmt_threefry_randint", keys.device, M * n,
                k.data_ptr(), k.stride(0), M, n, span, minval, out.data_ptr())
    return out


def uniform(
    keys: torch.Tensor, shape: Sequence[int], minval=0.0, maxval=1.0, offset: int = 0
) -> torch.Tensor:
    """``jax.random.uniform(key, shape, jnp.float32, minval, maxval)``
    (``plain_uniform`` says how); on CUDA tensors the kernel computes the
    same operations, each rounded on its own, in its one launch."""
    if not cuda_build.on_card("threefry_words", keys):
        return plain_uniform(keys, shape, minval, maxval, offset)
    lo, hi = np.float32(minval), np.float32(maxval)
    n = math.prod(shape)
    _check_counters(n, offset)
    k, M = _flat_keys(keys)
    out = torch.empty(*keys.shape[:-1], *shape, dtype=torch.float32, device=keys.device)
    if out.numel():
        _launch("tmt_threefry_uniform", keys.device, M * n, k.data_ptr(), k.stride(0), M, n,
                offset, float(lo), float(hi - lo), float(lo), out.data_ptr())
    return out


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


# ---- the plain version: int64 torch ops on any device ----------------------


def plain_split(keys: torch.Tensor, num: int = 2, offset: int = 0) -> torch.Tensor:
    counts = _counters(num, offset, keys.device)
    b0, b1 = threefry2x32(
        keys[..., 0, None], keys[..., 1, None], torch.zeros_like(counts), counts
    )
    return torch.stack([b0, b1], dim=-1)


def plain_fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    if not torch.is_tensor(data):
        data = torch.tensor(data, dtype=torch.int64, device=keys.device)
    data = data.to(torch.int64) & MASK32
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def plain_random_bits(keys: torch.Tensor, shape: Sequence[int], offset: int = 0) -> torch.Tensor:
    counts = _counters(math.prod(shape), offset, keys.device)
    b0, b1 = threefry2x32(
        keys[..., 0, None], keys[..., 1, None], torch.zeros_like(counts), counts
    )
    return (b0 ^ b1).reshape(*keys.shape[:-1], *shape)


def _randint_span(minval: int, maxval):
    if torch.is_tensor(maxval):
        span = maxval.to(torch.int64) - minval
        return torch.where(span <= 0, 1, span)
    span = max(maxval - minval, 1)
    if span > (1 << 31):
        raise ValueError(f"span {span} too wide for int32 randint")
    return span


def _randint_from(hi: torch.Tensor, lo: torch.Tensor, minval: int, span) -> torch.Tensor:
    # JAX's unsigned double-width remainder in uint32 arithmetic: every
    # product is wrapped to 32 bits (products stay below 2**62 in int64).
    mult = (((65536 % span) ** 2) & MASK32) % span
    off = (((hi % span) * mult) & MASK32) + (lo % span)
    off = (off & MASK32) % span
    return (minval + off).to(torch.int32)


def plain_randint(keys: torch.Tensor, shape: Sequence[int], minval: int, maxval) -> torch.Tensor:
    span = _randint_span(minval, maxval)
    halves = plain_split(keys)
    return _randint_from(plain_random_bits(halves[..., 0, :], shape),
                         plain_random_bits(halves[..., 1, :], shape), minval, span)


def plain_uniform(
    keys: torch.Tensor, shape: Sequence[int], minval=0.0, maxval=1.0, offset: int = 0
) -> torch.Tensor:
    """The top 23 bits of each word as the mantissa of a float in [1, 2),
    minus 1, scaled into [minval, maxval).

    XLA contracts the scaling ``u * (maxval - minval) + minval`` into one
    fused multiply-add in float32.  The product of two float32 values is
    exact in float64, so the sum is taken there and rounded to float32
    once more; that equals the fused result except where the float64 sum
    lands on a float32 tie, which cannot happen for [0, 1) or [tiny, 1)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (plain_random_bits(keys, shape, offset) >> 9) | 0x3F800000  # below 2**31
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    scaled = (floats.to(torch.float64) * float(hi - lo) + float(lo)).to(torch.float32)
    return torch.clamp_min(scaled, float(lo))
