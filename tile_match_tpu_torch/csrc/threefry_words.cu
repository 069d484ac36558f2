// The threefry words of tile_match_tpu_torch/random.py for Hopper (sm_90a):
// split, random_bits, uniform, fold_in and randint, each one launch.
//
// Replaces no TPU kernel: the JAX package draws through jax.random, whose
// threefry-2x32 XLA compiles into its own fused loops.  The port's plain
// version (random.py on CPU tensors) runs JAX's 20 rounds as int64
// element-wise torch ops, ~170 launches a split or a random_bits and ~550 a
// randint; this source computes the same words, bit for bit, in one launch
// a call.  The words follow jax_threefry_partitionable: word j of a draw of
// key k is threefry2x32(k, (0, offset + j)), a function of its flat index
// alone, so a thread computes any word on its own.
//
// Entry points (each takes device pointers, counts and the stream, and
// returns the cudaError_t of the launch; a `_host` twin runs the same
// arithmetic as loops when built with -DTMT_HOST_BUILD):
//   tmt_threefry_words    keys [M, 2] x counters [offset, offset + n):
//                         split mode writes (x0, x1) as int64 [M, n, 2],
//                         bits mode writes x0 ^ x1 as int64 [M, n];
//   tmt_threefry_uniform  the bits mode's word as jax.random.uniform's
//                         float32 (mantissa, minus 1, scaled in float64 by
//                         two rounded operations: no contraction);
//   tmt_threefry_fold_in  keys [N, 2] with data [N] (int32 or int64, or
//                         one scalar) to int64 [N, 2];
//   tmt_threefry_randint  for each key both halves of its split, both words
//                         at each of its n cells and JAX's double-width
//                         remainder, into int32 [M, n].
// Keys are uint32 pairs stored as int64, key m at keys + m * key_stride
// (its two words adjacent), so a strided slice such as split(k)[:, 1] is
// read where it lies; a stride of 0 broadcasts one key.
//
// What bounds it on the card: integer throughput.  A word is ~80 integer
// instructions (20 rounds of add, rotate and xor, 5 key injections) and
// 4-16 bytes out.  The draw of a policy step, categorical over 16,384
// boards x 180 actions, is 2,949,120 words: 11.8 MB of float32 out, 3.5 us
// at 3.35 TB/s, but ~236 M integer instructions, 14 us on the 64 integer
// lanes a multiprocessor (132 x 64 a cycle at 1.98 GHz; at the 67 TOP/s
// that PERF.md's kernel table takes for integer work, 3.5 us).  Measured on
// the H100, 13.3 us queued (PERF.md §6): the integer pipe's rate.
// draw_colour_grid over 16,384 boards of 10 x 10 is 1,638,400 cells of four
// hashes each (each cell's thread recomputes its key's split: no shared
// memory and no barrier), 6.6 MB out.  What it replaces was host launch
// time, ~11 us a launch and ~170-550 launches a call.  The design: a
// grid-stride loop over the flat words, a thread a word, blocks of 256
// threads and at most eight a multiprocessor; the key index by one division
// unless one key is broadcast; 16-byte stores for the split and fold_in
// pairs, 8- and 4-byte stores for the rest, consecutive threads on
// consecutive words.

#include <string.h>

#include "threefry.cuh"

namespace tmt {

using Index = unsigned long long;

// A draw over M keys of n words each, word j of key m at flat index
// m * n + j and counter offset + j; key m at keys + m * key_stride.
struct Draw {
  const long long* keys;
  long long key_stride;
  Index n;
  bool one_key;  // M == 1: no division
  uint32_t offset;

  // Flat word i's key and counter.
  TMT_DEV void at(Index i, uint32_t& k0, uint32_t& k1, uint32_t& counter) const {
    const Index m = one_key ? 0 : i / n;
    const long long* k = keys + static_cast<long long>(m) * key_stride;
    k0 = static_cast<uint32_t>(k[0]);
    k1 = static_cast<uint32_t>(k[1]);
    counter = offset + static_cast<uint32_t>(i - m * n);
  }
};

TMT_DEV float bits_as_float(uint32_t b) {
#ifdef __CUDACC__
  return __uint_as_float(b);
#else
  float f;
  memcpy(&f, &b, sizeof f);
  return f;
#endif
}

// split: word i as the pair (x0, x1), int64[M, n, 2].
struct SplitWords {
  Draw d;
  long long* out;
  TMT_DEV void operator()(Index i) const {
    uint32_t k0, k1, x0 = 0, x1;
    d.at(i, k0, k1, x1);
    threefry2x32(k0, k1, x0, x1);
#ifdef __CUDACC__
    reinterpret_cast<longlong2*>(out)[i] = make_longlong2(x0, x1);
#else
    out[2 * i] = x0;
    out[2 * i + 1] = x1;
#endif
  }
};

// random_bits: word i as x0 ^ x1, int64[M, n].
struct BitsWords {
  Draw d;
  long long* out;
  TMT_DEV void operator()(Index i) const {
    uint32_t k0, k1, c;
    d.at(i, k0, k1, c);
    out[i] = draw_word(k0, k1, c);
  }
};

// uniform: word i as jax.random.uniform's float32, as random.py's plain
// version computes it: the top 23 bits as the mantissa of a float in
// [1, 2), minus 1 (exact), then u * scale + lo in float64, each operation
// rounded on its own (the intrinsics keep nvcc from contracting them into
// one fused multiply-add), rounded to float32 and clamped below at lo.
struct UniformWords {
  Draw d;
  float lo;
  double scale, lo_d;
  float* out;
  TMT_DEV void operator()(Index i) const {
    uint32_t k0, k1, c;
    d.at(i, k0, k1, c);
    const float u = bits_as_float((draw_word(k0, k1, c) >> 9) | 0x3F800000u) - 1.0f;
#ifdef __CUDACC__
    const float r = __double2float_rn(__dadd_rn(__dmul_rn(static_cast<double>(u), scale), lo_d));
#else
    const double p = static_cast<double>(u) * scale;
    const float r = static_cast<float>(p + lo_d);
#endif
    out[i] = r < lo ? lo : r;
  }
};

// fold_in: key i (a stride of 0 broadcasts one) with its data, an int32 or
// int64 at i * data_stride, or `scalar` where data is null; int64[N, 2].
struct FoldIn {
  const long long* keys;
  long long key_stride;
  const void* data;
  long long data_stride;
  int data_bytes;
  uint32_t scalar;
  long long* out;
  TMT_DEV void operator()(Index i) const {
    const long long* k = keys + static_cast<long long>(i) * key_stride;
    const long long at = static_cast<long long>(i) * data_stride;
    uint32_t x0 = 0, x1 = scalar;
    if (data != nullptr)
      x1 = data_bytes == 4 ? static_cast<uint32_t>(static_cast<const int*>(data)[at])
                           : static_cast<uint32_t>(static_cast<const long long*>(data)[at]);
    threefry2x32(static_cast<uint32_t>(k[0]), static_cast<uint32_t>(k[1]), x0, x1);
#ifdef __CUDACC__
    reinterpret_cast<longlong2*>(out)[i] = make_longlong2(x0, x1);
#else
    out[2 * i] = x0;
    out[2 * i + 1] = x1;
#endif
  }
};

// randint: cell i of its key, both halves of the key's split (recomputed by
// each cell), a word of each at the cell's counter and JAX's double-width
// remainder; minval + the offset, wrapped to 32 bits as the int64 sum cast
// to int32 is; int32[M, n].
struct Randint {
  Draw d;
  uint32_t K, mult;
  long long minval;
  int* out;
  TMT_DEV void operator()(Index i) const {
    uint32_t k0, k1, c;
    d.at(i, k0, k1, c);
    const RefillKeys h = split(k0, k1);
    const uint32_t off = randint_offset(draw_word(h.a0, h.a1, c), draw_word(h.b0, h.b1, c), K, mult);
    out[i] = static_cast<int>(static_cast<uint32_t>(static_cast<unsigned long long>(minval) + off));
  }
};

}  // namespace tmt

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256, kBlocksPerSM = 8;

// f(i) for every i < total: a thread a word, in a grid-stride loop.
template <class F>
__global__ void __launch_bounds__(kThreads) threefry_kernel(tmt::Index total, F f) {
  const tmt::Index step = static_cast<tmt::Index>(gridDim.x) * kThreads;
  for (tmt::Index i = static_cast<tmt::Index>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += step)
    f(i);
}

// Launches f over `total` words on `stream`, at most kBlocksPerSM blocks a
// multiprocessor of the current device; returns the launch's cudaError_t.
template <class F>
int launch(long long total, F f, void* stream) {
  if (total == 0) return 0;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms < 1)
    sms = 1;
  const long long want = (total + kThreads - 1) / kThreads, cap = 1ll * sms * kBlocksPerSM;
  threefry_kernel<<<static_cast<unsigned>(want < cap ? want : cap), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(static_cast<tmt::Index>(total), f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define TMT_RUN(total, f) launch(total, f, stream)
#define TMT_ENTRY(name, ...) extern "C" int name(__VA_ARGS__, void* stream)
#define TMT_INVALID cudaErrorInvalidValue

#else  // host build (TMT_HOST_BUILD): the same words, one after another, in `_host` twins

template <class F>
int run_host(long long total, F f) {
  for (long long i = 0; i < total; ++i) f(static_cast<tmt::Index>(i));
  return 0;
}

#define TMT_RUN(total, f) run_host(total, f)
#define TMT_ENTRY(name, ...) extern "C" int name##_host(__VA_ARGS__)
#define TMT_INVALID (-1)

#endif

// Each entry point launches its words on `stream` and returns the launch's
// cudaError_t (the `_host` twin computes them and returns 0); bad sizes
// return cudaErrorInvalidValue (-1 on the host).

// split (mode 0: int64 [M, n, 2]) or random_bits (mode 1: int64 [M, n]) of
// keys [M, 2] over counters [offset, offset + n).
TMT_ENTRY(tmt_threefry_words, const long long* keys, long long key_stride, long long M,
          long long n, unsigned offset, int mode, long long* out) {
  if (M < 0 || n < 0 || (mode != 0 && mode != 1)) return TMT_INVALID;
  const tmt::Draw d{keys, key_stride, static_cast<tmt::Index>(n), M == 1, offset};
  return mode == 0 ? TMT_RUN(M * n, (tmt::SplitWords{d, out})) : TMT_RUN(M * n, (tmt::BitsWords{d, out}));
}

// uniform: float32 [M, n] from the words of keys [M, 2] over counters
// [offset, offset + n), scaled by `scale` and shifted by `lo_d` (lo as a
// double), clamped below at `lo`.
TMT_ENTRY(tmt_threefry_uniform, const long long* keys, long long key_stride, long long M,
          long long n, unsigned offset, float lo, double scale, double lo_d, float* out) {
  if (M < 0 || n < 0) return TMT_INVALID;
  const tmt::Draw d{keys, key_stride, static_cast<tmt::Index>(n), M == 1, offset};
  return TMT_RUN(M * n, (tmt::UniformWords{d, lo, scale, lo_d, out}));
}

// fold_in: int64 [N, 2] from keys [N, 2] (key_stride 0: one key) and data
// (int32 or int64 by data_bytes, at data_stride; null: `scalar`).
TMT_ENTRY(tmt_threefry_fold_in, const long long* keys, long long key_stride, const void* data,
          long long data_stride, int data_bytes, unsigned scalar, long long N, long long* out) {
  if (N < 0 || (data != nullptr && data_bytes != 4 && data_bytes != 8)) return TMT_INVALID;
  return TMT_RUN(N, (tmt::FoldIn{keys, key_stride, data, data_stride, data_bytes, scalar, out}));
}

// randint: int32 [M, n], minval + randint's offset in [0, K) at cells
// 0..n-1 of keys [M, 2], for a span K in [1, 2^31].
TMT_ENTRY(tmt_threefry_randint, const long long* keys, long long key_stride, long long M,
          long long n, unsigned K, long long minval, int* out) {
  if (M < 0 || n < 0 || K < 1 || K > (1u << 31)) return TMT_INVALID;
  const tmt::Draw d{keys, key_stride, static_cast<tmt::Index>(n), M == 1, 0};
  return TMT_RUN(M * n, (tmt::Randint{d, K, tmt::randint_mult(K), minval, out}));
}
