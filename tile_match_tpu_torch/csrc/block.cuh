// The executors the board programs are written for, and the bit helpers of
// their row-major and column-major cell masks.
//
// A board program is a sequence of phases.  Each phase runs a function of
// the cell index for every cell of the board and ends at a barrier.  A
// phase reads only shared entries that no cell writes in the same phase,
// and no two cells write the same entry, so the order in which cells run
// inside a phase does not matter.  Values that live across phases sit in
// shared memory, never in a thread's registers; board-wide scalars come
// from the reductions, which every thread sees alike.
//
// The executor on the card:
//   Warps<kW> — kW warps per board, one block of 32 kW threads (cascade.cu,
//           cascade_sp.cu; Warp = Warps<1>, also mask_sp.cu, whose blocks
//           hold several boards, a warp each): thread t runs cells t,
//           t + 32 kW, ...  With one warp a phase ends in __syncwarp() and
//           the reductions are single warp operations (__ballot_sync,
//           __reduce_or_sync, __reduce_max_sync, __reduce_add_sync), with
//           no shared atomics and no block barrier: a board's warp frees its
//           slot on the SM as soon as the board is done.  With several, a
//           phase ends at __syncthreads() and a reduction folds the warps'
//           results through shared memory: fewer boards in flight, each
//           sooner done.
//
// A cell mask is a bit set over the n cells of a board in 32-bit words,
// bit i of word i / 32 for cell i, with one zero word past the last: in
// row-major order (i = r * C + c) a run along a row is a run of bits, in
// column-major order (j = c * R + r) a run along a column is.  `ballot`
// builds one word per 32 cells with one warp vote.
//
// Compiled as plain C++ (TMT_HOST_BUILD), the executor runs each phase as
// a loop over the cells and the bit helpers use the compiler's builtins; the
// CPU tests build the board programs that way with g++ and hold them
// against the kernels' plain PyTorch versions.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define TMT_DEV __device__ __forceinline__
#define TMT_HOST_DEV __host__ __device__ __forceinline__
#else
#include <algorithm>
#define TMT_DEV inline
#define TMT_HOST_DEV inline
#endif

namespace tmt {

// ---- bit helpers ------------------------------------------------------------

#ifdef __CUDACC__
TMT_DEV int popc(uint32_t v) { return __popc(v); }
TMT_DEV int ctz(uint32_t v) { return __ffs(v) - 1; }  // v != 0
TMT_DEV int clz(uint32_t v) { return __clz(v); }      // 32 for v == 0
#else
inline int popc(uint32_t v) { return __builtin_popcount(v); }
inline int ctz(uint32_t v) { return __builtin_ctz(v); }
inline int clz(uint32_t v) { return v ? __builtin_clz(v) : 32; }
#endif

// words of a mask over n cells, the trailing zero word included
TMT_HOST_DEV int mask_words(int n) { return (n + 31) / 32 + 1; }

// i / d by a multiply-high with inv = reciprocal(d) (0 for d == 1): exact
// for 0 <= i < 2^16 and 1 <= d < 2^16, since ceil(2^32 / d) * d - 2^32 < d.
TMT_HOST_DEV uint32_t reciprocal(int d) {
  return d > 1 ? static_cast<uint32_t>(0xffffffffu / static_cast<uint32_t>(d) + 1u) : 0u;
}
TMT_DEV int div_by(int i, int d, uint32_t inv) {
#ifdef __CUDACC__
  return d == 1 ? i : static_cast<int>(__umulhi(static_cast<uint32_t>(i), inv));
#else
  return d == 1 ? i : static_cast<int>((static_cast<uint64_t>(i) * inv) >> 32);
#endif
}

TMT_DEV bool bit(const uint32_t* m, int i) { return (m[i >> 5] >> (i & 31)) & 1u; }

// Set bits at p, p + 1, ... before the first clear one.  The zero bit that
// ends every row (or column) of a same-as-the-next mask ends the count.
TMT_DEV int ones_up(const uint32_t* m, int p) {
  int n = 0, w = p >> 5, b = p & 31;
  while (true) {
    const uint32_t inv = ~(m[w] >> b);
    const int t = inv ? ctz(inv) : 32;
    n += t;
    if (t < 32 - b) return n;
    ++w;
    b = 0;
  }
}

// Set bits at p, p - 1, ... before the first clear one (0 for p < 0).
TMT_DEV int ones_down(const uint32_t* m, int p) {
  if (p < 0) return 0;
  int n = 0, w = p >> 5, b = p & 31;
  while (true) {
    const int t = clz(~(m[w] << (31 - b)));
    n += t;
    if (t < b + 1 || w == 0) return n;
    --w;
    b = 31;
  }
}

// bits lo..hi-1 of word w of a mask, as a word mask
TMT_DEV uint32_t word_range(int w, int lo, int hi) {
  const int a = lo > (w << 5) ? lo - (w << 5) : 0;
  const int e = hi < (w << 5) + 32 ? hi - (w << 5) : 32;
  const uint32_t top = e >= 32 ? 0xffffffffu : ((1u << e) - 1u);
  return top & ~((1u << a) - 1u);
}

// set bits of a in [lo, hi)
TMT_DEV int range_popc(const uint32_t* a, int lo, int hi) {
  int n = 0;
  for (int w = lo >> 5; (w << 5) < hi; ++w) n += popc(a[w] & word_range(w, lo, hi));
  return n;
}
// any set bit of (a & b) in [lo, hi); b may be null (all ones)
TMT_DEV bool range_any(const uint32_t* a, int lo, int hi, const uint32_t* b = nullptr) {
  for (int w = lo >> 5; (w << 5) < hi; ++w)
    if (a[w] & (b ? b[w] : ~0u) & word_range(w, lo, hi)) return true;
  return false;
}
// the first set bit in [lo, hi), or -1
TMT_DEV int range_first(const uint32_t* a, int lo, int hi) {
  for (int w = lo >> 5; (w << 5) < hi; ++w) {
    const uint32_t v = a[w] & word_range(w, lo, hi);
    if (v) return (w << 5) + ctz(v);
  }
  return -1;
}

// The same for a board whose rows and columns are each at most 32 cells:
// every run and range then lies in one 32-bit window of the mask, and each
// helper is a few instructions without a loop.
TMT_DEV uint32_t window(const uint32_t* m, int lo) {  // bits lo .. lo + 31 (lo < n)
  const int w = lo >> 5, s = lo & 31;
#ifdef __CUDACC__
  return __funnelshift_r(m[w], m[w + 1], s);
#else
  return s ? (m[w] >> s) | (m[w + 1] << (32 - s)) : m[w];
#endif
}
TMT_DEV uint32_t low_bits(int len) { return len >= 32 ? ~0u : (1u << len) - 1u; }
TMT_DEV int ones_up32(const uint32_t* m, int p) { return ctz(~window(m, p)); }
TMT_DEV int ones_down32(const uint32_t* m, int p) {
  if (p < 0) return 0;
  return clz(~(p >= 31 ? window(m, p - 31) : m[0] << (31 - p)));
}
TMT_DEV uint32_t range32(const uint32_t* m, int lo, int hi) {
  return hi > lo ? window(m, lo) & low_bits(hi - lo) : 0u;
}

// ---- executors --------------------------------------------------------------

// TMT_NO_UNROLL, defined by a source before it includes this header, keeps
// the warp executor's cell loops rolled (K2's large board program measured
// faster so, K1's slower).
#ifdef TMT_NO_UNROLL
#define TMT_CELL_LOOP _Pragma("unroll 1")
#else
#define TMT_CELL_LOOP
#endif

#ifdef __CUDACC__

}  // namespace tmt

#include <cuda_runtime.h>

// The shared memory one block may opt in to on the current device, in
// bytes (each kernel library exports it for its wrapper's size check).
extern "C" int tmt_smem_optin(void) {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return bytes;
}

namespace tmt {

// Lets `kernel` take `bytes` of dynamic shared memory a block.  Up to the
// default 48 KiB this needs no call; above it the kernel's limit is raised
// once, and never lowered, so a later launch of the same size or smaller
// queries the attribute and sets nothing.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess || static_cast<size_t>(a.maxDynamicSharedSizeBytes) >= bytes) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

constexpr uint32_t kFull = 0xffffffffu;

// kW warps per board; Warp = Warps<1> unless a kernel asks for more.
template <int kW>
struct Warps {
  static constexpr int kThreads = 32 * kW;
  int n;     // cells of the board
  int tid;   // this thread: lane tid % 32 of warp tid / 32
  int* red;  // with several warps: kW ints of shared memory for the reductions

  TMT_DEV int lane() const { return kW == 1 ? tid : tid & 31; }
  TMT_DEV int warp() const { return kW == 1 ? 0 : tid >> 5; }
  // the barrier that ends a phase
  TMT_DEV void sync() const {
    if constexpr (kW == 1)
      __syncwarp();
    else
      __syncthreads();
  }
  // the warps' values v, one a warp, folded with op (several warps)
  template <class Op>
  TMT_DEV int across(int v, Op op) const {
    if (lane() == 0) red[warp()] = v;
    __syncthreads();
    int out = red[0];
#pragma unroll
    for (int w = 1; w < kW; ++w) out = op(out, red[w]);
    __syncthreads();
    return out;
  }

  // f(i) for every cell i, then a barrier
  template <class F>
  TMT_DEV void each(F f) const {
    each_of(n, f);
  }
  // f(i) for every i < m, then a barrier
  // (the loops run over whole strides, so that a board size fixed at
  // compile time unrolls them)
  template <class F>
  TMT_DEV void each_of(int m, F f) const {
    TMT_CELL_LOOP
    for (int base = 0; base < m; base += kThreads)
      if (base + tid < m) f(base + tid);
    sync();
  }
  // f runs on every cell, side effects and all
  template <class F>
  TMT_DEV bool any(F f) const {
    bool v = false;
    TMT_CELL_LOOP
    for (int base = 0; base < n; base += kThreads)
      if (base + tid < n) v = f(base + tid) || v;
    if constexpr (kW == 1) __syncwarp();
    return lanes_any(v);
  }
  template <class F>
  TMT_DEV int count(F f) const {
    int v = 0;
    TMT_CELL_LOOP
    for (int base = 0; base < n; base += kThreads)
      if (base + tid < n) v += f(base + tid) ? 1 : 0;
    if constexpr (kW == 1) __syncwarp();
    return lanes_sum(v);
  }
  // max over cells of f(i), at least `floor`
  template <class F>
  TMT_DEV int max(F f, int floor) const {
    int v = floor;
    TMT_CELL_LOOP
    for (int base = 0; base < n; base += kThreads)
      if (base + tid < n) v = ::max(v, f(base + tid));
    if constexpr (kW == 1) __syncwarp();
    return lanes_max(v);
  }
  // bitwise OR over cells of f(i)
  template <class F>
  TMT_DEV int bit_or(F f) const {
    int v = 0;
    TMT_CELL_LOOP
    for (int base = 0; base < n; base += kThreads)
      if (base + tid < n) v |= f(base + tid);
    if constexpr (kW == 1) __syncwarp();
    return lanes_or(v);
  }
  TMT_DEV bool leader() const { return tid == 0; }

  // out[w] bit l = f(32 w + l) for 32 w + l < m, one vote per word (warp
  // w % kW votes word w), and the trailing zero word; then a barrier
  template <class F>
  TMT_DEV void ballot(int m, uint32_t* out, F f) const {
    TMT_CELL_LOOP
    for (int base = 32 * warp(); base < m; base += kThreads) {
      const int i = base + lane();
      const unsigned v = __ballot_sync(kFull, i < m && f(i));
      if (lane() == 0) out[base >> 5] = v;
    }
    if (tid == 0) out[(m + 31) >> 5] = 0;
    sync();
  }
  // ballot for NM masks at once: bit q of f(i) goes to outs[q]
  template <int NM, class F>
  TMT_DEV void ballots(int m, uint32_t* const (&outs)[NM], F f) const {
    TMT_CELL_LOOP
    for (int base = 32 * warp(); base < m; base += kThreads) {
      const int i = base + lane();
      const uint32_t v = i < m ? static_cast<uint32_t>(f(i)) : 0u;
#pragma unroll
      for (int q = 0; q < NM; ++q) {
        const unsigned b = __ballot_sync(kFull, (v >> q) & 1u);
        if (lane() == 0) outs[q][base >> 5] = b;
      }
    }
    if (tid == 0)
      for (int q = 0; q < NM; ++q) outs[q][(m + 31) >> 5] = 0;
    sync();
  }
  // the i < m with f(i), in order, into q; returns their number.  each_of
  // over the result hands the j-th of them to thread j mod kThreads.
  template <class F>
  TMT_DEV int compact(int m, uint16_t* q, F f) const {
    int total = 0;
    TMT_CELL_LOOP
    for (int base = 0; base < m; base += kThreads) {
      const int i = base + tid;
      const bool p = i < m && f(i);
      const unsigned v = __ballot_sync(kFull, p);
      int at = total, round = __popc(v);
      if constexpr (kW > 1) {  // the warps before this one come first
        if (lane() == 0) red[warp()] = round;
        __syncthreads();
        round = 0;
#pragma unroll
        for (int w = 0; w < kW; ++w) {
          at += w < warp() ? red[w] : 0;
          round += red[w];
        }
        __syncthreads();
      }
      if (p) q[at + __popc(v & ((1u << lane()) - 1u))] = static_cast<uint16_t>(i);
      total += round;
    }
    sync();
    return total;
  }
  // a value that each thread holds, reduced over the board's threads
  TMT_DEV bool lanes_any(bool v) const {
    const bool r = __any_sync(kFull, v) != 0;
    if constexpr (kW == 1)
      return r;
    else
      return across(r ? 1 : 0, [](int a, int b) { return a | b; }) != 0;
  }
  TMT_DEV int lanes_sum(int v) const {
    const int r = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(v)));
    if constexpr (kW == 1)
      return r;
    else
      return across(r, [](int a, int b) { return a + b; });
  }
  TMT_DEV int lanes_or(int v) const {
    const int r = static_cast<int>(__reduce_or_sync(kFull, static_cast<unsigned>(v)));
    if constexpr (kW == 1)
      return r;
    else
      return across(r, [](int a, int b) { return a | b; });
  }
  TMT_DEV int lanes_max(int v) const {
    const int r = __reduce_max_sync(kFull, v);
    if constexpr (kW == 1)
      return r;
    else
      return across(r, [](int a, int b) { return a > b ? a : b; });
  }
  TMT_DEV int lanes_min(int v) const {
    const int r = __reduce_min_sync(kFull, v);
    if constexpr (kW == 1)
      return r;
    else
      return across(r, [](int a, int b) { return a < b ? a : b; });
  }
};
using Warp = Warps<1>;

#else  // host build: the same phases as loops over the cells

template <int kW>
struct Warps {
  int n;
  int tid;
  int* red;
  void sync() const {}
  template <class F>
  void each(F f) const {
    for (int i = 0; i < n; ++i) f(i);
  }
  template <class F>
  void each_of(int m, F f) const {
    for (int i = 0; i < m; ++i) f(i);
  }
  template <class F>
  bool any(F f) const {
    bool out = false;
    for (int i = 0; i < n; ++i) out = f(i) || out;
    return out;
  }
  template <class F>
  int count(F f) const {
    int out = 0;
    for (int i = 0; i < n; ++i) out += f(i) ? 1 : 0;
    return out;
  }
  template <class F>
  int max(F f, int floor) const {
    int out = floor;
    for (int i = 0; i < n; ++i) out = std::max(out, f(i));
    return out;
  }
  template <class F>
  int bit_or(F f) const {
    int out = 0;
    for (int i = 0; i < n; ++i) out |= f(i);
    return out;
  }
  bool leader() const { return true; }
  template <class F>
  void ballot(int m, uint32_t* out, F f) const {
    for (int w = 0; w < mask_words(m); ++w) out[w] = 0;
    for (int i = 0; i < m; ++i)
      if (f(i)) out[i >> 5] |= 1u << (i & 31);
  }
  template <int NM, class F>
  void ballots(int m, uint32_t* const (&outs)[NM], F f) const {
    for (int q = 0; q < NM; ++q)
      for (int w = 0; w < mask_words(m); ++w) outs[q][w] = 0;
    for (int i = 0; i < m; ++i) {
      const uint32_t v = static_cast<uint32_t>(f(i));
      for (int q = 0; q < NM; ++q)
        if ((v >> q) & 1u) outs[q][i >> 5] |= 1u << (i & 31);
    }
  }
  template <class F>
  int compact(int m, uint16_t* q, F f) const {
    int total = 0;
    for (int i = 0; i < m; ++i)
      if (f(i)) q[total++] = static_cast<uint16_t>(i);
    return total;
  }
  bool lanes_any(bool v) const { return v; }
  int lanes_sum(int v) const { return v; }
  int lanes_or(int v) const { return v; }
  int lanes_max(int v) const { return v; }
  int lanes_min(int v) const { return v; }
};
using Warp = Warps<1>;

#endif

}  // namespace tmt
