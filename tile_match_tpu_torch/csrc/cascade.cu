// Fused no-specials cascade for Hopper (sm_90a), one or four warps a board.
//
// Replaces the TPU kernel `fused_cascade` of
// tile_match_tpu/ops/pallas_cascade.py:1107 (call :1132, body
// `_cascade_kernel` :1065, with the helpers `_union_mask_tile`,
// `_gravity_tile`, `_fill_tile`/`_tf2x32_tile`, `_active_tile` and
// `_settled_mask_tile`).  Its plain PyTorch version is `cascade_reference`
// in tile_match_tpu_torch/ops/cascade.py, and the outputs of the two are
// equal bit for bit.
//
// What it computes, per board: while the board holds a >= 3 same-colour run
// and fewer than `max_cascades` trips have run, one cascade trip — detect
// the lines and delete their union, count it, stable gravity per column,
// refill the empties with randint(fold_in(sub, t), (R, C), 1, K + 1) — the
// phases K2 shares (csrc/trip.cuh) without the kind channel and the case
// table.  Then the settled effective-action mask: 8 colour stencils per
// swap (csrc/mask.cuh), the actions looped over the lanes in action-table
// order (down-swaps, then right-swaps).
//
// What bounds it on the card: not memory — a 10x10 board is 400 bytes in
// and about 600 bytes out, a 0.005 ms bound at B=16384.  A trip is ~8
// dependent warp phases on the board in shared memory plus a hash a
// refilled cell, and a board runs its trips one after another: latency,
// times each board's own trips, and a launch lasts at least as long as its
// longest board.  The design: a board on one warp, or on four when the
// launch has fewer than 8,192 boards (`Warps`, csrc/block.cuh): 32 or 8
// boards in flight per SM, each freeing its slot after its own last trip,
// with warp votes for the reductions (and, on four warps, a barrier a
// phase); the board's
// shape fixed at compile time for each shape of at most 32 by 32 (one
// library a shape, `Geometry` in csrc/trip.cuh), read at run time above
// that; the lowest anchoring row, run lengths, extension reaches and the
// union cover from row-major and column-major cell bit masks in place of
// walks; the refill keys of 32 trips hashed at once, and each empty cell's
// two hashes on a pair of lanes.  The TPU's batch-on-lanes transposes,
// trip chunks and precomputed key words are gone.
//
// Limits: the board's working set fits a block's shared memory (2,032
// bytes at 10x10, ~13 bytes a cell at 36x36); kind is all-normal, as on
// every no-specials board.

#include "mask.cuh"
#include "trip.cuh"

namespace tmt {

// Warps a board: a launch of fewer than kFewBoards boards runs kWarpsFew
// warps a board, its boards' latency being what counts (a Gym step runs
// one board: a lone board's trip is ~2x faster on four warps than on
// one); a larger one kWarpsMany, the most boards in flight.  Measured on
// the H100 against two warps a board (PERF.md §6).
constexpr int kWarpsFew = 4, kWarpsMany = 1, kFewBoards = 8192;

// Shared memory of one board.
template <class Ln>
struct CascadeSmem {
  Ln L;
  int *x, *y;     // the board, and the board after the delete
  uint16_t* q;    // compacted empty cells
  uint32_t* emp;  // empty cells (cm)
  uint32_t* keys; // KeyRing words
  int* red;       // the executor's reductions across warps

  TMT_HOST_DEV size_t carve(unsigned char* base, int R, int C) {
    const int n = R * C;
    Arena a{base, 0};
    L.carve(a, R, C);
    x = a.take<int>(n);
    y = a.take<int>(n);
    q = a.take<uint16_t>(n);
    emp = a.take<uint32_t>(mask_words(n));
    keys = a.take<uint32_t>(4 * 32);
    red = a.take<int>(kWarpsFew);
    return a.used;
  }
};

template <class Ln>
TMT_HOST_DEV size_t cascade_smem_bytes(int R, int C) {
  CascadeSmem<Ln> s;
  return s.carve(nullptr, R, C);
}

struct CascadeState {
  int elim, trips;
  bool lined;
};

// The board's cascade; s.x holds the board on entry and on exit.
template <class W, class Ln>
TMT_DEV void cascade_program(const W& w, const CascadeSmem<Ln>& s, int K, int max_cascades,
                             uint32_t key0, uint32_t key1, CascadeState& st) {
  const Ln& L = s.L;
  const int n = L.n();
  const uint32_t mult = randint_mult(static_cast<uint32_t>(K));
  int* x = s.x;
  KeyRing ring{s.keys, -1};
  st.elim = 0;
  st.trips = 0;
  while (true) {
    const int sr0 = line_masks(w, L, x);
    st.lined = sr0 >= 0;
    if (!st.lined || st.trips >= max_cascades) break;
    detect(w, L, sr0);
    // delete the union into y, then gravity
    int del = 0;
    gravity(w, L, s.y, nullptr, x, nullptr, s.emp, [&](int i) {
      bool cov_h, cov_v;
      L.cover(x, i, cov_h, cov_v);
      const bool d = bit(L.p, i) || ((cov_h || cov_v) && x[i] > 0);
      del += d;
      s.y[i] = d ? 0 : x[i];
      return d;
    });
    st.elim += w.lanes_sum(del);
    refill(w, n, x, nullptr, s.q, ring, key0, key1, st.trips, static_cast<uint32_t>(K), mult);
    st.trips += 1;
  }
}

// The settled effective-action mask of the board in x (kind all-normal).
template <class W, class Ln>
TMT_DEV void cascade_mask(const W& w, const Ln& L, const int* x, bool* mask) {
  const int R = L.R(), C = L.C();
  auto at = [&](int r, int c) -> int {
    return (r >= 0 && r < R && c >= 0 && c < C) ? x[r * C + c] : -1;
  };
  auto normal = [](int, int) -> int { return 1; };
  w.each_of(2 * R * C - R - C, [&](int a) { mask[a] = settled_action(a, R, C, at, normal, false); });
}

}  // namespace tmt

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

// 32 warps an SM (32 / kW boards): ptxas keeps each thread within 64
// registers
template <class Ln, int kW>
__global__ void __launch_bounds__(32 * kW, 32 / kW)
    cascade_kernel(const int* __restrict__ colour_in, const long long* __restrict__ sub_keys,
                   int* __restrict__ colour_out, int* __restrict__ elim_out,
                   int* __restrict__ trips_out, bool* __restrict__ trunc_out,
                   bool* __restrict__ mask_out, int R, int C, int K, int max_cascades) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t b = blockIdx.x;
  tmt::CascadeSmem<Ln> s;
  s.carve(smem, R, C);
  const int n = s.L.n();
  const tmt::Warps<kW> w{n, static_cast<int>(threadIdx.x), s.red};
  w.each([&](int i) { s.x[i] = colour_in[b * n + i]; });
  tmt::CascadeState st;
  tmt::cascade_program(w, s, K, max_cascades, static_cast<uint32_t>(sub_keys[2 * b]),
                       static_cast<uint32_t>(sub_keys[2 * b + 1]), st);
  w.each([&](int i) { colour_out[b * n + i] = s.x[i]; });
  if (w.leader()) {
    elim_out[b] = st.elim;
    trips_out[b] = st.trips;
    trunc_out[b] = st.lined;
  }
  tmt::cascade_mask(w, s.L, s.x, mask_out + b * (2 * n - s.L.R() - s.L.C()));
}

const auto kernel_many = cascade_kernel<tmt::Geometry, tmt::kWarpsMany>;
const auto kernel_few = cascade_kernel<tmt::Geometry, tmt::kWarpsFew>;

}  // namespace

// Shared memory of one board, in bytes.
extern "C" long long tmt_fused_cascade_smem(int R, int C) {
  return static_cast<long long>(tmt::cascade_smem_bytes<tmt::Geometry>(R, C));
}

// Boards in flight per SM at R x C in a launch of kFewBoards boards or
// more, from the occupancy calculator (0 when a board does not fit).
extern "C" int tmt_fused_cascade_occupancy(int R, int C) {
  const size_t smem = tmt::cascade_smem_bytes<tmt::Geometry>(R, C);
  int blocks = 0;
  if (!tmt::takes(R, C) || tmt::allow_smem(kernel_many, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel_many, 32 * tmt::kWarpsMany,
                                                    smem) != cudaSuccess)
    return 0;
  return blocks;
}

// Launches the cascade for B boards on `stream`; returns the cudaError_t of
// the launch (0 on success).  colour_in/colour_out: int32[B, R, C];
// sub_keys: int64[B, 2] threefry words; elim/trips: int32[B];
// truncated: bool[B]; mask: bool[B, 2RC - R - C].
extern "C" int tmt_fused_cascade(const int* colour_in, const long long* sub_keys,
                                 int* colour_out, int* elim, int* trips, bool* truncated,
                                 bool* mask, int B, int R, int C, int K, int max_cascades,
                                 void* stream) {
  if (B == 0) return 0;
  if (!tmt::takes(R, C) || R * C > 65535 || K < 1 || K > 65535) return cudaErrorInvalidValue;
  const size_t smem = tmt::cascade_smem_bytes<tmt::Geometry>(R, C);
  const bool few = B < tmt::kFewBoards;
  const auto kernel = few ? kernel_few : kernel_many;
  const cudaError_t err = tmt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, 32 * (few ? tmt::kWarpsFew : tmt::kWarpsMany), smem,
           static_cast<cudaStream_t>(stream)>>>(colour_in, sub_keys, colour_out, elim, trips,
                                                truncated, mask, R, C, K, max_cascades);
  return static_cast<int>(cudaGetLastError());
}

#else  // host build (TMT_HOST_BUILD): the same board program, board by board

#include <vector>

// As tmt_fused_cascade, on the host; returns 0, or -1 for a board shape the
// library's geometry does not take.
extern "C" int tmt_fused_cascade_host(const int* colour_in, const long long* sub_keys,
                                      int* colour_out, int* elim, int* trips, bool* truncated,
                                      bool* mask, int B, int R, int C, int K, int max_cascades) {
  if (!tmt::takes(R, C)) return -1;
  const int n = R * C;
  const size_t A = 2 * n - R - C;
  const tmt::Warp w{n};
  std::vector<uint64_t> smem(tmt::cascade_smem_bytes<tmt::Geometry>(R, C) / 8 + 2);
  tmt::CascadeSmem<tmt::Geometry> s;
  s.carve(reinterpret_cast<unsigned char*>(smem.data()), R, C);
  for (size_t b = 0; b < static_cast<size_t>(B); ++b) {
    for (int i = 0; i < n; ++i) s.x[i] = colour_in[b * n + i];
    tmt::CascadeState st;
    tmt::cascade_program(w, s, K, max_cascades, static_cast<uint32_t>(sub_keys[2 * b]),
                         static_cast<uint32_t>(sub_keys[2 * b + 1]), st);
    for (int i = 0; i < n; ++i) colour_out[b * n + i] = s.x[i];
    elim[b] = st.elim;
    trips[b] = st.trips;
    truncated[b] = st.lined;
    tmt::cascade_mask(w, s.L, s.x, mask + b * A);
  }
  return 0;
}

#endif
