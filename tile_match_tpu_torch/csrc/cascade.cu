// Fused no-specials cascade for Hopper (sm_90a), one thread block per board.
//
// Replaces the TPU kernel `fused_cascade` of
// tile_match_tpu/ops/pallas_cascade.py (body `_cascade_kernel`, with the
// helpers `_union_mask_tile`, `_gravity_tile`, `_fill_tile`/`_tf2x32_tile`,
// `_active_tile` and `_settled_mask_tile`).  Its plain PyTorch version is
// `cascade_reference` in tile_match_tpu_torch/ops/cascade.py, and the
// outputs of the two are equal bit for bit.
//
// What it computes, per board: while the board holds a >= 3 same-colour run
// and fewer than `max_cascades` trips have run, one cascade trip —
//   1. run lengths of every cell along its row and column;
//   2. the lowest row that anchors a line (block max-reduction);
//   3. the primary cells (horizontal runs in that row, vertical runs whose
//      bottom cell is in it) and the >= 3 extension segments through them;
//   4. delete that union and count it;
//   5. stable gravity per column (empties to the top);
//   6. refill the empties with randint(fold_in(sub, t), (R, C), 1, K + 1),
//      JAX's partitionable threefry-2x32 computed per cell in-kernel
//      (csrc/threefry.cuh).
// Then the settled effective-action mask: 8 colour stencils per swap, one
// thread per action, in action-table order (down-swaps, then right-swaps);
// the stencils are csrc/mask.cuh, shared with the specials mask kernel.
//
// What bounds it on the card: not memory — a 10x10 board is 400 bytes in and
// about 600 bytes out.  Each trip is a handful of short scans over shared
// memory, three block barriers and, for refilled cells, five threefry hashes
// of 20 rounds; the cost is integer issue and barrier latency, times each
// board's own number of trips.  The design keeps the board in shared memory
// for the whole cascade and gives each board its own block, so a board stops
// after its own last trip instead of running in lockstep with a tile of other
// boards (the TPU kernel's lanes ran the tile's maximum).  The TPU's
// batch-on-lanes transposes, trip chunks and precomputed key words are gone.
//
// Limits: R * C <= 1024 (one thread per cell); kind is all-normal, as on
// every no-specials board.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mask.cuh"
#include "threefry.cuh"

namespace {

constexpr int kNoReach = 1 << 20;

__global__ void cascade_kernel(const int* __restrict__ colour_in,
                               const long long* __restrict__ sub_keys,
                               int* __restrict__ colour_out, int* __restrict__ elim_out,
                               int* __restrict__ trips_out, bool* __restrict__ trunc_out,
                               bool* __restrict__ mask_out, int R, int C, int K,
                               int max_cascades, uint32_t mult) {
  extern __shared__ int smem[];
  const int n = R * C;
  int* x = smem;        // the board
  int* y = x + n;       // gravity output
  int* hlo = y + n;     // horizontal extension reach of a generator cell
  int* hhi = hlo + n;
  int* vlo = hhi + n;   // vertical extension reach
  int* vhi = vlo + n;
  unsigned char* prim = reinterpret_cast<unsigned char*>(vhi + n);
  __shared__ int s_row;

  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const bool live = i < n;
  const int r = live ? i / C : 0;
  const int c = live ? i % C : 0;
  const uint32_t s0 = static_cast<uint32_t>(sub_keys[2 * b]);
  const uint32_t s1 = static_cast<uint32_t>(sub_keys[2 * b + 1]);

  if (live) x[i] = colour_in[static_cast<size_t>(b) * n + i];
  __syncthreads();

  int elim = 0;
  int t = 0;
  bool lined;
  while (true) {
    // does any >= 3 run remain?
    bool starts_run = false;
    if (live) {
      const int v = x[i];
      if (v > 0) {
        if (c + 2 < C && x[i + 1] == v && x[i + 2] == v) starts_run = true;
        if (r + 2 < R && x[i + C] == v && x[i + 2 * C] == v) starts_run = true;
      }
    }
    lined = __syncthreads_or(starts_run);
    if (!lined || t >= max_cascades) break;

    // run lengths through this cell
    const int v = live ? x[i] : 0;
    const bool valid = v > 0;
    int lc = 0, rc = 0, uc = 0, dc = 0;
    if (live && valid) {
      for (int q = c - 1; q >= 0 && x[r * C + q] == v; --q) ++lc;
      for (int q = c + 1; q < C && x[r * C + q] == v; ++q) ++rc;
      for (int q = r - 1; q >= 0 && x[q * C + c] == v; --q) ++uc;
      for (int q = r + 1; q < R && x[q * C + c] == v; ++q) ++dc;
    }
    const bool h3 = valid && lc + rc + 1 >= 3;
    const bool v3 = valid && uc + dc + 1 >= 3;

    // the lowest row anchoring a line
    if (i == 0) s_row = -1;
    __syncthreads();
    if (h3 || (v3 && dc == 0)) atomicMax(&s_row, r);
    __syncthreads();
    const int sr0 = s_row;

    // primary cells: horizontal runs in row sr0, vertical runs ending there
    const bool is_prim = (h3 && r == sr0) || (v3 && r + dc == sr0);
    if (live) prim[i] = is_prim;
    __syncthreads();

    // extension segments through each primary cell: the same-colour,
    // non-primary chain on either side; a generator covers its chain if the
    // segment is >= 3 long
    if (live) {
      int lo_h = kNoReach, hi_h = -1, lo_v = kNoReach, hi_v = -1;
      if (is_prim) {
        int le = 0, re = 0, ue = 0, de = 0;
        for (int q = c - 1; q >= 0 && !prim[r * C + q] && x[r * C + q] == v; --q) ++le;
        for (int q = c + 1; q < C && !prim[r * C + q] && x[r * C + q] == v; ++q) ++re;
        for (int q = r - 1; q >= 0 && !prim[q * C + c] && x[q * C + c] == v; --q) ++ue;
        for (int q = r + 1; q < R && !prim[q * C + c] && x[q * C + c] == v; ++q) ++de;
        if (1 + le + re >= 3) { lo_h = c - le; hi_h = c + re; }
        if (1 + ue + de >= 3) { lo_v = r - ue; hi_v = r + de; }
      }
      hlo[i] = lo_h;
      hhi[i] = hi_h;
      vlo[i] = lo_v;
      vhi[i] = hi_v;
    }
    __syncthreads();

    bool del = is_prim;
    if (live && valid && !del) {
      for (int q = 0; q < C && !del; ++q) {
        const int p = r * C + q;
        del = hlo[p] <= c && c <= hhi[p];
      }
      for (int q = 0; q < R && !del; ++q) {
        const int p = q * C + c;
        del = vlo[p] <= r && r <= vhi[p];
      }
    }
    elim += __syncthreads_count(live && del);
    if (live && del) x[i] = 0;
    __syncthreads();

    // stable gravity: an empty cell lands at the number of empties above it,
    // a tile moves down by the number of empties below it
    if (live) {
      const int w = x[i];
      int dest = 0;
      if (w == 0) {
        for (int q = 0; q < r; ++q) dest += x[q * C + c] == 0;
      } else {
        dest = r;
        for (int q = r + 1; q < R; ++q) dest += x[q * C + c] == 0;
      }
      y[dest * C + c] = w;
    }
    __syncthreads();

    if (live) {
      const int w = y[i];
      x[i] = w != 0 ? w
                    : tmt::refill_colour(s0, s1, static_cast<uint32_t>(t),
                                    static_cast<uint32_t>(i),
                                    static_cast<uint32_t>(K), mult);
    }
    ++t;
    __syncthreads();
  }

  if (live) colour_out[static_cast<size_t>(b) * n + i] = x[i];
  if (i == 0) {
    elim_out[b] = elim;
    trips_out[b] = t;
    trunc_out[b] = lined;
  }

  // settled effective-action mask (csrc/mask.cuh); kind is all-normal
  const int A = 2 * n - R - C;
  auto at = [&](int rr, int cc) -> int {
    return (rr >= 0 && rr < R && cc >= 0 && cc < C) ? x[rr * C + cc] : -1;
  };
  auto normal = [](int, int) -> int { return 1; };
  for (int a = i; a < A; a += blockDim.x) {
    mask_out[static_cast<size_t>(b) * A + a] = tmt::settled_action(a, R, C, at, normal, false);
  }
}

}  // namespace

// Launches the cascade for B boards on `stream`; returns the cudaError_t of
// the launch (0 on success).  colour_in/colour_out: int32[B, R, C];
// sub_keys: int64[B, 2] threefry words; elim/trips: int32[B];
// truncated: bool[B]; mask: bool[B, 2RC - R - C].
extern "C" int tmt_fused_cascade(const int* colour_in, const long long* sub_keys,
                                 int* colour_out, int* elim, int* trips, bool* truncated,
                                 bool* mask, int B, int R, int C, int K, int max_cascades,
                                 void* stream) {
  if (B == 0) return 0;
  const int n = R * C;
  if (n > 1024 || R < 1 || C < 1 || K < 1 || K > 65535) return cudaErrorInvalidValue;
  const int threads = ((n + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(n) * (6 * sizeof(int) + 1);
  const uint32_t mult = tmt::randint_mult(static_cast<uint32_t>(K));
  cascade_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      colour_in, sub_keys, colour_out, elim, trips, truncated, mask, R, C, K,
      max_cascades, mult);
  return static_cast<int>(cudaGetLastError());
}
