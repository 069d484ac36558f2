// The combination branch of a move for Hopper (sm_90a), one warp per board
// (K5 `combination_trip`).
//
// Replaces the XLA combination round of `batched_step_fused_sp`
// (tile_match_tpu/envs/fused.py:422-524; its per-board body `one` at
// :469-480, `combination_match` at tile_match_tpu/ops/combination.py:42-144);
// no Pallas kernel computed it.  Its plain PyTorch version is
// `engine.combination_branch` in tile_match_tpu_torch/engine.py; the outputs
// of the two are equal bit for bit.
//
// What it computes, for each board whose `comb` flag is set (a swap of two
// specials, or of a cookie and anything, ops/combination.py):
//   1. the direct edits of the 9-way case table: cookie+cookie wipes the
//      board; cookie+normal deletes the cookie cell and the partner
//      colour's normals; cookie+special deletes the cookie cell and turns
//      those normals into the partner's special; laser and bomb pairs
//      delete both swap cells;
//   2. the case's seed frames, pushed in reverse execution order as
//      `combination_match` pushes them (laser+laser: a vertical and a
//      horizontal laser at (rmin, cmin); laser+bomb: three horizontal and
//      three vertical lasers around it, clipped to the board; bomb+bomb: a
//      5x5 sweep at (rmin, cmin); cookie+normal and cookie+special: a scan
//      of the partner colour's specials), uncounted;
//   3. the activation machine (csrc/machine.cuh) under `stack_max` and
//      `activation_steps_max`: a dropped push sets ovf (and kCapStack when
//      a micro-step pushed it), frames left at the budget set ovf and
//      kCapSteps;
//   4. activated = 2 + the machine's count - 1 for cookie+normal, and the
//      eliminations (cells of kind 0);
//   5. stable gravity of both channels, then key', kd = split(key) and the
//      refill from randint(kd, (R, C), 1, K + 1) (csrc/threefry.cuh).
// A board whose flag is clear is copied through with zero counts and its
// key unchanged, and runs nothing else: the launch takes the whole batch,
// with no compaction of the flagged boards and no host synchronisation.
//
// What bounds it on the card: not memory (the flagged boards' bytes in and
// out, ~1.6 KB a 10x10 board) and not arithmetic, but the chain of
// dependent micro-steps of the longest board's activation (a
// cookie+special turns every normal of the partner's colour into that
// special and each one's frame scans its region in turn; laser+bomb seeds
// six lasers).  The design: one warp per board, the machine's decisions
// taken alike by every lane and its region scans and deletions spread over
// the lanes (csrc/machine.cuh, shared with K4); the direct edits, the
// counts, gravity and the refill on the whole warp (csrc/trip.cuh); the
// board and its stack in shared memory when they fit the block's opt-in
// limit and in a device buffer the wrapper hands in when not (80x80 and
// up, at the default `stack_max` of R*C + 8 frames); the board's shape
// fixed at compile time for boards up to 32 by 32 (one library a shape, as
// K1-K4), read at run time above.
//
// Limits: at most 65,535 cells a board (16-bit cell indices of the refill).
#define TMT_NO_UNROLL

#include "machine.cuh"

namespace tmt {

struct CombConfig {
  int R, C, K, SM, steps;  // stack_max, activation_steps_max (< 0: no budget)
};

// Scratch of one board.  Cells are flat row-major indices.
template <class Ln>
struct CombSmem {
  Ln L;                 // the geometry alone
  int *x, *k, *y, *yk;  // the board; the board before gravity
  uint16_t* q;          // compacted empty cells
  uint32_t* emp;
  int* ccount;  // cells of each colour 1..K
  Frames frames;

  TMT_HOST_DEV size_t carve(unsigned char* base, const CombConfig& cf) {
    const int n = cf.R * cf.C;
    Arena a{base, 0};
    L.shape(cf.R, cf.C);
    int** cell[4] = {&x, &k, &y, &yk};
    for (auto p : cell) *p = a.take<int>(n);
    q = a.take<uint16_t>(n);
    emp = a.take<uint32_t>(mask_words(n));
    ccount = a.take<int>(cf.K + 1);
    frames.carve(a, cf.SM);
    return (a.used + 15) & ~static_cast<size_t>(15);
  }
};

template <class Ln>
TMT_HOST_DEV size_t comb_bytes(const CombConfig& cf) {
  CombSmem<Ln> s;
  return s.carve(nullptr, cf);
}

TMT_HOST_DEV bool comb_takes(const CombConfig& cf) {
  return takes(cf.R, cf.C) && cf.R * cf.C <= 65535 && cf.K >= 1 && cf.K <= 65535 && cf.SM >= 1;
}

struct CombResult {
  int elim, act, ovf, caps, live;
  uint32_t key0, key1;
};

// The combination branch of board s.x / s.k, swapped at (r1, c1) and
// (r2, c2), with key (key0, key1).  Leaves the board after refill in s.x /
// s.k.
template <class W, class Ln>
TMT_DEV void comb_program(const W& w, CombSmem<Ln>& s, const CombConfig& cf, int r1, int c1, int r2,
                          int c2, uint32_t key0, uint32_t key1, CombResult& res) {
  const Ln& L = s.L;
  const int R = L.R(), C = L.C(), n = L.n();
  const int i1 = r1 * C + c1, i2 = r2 * C + c2;
  const int k1 = s.k[i1], k2 = s.k[i2], col1 = s.x[i1], col2 = s.x[i2];
  w.sync();  // every lane has read the swap cells before the edits

  // the case (ops/combination.py `combination_match`)
  const bool laser1 = k1 == kKindV || k1 == kKindH, laser2 = k2 == kKindV || k2 == kKindH;
  const bool cc = k1 == kKindCookie && k2 == kKindCookie;
  const bool cn = (k1 == kKindCookie && k2 == kKindNormal) || (k1 == kKindNormal && k2 == kKindCookie);
  const bool cs = (k1 == kKindCookie && k2 >= 2) || (k1 >= 2 && k2 == kKindCookie);
  const bool ll = laser1 && laser2;
  const bool lb = (k1 == kKindBomb && laser2) || (k2 == kKindBomb && laser1);
  const bool bb = k1 == kKindBomb && k2 == kKindBomb;
  const bool cookie1 = k1 == kKindCookie;
  const int cook = cookie1 ? i1 : i2, other_k = cookie1 ? k2 : k1, other_col = cookie1 ? col2 : col1;

  // 1. the direct edits
  w.each([&](int i) {
    const bool same = s.x[i] == other_col && s.k[i] == kKindNormal;
    const bool del = cc || ((cn || cs) && i == cook) || ((ll || lb || bb) && (i == i1 || i == i2)) ||
                     (cn && same);
    if (del) {
      s.x[i] = 0;
      s.k[i] = 0;
    } else if (cs && same) {
      s.k[i] = other_k;
    }
  });

  // 2. the seeds, in reverse execution order
  Machine<W, Ln> mc{w, L, s.x, s.k, s.ccount, s.frames, cf.K, cf.SM};
  const int rmin = r1 < r2 ? r1 : r2, cmin = c1 < c2 ? c1 : c2, at = rmin * C + cmin;
  if (bb) mc.push(kOpBomb2, at, 0, 0);
  if (ll) {
    mc.push(kKindH, at, 0);
    mc.push(kKindV, at, 0);
  }
  if (lb) {
    if (cmin + 1 <= C - 1) mc.push(kKindV, at + 1, 0);
    mc.push(kKindV, at, 0);
    if (cmin - 1 >= 0) mc.push(kKindV, at - 1, 0);
    if (rmin + 1 <= R - 1) mc.push(kKindH, at + C, 0);
    mc.push(kKindH, at, 0);
    if (rmin - 1 >= 0) mc.push(kKindH, at - C, 0);
  }
  if (cn || cs) mc.push(kOpMaskscan, 0, 0, 0, other_col);

  // 3. the machine
  mc.count_colours();
  mc.run(cf.steps);
  res.act = 2 + mc.act - (cn ? 1 : 0);
  res.ovf = mc.ovf;
  res.caps = mc.caps;
  res.live = mc.sp;

  // 4-5. the eliminations, gravity and the refill from split(key)
  res.elim = n - w.count([&](int i) { return s.k[i] != 0; });
  gravity(w, L, s.y, s.yk, s.x, s.k, s.emp, [&](int i) {
    s.y[i] = s.x[i];
    s.yk[i] = s.k[i];
    return s.x[i] == 0 && s.k[i] == 0;
  });
  const RefillKeys next = split(key0, key1);           // (key', kd)
  const RefillKeys halves = split(next.b0, next.b1);  // randint's two keys of kd
  const uint32_t words[4] = {halves.a0, halves.a1, halves.b0, halves.b1};
  refill_from(w, n, s.x, s.k, s.q, [&] { return words; }, static_cast<uint32_t>(cf.K),
              randint_mult(static_cast<uint32_t>(cf.K)));
  res.key0 = next.a0;
  res.key1 = next.a1;
}

}  // namespace tmt

// Scratch of one board, in bytes.
extern "C" long long tmt_combination_trip_smem(int R, int C, int K, int SM) {
  const tmt::CombConfig cf{R, C, K, SM, 0};
  return static_cast<long long>(tmt::comb_bytes<tmt::Geometry>(cf));
}

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

struct CombOut {
  int *colour, *kind;
  long long* key;
  int *elim, *act;
  bool* ovf;
  int *caps, *live;
};

template <class Ln>
__global__ void __launch_bounds__(32)
    combination_trip_kernel(const int* __restrict__ colour_in, const int* __restrict__ kind_in,
                            const long long* __restrict__ keys, const int* __restrict__ coord1,
                            const int* __restrict__ coord2, const bool* __restrict__ comb,
                            CombOut out, unsigned char* scratch, size_t scratch_bytes,
                            tmt::CombConfig cf) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t b = blockIdx.x;
  tmt::CombSmem<Ln> s;
  s.carve(scratch != nullptr ? scratch + b * scratch_bytes : smem, cf);
  const int n = s.L.n();
  const tmt::Warp w{n, static_cast<int>(threadIdx.x)};
  if (!comb[b]) {  // copied through, zero counts
    for (int i = w.tid; i < n; i += 32) {
      out.colour[b * n + i] = colour_in[b * n + i];
      out.kind[b * n + i] = kind_in[b * n + i];
    }
    if (w.leader()) {
      out.key[2 * b] = keys[2 * b];
      out.key[2 * b + 1] = keys[2 * b + 1];
      out.elim[b] = 0;
      out.act[b] = 0;
      out.ovf[b] = false;
      out.caps[b] = 0;
      out.live[b] = 0;
    }
    return;
  }
  w.each([&](int i) {
    s.x[i] = colour_in[b * n + i];
    s.k[i] = kind_in[b * n + i];
  });
  tmt::CombResult res{};
  tmt::comb_program(w, s, cf, coord1[2 * b], coord1[2 * b + 1], coord2[2 * b], coord2[2 * b + 1],
                    static_cast<uint32_t>(keys[2 * b]), static_cast<uint32_t>(keys[2 * b + 1]),
                    res);
  w.each([&](int i) {
    out.colour[b * n + i] = s.x[i];
    out.kind[b * n + i] = s.k[i];
  });
  if (w.leader()) {  // every lane holds the same results
    out.key[2 * b] = res.key0;
    out.key[2 * b + 1] = res.key1;
    out.elim[b] = res.elim;
    out.act[b] = res.act;
    out.ovf[b] = res.ovf != 0;
    out.caps[b] = res.caps;
    out.live[b] = res.live;
  }
}

const auto kernel = combination_trip_kernel<tmt::Geometry>;

}  // namespace

// Boards in flight per SM at R x C with the default stack_max (R*C + 8)
// and K colours, from the occupancy calculator (0 when a board's scratch
// does not fit shared memory: it then runs from device memory).
extern "C" int tmt_combination_trip_occupancy(int R, int C, int K) {
  const tmt::CombConfig cf{R, C, K, R * C + 8, 4 * R * C + 16};
  const size_t smem = tmt::comb_bytes<tmt::Geometry>(cf);
  int blocks = 0;
  if (!tmt::comb_takes(cf) || tmt::allow_smem(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 32, smem) != cudaSuccess)
    return 0;
  return blocks;
}

// Launches the kernel for B boards on `stream`; returns the cudaError_t of
// the launch (0 on success).  colour/kind in and out: int32[B, R, C]; keys
// in and out: int64[B, 2] threefry words; coord1, coord2: int32[B, 2];
// comb: bool[B]; elim, act, caps, live: int32[B]; ovf: bool[B].  scratch:
// null to keep each board's scratch in shared memory, else
// B * tmt_combination_trip_smem bytes of device memory.
extern "C" int tmt_combination_trip(const int* colour_in, const int* kind_in, const long long* keys,
                                    const int* coord1, const int* coord2, const bool* comb,
                                    int* colour_out, int* kind_out, long long* key_out, int* elim,
                                    int* act, bool* ovf, int* caps, int* live, void* scratch, int B,
                                    int R, int C, int K, int SM, int steps, void* stream) {
  if (B == 0) return 0;
  const tmt::CombConfig cf{R, C, K, SM, steps};
  if (!tmt::comb_takes(cf)) return cudaErrorInvalidValue;
  const size_t bytes = tmt::comb_bytes<tmt::Geometry>(cf);
  const size_t smem = scratch != nullptr ? 0 : bytes;
  const cudaError_t err = tmt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const CombOut out{colour_out, kind_out, key_out, elim, act, ovf, caps, live};
  kernel<<<B, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      colour_in, kind_in, keys, coord1, coord2, comb, out, static_cast<unsigned char*>(scratch),
      bytes, cf);
  return static_cast<int>(cudaGetLastError());
}

#else  // host build (TMT_HOST_BUILD): the same board programs, board by board

#include <vector>

// As tmt_combination_trip, on the host; returns 0, or -1 for a board or
// config the library does not take.
extern "C" int tmt_combination_trip_host(const int* colour_in, const int* kind_in,
                                         const long long* keys, const int* coord1,
                                         const int* coord2, const bool* comb, int* colour_out,
                                         int* kind_out, long long* key_out, int* elim, int* act,
                                         bool* ovf, int* caps, int* live, int B, int R, int C,
                                         int K, int SM, int steps) {
  const tmt::CombConfig cf{R, C, K, SM, steps};
  if (!tmt::comb_takes(cf)) return -1;
  const int n = R * C;
  const tmt::Warp w{n};
  std::vector<uint64_t> scratch(tmt::comb_bytes<tmt::Geometry>(cf) / 8 + 2);
  tmt::CombSmem<tmt::Geometry> s;
  s.carve(reinterpret_cast<unsigned char*>(scratch.data()), cf);
  for (size_t b = 0; b < static_cast<size_t>(B); ++b) {
    for (int i = 0; i < n; ++i) {
      s.x[i] = colour_in[b * n + i];
      s.k[i] = kind_in[b * n + i];
    }
    tmt::CombResult res{0, 0, 0, 0, 0, static_cast<uint32_t>(keys[2 * b]),
                        static_cast<uint32_t>(keys[2 * b + 1])};
    if (comb[b])
      tmt::comb_program(w, s, cf, coord1[2 * b], coord1[2 * b + 1], coord2[2 * b],
                        coord2[2 * b + 1], res.key0, res.key1, res);
    for (int i = 0; i < n; ++i) {
      colour_out[b * n + i] = s.x[i];
      kind_out[b * n + i] = s.k[i];
    }
    key_out[2 * b] = res.key0;
    key_out[2 * b + 1] = res.key1;
    elim[b] = res.elim;
    act[b] = res.act;
    ovf[b] = res.ovf != 0;
    caps[b] = res.caps;
    live[b] = res.live;
  }
  return 0;
}

// The activation machine alone (csrc/machine.cuh), board by board: each
// board's stack is seeded with one frame, seed[6 b .. 6 b + 5] = (op, row,
// column, scan index, colour, counted), and runs at most `steps`
// micro-steps (< 0: no budget), as ops/activate.py's `push_frame` then
// `run_machine`.  Returns 0, or -1 for a board or config it does not take.
extern "C" int tmt_run_machine_host(const int* colour_in, const int* kind_in, const int* seed,
                                    int* colour_out, int* kind_out, int* count, bool* ovf,
                                    int* caps, int* live, int B, int R, int C, int K, int SM,
                                    int steps) {
  const tmt::CombConfig cf{R, C, K, SM, steps};
  if (!tmt::comb_takes(cf)) return -1;
  const int n = R * C;
  const tmt::Warp w{n};
  std::vector<uint64_t> scratch(tmt::comb_bytes<tmt::Geometry>(cf) / 8 + 2);
  tmt::CombSmem<tmt::Geometry> s;
  s.carve(reinterpret_cast<unsigned char*>(scratch.data()), cf);
  for (size_t b = 0; b < static_cast<size_t>(B); ++b) {
    for (int i = 0; i < n; ++i) {
      s.x[i] = colour_in[b * n + i];
      s.k[i] = kind_in[b * n + i];
    }
    tmt::Machine<tmt::Warp, tmt::Geometry> mc{w, s.L, s.x, s.k, s.ccount, s.frames, K, SM};
    const int* f = seed + 6 * b;
    mc.push(f[0], f[1] * C + f[2], f[5], f[3], f[4]);
    mc.count_colours();
    mc.run(steps);
    for (int i = 0; i < n; ++i) {
      colour_out[b * n + i] = s.x[i];
      kind_out[b * n + i] = s.k[i];
    }
    count[b] = mc.act;
    ovf[b] = mc.ovf != 0;
    caps[b] = mc.caps;
    live[b] = mc.sp;
  }
  return 0;
}

#endif
