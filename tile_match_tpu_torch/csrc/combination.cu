// The combination branch of a move for Hopper (sm_90a): K5
// `combination_trip`, a persistent grid of warps that each take boards
// from the batch and run only the flagged ones, a board a warp at a time.
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
//   3. the activation machine on cell bit planes (csrc/machine_bits.cuh)
//      under `stack_max` and `activation_steps_max`: a dropped push sets ovf
//      (and kCapStack when a micro-step pushed it), frames left at the
//      budget set ovf and kCapSteps;
//   4. activated = 2 + the machine's count - 1 for cookie+normal, and the
//      eliminations (cells of kind 0);
//   5. stable gravity of both channels, then key', kd = split(key) and the
//      refill from randint(kd, (R, C), 1, K + 1) (csrc/threefry.cuh).
// The flagged boards are updated in place: the kernel reads and writes the
// board of a flagged board only.  An unflagged board's cells are neither
// read nor written; its key is copied to the key output and its counts are
// zero.  No compaction of the flagged boards, no host synchronisation.
//
// What bounds it on the card: not memory (the flagged boards' bytes in and
// out, ~1.6 KB a 10x10 board) and not arithmetic, but the chain of
// dependent micro-steps of the longest board's activation (a
// cookie+special turns every normal of the partner's colour into that
// special and each one's frame scans its region in turn; laser+bomb seeds
// six lasers): on config 3's step-20 inputs at B=16384 (1,189 flagged
// boards) the longest chain is 77 micro-steps, the 99th percentile 69,
// the mean 10.25.  The first design (one 32-thread block a board over the
// whole batch, the machine of machine.cuh) took 0.0815 ms a launch there
// on fresh copies of the inputs, of which the copy-through of the
// unflagged boards alone 0.0206 and the longest chain alone 0.0666, ~1,700
// cycles a micro-step (PERF.md §6, NVIDIA H100 80GB HBM3, 700 W).  The
// design:
//   - a persistent grid, the SMs times the blocks that fit one (the
//     occupancy calculator; the wrapper keeps each plan), each block several
//     warps with a board's scratch each: boards in flight are bounded by
//     registers and shared memory, not by one warp a block;
//   - a block takes a contiguous share of the batch; its threads list the
//     flagged boards in shared memory by one vote a warp (the unflagged
//     ones get their key and zero counts there and then), and its warps
//     take the listed boards one at a time from a shared counter: a long
//     chain waits behind another board only when a block holds more
//     flagged boards than warps, and no global atomic is needed;
//   - the machine on three bit planes in registers (live, normal,
//     special), its top frame in registers and the frames below it 16
//     bytes each in shared memory: a micro-step is one vote, a
//     find-first-set and a shuffle, and its deletions an AND-NOT a word;
//   - the board's first cells are loaded while the keys hash, split(key)
//     and split(kd) two hashes at a time on the even and odd lanes;
//   - the direct edits, gravity and the refill on the whole warp
//     (csrc/trip.cuh); the board and its stack in shared memory when they
//     fit the block's opt-in limit and in a device buffer the wrapper hands
//     in when not (and for every board above 8,192 cells); the board's shape
//     fixed at compile time for boards up to 32 by 32 (one library a shape,
//     as K1-K4), read at run time above.
//
// Limits: at most 65,535 cells a board (16-bit cell indices of the refill).
#define TMT_NO_UNROLL

#include "machine_bits.cuh"

namespace tmt {

// words of a board's bit planes
TMT_HOST_DEV int plane_words(int n) { return (n + 31) / 32; }

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
  uint32_t* colours;  // the colour planes, (K + 1) words a word of the board
  Frame* stack;

  TMT_HOST_DEV size_t carve(unsigned char* base, const CombConfig& cf) {
    const int n = cf.R * cf.C;
    Arena a{base, 0};
    L.shape(cf.R, cf.C);
    int** cell[4] = {&x, &k, &y, &yk};
    for (auto p : cell) *p = a.take<int>(n);
    q = a.take<uint16_t>(n);
    emp = a.take<uint32_t>(mask_words(n));
    colours = a.take<uint32_t>(static_cast<size_t>(cf.K + 1) * plane_words(n));
    stack = a.take<Frame>(cf.SM);
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

// (key', kd) = split(key), and randint's two keys of kd, split(kd) (four
// words): on the card the four hashes two at a time, the even lanes
// taking each split's first key and the odd ones its second.
struct CombKeys {
  uint32_t next0, next1, words[4];
};

TMT_DEV CombKeys comb_keys(uint32_t k0, uint32_t k1, int lane) {
  CombKeys out;
#ifdef __CUDACC__
  const uint32_t half = static_cast<uint32_t>(lane) & 1u;
  uint32_t a0 = 0, a1 = half;
  threefry2x32(k0, k1, a0, a1);  // split(key): key' (even lanes), kd (odd)
  const uint32_t kd0 = __shfl_sync(kFull, a0, 1), kd1 = __shfl_sync(kFull, a1, 1);
  uint32_t c0 = 0, c1 = half;
  threefry2x32(kd0, kd1, c0, c1);  // split(kd)
  out.next0 = __shfl_sync(kFull, a0, 0);
  out.next1 = __shfl_sync(kFull, a1, 0);
  out.words[0] = __shfl_sync(kFull, c0, 0);
  out.words[1] = __shfl_sync(kFull, c1, 0);
  out.words[2] = __shfl_sync(kFull, c0, 1);
  out.words[3] = __shfl_sync(kFull, c1, 1);
#else
  const RefillKeys next = split(k0, k1), halves = split(next.b0, next.b1);
  out = CombKeys{next.a0, next.a1, {halves.a0, halves.a1, halves.b0, halves.b1}};
#endif
  return out;
}

// The combination branch of board s.x / s.k, swapped at (r1, c1) and
// (r2, c2), with the keys of its key (comb_keys).  Leaves the board after
// refill in s.x / s.k.
template <int NW, class W, class Ln>
TMT_DEV void comb_program(const W& w, const BitWarp<NW>& bw, CombSmem<Ln>& s, const CombConfig& cf,
                          int r1, int c1, int r2, int c2, const CombKeys& keys, CombResult& res) {
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
  BitMachine<NW, W, Ln> mc{w, bw, L, s.x, s.k, s.colours, s.stack, cf.K, cf.SM};
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
  mc.load();
  mc.run(cf.steps);
  mc.settle();
  res.act = 2 + mc.act - (cn ? 1 : 0);
  res.ovf = mc.ovf;
  res.caps = mc.caps;
  res.live = mc.sp;

  // 4-5. the eliminations, gravity and the refill from split(key)
  res.elim = n - mc.kinds();
  gravity(w, L, s.y, s.yk, s.x, s.k, s.emp, [&](int i) {
    s.y[i] = s.x[i];
    s.yk[i] = s.k[i];
    return s.x[i] == 0 && s.k[i] == 0;
  });
  refill_from(w, n, s.x, s.k, s.q, [&] { return keys.words; }, static_cast<uint32_t>(cf.K),
              randint_mult(static_cast<uint32_t>(cf.K)));
  res.key0 = keys.next0;
  res.key1 = keys.next1;
}

}  // namespace tmt

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 8;  // warps a block, a board's scratch each
// a board of more than 8 words a lane (8,192 cells) never fits a block's
// shared memory at the default stack_max: its kernel is compiled for
// scratch in device memory alone
constexpr int kMaxSharedWords = 8;
constexpr int kListBytes = 2048;  // at least the block's static shared memory

struct CombOut {
  long long* key;
  int *elim, *act;
  bool* ovf;
  int *caps, *live;
};

// A block takes `chunk` boards from board blockIdx.x * chunk, blockDim.x
// at a time: its threads write the key and zero counts of the unflagged
// ones and list the flagged ones in shared memory; its warps then take
// the listed boards one at a time.
//
// kShared: the warps' scratch lies in the block's shared memory (a pointer
// the compiler knows to be shared, so its accesses are shared-memory
// instructions), else in `scratch`, device memory.
template <class Ln, int NW, bool kShared>
__global__ void __launch_bounds__(32 * kMaxWarps, NW <= 2 ? 4 : 1)
    combination_trip_kernel(int* __restrict__ colour, int* __restrict__ kind,
                            const long long* __restrict__ keys, const int* __restrict__ coord1,
                            const int* __restrict__ coord2, const bool* __restrict__ comb,
                            CombOut out, unsigned char* scratch, size_t bytes, tmt::CombConfig cf,
                            int B, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int list[32 * kMaxWarps], listed, taken;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  tmt::CombSmem<Ln> s;
  s.carve(kShared ? smem + warp * bytes
                  : scratch + (static_cast<size_t>(blockIdx.x) * (blockDim.x >> 5) + warp) * bytes,
          cf);
  const int n = s.L.n();
  const tmt::Warp w{n, lane};
  const tmt::BitWarp<NW> bw{n, tmt::plane_words(n), lane};
  const int first = blockIdx.x * chunk, last = min(first + chunk, B);
  for (int base = first; base < last; base += blockDim.x) {
    if (threadIdx.x == 0) listed = taken = 0;
    __syncthreads();
    const int b = base + threadIdx.x;
    const bool mine = b < last, flag = mine && comb[b];
    if (mine && !flag) {  // the key through, zero counts; the board untouched
      out.key[2 * b] = keys[2 * b];
      out.key[2 * b + 1] = keys[2 * b + 1];
      out.elim[b] = 0;
      out.act[b] = 0;
      out.ovf[b] = false;
      out.caps[b] = 0;
      out.live[b] = 0;
    }
    const unsigned v = __ballot_sync(tmt::kFull, flag);
    int at = 0;
    if (lane == 0 && v != 0) at = atomicAdd(&listed, __popc(v));
    at = __shfl_sync(tmt::kFull, at, 0);
    if (flag) list[at + __popc(v & ((1u << lane) - 1u))] = b;
    __syncthreads();
    for (;;) {
      int i = 0;
      if (lane == 0) i = atomicAdd(&taken, 1);
      i = __shfl_sync(tmt::kFull, i, 0);
      if (i >= listed) break;
      const size_t f = list[i];
      // the board's first 128 cells in flight while the keys hash
      int cx[4], ck[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = 32 * u + lane;
        cx[u] = c < n ? colour[f * n + c] : 0;
        ck[u] = c < n ? kind[f * n + c] : 0;
      }
      const int r1 = coord1[2 * f], c1 = coord1[2 * f + 1], r2 = coord2[2 * f],
                c2 = coord2[2 * f + 1];
      const tmt::CombKeys ks = tmt::comb_keys(static_cast<uint32_t>(keys[2 * f]),
                                              static_cast<uint32_t>(keys[2 * f + 1]), lane);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = 32 * u + lane;
        if (c < n) {
          s.x[c] = cx[u];
          s.k[c] = ck[u];
        }
      }
      for (int c = 128 + lane; c < n; c += 32) {
        s.x[c] = colour[f * n + c];
        s.k[c] = kind[f * n + c];
      }
      __syncwarp();
      tmt::CombResult res{};
      tmt::comb_program(w, bw, s, cf, r1, c1, r2, c2, ks, res);
      for (int c = lane; c < n; c += 32) {
        colour[f * n + c] = s.x[c];
        kind[f * n + c] = s.k[c];
      }
      if (lane == 0) {  // every lane holds the same results
        out.key[2 * f] = res.key0;
        out.key[2 * f + 1] = res.key1;
        out.elim[f] = res.elim;
        out.act[f] = res.act;
        out.ovf[f] = res.ovf != 0;
        out.caps[f] = res.caps;
        out.live[f] = res.live;
      }
    }
    __syncthreads();  // every warp is done with the list
  }
}

// The launch of B boards: the kernel instance, warps a block, blocks, each
// warp's scratch.
struct Plan {
  const void* kernel;
  int warps, blocks;
  size_t bytes, smem;  // a board's scratch; shared memory a block (0: device memory)
};

// Blocks an SM for (kernel, threads, shared memory), from the occupancy
// calculator (0 on an error).
int blocks_per_sm(const void* kernel, int threads, size_t smem) {
  int blocks = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem) == cudaSuccess
             ? blocks
             : 0;
}

// The plan for B boards (B large: the whole grid); warps = 0 on an error.
Plan plan_of(int B, const tmt::CombConfig& cf) {
  const size_t bytes = tmt::comb_bytes<tmt::Geometry>(cf);
  // the block's list and its counters take the rest
  const int nw = tmt::plane_words(cf.R * cf.C);
  const long long fit = nw > 32 * kMaxSharedWords
                            ? 0
                            : (tmt_smem_optin() - kListBytes) / static_cast<long long>(bytes);
  const int warps = fit >= 1 ? static_cast<int>(fit < kMaxWarps ? fit : kMaxWarps) : 4;
  Plan p{nullptr, 0, 0, bytes, fit >= 1 ? warps * bytes : 0};
  const cudaError_t err = tmt::with_words<tmt::Geometry>(nw, [&](auto words) {
    constexpr int NW = decltype(words)::value;
    if (p.smem == 0 || NW > kMaxSharedWords) {
      const auto kernel = combination_trip_kernel<tmt::Geometry, NW, false>;
      p.kernel = reinterpret_cast<const void*>(kernel);
      return tmt::allow_smem(kernel, p.smem);
    }
    const auto kernel = combination_trip_kernel<tmt::Geometry, NW, NW <= kMaxSharedWords>;
    p.kernel = reinterpret_cast<const void*>(kernel);
    return tmt::allow_smem(kernel, p.smem);
  });
  int dev = 0, sms = 0;
  if (err != cudaSuccess || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return p;
  const int per_sm = blocks_per_sm(p.kernel, 32 * warps, p.smem);
  if (per_sm < 1) return p;
  long long blocks = static_cast<long long>(sms) * per_sm;
  const long long need = (static_cast<long long>(B) + warps - 1) / warps;  // no more warps than boards
  if (blocks > need) blocks = need;
  if (p.smem == 0) {  // scratch in device memory: at most 1 GiB of it
    const long long cap = ((1ll << 30) / static_cast<long long>(bytes)) / warps;
    if (blocks > cap) blocks = cap;
  }
  p.warps = warps;
  p.blocks = static_cast<int>(blocks < 1 ? 1 : blocks);
  return p;
}

}  // namespace

// Boards in flight per SM at R x C with the default stack_max (R*C + 8)
// and K colours: warps a block times the blocks the occupancy calculator
// fits on an SM (0 when the library does not take the shape).
extern "C" int tmt_combination_trip_occupancy(int R, int C, int K) {
  const tmt::CombConfig cf{R, C, K, R * C + 8, 4 * R * C + 16};
  if (!tmt::comb_takes(cf)) return 0;
  const Plan p = plan_of(1 << 30, cf);
  return p.warps == 0 ? 0 : p.warps * blocks_per_sm(p.kernel, 32 * p.warps, p.smem);
}

// The persistent grid for B boards: plan[0] warps a block, plan[1] blocks,
// plan[2] bytes of device-memory scratch each warp needs (0: its scratch
// lies in shared memory).  Returns 0, or a cudaError_t.
extern "C" int tmt_combination_trip_plan(int B, int R, int C, int K, int SM, long long* plan) {
  const tmt::CombConfig cf{R, C, K, SM, 0};
  if (!tmt::comb_takes(cf)) return cudaErrorInvalidValue;
  const Plan p = plan_of(B, cf);
  if (p.warps == 0) return cudaErrorInvalidConfiguration;
  plan[0] = p.warps;
  plan[1] = p.blocks;
  plan[2] = p.smem == 0 ? static_cast<long long>(p.bytes) : 0;
  return 0;
}

// Launches the kernel for B boards on `stream` with the grid of
// tmt_combination_trip_plan; returns the cudaError_t of the launch (0 on
// success).  colour/kind: int32[B, R, C], updated in place on the flagged
// boards; keys: int64[B, 2] threefry words; coord1, coord2: int32[B, 2];
// comb: bool[B]; key_out: int64[B, 2]; elim, act, caps, live: int32[B];
// ovf: bool[B]; scratch: null, or warps * blocks * plan[2] bytes of
// device memory.
extern "C" int tmt_combination_trip(int* colour, int* kind, const long long* keys, const int* coord1,
                                    const int* coord2, const bool* comb, long long* key_out,
                                    int* elim, int* act, bool* ovf, int* caps, int* live,
                                    void* scratch, int B, int R, int C, int K, int SM, int steps,
                                    int warps, int blocks, void* stream) {
  if (B == 0) return 0;
  const tmt::CombConfig cf{R, C, K, SM, steps};
  if (!tmt::comb_takes(cf) || warps < 1 || warps > kMaxWarps || blocks < 1)
    return cudaErrorInvalidValue;
  const size_t bytes = tmt::comb_bytes<tmt::Geometry>(cf);
  const size_t smem = scratch != nullptr ? 0 : warps * bytes;
  const int chunk = static_cast<int>((static_cast<long long>(B) + blocks - 1) / blocks);
  const CombOut out{key_out, elim, act, ovf, caps, live};
  return tmt::with_words<tmt::Geometry>(tmt::plane_words(R * C), [&](auto words) {
    constexpr int NW = decltype(words)::value;
    if (NW > kMaxSharedWords && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const auto kernel = scratch != nullptr
                            ? combination_trip_kernel<tmt::Geometry, NW, false>
                            : combination_trip_kernel<tmt::Geometry, NW, NW <= kMaxSharedWords>;
    const cudaError_t err = tmt::allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
        colour, kind, keys, coord1, coord2, comb, out, static_cast<unsigned char*>(scratch), bytes,
        cf, B, chunk);
    return static_cast<int>(cudaGetLastError());
  });
}

#else  // host build (TMT_HOST_BUILD): the same board programs, board by board

#include <vector>

// As tmt_combination_trip_plan, for the host build below: one warp in one
// block, its scratch plan[2] bytes in the caller's buffer.
extern "C" int tmt_combination_trip_plan(int B, int R, int C, int K, int SM, long long* plan) {
  const tmt::CombConfig cf{R, C, K, SM, 0};
  if (!tmt::comb_takes(cf) || B < 0) return -1;
  plan[0] = 1;
  plan[1] = 1;
  plan[2] = static_cast<long long>(tmt::comb_bytes<tmt::Geometry>(cf));
  return 0;
}

// As tmt_combination_trip, board by board on the host, with the card's
// arguments but the stream: the flagged boards updated in place (an
// unflagged board is neither read nor written), a board's scratch at the
// start of `scratch` (or, null, in a buffer of its own); the grid's warps
// and blocks, which it does not use, are at least 1 as on the card.
// Returns 0, or -1 for a board, config or grid the library does not take.
extern "C" int tmt_combination_trip_host(int* colour, int* kind, const long long* keys,
                                         const int* coord1, const int* coord2, const bool* comb,
                                         long long* key_out, int* elim, int* act, bool* ovf,
                                         int* caps, int* live, void* scratch, int B, int R, int C,
                                         int K, int SM, int steps, int warps, int blocks) {
  const tmt::CombConfig cf{R, C, K, SM, steps};
  if (!tmt::comb_takes(cf) || warps < 1 || blocks < 1) return -1;
  const int n = R * C;
  const tmt::Warp w{n};
  std::vector<uint64_t> own(scratch != nullptr ? 0 : tmt::comb_bytes<tmt::Geometry>(cf) / 8 + 2);
  tmt::CombSmem<tmt::Geometry> s;
  s.carve(scratch != nullptr ? static_cast<unsigned char*>(scratch)
                             : reinterpret_cast<unsigned char*>(own.data()),
          cf);
  return tmt::with_words<tmt::Geometry>(tmt::plane_words(n), [&](auto words) {
    const tmt::BitWarp<decltype(words)::value> bw{n, tmt::plane_words(n), 0};
    for (size_t b = 0; b < static_cast<size_t>(B); ++b) {
      tmt::CombResult res{0, 0, 0, 0, 0, static_cast<uint32_t>(keys[2 * b]),
                          static_cast<uint32_t>(keys[2 * b + 1])};
      if (comb[b]) {
        for (int i = 0; i < n; ++i) {
          s.x[i] = colour[b * n + i];
          s.k[i] = kind[b * n + i];
        }
        tmt::comb_program(w, bw, s, cf, coord1[2 * b], coord1[2 * b + 1], coord2[2 * b],
                          coord2[2 * b + 1], tmt::comb_keys(res.key0, res.key1, 0), res);
        for (int i = 0; i < n; ++i) {
          colour[b * n + i] = s.x[i];
          kind[b * n + i] = s.k[i];
        }
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
  });
}

// The bit-plane machine alone (csrc/machine_bits.cuh), board by board:
// each board's stack is seeded with one frame, seed[6 b .. 6 b + 5] = (op,
// row, column, scan index, colour, counted), and runs at most `steps`
// micro-steps (< 0: no budget), as ops/activate.py's `push_frame` then
// `run_machine`.  Returns 0, or -1 for a board or config it does not take.
extern "C" int tmt_run_machine_bits_host(const int* colour_in, const int* kind_in, const int* seed,
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
  return tmt::with_words<tmt::Geometry>(tmt::plane_words(n), [&](auto words) {
    constexpr int NW = decltype(words)::value;
    const tmt::BitWarp<NW> bw{n, tmt::plane_words(n), 0};
    for (size_t b = 0; b < static_cast<size_t>(B); ++b) {
      for (int i = 0; i < n; ++i) {
        s.x[i] = colour_in[b * n + i];
        s.k[i] = kind_in[b * n + i];
      }
      tmt::BitMachine<NW, tmt::Warp, tmt::Geometry> mc{w, bw, s.L, s.x, s.k, s.colours, s.stack,
                                                      K, SM};
      const int* f = seed + 6 * b;
      mc.push(f[0], f[1] * C + f[2], f[5], f[3], f[4]);
      mc.load();
      mc.run(steps);
      mc.settle();
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
  });
}

// The machine of csrc/machine.cuh alone (K4's), the same way.
extern "C" int tmt_run_machine_host(const int* colour_in, const int* kind_in, const int* seed,
                                    int* colour_out, int* kind_out, int* count, bool* ovf,
                                    int* caps, int* live, int B, int R, int C, int K, int SM,
                                    int steps) {
  const tmt::CombConfig cf{R, C, K, SM, steps};
  if (!tmt::comb_takes(cf)) return -1;
  const int n = R * C;
  const tmt::Warp w{n};
  tmt::Geometry L;
  L.shape(R, C);
  std::vector<int> x(n), k(n), ccount(K + 1);
  tmt::Arena size{nullptr, 0};
  tmt::Frames f;
  f.carve(size, SM);
  std::vector<uint64_t> frames(size.used / 8 + 2);
  tmt::Arena a{reinterpret_cast<unsigned char*>(frames.data()), 0};
  f.carve(a, SM);
  for (size_t b = 0; b < static_cast<size_t>(B); ++b) {
    for (int i = 0; i < n; ++i) {
      x[i] = colour_in[b * n + i];
      k[i] = kind_in[b * n + i];
    }
    tmt::Machine<tmt::Warp, tmt::Geometry> mc{w, L, x.data(), k.data(), ccount.data(), f, K, SM};
    const int* sd = seed + 6 * b;
    mc.push(sd[0], sd[1] * C + sd[2], sd[5], sd[3], sd[4]);
    mc.count_colours();
    mc.run(steps);
    for (int i = 0; i < n; ++i) {
      colour_out[b * n + i] = x[i];
      kind_out[b * n + i] = k[i];
    }
    count[b] = mc.act;
    ovf[b] = mc.ovf != 0;
    caps[b] = mc.caps;
    live[b] = mc.sp;
  }
  return 0;
}

#endif
