// Settled effective-action mask for Hopper (sm_90a), one warp a board, from
// cell bit masks.
//
// Replaces the TPU kernel `settled_mask_sp` of
// tile_match_tpu/ops/pallas_cascade.py:1039 (call :1051, body `_mask_sp_kernel`
// :1032, stencils `_settled_mask_sp_tile` :963-1029).  Its plain PyTorch
// version is `effective_mask_settled` in tile_match_tpu_torch/ops/effective.py,
// and the two are equal bit for bit, on boards with specials and without
// (`any_special` false leaves out the special-pair and cookie terms).
//
// What it computes, per board: for every action, the 8 colour stencils of a
// swap on a board with no >= 3 run (through each swapped cell its 3
// perpendicular stencils and the parallel one pointing away from the
// partner), each guarded by kind >= 0 of its last (rightmost or bottom)
// cell — the post-swap kind when that cell is a swapped one, the cookie-end
// quirk of the original game — and, with specials, a swap of two specials
// or of a cookie (`board.py:735-787`).
//
// How.  Each stencil is two colour equalities, each between a cell of the
// run and the swapped cell whose colour moves in, plus its guard.  So the
// board becomes ten same-colour-at-offset masks E_d (bit p set when cell p
// and cell p + d, d = (dr, dc) with dr >= 0, are both on the board and hold
// the same colour; colour 0 matches colour 0, as in the plain version) and
// three kind masks (kind >= 0, special, cookie), row-major over the cells,
// each built with one warp vote per 32 cells.  The board sits in shared
// memory padded with -1 (three columns right of every row, three rows
// below), so every E_d bit is one unconditional compare.  The down-swap at
// (r, c) has action index a = r * C + c, its cell's index, so its 16 terms
// are ANDs of the masks read at a + s for fixed offsets s: one 32-bit
// window a term gives 32 actions at once.  The right-swaps are computed the
// same way at their left cell's index and compacted (C - 1 a row) as the
// bytes are written.  A read whose intended cell lies left or right of the
// board lands in the row above or below; but every equality pairs it with
// a swapped cell, which is on the board, so the cell it lands on has its
// partner off the board and its bit is clear.  Reads above or below the
// board land in zero words around the masks.
//
// What bounds it on the card: bytes in principle — a 10x10 board is 800
// bytes in (colour and kind) and 180 bytes out, 0.0048 ms at B=16384 — but
// in practice the SM's instruction issue.  A board is one warp, with no
// block barrier, up to kBoardsPerBlock boards a block; it loads the board with
// 16-byte loads where its offset allows and writes its mask row
// contiguously.  At 10x10 a board takes ~650 warp instructions: the votes
// (13 compares, 13 votes and 13 stores a 32 cells) about half, the 16 terms
// a 32 actions (on 4 of the 32 lanes) and the bytes most of the rest.
// Measured against this design on the H100 (PERF.md §6): several boards
// a warp, sharing the word phase's lanes, lost (fewer warps in flight); so
// did interleaving the masks to store a vote round at once, and 4-byte
// stores of the down-swaps.  The TPU's batch-on-lanes transposes are gone.
//
// Colours are >= 0 (off the board the plain version reads -1, which then
// never matches).  The board shape is fixed at compile time for each shape
// of at most 32 by 32 (one library a shape, `Geometry` in csrc/trip.cuh)
// and read at run time above that.  Limits: one board (~10 bytes a cell
// with its masks) fits a block's shared memory; a block takes as many
// boards, up to kBoardsPerBlock, as its opt-in shared memory holds.

#include "block.cuh"
#include "trip.cuh"

namespace tmt {

// Boards (warps) a block, at most: fewer where that many boards of the
// shape overflow a block's shared memory (`boards_per_block`).
constexpr int kBoardsPerBlock = 4;

// The masks, in this order: E_d for the ten offsets, then the kind masks.
enum MaskId { E11, E1M1, E12, E1M2, E20, E30, E21, E2M1, E02, E03, KN, SP, CK, kMasks };

struct alignas(16) Words4 {
  int v[4];
};

// Shared memory of one board: its colours padded with -1 (three columns
// right of every row, three rows below the board: cell (r, c) at
// r * (C + 3) + c), its kinds, its masks (each `mw` words, bit p of the
// mask at bit 32 * pf + p, zero words before and after) and its down and
// right action words.
struct MaskSmem {
  int *xp, *k;
  uint32_t* masks;
  uint32_t *down, *right;
  int pf, mw, nwo, padded;

  TMT_HOST_DEV size_t carve(unsigned char* base, int R, int C) {
    const int n = R * C;
    nwo = (n + 31) / 32;
    pf = (2 * C + 31) / 32;                // reads reach 2C cells before a
    mw = pf + nwo + (3 * C + 31) / 32 + 2;  // and 3C cells after, plus a window
    padded = ((R + 3) * (C + 3) + 3) & ~3;
    Arena a{base, 0};
    xp = a.take<int>(padded);
    k = a.take<int>(n);
    masks = a.take<uint32_t>((kMasks * mw + 3) & ~3);
    down = a.take<uint32_t>(nwo);
    right = a.take<uint32_t>(nwo);
    return (a.used + 15) & ~static_cast<size_t>(15);
  }
  TMT_HOST_DEV const uint32_t* mask(int id) const { return masks + id * mw; }
};

TMT_HOST_DEV size_t mask_smem_bytes(int R, int C) {
  MaskSmem s;
  return s.carve(nullptr, R, C);
}

// The masks' predicates at cell i: every E_d is one compare on the padded
// board, whose pads (-1) match no colour.  Past the last cell (i >= n) the
// colour -2 matches nothing and the kind is 0: KN is set there, and a term
// reads it only beside an E_d bit that is clear.
template <class Ln>
TMT_DEV void cell_preds(const Ln& L, const MaskSmem& s, int i, bool (&p)[kMasks]) {
  const int C = L.C(), Cp = C + 3, n = L.n();
  const bool on = i < n;
  const int ic = on ? i : 0;
  const int* x = s.xp + ic + 3 * L.row(ic);
  const int v = on ? x[0] : -2, kv = on ? s.k[i] : 0;
  p[E11] = x[Cp + 1] == v;
  p[E1M1] = x[Cp - 1] == v;
  p[E12] = x[Cp + 2] == v;
  p[E1M2] = x[Cp - 2] == v;
  p[E20] = x[2 * Cp] == v;
  p[E30] = x[3 * Cp] == v;
  p[E21] = x[2 * Cp + 1] == v;
  p[E2M1] = x[2 * Cp - 1] == v;
  p[E02] = x[2] == v;
  p[E03] = x[3] == v;
  p[KN] = kv >= 0;
  p[SP] = kv != 0 && kv != 1;
  p[CK] = kv < 0;
}

// The mask row of the board in s.xp, s.k into out (2RC - R - C bools).
template <class W, class Ln>
TMT_DEV void mask_program(const W& w, const Ln& L, const MaskSmem& s, bool* out,
                          bool any_special) {
  const int R = L.R(), C = L.C(), n = L.n();
  // the cell masks, one warp vote a mask a 32 cells (the special and
  // cookie masks only with specials); the words around them zero
  const int votes = any_special ? kMasks : SP;
  Words4* const zero = reinterpret_cast<Words4*>(s.masks);
  w.each_of(((kMasks * s.mw + 3) & ~3) / 4, [&](int q) { zero[q] = Words4{}; });
#ifdef __CUDACC__
#pragma unroll 4
  for (int base = 0; base < n; base += 32) {
    bool p[kMasks];
    cell_preds(L, s, base + w.lane(), p);
#pragma unroll
    for (int id = 0; id < kMasks; ++id) {
      if (id >= votes) break;
      const unsigned v = __ballot_sync(kFull, p[id]);
      if (w.lane() == 0) s.masks[id * s.mw + s.pf + (base >> 5)] = v;
    }
  }
  __syncwarp();
#else
  for (int i = 0; i < s.nwo * 32; ++i) {
    bool p[kMasks];
    cell_preds(L, s, i, p);
    for (int id = 0; id < votes; ++id)
      if (p[id]) s.masks[id * s.mw + s.pf + (i >> 5)] |= 1u << (i & 31);
  }
#endif
  // 32 actions a lane: the down-swaps and the right-swaps at cell index a
  w.each_of(s.nwo, [&](int q) {
    const int lo = (s.pf + q) * 32;
    auto at = [&](int id, int sh) { return window(s.mask(id), lo + sh); };
    // down-swap of a = (r, c) with a + C: through a (colour of a + C), then
    // through a + C (colour of a)
    uint32_t d = (at(E12, -2) & at(E11, -1) & at(KN, C)) |
                 (at(E11, -1) & at(E1M1, 1) & at(KN, 1)) |
                 (at(E1M1, 1) & at(E1M2, 2) & at(KN, 2)) |
                 (at(E30, -2 * C) & at(E20, -C) & at(KN, C)) |
                 (at(E1M2, 0) & at(E1M1, 0) & at(KN, 0)) |
                 (at(E1M1, 0) & at(E11, 0) & at(KN, C + 1)) |
                 (at(E11, 0) & at(E12, 0) & at(KN, C + 2)) |
                 (at(E20, 0) & at(E30, 0) & at(KN, 3 * C));
    // right-swap of a = (r, c) with a + 1: through a (colour of a + 1), then
    // through a + 1 (colour of a)
    uint32_t rt = (at(E21, -2 * C) & at(E11, -C) & at(KN, 1)) |
                  (at(E11, -C) & at(E1M1, 1) & at(KN, C)) |
                  (at(E1M1, 1) & at(E2M1, 1) & at(KN, 2 * C)) |
                  (at(E03, -2) & at(E02, -1) & at(KN, 1)) |
                  (at(E2M1, 1 - 2 * C) & at(E1M1, 1 - C) & at(KN, 0)) |
                  (at(E1M1, 1 - C) & at(E11, 0) & at(KN, C + 1)) |
                  (at(E11, 0) & at(E21, 0) & at(KN, 2 * C + 1)) |
                  (at(E02, 0) & at(E03, 0) & at(KN, 3));
    if (any_special) {
      const uint32_t cookie = at(CK, 0);
      d |= (at(SP, 0) & at(SP, C)) | cookie | at(CK, C);
      rt |= (at(SP, 0) & at(SP, 1)) | cookie | at(CK, 1);
    }
    s.down[q] = d;
    s.right[q] = rt;
  });
  // the bytes, in action-table order: right-swap j is at cell j + j / (C - 1)
  const int nd = C * (R - 1);
  const uint32_t inv = reciprocal(C - 1);
  w.each_of(nd + R * (C - 1), [&](int t) {
    if (t < nd) {
      out[t] = bit(s.down, t);
    } else {
      const int j = t - nd;
      const int row = C <= 1 ? 0 : Ln::kFixed ? j / (C - 1) : div_by(j, C - 1, inv);
      out[t] = bit(s.right, j + row);
    }
  });
}

// The board from device memory (int32 colour and kind, n cells each) into
// s: the colours padded, 16 bytes a lane where the source allows.
template <class W, class Ln>
TMT_DEV void load_board(const W& w, const Ln& L, const MaskSmem& s, const int* colour,
                        const int* kind) {
  const int n = L.n();
  Words4* const fill = reinterpret_cast<Words4*>(s.xp);
  w.each_of(s.padded / 4, [&](int q) { fill[q] = Words4{{-1, -1, -1, -1}}; });
  auto put = [&](int i, int v) { s.xp[i + 3 * L.row(i)] = v; };
#ifdef __CUDACC__
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(colour) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(kind) & 15) == 0) {
    const int4* c4 = reinterpret_cast<const int4*>(colour);
    const int4* k4 = reinterpret_cast<const int4*>(kind);
    w.each_of(n >> 2, [&](int q) {
      const int4 c = __ldg(c4 + q);
      reinterpret_cast<int4*>(s.k)[q] = __ldg(k4 + q);
      put(4 * q, c.x);
      put(4 * q + 1, c.y);
      put(4 * q + 2, c.z);
      put(4 * q + 3, c.w);
    });
    return;
  }
#endif
  w.each_of(n, [&](int i) {
    put(i, colour[i]);
    s.k[i] = kind[i];
  });
}

}  // namespace tmt

// Shared memory of one board, in bytes: the least a block needs, which the
// wrapper's size check holds against the card's limit.
extern "C" long long tmt_settled_mask_sp_smem(int R, int C) {
  return static_cast<long long>(tmt::mask_smem_bytes(R, C));
}

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

template <class Ln>
__global__ void __launch_bounds__(32 * tmt::kBoardsPerBlock)
    mask_sp_kernel(const int* __restrict__ colour, const int* __restrict__ kind,
                   bool* __restrict__ mask, int B, int R, int C, bool any_special) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t b = static_cast<size_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (b >= static_cast<size_t>(B)) return;  // a whole warp: no barrier follows
  Ln L;
  tmt::Arena geometry_only{nullptr, 0};
  L.carve(geometry_only, R, C);  // with a fixed shape, L.R() and L.C() are constants
  const int n = L.n();
  tmt::MaskSmem s;
  s.carve(smem + warp * tmt::mask_smem_bytes(L.R(), L.C()), L.R(), L.C());
  const tmt::Warp w{n, lane, nullptr};
  tmt::load_board(w, L, s, colour + b * n, kind + b * n);
  tmt::mask_program(w, L, s, mask + b * (2 * n - L.R() - L.C()), any_special);
}

const auto kernel = mask_sp_kernel<tmt::Geometry>;

}  // namespace

// Boards a block at R x C: kBoardsPerBlock, or as many as a block's opt-in
// shared memory holds, and at least one.
static int boards_per_block(int R, int C) {
  const long long fit = tmt_smem_optin() / tmt_settled_mask_sp_smem(R, C);
  return static_cast<int>(fit < 1 ? 1 : fit < tmt::kBoardsPerBlock ? fit : tmt::kBoardsPerBlock);
}

// Boards in flight per SM at R x C, from the occupancy calculator (0 when a
// board does not fit or the library does not take the shape).
extern "C" int tmt_settled_mask_sp_occupancy(int R, int C) {
  if (!tmt::takes(R, C)) return 0;
  const int per = boards_per_block(R, C);
  const size_t smem = tmt_settled_mask_sp_smem(R, C) * per;
  int blocks = 0;
  if (tmt::allow_smem(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 32 * per, smem) != cudaSuccess)
    return 0;
  return blocks * per;
}

// Launches the mask for B boards on `stream`; returns the cudaError_t of the
// launch (0 on success).  colour, kind: int32[B, R, C]; mask: bool[B, 2RC-R-C].
extern "C" int tmt_settled_mask_sp(const int* colour, const int* kind, bool* mask, int B, int R,
                                   int C, int any_special, void* stream) {
  if (B == 0) return 0;
  if (!tmt::takes(R, C) || R * C > 65535) return cudaErrorInvalidValue;
  const int per = boards_per_block(R, C);
  const size_t smem = tmt_settled_mask_sp_smem(R, C) * per;
  const cudaError_t err = tmt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + per - 1) / per;
  kernel<<<blocks, 32 * per, smem, static_cast<cudaStream_t>(stream)>>>(
      colour, kind, mask, B, R, C, any_special != 0);
  return static_cast<int>(cudaGetLastError());
}

#else  // host build (TMT_HOST_BUILD): the same board program, board by board

#include <vector>

// As tmt_settled_mask_sp, on the host; returns 0, or -1 for a board shape the
// library's geometry does not take.
extern "C" int tmt_settled_mask_sp_host(const int* colour, const int* kind, bool* mask, int B,
                                        int R, int C, int any_special) {
  if (!tmt::takes(R, C)) return -1;
  const int n = R * C;
  const size_t A = 2 * n - R - C;
  tmt::Geometry L;
  tmt::Arena geometry_only{nullptr, 0};
  L.carve(geometry_only, R, C);
  std::vector<tmt::Words4> smem(tmt::mask_smem_bytes(R, C) / sizeof(tmt::Words4) + 1);
  tmt::MaskSmem s;
  s.carve(reinterpret_cast<unsigned char*>(smem.data()), R, C);
  const tmt::Warp w{n, 0, nullptr};
  for (size_t b = 0; b < static_cast<size_t>(B); ++b) {
    tmt::load_board(w, L, s, colour + b * n, kind + b * n);
    tmt::mask_program(w, L, s, mask + b * A, any_special != 0);
  }
  return 0;
}

#endif
