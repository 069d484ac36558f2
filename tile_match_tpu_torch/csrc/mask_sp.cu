// Settled effective-action mask of boards with specials for Hopper (sm_90a),
// one thread block per board.
//
// Replaces the TPU kernel `settled_mask_sp` of
// tile_match_tpu/ops/pallas_cascade.py (body `_mask_sp_kernel`, stencils
// `_settled_mask_sp_tile`).  Its plain PyTorch version is
// `effective_mask_settled` in tile_match_tpu_torch/ops/effective.py, and the
// two are equal bit for bit.
//
// What it computes, per board: for every action, the 8 colour stencils of
// csrc/mask.cuh with their kind terms, plus the special-pair / any-cookie
// terms.
//
// What bounds it on the card: bytes.  A 10x10 board is 800 bytes in (colour
// and kind) and 180 bytes out; each action is ~30 integer compares on
// shared memory.  The design reads each board once into shared memory with
// coalesced loads and writes the mask row of the board contiguously; the
// TPU's batch-on-lanes transposes are gone.
//
// Limits: R * C <= 1024 (one thread per cell for the loads).

#include "block.cuh"
#include "mask.cuh"

namespace tmt {

// The mask of one board; x and k hold the board in shared memory.
template <class Blk>
TMT_DEV void mask_program(const Blk& blk, const int* x, const int* k, bool* mask, int R, int C,
                          bool any_special) {
  auto at = [&](int r, int c) -> int {
    return (r >= 0 && r < R && c >= 0 && c < C) ? x[r * C + c] : -1;
  };
  auto kat = [&](int r, int c) -> int {
    return (r >= 0 && r < R && c >= 0 && c < C) ? k[r * C + c] : 1;
  };
  const int A = 2 * R * C - R - C;
  blk.each_of(A, [&](int a) { mask[a] = settled_action(a, R, C, at, kat, any_special); });
}

}  // namespace tmt

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

__global__ void mask_sp_kernel(const int* __restrict__ colour, const int* __restrict__ kind,
                               bool* __restrict__ mask, int R, int C, bool any_special) {
  extern __shared__ int smem[];
  __shared__ int scratch;
  const int n = R * C;
  int* x = smem;
  int* k = x + n;
  const size_t b = blockIdx.x;
  const tmt::Block blk{n, static_cast<int>(threadIdx.x), &scratch};
  blk.each([&](int i) {
    x[i] = colour[b * n + i];
    k[i] = kind[b * n + i];
  });
  const size_t A = 2 * n - R - C;
  tmt::mask_program(blk, x, k, mask + b * A, R, C, any_special);
}

}  // namespace

// Launches the mask for B boards on `stream`; returns the cudaError_t of the
// launch (0 on success).  colour, kind: int32[B, R, C]; mask: bool[B, 2RC-R-C].
extern "C" int tmt_settled_mask_sp(const int* colour, const int* kind, bool* mask, int B, int R,
                                   int C, int any_special, void* stream) {
  if (B == 0) return 0;
  const int n = R * C;
  if (n > 1024 || R < 1 || C < 1) return cudaErrorInvalidValue;
  const int threads = ((n + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(n) * 2 * sizeof(int);
  mask_sp_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      colour, kind, mask, R, C, any_special != 0);
  return static_cast<int>(cudaGetLastError());
}

#else  // host build (TMT_HOST_BUILD): the same board program, board by board

#include <vector>

extern "C" int tmt_settled_mask_sp_host(const int* colour, const int* kind, bool* mask, int B,
                                        int R, int C, int any_special) {
  const int n = R * C;
  const size_t A = 2 * n - R - C;
  const tmt::Block blk{n};
  for (size_t b = 0; b < static_cast<size_t>(B); ++b) {
    tmt::mask_program(blk, colour + b * n, kind + b * n, mask + b * A, R, C, any_special != 0);
  }
  return 0;
}

#endif
