// Settled effective-action mask of boards with specials for Hopper (sm_90a),
// one thread block per board, the cells and actions looped over its threads.
//
// Replaces the TPU kernel `settled_mask_sp` of
// tile_match_tpu/ops/pallas_cascade.py:1039 (call :1051, body `_mask_sp_kernel`
// :1032, stencils
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
// Limits: the board (8 bytes a cell) fits a block's shared memory; a block
// has at most 256 threads, which loop over the cells and the actions.

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
  const int n = R * C;
  int* x = smem;
  int* k = x + n;
  const size_t b = blockIdx.x;
  const tmt::Block blk{static_cast<int>(threadIdx.x)};
  blk.each_of(n, [&](int i) {
    x[i] = colour[b * n + i];
    k[i] = kind[b * n + i];
  });
  const size_t A = 2 * n - R - C;
  tmt::mask_program(blk, x, k, mask + b * A, R, C, any_special);
}

}  // namespace

constexpr int kMaskThreads = 256;

// threads of a block: one a cell up to kMaskThreads
int mask_threads(int n) { return n < kMaskThreads ? ((n + 31) / 32) * 32 : kMaskThreads; }

// Shared memory of one board, in bytes.
extern "C" long long tmt_settled_mask_sp_smem(int R, int C) {
  return static_cast<long long>(R) * C * 2 * sizeof(int);
}

// Blocks (boards) in flight per SM at R x C, from the occupancy calculator.
extern "C" int tmt_settled_mask_sp_occupancy(int R, int C) {
  const int smem = static_cast<int>(tmt_settled_mask_sp_smem(R, C));
  if (tmt::allow_smem(mask_sp_kernel, smem) != cudaSuccess) return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mask_sp_kernel,
                                                    mask_threads(R * C), smem) != cudaSuccess)
    return 0;
  return blocks;
}

// Launches the mask for B boards on `stream`; returns the cudaError_t of the
// launch (0 on success).  colour, kind: int32[B, R, C]; mask: bool[B, 2RC-R-C].
extern "C" int tmt_settled_mask_sp(const int* colour, const int* kind, bool* mask, int B, int R,
                                   int C, int any_special, void* stream) {
  if (B == 0) return 0;
  if (R < 1 || C < 1) return cudaErrorInvalidValue;
  const int n = R * C;
  const int threads = mask_threads(n);
  const size_t smem = tmt_settled_mask_sp_smem(R, C);
  const cudaError_t err = tmt::allow_smem(mask_sp_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
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
  const tmt::Block blk{};
  for (size_t b = 0; b < static_cast<size_t>(B); ++b) {
    tmt::mask_program(blk, colour + b * n, kind + b * n, mask + b * A, R, C, any_special != 0);
  }
  return 0;
}

#endif
