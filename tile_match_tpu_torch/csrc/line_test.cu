// The line test for Hopper (sm_90a): which cells lie in a horizontal or
// vertical run of three or more equal colours (> 0), and does a board hold
// any.
//
// Replaces no TPU kernel: the JAX package's `run_member_mask` and
// `has_any_line` (tile_match_tpu/ops/lines.py:272, :311) are XLA programs of
// run-extent scans.  Their plain PyTorch versions are `plain_run_member_mask`
// and `plain_has_any_line` of tile_match_tpu_torch/ops/lines.py
// (`colour_run_extents`: a cummax and a flipped cummin on each axis), and the
// two are equal bit for bit.
//
// Two entry points: `tmt_line_test_member` writes bool[B, R, C], true where a
// cell lies in such a run; `tmt_line_test_any` writes bool[B], the OR of that
// mask, reduced in the kernel (no mask goes to memory).
//
// How.  A cell is in a run of three or more exactly when, along its row or
// its column, at least two of the four cells at distance one and two on
// either side that are joined to it by equal cells hold its colour; no
// run's extent is needed.  One block a board, one thread a cell, each
// reading its neighbours from device memory through the cache; `any` is a
// block vote.  The geometry is read at run time: one library serves every
// board shape.
//
// What bounds it on the card: bytes.  At 10x10, B = 16384 the board is 6.6 MB
// in and the mask 1.6 MB out: ~0.0025 ms at 3.35 TB/s.  Measured on the H100
// (PERF.md §6) 0.013-0.014 ms queued, about the host's time to issue a
// launch.  A warp a board on row bit masks, with one library a shape, ran
// 0.007 ms there: under 0.1 ms of a step of several ms in every benchmark
// cell, not worth a second program and a build a shape.
//
// Compiled as plain C++ (TMT_HOST_BUILD) each entry point has a `_host` twin
// that runs the same cell test board by board, which the CPU tests hold
// against the plain version.

#include <stddef.h>

#include "block.cuh"

namespace tmt {

// Threads a block (a board).
constexpr int kCellThreads = 128;

// Is cell i of board x (R x C cells, row-major) in a run of three or more?
TMT_HOST_DEV bool cell_in_line(const int* x, int R, int C, int i) {
  const int v = x[i];
  if (v <= 0) return false;
  const int r = i / C, c = i - r * C;
  const int l1 = c >= 1 && x[i - 1] == v, l2 = l1 && c >= 2 && x[i - 2] == v;
  const int r1 = c + 1 < C && x[i + 1] == v, r2 = r1 && c + 2 < C && x[i + 2] == v;
  if (l1 + l2 + r1 + r2 >= 2) return true;
  const int u1 = r >= 1 && x[i - C] == v, u2 = u1 && r >= 2 && x[i - 2 * C] == v;
  const int d1 = r + 1 < R && x[i + C] == v, d2 = d1 && r + 2 < R && x[i + 2 * C] == v;
  return u1 + u2 + d1 + d2 >= 2;
}

}  // namespace tmt

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

// One block a board, one thread a cell (kAny: the board's OR, written by
// thread 0).
template <bool kAny>
__device__ __forceinline__ void line_test(const int* __restrict__ colour, bool* __restrict__ out,
                                          int R, int C) {
  const int n = R * C;
  const size_t b = blockIdx.x;
  const int* x = colour + b * n;
  bool any = false;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool v = tmt::cell_in_line(x, R, C, i);
    if constexpr (kAny)
      any = any || v;
    else
      out[b * n + i] = v;
  }
  if constexpr (kAny) {
    any = __syncthreads_or(any) != 0;
    if (threadIdx.x == 0) out[b] = any;
  }
}

// A kernel a mode, each named for the profiler.
__global__ void __launch_bounds__(tmt::kCellThreads)
    line_test_member_kernel(const int* __restrict__ colour, bool* __restrict__ out, int R, int C) {
  line_test<false>(colour, out, R, C);
}

__global__ void __launch_bounds__(tmt::kCellThreads)
    line_test_any_kernel(const int* __restrict__ colour, bool* __restrict__ out, int R, int C) {
  line_test<true>(colour, out, R, C);
}

template <class Kernel>
int launch(Kernel kernel, const int* colour, bool* out, int B, int R, int C, void* stream) {
  if (R < 1 || C < 1 || B < 0) return cudaErrorInvalidValue;
  if (B == 0) return 0;
  kernel<<<B, tmt::kCellThreads, 0, static_cast<cudaStream_t>(stream)>>>(colour, out, R, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch the line test for B boards on `stream`; each returns the
// cudaError_t of the launch (0 on success; no launch for B = 0).
// colour: int32[B, R, C]; out: bool[B, R, C] (member) or bool[B] (any).
extern "C" int tmt_line_test_member(const int* colour, bool* out, int B, int R, int C,
                                    void* stream) {
  return launch(line_test_member_kernel, colour, out, B, R, C, stream);
}

extern "C" int tmt_line_test_any(const int* colour, bool* out, int B, int R, int C, void* stream) {
  return launch(line_test_any_kernel, colour, out, B, R, C, stream);
}

#else  // host build (TMT_HOST_BUILD): the same cell test, board by board

namespace {

int host_line_test(const int* colour, bool* out, int B, int R, int C, bool any) {
  if (R < 1 || C < 1 || B < 0) return -1;
  const size_t n = static_cast<size_t>(R) * C;
  for (size_t b = 0; b < static_cast<size_t>(B); ++b) {
    bool v = false;
    for (size_t i = 0; i < n; ++i) {
      const bool m = tmt::cell_in_line(colour + b * n, R, C, static_cast<int>(i));
      v = v || m;
      if (!any) out[b * n + i] = m;
    }
    if (any) out[b] = v;
  }
  return 0;
}

}  // namespace

// As tmt_line_test_member / tmt_line_test_any, on the host; return 0, or -1
// for a shape with no cells.
extern "C" int tmt_line_test_member_host(const int* colour, bool* out, int B, int R, int C) {
  return host_line_test(colour, out, B, R, C, false);
}

extern "C" int tmt_line_test_any_host(const int* colour, bool* out, int B, int R, int C) {
  return host_line_test(colour, out, B, R, C, true);
}

#endif
