// One thread block per board, one thread per cell: the phase primitives the
// board programs of cascade_sp.cu and mask_sp.cu are written in.
//
// A board program is a sequence of phases.  Each phase runs a function of
// the cell index for every cell of the board and ends at a block barrier.
// A phase reads only shared entries that no cell writes in the same phase,
// and no two cells write the same entry, so the order in which cells run
// inside a phase does not matter.  Values that live across phases sit in
// shared memory, never in a thread's registers; block-wide scalars come
// from the reductions, which every thread sees alike.
//
// Compiled by nvcc, a Block runs each phase with one thread per cell.
// Compiled as plain C++ (TMT_HOST_BUILD), the same program runs on the host
// with a loop over the cells in place of the threads; the CPU tests build it
// that way with g++ and hold it against the kernels' plain PyTorch versions.
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

#ifdef __CUDACC__

struct Block {
  int n;        // cells of the board
  int tid;      // this thread's cell
  int* scratch; // one shared int for reductions

  // f(i) for every cell i, then a barrier
  template <class F>
  TMT_DEV void each(F f) const {
    if (tid < n) f(tid);
    __syncthreads();
  }
  // f(i) for every i < m (m may exceed the thread count), then a barrier
  template <class F>
  TMT_DEV void each_of(int m, F f) const {
    for (int i = tid; i < m; i += blockDim.x) f(i);
    __syncthreads();
  }
  template <class F>
  TMT_DEV bool any(F f) const {
    return __syncthreads_or(tid < n && f(tid)) != 0;
  }
  template <class F>
  TMT_DEV int count(F f) const {
    return __syncthreads_count(tid < n && f(tid));
  }
  // max over cells of f(i), at least `floor`
  template <class F>
  TMT_DEV int max(F f, int floor) const {
    if (tid == 0) *scratch = floor;
    __syncthreads();
    if (tid < n) {
      const int v = f(tid);
      if (v > floor) atomicMax(scratch, v);
    }
    __syncthreads();
    const int out = *scratch;
    __syncthreads();
    return out;
  }
  // bitwise OR over cells of f(i)
  template <class F>
  TMT_DEV int bit_or(F f) const {
    if (tid == 0) *scratch = 0;
    __syncthreads();
    if (tid < n) {
      const int v = f(tid);
      if (v) atomicOr(scratch, v);
    }
    __syncthreads();
    const int out = *scratch;
    __syncthreads();
    return out;
  }
  TMT_DEV bool leader() const { return tid == 0; }
};

#else  // host build: the same phases as loops over the cells

struct Block {
  int n;
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
};

#endif

}  // namespace tmt
