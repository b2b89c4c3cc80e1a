// Tiles of neighbouring columns in shared memory, for Hopper (sm_90a).
//
// Shared by the column stages of the substep kernels (hydro_columns in
// dsw_common.cuh, nh_columns in dsw_nh_pert.cu), by nh_vertical_solve.cu
// and by remap_banded.cu.
// An array of columns is [ncol, L] row-major with L (the K levels or the
// K+1 interfaces) minor, so the C neighbouring columns of a block are one
// contiguous run of C*L values: the block reads and writes that run as a
// warp-wide sequence of neighbouring addresses, and keeps column c of the
// array at c*P of a row block in shared memory.  The pitch P is odd, so
// that threads walking different columns fall in different banks.
#pragma once

#include <cuda_runtime.h>

namespace {

// fn(e, c, k) for the elements e = threadIdx.x + r T < n of a tile of
// columns of length L: position k of the tile's column c, with e the offset
// in the run of the block's columns.  T is the block's thread count; (c, k)
// advance without a division.
template <int T, class Fn>
__device__ __forceinline__ void for_tile_elements(int n, int L, Fn fn) {
  int c = threadIdx.x / L, k = threadIdx.x % L;
  const int c_step = T / L, k_step = T % L;
  for (int e = threadIdx.x; e < n; e += T) {
    fn(e, c, k);
    c += c_step;
    k += k_step;
    if (k >= L) {
      k -= L;
      ++c;
    }
  }
}

// *dst = *src as an asynchronous copy of 4 bytes (cp.async) from device
// into shared memory: a thread starts every copy of its part of a tile
// before it waits for them (async_copy_wait), so that many loads are in
// flight at once where a plain staging loop waits for each in turn.
__device__ __forceinline__ void async_copy4(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}

// Waits for this thread's asynchronous copies; a __syncthreads() after it
// makes every thread's copies visible to the block.
__device__ __forceinline__ void async_copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

}  // namespace
