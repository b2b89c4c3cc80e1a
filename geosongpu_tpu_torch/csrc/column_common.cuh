// Shared by the moist column-physics kernels (gfdl_microphysics.cu,
// fill_q2_zero.cu, column_kernels.cu, standalone_twins.cu): launch
// geometry, pointer casts and the saturation functions of the plain
// PyTorch versions (geosongpu_tpu_torch/physics/thermo.py).
//
// Every array is [ncol, K] float32, row-major, K minor; the ragged last
// block is masked in the kernel, nothing is padded.
//
// Arithmetic that must match PyTorch on the card, operation by operation
// (the library builds with --fmad=false and without fast-math):
//   * a tensor divided by a Python number is, in PyTorch's CUDA kernel, a
//     multiplication by the float32 reciprocal of that number: `rcp(c)`;
//   * a Python number divided by a tensor is `reciprocal(x) * c`;
//   * `**` is powf (no exponent used here is one PyTorch special-cases),
//     exp/log/sqrt/erf are expf/logf/sqrtf/erff.
#pragma once
#include <cuda_runtime.h>

namespace {

constexpr int kColThreads = 128;

__host__ inline unsigned col_blocks(long long n) {
  return (unsigned)((n + kColThreads - 1) / kColThreads);
}

// What every C entry starts with: the shape check (the flat index of the
// pointwise kernels must fit a grid) and the device selection; 0 when the
// launch may go on.
__host__ inline int prepare(long long ncol, int K, int device) {
  if (ncol < 0 || K < 1) return (int)cudaErrorInvalidValue;
  if ((ncol * (long long)K + kColThreads - 1) / kColThreads > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSetDevice(device);
}

__host__ inline const float* cf(const void* p) {
  return static_cast<const float*>(p);
}
__host__ inline float* wf(void* p) { return static_cast<float*>(p); }

__device__ __forceinline__ float rcp(float c) { return 1.0f / c; }

// torch.clamp(x, lo, hi)
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Constants of physics/thermo.py, rounded to float32 as PyTorch rounds a
// Python number that meets a float32 tensor.
struct Thermo {
  float t_ice, eps, one_m_eps, hlv, rvgas;
};

__device__ __forceinline__ float mixing_ratio(float es, float p,
                                              const Thermo& c) {
  es = fminf(es, 0.9f * p);
  return c.eps * es / (p - c.one_m_eps * es);
}

// thermo.qsat: Bolton saturation pressure over liquid.
__device__ __forceinline__ float qsat_liquid(float t, float p,
                                             const Thermo& c) {
  const float tc = t - c.t_ice;
  return mixing_ratio(611.2f * expf(17.67f * tc / (tc + 243.5f)), p, c);
}

// thermo.qsat_ice.
__device__ __forceinline__ float qsat_ice(float t, float p, const Thermo& c) {
  const float tc = t - c.t_ice;
  return mixing_ratio(611.2f * expf(21.87f * tc / (tc + 265.5f)), p, c);
}

// thermo.dqsat_dt: qsat HLV / (Rv t t), in that order.
__device__ __forceinline__ float dqsat_dt(float t, float p, const Thermo& c) {
  return qsat_liquid(t, p, c) * c.hlv / (c.rvgas * t * t);
}

}  // namespace
