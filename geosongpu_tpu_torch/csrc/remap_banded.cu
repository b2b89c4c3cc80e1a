// Banded vertical Lagrangian-to-Eulerian remap, kord 8, for Hopper (sm_90a).
//
// Replaces the TPU kernel `remap_banded`
// (geosongpu_tpu/ops/pallas/remap.py:28, remap_multi_banded_pallas).  It
// computes exactly geosongpu_tpu_torch/ops/remap.py::remap_fields_banded
// (the plain PyTorch version, itself the port of the reference's
// ops/remap.py::remap_fields_banded): n fields that share one source /
// target interface pair (pe1, pe2), each target layer l drawing from the
// source layers l-band..l+band, with monotone PPM edges per source layer.
//
// Layout: every array is [ncol, K] (fields) or [ncol, K+1] (interfaces),
// row-major, K minor; any leading shape is flattened to columns by the
// wrapper (the D-grid winds come as [6, 49, 48, K] and [6, 48, 49, K]).
//
// What bounds it on this card: per column it reads about (n+2)*K*4 bytes
// and writes n*K*4 bytes, for about (2*band+1)*n*20 flops per layer.  At
// c48-L72 one call moves 10-25 MB, a few microseconds of HBM time at
// 3.35 TB/s, so the kernel is bound by its instruction count and latency,
// not by bytes.
//
// Design (simple first): one thread per (column, target layer l), so
// neighbouring threads of a warp read neighbouring addresses along K.  The
// thread walks d = -band..band over source layer k = l + d, computes the
// overlap bounds once per d, and only where the overlap is non-empty
// recomputes layer k's PPM edges from q[k-1..k+1] and pe1[k-1..k+2] for
// each field (these reads hit L1: the column's neighbours read the same
// lines).  A source slot outside [0, K), or an empty overlap, contributes
// an exact 0 in the plain version (its bounds collapse to x0 == x1), so
// skipping it changes no bit of the sum.  The accumulation order over d is
// the plain version's.  Shared-memory column staging and several columns
// per warp are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxFields = 4;
constexpr int kThreads = 128;

struct FieldPtrs {
  const float* q[kMaxFields];
  float* out[kMaxFields];
};

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// Edge value at interface j (0..K) of one column: thickness-weighted
// two-cell value clipped to its neighbours inside, one-sided 2nd-order
// extrapolation at the top (j == 0) and bottom (j == K).
__device__ __forceinline__ float ppm_edge(const float* __restrict__ q,
                                          const float* __restrict__ pe,
                                          int j, int K) {
  if (j == 0) {
    const float dp0 = pe[1] - pe[0];
    const float dp1 = pe[2] - pe[1];
    const float s_top = (q[1] - q[0]) / (0.5f * (dp0 + dp1));
    return q[0] - s_top * 0.5f * dp0;
  }
  if (j == K) {
    const float dpl = pe[K] - pe[K - 1];
    const float dpm = pe[K - 1] - pe[K - 2];
    const float s_bot = (q[K - 1] - q[K - 2]) / (0.5f * (dpl + dpm));
    return q[K - 1] + s_bot * 0.5f * dpl;
  }
  const float qm = q[j - 1];
  const float qp = q[j];
  const float dpm = pe[j] - pe[j - 1];
  const float dpp = pe[j + 1] - pe[j];
  const float w = dpm / (dpm + dpp);
  const float e = qm + (qp - qm) * w;
  return fminf(fmaxf(e, fminf(qm, qp)), fmaxf(qm, qp));
}

// Parabola of source layer k after the two-pass Colella-Woodward limiter,
// in the order of wheres of the plain version.
__device__ __forceinline__ void ppm_layer(const float* __restrict__ q,
                                          const float* __restrict__ pe,
                                          int k, int K, float& aL, float& aR,
                                          float& a6) {
  const float qk = q[k];
  aL = ppm_edge(q, pe, k, K);
  aR = ppm_edge(q, pe, k + 1, K);
  if ((aR - qk) * (qk - aL) <= 0.0f) {
    aL = qk;
    aR = qk;
  }
  float da = aR - aL;
  a6 = 6.0f * (qk - 0.5f * (aL + aR));
  if (a6 * da > da * da) aL = 3.0f * qk - 2.0f * aR;
  da = aR - aL;
  a6 = 6.0f * (qk - 0.5f * (aL + aR));
  if (a6 * da < -da * da) aR = 3.0f * qk - 2.0f * aL;
  a6 = 6.0f * (qk - 0.5f * (aL + aR));
}

__device__ __forceinline__ float anti(float aL, float da, float a6, float x) {
  return aL * x + 0.5f * da * x * x + a6 * (0.5f * x * x - x * x * x / 3.0f);
}

template <int NF>
__global__ void __launch_bounds__(kThreads)
remap_banded_kernel(FieldPtrs p, const float* __restrict__ pe1,
                    const float* __restrict__ pe2, long long ncol, int K,
                    int band) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= ncol * K) return;
  const long long col = t / K;
  const int l = (int)(t - col * K);
  const float* pe1c = pe1 + col * (K + 1);
  const float* pe2c = pe2 + col * (K + 1);
  const float p2lo = pe2c[l];
  const float p2hi = pe2c[l + 1];

  float tot[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) tot[f] = 0.0f;

  for (int d = -band; d <= band; ++d) {
    const int k = l + d;
    if (k < 0 || k >= K) continue;
    const float lo_s = pe1c[k];
    const float hi_s = pe1c[k + 1];
    const float dp_s = hi_s - lo_s;
    const float rdp_s = 1.0f / dp_s;
    const float lo = fmaxf(lo_s, p2lo);
    const float hi = fminf(hi_s, p2hi);
    const float x0 = clamp01((lo - lo_s) * rdp_s);
    const float x1 = fmaxf(clamp01((hi - lo_s) * rdp_s), x0);
    if (x1 == x0) continue;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      float aL, aR, a6;
      ppm_layer(p.q[f] + col * K, pe1c, k, K, aL, aR, a6);
      const float da = aR - aL;
      tot[f] = tot[f] + (anti(aL, da, a6, x1) - anti(aL, da, a6, x0)) * dp_s;
    }
  }
  const float rdp2 = 1.0f / (p2hi - p2lo);
#pragma unroll
  for (int f = 0; f < NF; ++f) p.out[f][col * K + l] = tot[f] * rdp2;
}

}  // namespace

// qs / outs: host arrays of n device pointers ([ncol, K] f32, contiguous);
// pe1 / pe2: [ncol, K+1].  Launches on `stream` of `device` and returns
// cudaGetLastError() of the launch (0 = launched).
extern "C" int remap_banded_f32(const void* const* qs, void* const* outs,
                                int n, const void* pe1, const void* pe2,
                                long long ncol, int K, int band, int device,
                                void* stream) {
  if (n < 1 || n > kMaxFields || K < 2 || ncol < 0 || band < 0 ||
      band > K - 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  FieldPtrs p = {};
  for (int i = 0; i < n; ++i) {
    p.q[i] = static_cast<const float*>(qs[i]);
    p.out[i] = static_cast<float*>(outs[i]);
  }
  const long long total = ncol * (long long)K;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(pe1);
  const float* b = static_cast<const float*>(pe2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks);
  switch (n) {
    case 1: remap_banded_kernel<1><<<grid, kThreads, 0, s>>>(p, a, b, ncol, K, band); break;
    case 2: remap_banded_kernel<2><<<grid, kThreads, 0, s>>>(p, a, b, ncol, K, band); break;
    case 3: remap_banded_kernel<3><<<grid, kThreads, 0, s>>>(p, a, b, ncol, K, band); break;
    default: remap_banded_kernel<4><<<grid, kThreads, 0, s>>>(p, a, b, ncol, K, band); break;
  }
  return (int)cudaGetLastError();
}
