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
// What bounds it on this card: per column it reads (n+2) K floats and
// writes n K; at c192-L72 the step's three calls move 0.9 GB, 0.27 ms at
// 3.35 TB/s, against a few hundred operations per level.
//
// Design: a block takes a tile of C neighbouring columns (column_tile.cuh):
// pe1, pe2 and the fields of its columns are one contiguous run of each
// array, staged into shared memory with coalesced reads, and the outputs
// are written once, coalesced.  Then, every thread over the tile's points:
//   A1, once per interface j of pe1 (and field): the reciprocal thickness of
//       layer j, and the monotone PPM edge at j of every field (one division
//       for the thickness weight, shared by the fields);
//   A2, once per source layer k (and field): the two-pass limiter on the
//       layer's two edges, leaving aL, aR - aL and a6 in shared memory (a6 in
//       the slot of the field's values);
//   B,  once per target layer l: the source layers whose overlap with
//       [pe2[l], pe2[l+1]] is not empty are one contiguous run (pe1 and pe2
//       rise down the column); the thread finds its first layer, searching
//       from layer l, and walks the run upward, within l-band..l+band,
//       adding each slot's integral of the parabola in the plain version's
//       order of d.
// A source slot outside the run contributes an exact +0 in the plain
// version: below the run (pe1[k+1] <= pe2[l]) the clamped overlap bounds
// are equal, x1 == x0, and above it (pe1[k] >= pe2[l+1]) both are 0.  So the
// walk adds the same terms in the same order and changes no bit of the sum
// (tests/test_torch_remap.py holds that premise on the CPU).  Each
// expression keeps the plain version's operation order, and x / 3.0 is
// x * (1/3), the form PyTorch evaluates a division by a Python scalar in on
// the card.

#include <cuda_runtime.h>

#include "column_tile.cuh"

namespace {

constexpr int kMaxFields = 4;
// 16 columns and 256 threads a block: at c192-L72 a fifth less device time
// than 32 columns (more blocks an SM, fewer points a thread); 8 columns,
// 128 threads, 512 threads, and double-buffered asynchronous staging of the
// next tile were no faster.
constexpr int kRemapThreads = 256;
constexpr int kRemapTile = 16;          // columns of a block, at most
constexpr int kRemapSmem = 227 * 1024;  // shared memory a block can opt in to
constexpr float kThird = 1.0f / 3.0f;   // Python's 1 / 3.0 in float32

struct FieldPtrs {
  const float* q[kMaxFields];
  float* out[kMaxFields];
};

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ float anti(float aL, float da, float a6, float x) {
  return aL * x + 0.5f * da * x * x + a6 * (0.5f * x * x - x * x * x * kThird);
}

// Shared row blocks of a tile of C columns, each C x P floats with the
// column c at c P and P = (K+1) | 1: pe1, pe2 and the reciprocal source
// thickness, then per field its values (then a6), its edges, aL and aR - aL.
constexpr int kRemapRows = 3;
constexpr int kRemapFieldRows = 4;

__host__ __device__ __forceinline__ int remap_pitch(int K) {
  return (K + 1) | 1;
}

__host__ __forceinline__ size_t remap_smem(int nf, int K, int C) {
  return (size_t)(kRemapRows + kRemapFieldRows * nf) * C * remap_pitch(K) *
         sizeof(float);
}

template <int NF>
__global__ void __launch_bounds__(kRemapThreads)
remap_banded_kernel(FieldPtrs p, const float* __restrict__ pe1,
                    const float* __restrict__ pe2, long long ncol, int K,
                    int band, int C) {
  extern __shared__ float remap_smem_[];
  const int P = remap_pitch(K);
  const int rows = C * P;
  float* s_pe1 = remap_smem_;
  float* s_pe2 = s_pe1 + rows;
  float* s_rdp = s_pe2 + rows;
  float* s_q = s_rdp + rows;       // field f at f rows: q, then a6
  float* s_e = s_q + NF * rows;    // edges at the interfaces
  float* s_al = s_e + NF * rows;   // aL
  float* s_da = s_al + NF * rows;  // aR - aL
  const long long col0 = (long long)blockIdx.x * C;
  const int nc = (int)min((long long)C, ncol - col0);
  const int n = nc * K, n1 = nc * (K + 1);
  const long long base = col0 * K, base1 = col0 * (K + 1);

  for_tile_elements<kRemapThreads>(n1, K + 1, [&](int e, int c, int j) {
    s_pe1[c * P + j] = pe1[base1 + e];
    s_pe2[c * P + j] = pe2[base1 + e];
  });
  for_tile_elements<kRemapThreads>(n, K, [&](int e, int c, int k) {
#pragma unroll
    for (int f = 0; f < NF; ++f) s_q[f * rows + c * P + k] = p.q[f][base + e];
  });
  __syncthreads();

  // A1: the reciprocal thickness of layer j and the edges at interface j:
  // thickness-weighted two-cell values clipped to their neighbours inside,
  // one-sided 2nd-order extrapolation at the top (j == 0) and bottom
  // (j == K), as ops/remap.py::_ppm_edges_k.
  for_tile_elements<kRemapThreads>(n1, K + 1, [&](int, int c, int j) {
    const float* pe = s_pe1 + c * P;
    const int o = c * P;
    if (j < K) s_rdp[o + j] = 1.0f / (pe[j + 1] - pe[j]);
    if (j == 0) {
      const float dp0 = pe[1] - pe[0];
      const float dp1 = pe[2] - pe[1];
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const float* q = s_q + f * rows + o;
        const float s_top = (q[1] - q[0]) / (0.5f * (dp0 + dp1));
        s_e[f * rows + o] = q[0] - s_top * 0.5f * dp0;
      }
    } else if (j == K) {
      const float dpl = pe[K] - pe[K - 1];
      const float dpm = pe[K - 1] - pe[K - 2];
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const float* q = s_q + f * rows + o;
        const float s_bot = (q[K - 1] - q[K - 2]) / (0.5f * (dpl + dpm));
        s_e[f * rows + o + K] = q[K - 1] + s_bot * 0.5f * dpl;
      }
    } else {
      const float dpm = pe[j] - pe[j - 1];
      const float dpp = pe[j + 1] - pe[j];
      const float w = dpm / (dpm + dpp);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const float* q = s_q + f * rows + o;
        const float qm = q[j - 1];
        const float qp = q[j];
        const float e = qm + (qp - qm) * w;
        s_e[f * rows + o + j] =
            fminf(fmaxf(e, fminf(qm, qp)), fmaxf(qm, qp));
      }
    }
  });
  __syncthreads();

  // A2: the parabola of source layer k after the two-pass Colella-Woodward
  // limiter, in the order of wheres of the plain version.
  for_tile_elements<kRemapThreads>(n, K, [&](int, int c, int k) {
    const int o = c * P + k;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int fo = f * rows + o;
      const float qk = s_q[fo];
      float aL = s_e[fo];
      float aR = s_e[fo + 1];
      if ((aR - qk) * (qk - aL) <= 0.0f) {
        aL = qk;
        aR = qk;
      }
      float da = aR - aL;
      float a6 = 6.0f * (qk - 0.5f * (aL + aR));
      if (a6 * da > da * da) aL = 3.0f * qk - 2.0f * aR;
      da = aR - aL;
      a6 = 6.0f * (qk - 0.5f * (aL + aR));
      if (a6 * da < -da * da) aR = 3.0f * qk - 2.0f * aL;
      s_q[fo] = 6.0f * (qk - 0.5f * (aL + aR));
      s_al[fo] = aL;
      s_da[fo] = aR - aL;
    }
  });
  __syncthreads();

  // B: target layer l from the run of source layers it overlaps.
  for_tile_elements<kRemapThreads>(n, K, [&](int e, int c, int l) {
    const int o = c * P;
    const float* pe = s_pe1 + o;
    const float p2lo = s_pe2[o + l];
    const float p2hi = s_pe2[o + l + 1];
    // the first k of l-band..l+band with pe[k+1] > p2lo, searched from l
    const int k_lo = max(0, l - band), k_end = min(K - 1, l + band);
    int k = l;
    if (pe[k + 1] > p2lo) {
      while (k > k_lo && pe[k] > p2lo) --k;
    } else {
      do ++k; while (k <= k_end && pe[k + 1] <= p2lo);
    }
    float tot[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) tot[f] = 0.0f;
    for (; k <= k_end && pe[k] < p2hi; ++k) {
      const float lo_s = pe[k];
      const float hi_s = pe[k + 1];
      const float dp_s = hi_s - lo_s;
      const float rdp_s = s_rdp[o + k];
      const float lo = fmaxf(lo_s, p2lo);
      const float hi = fminf(hi_s, p2hi);
      const float x0 = clamp01((lo - lo_s) * rdp_s);
      const float x1 = fmaxf(clamp01((hi - lo_s) * rdp_s), x0);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int fo = f * rows + o + k;
        const float aL = s_al[fo], da = s_da[fo], a6 = s_q[fo];
        tot[f] = tot[f] + (anti(aL, da, a6, x1) - anti(aL, da, a6, x0)) * dp_s;
      }
    }
    const float rdp2 = 1.0f / (p2hi - p2lo);
#pragma unroll
    for (int f = 0; f < NF; ++f) p.out[f][base + e] = tot[f] * rdp2;
  });
}

// One launch of NF fields: the tile shrinks while its rows would not fit
// the shared memory a block can opt in to.
template <int NF>
cudaError_t launch_remap(const FieldPtrs& p, const float* pe1,
                         const float* pe2, long long ncol, int K, int band,
                         cudaStream_t s) {
  int C = kRemapTile;
  while (C > 1 && remap_smem(NF, K, C) > kRemapSmem) C /= 2;
  const size_t bytes = remap_smem(NF, K, C);
  if (bytes > kRemapSmem) return cudaErrorInvalidValue;
  const long long blocks = (ncol + C - 1) / C;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      remap_banded_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  remap_banded_kernel<NF><<<(unsigned)blocks, kRemapThreads, bytes, s>>>(
      p, pe1, pe2, ncol, K, band, C);
  return cudaGetLastError();
}

}  // namespace

// qs / outs: host arrays of n device pointers ([ncol, K] f32, contiguous);
// pe1 / pe2: [ncol, K+1].  Launches on `stream` of `device` and returns
// the CUDA error of the launch (0 = launched).
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
  if (ncol == 0) return 0;
  const float* a = static_cast<const float*>(pe1);
  const float* b = static_cast<const float*>(pe2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: return (int)launch_remap<1>(p, a, b, ncol, K, band, s);
    case 2: return (int)launch_remap<2>(p, a, b, ncol, K, band, s);
    case 3: return (int)launch_remap<3>(p, a, b, ncol, K, band, s);
    default: return (int)launch_remap<4>(p, a, b, ncol, K, band, s);
  }
}
