// Conservative removal of negative tracer values, for Hopper (sm_90a).
//
// Replaces the TPU kernel `fill_q2_zero_pallas`
// (geosongpu_tpu/ops/pallas/columns.py:99, body _fillq_kernel :82,
// pallas_call :112).  It computes what
// geosongpu_tpu_torch/physics/standalone.py::fill_q2_zero computes (the
// kernel's plain PyTorch version): from the model top down,
//   qk = q[k] + deficit / delp[k];  deficit = min(qk, 0) delp[k];
//   out[k] = max(qk, 0),
// a layer's negative mass being owed by the layer below it.
//
// It fills the first n tracers of a tracer array q [ncol, K, nq] as the
// model state holds it, in one launch, into n contiguous [ncol, K] outputs
// (a single field is nq = n = 1): delp is read once, and no strided slice
// of a tracer has to be copied first.
//
// What bounds it on this card: bytes, 2 inputs and 1 output of [ncol, K]
// per tracer (5.3 MB at 13,824 x 32, 1.6 us at 3.35 TB/s; three tracers
// share delp: 12.4 MB, 3.7 us), against one division per point; the
// recurrence is serial in K.
//
// Design: a block takes a tile of C neighbouring columns (column_tile.cuh):
// their values are one contiguous run of each array (C K nq floats of q),
// staged into shared memory with coalesced reads, tracer t of column c at
// t C P + c P (P = K | 1 odd, so that walkers of neighbouring columns fall
// in different banks); the staging copies are asynchronous (cp.async), so
// that a thread has all its loads of the tile in flight at once (on an H100
// SXM at 221,184 x 72 and three tracers 0.26 ms, against 0.36 with plain
// loads).  One thread per (tracer, column) walks K in shared memory and
// writes the result back in place; the outputs are then stored coalesced.
// (n + 1) rows of C x P floats: 37 KB at C = 32, K = 72 and three tracers;
// C halves while that would exceed kFillSmemTarget.  One thread per column
// instead would read addresses K floats apart across a warp.
#include "column_common.cuh"
#include "column_tile.cuh"

namespace {

constexpr int kFillThreads = 128;
constexpr int kFillTile = 32;                    // columns of a block, at most
constexpr size_t kFillSmemTarget = 48 * 1024;    // no opt-in at the models' K
constexpr size_t kFillSmemMax = 227 * 1024;      // what a block can opt in to

__host__ __device__ __forceinline__ int fill_pitch(int K) { return K | 1; }

__host__ __forceinline__ size_t fill_smem(int K, int n, int C) {
  return (size_t)(n + 1) * C * fill_pitch(K) * sizeof(float);
}

__global__ void __launch_bounds__(kFillThreads)
fill_q2_zero_columns(long long ncol, int K, int nq, int n, int C,
                     const float* __restrict__ q,
                     const float* __restrict__ delp,
                     float* __restrict__ out) {
  extern __shared__ float fill_smem_[];
  const int P = fill_pitch(K);
  const int rows = C * P;
  float* s_dp = fill_smem_;
  float* s_q = s_dp + rows;   // tracer t at t rows
  const long long col0 = (long long)blockIdx.x * C;
  const int nc = (int)min((long long)C, ncol - col0);
  const long long base = col0 * K;

  for_tile_elements<kFillThreads>(nc * K, K, [&](int e, int c, int k) {
    async_copy4(s_dp + c * P + k, delp + base + e);
  });
  // position j = k nq + t of a column's run of K nq tracer values
  for_tile_elements<kFillThreads>(nc * K * nq, K * nq, [&](int e, int c,
                                                           int j) {
    const int k = j / nq, t = j - k * nq;
    if (t < n) async_copy4(s_q + t * rows + c * P + k, q + base * nq + e);
  });
  async_copy_wait();
  __syncthreads();

  for (int w = threadIdx.x; w < n * C; w += kFillThreads) {
    const int t = w / C, c = w - t * C;
    if (c < nc) {
      float* qc = s_q + t * rows + c * P;
      const float* dp = s_dp + c * P;
      float deficit = 0.0f;
      for (int k = 0; k < K; ++k) {
        const float d = dp[k];
        const float qk = qc[k] + deficit / d;
        deficit = fminf(qk, 0.0f) * d;
        qc[k] = fmaxf(qk, 0.0f);
      }
    }
  }
  __syncthreads();

  // output t is [ncol, K] at t ncol K of `out`
  for (int t = 0; t < n; ++t) {
    float* o = out + t * ncol * K + base;
    const float* sq = s_q + t * rows;
    for_tile_elements<kFillThreads>(nc * K, K, [&](int e, int c, int k) {
      o[e] = sq[c * P + k];
    });
  }
}

}  // namespace

// q: [ncol, K, nq] (nq = 1: a field [ncol, K]); delp: [ncol, K]; out: n
// outputs [ncol, K], one after the other, for the tracers 0..n-1 of q.
// Returns the CUDA error of the launch, 0 when it launched.
extern "C" int fill_q2_zero_f32(long long ncol, int K, int nq, int n,
                                const void* q, const void* delp, void* out,
                                int device, void* stream) {
  const int rc = prepare(ncol, K, device);
  if (rc != 0) return rc;
  if (nq < 1 || n < 1 || n > nq ||
      (long long)kFillTile * K * nq > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  if (ncol == 0) return 0;
  int C = kFillTile;
  while (C > 1 && fill_smem(K, n, C) > kFillSmemTarget) C /= 2;
  const size_t bytes = fill_smem(K, n, C);
  if (bytes > kFillSmemMax) return (int)cudaErrorInvalidValue;
  const long long blocks = (ncol + C - 1) / C;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fill_q2_zero_columns, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  fill_q2_zero_columns<<<(unsigned)blocks, kFillThreads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      ncol, K, nq, n, C, cf(q), cf(delp), wf(out));
  return (int)cudaGetLastError();
}
