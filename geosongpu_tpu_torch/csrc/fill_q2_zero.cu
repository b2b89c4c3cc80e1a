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
// Design: one thread per column, the deficit carried in a register down a
// run-time loop over K (the TPU kernel unrolled K and concatenated the
// levels; its 256-column panes and padding are gone, the last block is
// masked).  What bounds it on this card: 2 inputs and 1 output of
// [ncol, K], 5.3 MB at 13,824 x 32 (1.6 us at 3.35 TB/s), against one
// division per point.  What holds it back: the recurrence is serial in K
// and neighbouring threads read K floats apart; at the model's size the
// call is a launch and 108 blocks.
#include "column_common.cuh"

namespace {

__global__ void __launch_bounds__(kColThreads)
fill_q2_zero_columns(long long ncol, int K, const float* __restrict__ q,
                     const float* __restrict__ delp, float* __restrict__ out) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= ncol) return;
  const long long base = col * K;
  float deficit = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float dp = delp[base + k];
    const float qk = q[base + k] + deficit / dp;
    deficit = fminf(qk, 0.0f) * dp;
    out[base + k] = fmaxf(qk, 0.0f);
  }
}

}  // namespace

// q, delp, out: [ncol, K].  Returns the CUDA error of the launch, 0 when
// it launched.
extern "C" int fill_q2_zero_f32(long long ncol, int K, const void* q,
                                const void* delp, void* out, int device,
                                void* stream) {
  const int rc = prepare(ncol, K, device);
  if (rc != 0 || ncol == 0) return rc;
  fill_q2_zero_columns<<<col_blocks(ncol), kColThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      ncol, K, cf(q), cf(delp), wf(out));
  return (int)cudaGetLastError();
}
