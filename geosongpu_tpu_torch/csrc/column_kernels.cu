// aer_activation, moist_rad_coup and cup_gf_sh as kernels written by hand,
// for Hopper (sm_90a).
//
// They replace the TPU's generic fuser `column_kernel_call`
// (geosongpu_tpu/ops/pallas/columns.py:30, pallas_call :61), which runs a
// Python column body on [256, K] panes and is given three bodies by the
// physics gate: aer_activation, moist_rad_coup and cup_gf_sh
// (geosongpu_tpu/physics/standalone.py:98, :270, :286).  A fuser of Python
// bodies has no CUDA counterpart short of a code generator, so each body
// is written here from its formula, a second source beside the primary in
// geosongpu_tpu_torch/physics/standalone.py, which is also each kernel's
// plain PyTorch version.
//
// Design: one thread per point (col, k) over the flat [ncol * K] index, so
// a warp reads and writes neighbouring addresses; the tail of the last
// block is masked.  cup_gf_sh needs the theta_v of its two vertical
// neighbours: a block forms theta_v once for each point of its run and
// the point on each side of it, in shared memory, and each thread reads
// its neighbours' from there (one powf a point where recomputing them
// took three).  Their byte bounds at 3.35 TB/s: 2 + 1, 3 + 4 and 4 + 2
// arrays of [ncol, K], 1.6 to 3.7 us at 13,824 x 32 (1.8 MB an array),
// 0.057 to 0.133 ms at 221,184 x 72 (63.7 MB).  moist_rad_coup (one expf
// a point) is bound by those bytes; aer_activation (a powf, a logf, an
// erff and two IEEE divisions a point for 12 bytes) and cup_gf_sh (a powf
// and five IEEE divisions a point) by instruction issue, as the library
// keeps IEEE arithmetic without contraction to match the plain versions
// bit for bit.  At 13,824 x 32 each call is one launch of 3,456 blocks
// and its time is mostly the launch.
#include "column_common.cuh"

namespace {

// standalone.aer_activation: smax = clip(0.01 max(w, 0)^0.75, 1e-5, 0.1);
// frac = 0.5 (1 - erf(log(s_crit0 / smax) / denom)), denom = sqrt(2) 1.5
// log(sigma_g); out = num_aer frac.
__global__ void __launch_bounds__(kColThreads)
aer_activation_points(long long n, const float* __restrict__ num_aer,
                      const float* __restrict__ w, float s_crit0, float denom,
                      float* __restrict__ nact) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float smax = clampf(0.01f * powf(fmaxf(w[i], 0.0f), 0.75f), 1.0e-5f,
                            0.1f);
  const float ln_ratio = logf(rcp(smax) * s_crit0);
  const float frac = 0.5f * (1.0f - erff(ln_ratio * rcp(denom)));
  nact[i] = num_aer[i] * frac;
}

// standalone.moist_rad_coup: condensate ql + qi, cloud fraction
// clip(1 - exp(-cond / 2e-5), 0, 1), liquid radius 10 um, ice radius
// clip((t - 180) 0.5e-6, 10 um, 60 um).
__global__ void __launch_bounds__(kColThreads)
moist_rad_coup_points(long long n, const float* __restrict__ ql,
                      const float* __restrict__ qi,
                      const float* __restrict__ t, float* __restrict__ cf_out,
                      float* __restrict__ re_liq, float* __restrict__ re_ice,
                      float* __restrict__ cond) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float q_cond = ql[i] + qi[i];
  cf_out[i] = clampf(1.0f - expf((-q_cond) * rcp(2.0e-5f)), 0.0f, 1.0f);
  re_liq[i] = 10.0e-6f;
  re_ice[i] = clampf((t[i] - 180.0f) * 0.5e-6f, 10.0e-6f, 60.0e-6f);
  cond[i] = q_cond;
}

// theta_v = t (1 + (1/eps - 1) qv) (1e5 / p)^kappa, in the plain
// version's order: t_virtual first, then the Exner factor.
__device__ __forceinline__ float theta_v(float t, float qv, float p,
                                         float c_virt, float kappa) {
  return t * (1.0f + c_virt * qv) * powf(rcp(p) * 1.0e5f, kappa);
}

// standalone.cup_gf_sh: across every interface where theta_v below exceeds
// theta_v above by more than 0.1 K, mix t and qv downgradient with weight
// f_mix and the two layers' delp.  A layer's increment takes the term of
// the interface below it first, then the one above, as the plain version's
// two slice updates do.  A block takes the run of kColThreads points from
// base; slot r of its shared rows holds the point base - 1 + r, so that
// slots 0 and kColThreads + 1 hold the neighbours just outside the run,
// which threads 0 and 1 stage besides their own point.
__global__ void __launch_bounds__(kColThreads)
cup_gf_sh_points(long long n, int K, const float* __restrict__ t,
                 const float* __restrict__ qv, const float* __restrict__ p,
                 const float* __restrict__ delp, float f_mix, float c_virt,
                 float kappa, float* __restrict__ t_out,
                 float* __restrict__ qv_out) {
  constexpr int kRow = kColThreads + 2;
  __shared__ float s_t[kRow], s_q[kRow], s_dp[kRow], s_th[kRow];
  const long long base = (long long)blockIdx.x * kColThreads;
  const auto stage = [&](int r) {
    const long long e = base - 1 + r;
    if (e < 0 || e >= n) return;
    s_t[r] = t[e];
    s_q[r] = qv[e];
    s_dp[r] = delp[e];
    s_th[r] = theta_v(s_t[r], s_q[r], p[e], c_virt, kappa);
  };
  stage(threadIdx.x + 1);
  if (threadIdx.x < 2) stage(threadIdx.x * (kRow - 1));
  __syncthreads();

  const long long i = base + threadIdx.x;
  if (i >= n) return;
  const int r = threadIdx.x + 1;
  const int k = (int)(i % K);
  const float t0 = s_t[r], q0 = s_q[r], dp0 = s_dp[r], th0 = s_th[r];
  float dt_acc = 0.0f, dq_acc = 0.0f;
  if (k < K - 1) {   // interface below: layers k (above) and k + 1 (below)
    const float t1 = s_t[r + 1], q1 = s_q[r + 1], dp1 = s_dp[r + 1];
    const float mix = s_th[r + 1] > th0 + 0.1f ? f_mix : 0.0f;
    const float wsum = dp0 + dp1;
    dt_acc = dt_acc + mix * (t1 - t0) * dp1 / wsum;
    dq_acc = dq_acc + mix * (q1 - q0) * dp1 / wsum;
  }
  if (k > 0) {       // interface above: layers k - 1 (above) and k (below)
    const float tm = s_t[r - 1], qm = s_q[r - 1], dpm = s_dp[r - 1];
    const float mix = th0 > s_th[r - 1] + 0.1f ? f_mix : 0.0f;
    const float wsum = dpm + dp0;
    dt_acc = dt_acc + (-(mix * (t0 - tm))) * dpm / wsum;
    dq_acc = dq_acc + (-(mix * (q0 - qm))) * dpm / wsum;
  }
  t_out[i] = t0 + dt_acc;
  qv_out[i] = q0 + dq_acc;
}

}  // namespace

// Every array [ncol, K].  Each entry returns the CUDA error of its launch,
// 0 when it launched.
extern "C" int aer_activation_f32(long long ncol, int K, const void* num_aer,
                                  const void* w, float s_crit0, float denom,
                                  void* nact, int device, void* stream) {
  const int rc = prepare(ncol, K, device);
  if (rc != 0 || ncol == 0) return rc;
  const long long n = ncol * K;
  aer_activation_points<<<col_blocks(n), kColThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      n, cf(num_aer), cf(w), s_crit0, denom, wf(nact));
  return (int)cudaGetLastError();
}

extern "C" int moist_rad_coup_f32(long long ncol, int K, const void* ql,
                                  const void* qi, const void* t,
                                  void* cloud_fraction, void* re_liquid,
                                  void* re_ice, void* condensate, int device,
                                  void* stream) {
  const int rc = prepare(ncol, K, device);
  if (rc != 0 || ncol == 0) return rc;
  const long long n = ncol * K;
  moist_rad_coup_points<<<col_blocks(n), kColThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      n, cf(ql), cf(qi), cf(t), wf(cloud_fraction), wf(re_liquid),
      wf(re_ice), wf(condensate));
  return (int)cudaGetLastError();
}

extern "C" int cup_gf_sh_f32(long long ncol, int K, const void* t,
                             const void* qv, const void* p, const void* delp,
                             float f_mix, float c_virt, float kappa,
                             void* t_out, void* qv_out, int device,
                             void* stream) {
  const int rc = prepare(ncol, K, device);
  if (rc != 0 || ncol == 0) return rc;
  const long long n = ncol * K;
  cup_gf_sh_points<<<col_blocks(n), kColThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      n, K, cf(t), cf(qv), cf(p), cf(delp), f_mix, c_virt, kappa, wf(t_out),
      wf(qv_out));
  return (int)cudaGetLastError();
}
