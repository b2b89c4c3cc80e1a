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
// Design: the points of the flat [ncol * K] index, so a warp reads and
// writes neighbouring addresses; the tail of the last block is masked.
// Their byte bounds at 3.35 TB/s: 2 + 1, 3 + 4 and 4 + 2 arrays of
// [ncol, K], 1.6 to 3.7 us at 13,824 x 32 (1.8 MB an array), 0.057 to
// 0.133 ms at 221,184 x 72 (63.7 MB).  moist_rad_coup (one expf a point)
// is bound by those bytes and takes one point a thread.  aer_activation (a
// powf, a logf, an erff and an IEEE division a point for 12 bytes) and
// cup_gf_sh (a powf and five IEEE divisions a point) are bound by
// instruction issue, as the library keeps IEEE arithmetic without
// contraction to match the plain versions bit for bit.
//
// aer_activation's smax is one of two clamp values for every w <= 0 and
// every w at or above kAerWHi, and then so is the activated fraction: a
// warp whose points all lie on a clamp takes both fractions from two of its
// lanes, which form them once with the same device expressions, and skips
// the powf, logf and erff of its points.  From kAerWide points on a thread
// takes four points, kColThreads apart, so that it has independent
// transcendental chains to issue and all its loads in flight at once;
// below that, one point a thread: a grid of fewer, longer threads was
// slower there (PERF.md, row 11a).  The accesses stay 4-byte and coalesced,
// which takes any alignment of the views.  The reciprocal of denom is
// taken once, on the host.
//
// cup_gf_sh needs the theta_v of its two vertical neighbours: a block forms
// theta_v once for each point of its run and the point on each side of it,
// in shared memory, and each thread reads its neighbours' from there (one
// powf a point where recomputing them took three).  At 13,824 x 32 each
// call is one launch and its time is mostly the launch.
#include "column_common.cuh"

namespace {

// standalone.aer_activation: smax = clip(0.01 max(w, 0)^0.75, 1e-5, 0.1);
// frac = 0.5 (1 - erf(log(s_crit0 / smax) / denom)), denom = sqrt(2) 1.5
// log(sigma_g); out = num_aer frac.
//
// 0.01 w^0.75 reaches the upper clamp 0.1 at w = 10^(4/3) = 21.544; from
// 21.6 on it is at least 0.10019, further above 0.1 than powf's error.
constexpr float kAerWHi = 21.6f;
// Flat sizes from which a thread takes four points, not one.
constexpr long long kAerWide = 1LL << 20;

__device__ __forceinline__ float aer_smax(float w) {
  return clampf(0.01f * powf(fmaxf(w, 0.0f), 0.75f), 1.0e-5f, 0.1f);
}

__device__ __forceinline__ float aer_frac(float smax, float s_crit0,
                                          float rdenom) {
  const float ln_ratio = logf(rcp(smax) * s_crit0);
  return 0.5f * (1.0f - erff(ln_ratio * rdenom));
}

// Per points a thread, kColThreads apart.  A warp whose points of one step
// all lie on a clamp (or past n) takes frac from lanes 0 and 1, which form
// it at smax 1e-5 and 0.1 the first time the warp needs it.
template <int Per>
__global__ void __launch_bounds__(kColThreads)
aer_activation_points(long long n, const float* __restrict__ num_aer,
                      const float* __restrict__ w, float s_crit0,
                      float rdenom, float* __restrict__ nact) {
  const long long base =
      (long long)blockIdx.x * (kColThreads * Per) + threadIdx.x;
  float wv[Per], na[Per];
#pragma unroll
  for (int r = 0; r < Per; ++r) {
    const long long i = base + r * kColThreads;
    wv[r] = i < n ? w[i] : 0.0f;
    na[r] = i < n ? num_aer[i] : 0.0f;
  }
  float clamp_frac = 0.0f;
  bool formed = false;  // the same in every lane of the warp
#pragma unroll
  for (int r = 0; r < Per; ++r) {
    const long long i = base + r * kColThreads;
    const bool hi = wv[r] >= kAerWHi;
    float frac;
    if (__all_sync(0xffffffffu, wv[r] <= 0.0f || hi || i >= n)) {
      if (!formed) {
        clamp_frac = aer_frac(threadIdx.x & 1 ? 0.1f : 1.0e-5f, s_crit0,
                              rdenom);
        formed = true;
      }
      frac = __shfl_sync(0xffffffffu, clamp_frac, hi ? 1 : 0);
    } else {
      frac = aer_frac(aer_smax(wv[r]), s_crit0, rdenom);
    }
    if (i < n) nact[i] = na[r] * frac;
  }
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the plain version's division by denom, as PyTorch's CUDA kernel takes
  // it: a product with the float reciprocal, which IEEE division rounds
  // alike on the host and on the card
  const float rdenom = 1.0f / denom;
  if (n >= kAerWide)
    aer_activation_points<4><<<col_blocks((n + 3) / 4), kColThreads, 0, s>>>(
        n, cf(num_aer), cf(w), s_crit0, rdenom, wf(nact));
  else
    aer_activation_points<1><<<col_blocks(n), kColThreads, 0, s>>>(
        n, cf(num_aer), cf(w), s_crit0, rdenom, wf(nact));
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
