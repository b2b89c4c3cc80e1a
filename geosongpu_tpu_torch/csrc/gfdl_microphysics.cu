// GFDL-1M single-moment microphysics column update, for Hopper (sm_90a).
//
// Replaces the TPU kernel `gfdl_microphysics`
// (geosongpu_tpu/ops/pallas/microphysics.py:152 gfdl_microphysics_pallas,
// body _mp_kernel :54, pallas_call :180).  It computes what
// geosongpu_tpu_torch/physics/standalone.py::gfdl_microphysics computes
// (the kernel's plain PyTorch version), in its operation order:
//   1. two Newton steps of saturation adjustment over liquid,
//   2. homogeneous (< -40 C) and Bigg freezing, melting limited by the
//      sensible heat,
//   3. Wegener-Bergeron-Findeisen deposition and ice sublimation,
//   4. Kessler autoconversion and accretion,
//   5. implicit-upstream sedimentation of rain and of ice, a recurrence
//      from the model top to the surface,
//   6. rain evaporation,
// and the surface precipitation of the column.
//
// What bounds it on this card: 7 inputs and 5 outputs of [ncol, K] (21 MB
// at 13,824 x 32, 6 us at 3.35 TB/s; 0.23 ms at 221,184 x 72) against
// about 13 expf, 4 powf and 25 IEEE divisions per point, several hundred
// instructions: the rate at which the SMs execute instructions, not the
// bytes, sets the time at every size the models use.
//
// Design: a block takes a tile of C neighbouring columns (column_tile.cuh),
// whose values are one contiguous run of C K floats in every array.
//   A, every thread over the tile's points, in the run's order: reads the
//      inputs coalesced, computes stages 1-4 and the sedimentation Courant
//      numbers cr and ci (pointwise in the plain version), writes ql' (final
//      after stage 4) and keeps in shared memory what the later phases
//      read: qr, qi, delp, cr, ci for B; t, qv, p, rho for C;
//   B, one thread per (column, species), rain and ice on different warps:
//      the recurrence q' = (q delp + in) / (1 + c), in = q' c, q = q' / delp
//      down the column in shared memory, the surface flux kept per column;
//   C, every thread over the points: rain evaporation from the sedimented
//      qr, the four field outputs written coalesced, and the column's
//      precipitation (rain + ice flux) / g.
// Shared memory holds nine rows of C x P floats (column c at c P, P = K | 1
// odd, so that the walkers of B fall in different banks).  The tile is
// chosen by K: C halves from 32 while the rows would exceed kMpSmemTarget,
// so that five blocks (40 warps) fit an SM: 32 columns at K = 32 (38 KB),
// 16 at K = 72 (42 KB), down to one column, which takes K up to ~6,400
// within what a block can opt in to; the last block is masked, nothing is
// padded.  On an H100 SXM (700 W) at 221,184 x 72, 16 columns took 1.03 ms
// and 32 columns (two blocks an SM) 1.48; at 13,824 x 32, 32 columns 0.035
// ms and 16 0.040.  One thread per column instead would read addresses K
// floats apart across a warp and run 108 blocks at 13,824 columns.
//
// fminf/fmaxf drop a NaN where PyTorch's minimum/clamp would pass it on;
// on finite inputs they agree.  exp(0.66 max(-tc, 0)) overflows to inf in
// very cold layers and 1 - exp(-inf) absorbs it, as in the plain version.
#include "column_common.cuh"
#include "column_tile.cuh"

namespace {

// Order of the wrapper's constant array (ops/kernels/microphysics.py).
enum ConstId {
  C_T_ICE, C_EPS, C_ONE_M_EPS, C_HLV, C_RVGAS, C_RDGAS, C_GRAV, C_LV_CP,
  C_LF_CP, C_LS_CP, C_CP_AIR, C_HLF, C_BIGG, C_F_WBF, C_QL_CRIT, C_F_AUTO,
  C_ACC, C_RHO0, C_VT_RAIN_MAX, C_VT_ICE_MAX, C_DT, C_REVP, C_COUNT
};

struct MpConst {
  float v[C_COUNT];
};

constexpr int kMpThreads = 256;
constexpr int kMpTile = 32;                  // columns of a block, at most
constexpr int kMpRows = 9;                   // shared rows of C x P floats
constexpr size_t kMpSmemTarget = 48 * 1024;   // five blocks an SM
constexpr size_t kMpSmemMax = 227 * 1024;     // what a block can opt in to

__host__ __device__ __forceinline__ int mp_pitch(int K) { return K | 1; }

// the rows and the two surface fluxes of each column
__host__ __forceinline__ size_t mp_smem(int K, int C) {
  return ((size_t)kMpRows * C * mp_pitch(K) + 2 * C) * sizeof(float);
}

__global__ void __launch_bounds__(kMpThreads)
gfdl_microphysics_columns(
    long long ncol, int K, int C, const float* __restrict__ t_in,
    const float* __restrict__ qv_in, const float* __restrict__ ql_in,
    const float* __restrict__ qr_in, const float* __restrict__ qi_in,
    const float* __restrict__ p_in, const float* __restrict__ delp_in,
    MpConst c, float* __restrict__ t_out, float* __restrict__ qv_out,
    float* __restrict__ ql_out, float* __restrict__ qr_out,
    float* __restrict__ qi_out, float* __restrict__ precip) {
  extern __shared__ float mp_smem_[];
  const int P = mp_pitch(K);
  const int rows = C * P;
  float* s_t = mp_smem_;
  float* s_qv = s_t + rows;
  float* s_p = s_qv + rows;
  float* s_rho = s_p + rows;
  float* s_delp = s_rho + rows;
  float* s_qr = s_delp + rows;   // rain, then ice: B indexes them by species
  float* s_qi = s_qr + rows;
  float* s_cr = s_qi + rows;     // Courant numbers, rain then ice
  float* s_ci = s_cr + rows;
  float* s_flux = s_ci + rows;   // [2][C]: rain, then ice
  const long long col0 = (long long)blockIdx.x * C;
  const int nc = (int)min((long long)C, ncol - col0);
  const long long base = col0 * K;
  const Thermo th = {c.v[C_T_ICE], c.v[C_EPS], c.v[C_ONE_M_EPS], c.v[C_HLV],
                     c.v[C_RVGAS]};
  const float lv_cp = c.v[C_LV_CP], lf_cp = c.v[C_LF_CP];
  const float ls_cp = c.v[C_LS_CP], dt = c.v[C_DT];

  // A: stages 1-4 and the Courant numbers, point by point
  for_tile_elements<kMpThreads>(nc * K, K, [&](int e, int col, int k) {
    const long long i = base + e;
    const int o = col * P + k;
    float t = t_in[i], qv = qv_in[i], ql = ql_in[i], qr = qr_in[i];
    float qi = qi_in[i];
    const float p = p_in[i], delp = delp_in[i];

    const float rho = p / (c.v[C_RDGAS] * fmaxf(t, 150.0f));
    const float dz = delp / (rho * c.v[C_GRAV]);

    // 1. saturation adjustment
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const float qs0 = qsat_liquid(t, p, th);
      const float dq = (qv - qs0) / (1.0f + lv_cp * dqsat_dt(t, p, th));
      const float cond = dq > 0.0f ? dq : fmaxf(dq, -ql);
      qv = qv - cond;
      ql = ql + cond;
      t = t + lv_cp * cond;
    }

    // 2. freezing / melting
    const float tc = t - th.t_ice;
    const float frz_hom = tc < -40.0f ? ql : 0.0f;
    const float bigg = ql * (1.0f - expf(
        c.v[C_BIGG] * (expf(0.66f * fmaxf(-tc, 0.0f)) - 1.0f)));
    const float frz = fminf(
        ql, ((tc < 0.0f && tc >= -40.0f) ? bigg : 0.0f) + frz_hom);
    const float melt = tc > 0.0f
        ? fminf(qi, c.v[C_CP_AIR] * fmaxf(tc, 0.0f) * rcp(c.v[C_HLF]))
        : 0.0f;
    ql = ql - frz + melt;
    qi = qi + frz - melt;
    t = t + lf_cp * (frz - melt);

    // 3. WBF deposition / ice sublimation (tc is that of step 2)
    const float qs_i = qsat_ice(t, p, th);
    const float gam_i = 1.0f + ls_cp * dqsat_dt(t, p, th);
    const float ice_presence = 1.0f - expf((-qi) * rcp(1.0e-6f));
    const float dep = tc < 0.0f
        ? fmaxf(qv - qs_i, 0.0f) / gam_i * ice_presence * c.v[C_F_WBF]
        : 0.0f;
    const float sub = fminf(qi, fmaxf(qs_i - qv, 0.0f) / gam_i * c.v[C_F_WBF]);
    qv = qv - dep + sub;
    qi = qi + dep - sub;
    t = t + ls_cp * (dep - sub);

    // 4. warm rain
    const float aut = fmaxf(ql - c.v[C_QL_CRIT], 0.0f) * c.v[C_F_AUTO];
    const float acc = ql * (1.0f - expf(
        c.v[C_ACC] * powf(fmaxf(rho * qr, 0.0f), 0.875f)));
    const float to_rain = fminf(ql, aut + acc);
    ql = ql - to_rain;
    qr = qr + to_rain;

    // 5a. the Courant numbers of the fall speeds
    const float rdz = fmaxf(dz, 1.0f);
    const float vt_r = clampf(
        36.34f * powf(fmaxf(rho * qr, 0.0f), 0.2f)
            * sqrtf(rcp(rho) * c.v[C_RHO0]),
        0.0f, c.v[C_VT_RAIN_MAX]);
    const float vt_i = clampf(3.29f * powf(fmaxf(rho * qi, 0.0f), 0.16f),
                              0.0f, c.v[C_VT_ICE_MAX]);

    ql_out[i] = ql;
    s_t[o] = t;
    s_qv[o] = qv;
    s_p[o] = p;
    s_rho[o] = rho;
    s_delp[o] = delp;
    s_qr[o] = qr;
    s_qi[o] = qi;
    s_cr[o] = vt_r * dt / rdz;
    s_ci[o] = vt_i * dt / rdz;
  });
  __syncthreads();

  // B: 5b. sedimentation, implicit upstream, top to surface: the flux
  // leaving the layer above enters this one
  if (threadIdx.x < 2 * C) {
    const int species = threadIdx.x >= C;
    const int col = threadIdx.x - species * C;
    if (col < nc) {
      float* q = s_qr + species * rows + col * P;
      const float* cn = s_cr + species * rows + col * P;
      const float* dp = s_delp + col * P;
      float flux = 0.0f;
      for (int k = 0; k < K; ++k) {
        const float m = (q[k] * dp[k] + flux) / (1.0f + cn[k]);
        flux = m * cn[k];
        q[k] = m / dp[k];
      }
      s_flux[species * C + col] = flux;
    }
  }
  __syncthreads();

  // C: 6. rain evaporation, point by point, and the stores
  for_tile_elements<kMpThreads>(nc * K, K, [&](int e, int col, int k) {
    const long long i = base + e;
    const int o = col * P + k;
    float t = s_t[o], qv = s_qv[o], qr = s_qr[o];
    const float p = s_p[o], rho = s_rho[o];
    const float qs1 = qsat_liquid(t, p, th);
    const float gam_l = 1.0f + lv_cp * dqsat_dt(t, p, th);
    const float subsat = fmaxf(qs1 - qv, 0.0f);
    const float vent = 1.0f - expf(
        c.v[C_REVP] * powf(fmaxf(rho * qr, 0.0f), 0.525f));
    const float evap = fminf(qr, subsat / gam_l * vent);
    qr = qr - evap;
    qv = qv + evap;
    t = t - lv_cp * evap;

    t_out[i] = t;
    qv_out[i] = qv;
    qr_out[i] = qr;
    qi_out[i] = s_qi[o];
  });
  if (threadIdx.x < nc) {
    precip[col0 + threadIdx.x] =
        (s_flux[threadIdx.x] + s_flux[C + threadIdx.x]) * rcp(c.v[C_GRAV]);
  }
}

}  // namespace

// t, qv, ql, qr, qi, p, delp and the five field outputs: [ncol, K];
// precip: [ncol]; consts: host array of n_consts floats in ConstId order.
// Returns the CUDA error of the launch, 0 when it launched.
extern "C" int gfdl_microphysics_f32(
    long long ncol, int K, const void* t, const void* qv, const void* ql,
    const void* qr, const void* qi, const void* p, const void* delp,
    const void* consts, int n_consts, void* t_out, void* qv_out,
    void* ql_out, void* qr_out, void* qi_out, void* precip, int device,
    void* stream) {
  const int rc = prepare(ncol, K, device);
  if (rc != 0) return rc;
  if (n_consts != C_COUNT) return (int)cudaErrorInvalidValue;
  if (ncol == 0) return 0;
  int C = kMpTile;
  while (C > 1 && mp_smem(K, C) > kMpSmemTarget) C /= 2;
  const size_t bytes = mp_smem(K, C);
  if (bytes > kMpSmemMax) return (int)cudaErrorInvalidValue;
  const long long blocks = (ncol + C - 1) / C;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gfdl_microphysics_columns, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  MpConst c;
  for (int n = 0; n < C_COUNT; ++n) c.v[n] = cf(consts)[n];
  gfdl_microphysics_columns<<<(unsigned)blocks, kMpThreads, bytes,
                              static_cast<cudaStream_t>(stream)>>>(
      ncol, K, C, cf(t), cf(qv), cf(ql), cf(qr), cf(qi), cf(p), cf(delp), c,
      wf(t_out), wf(qv_out), wf(ql_out), wf(qr_out), wf(qi_out), wf(precip));
  return (int)cudaGetLastError();
}
