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
// Design: one thread per column and one walk down K.  Everything but the
// two sedimentation fluxes is pointwise, and a layer's sedimentation needs
// only the flux that leaves the layer above, so the whole chain runs level
// by level with the two fluxes carried in registers: each input is read
// once and each output written once, with no scratch array.  The TPU
// kernel's 256-column panes, its padding of the column count and its
// recurrence unrolled over K have no counterpart: the last block is
// masked and K is a run-time loop.
//
// What bounds it on this card: 7 inputs and 5 outputs of [ncol, K] (21 MB
// at 13,824 x 32, 6 us at 3.35 TB/s) against about 13 expf, 4 powf and 25
// divisions per point, which stay below the byte time at every size the
// models use.  What holds it back: neighbouring threads read addresses K
// floats apart, so a warp's load touches 32 lines instead of one, and
// 13,824 columns are 108 blocks of 128 threads, less than one per SM.  A
// tile of columns staged through shared memory is later work.
//
// fminf/fmaxf drop a NaN where PyTorch's minimum/clamp would pass it on;
// on finite inputs they agree.  exp(0.66 max(-tc, 0)) overflows to inf in
// very cold layers and 1 - exp(-inf) absorbs it, as in the plain version.
#include "column_common.cuh"

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

__global__ void __launch_bounds__(kColThreads)
gfdl_microphysics_columns(
    long long ncol, int K, const float* __restrict__ t_in,
    const float* __restrict__ qv_in, const float* __restrict__ ql_in,
    const float* __restrict__ qr_in, const float* __restrict__ qi_in,
    const float* __restrict__ p_in, const float* __restrict__ delp_in,
    MpConst c, float* __restrict__ t_out, float* __restrict__ qv_out,
    float* __restrict__ ql_out, float* __restrict__ qr_out,
    float* __restrict__ qi_out, float* __restrict__ precip) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= ncol) return;
  const Thermo th = {c.v[C_T_ICE], c.v[C_EPS], c.v[C_ONE_M_EPS], c.v[C_HLV],
                     c.v[C_RVGAS]};
  const float lv_cp = c.v[C_LV_CP], lf_cp = c.v[C_LF_CP];
  const float ls_cp = c.v[C_LS_CP], dt = c.v[C_DT];
  const long long base = col * K;
  float rain_flux = 0.0f, ice_flux = 0.0f;
  for (int k = 0; k < K; ++k) {
    const long long i = base + k;
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

    // 5. sedimentation, implicit upstream: the flux leaving the layer
    // above enters this one
    const float rdz = fmaxf(dz, 1.0f);
    const float vt_r = clampf(
        36.34f * powf(fmaxf(rho * qr, 0.0f), 0.2f)
            * sqrtf(rcp(rho) * c.v[C_RHO0]),
        0.0f, c.v[C_VT_RAIN_MAX]);
    const float cr = vt_r * dt / rdz;
    const float qr_m = (qr * delp + rain_flux) / (1.0f + cr);
    rain_flux = qr_m * cr;
    qr = qr_m / delp;
    const float vt_i = clampf(3.29f * powf(fmaxf(rho * qi, 0.0f), 0.16f),
                              0.0f, c.v[C_VT_ICE_MAX]);
    const float ci = vt_i * dt / rdz;
    const float qi_m = (qi * delp + ice_flux) / (1.0f + ci);
    ice_flux = qi_m * ci;
    qi = qi_m / delp;

    // 6. rain evaporation
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
    ql_out[i] = ql;
    qr_out[i] = qr;
    qi_out[i] = qi;
  }
  precip[col] = (rain_flux + ice_flux) * rcp(c.v[C_GRAV]);
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
  MpConst c;
  for (int n = 0; n < C_COUNT; ++n) c.v[n] = cf(consts)[n];
  gfdl_microphysics_columns<<<col_blocks(ncol), kColThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      ncol, K, cf(t), cf(qv), cf(ql), cf(qr), cf(qi), cf(p), cf(delp), c,
      wf(t_out), wf(qv_out), wf(ql_out), wf(qr_out), wf(qi_out), wf(precip));
  return (int)cudaGetLastError();
}
