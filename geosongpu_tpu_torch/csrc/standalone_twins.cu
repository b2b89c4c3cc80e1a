// Second sources of the Buoyancy and EvapSublPdfLoop column kernels, for
// Hopper (sm_90a).
//
// They replace the TPU kernels `buoyancy_pallas` and `evap_subl_pdf_pallas`
// (geosongpu_tpu/ops/pallas/standalone_twins.py:85 and :133, bodies
// _buoy_kernel :75 and _evap_kernel :96, through _call :53, pallas_call
// :59).  Like them they are re-derivations, not copies, of the primaries
// in physics/standalone.py, and compute what
// geosongpu_tpu_torch/ops/kernels/standalone_twins.py's plain versions
// compute, in their order:
//   * buoyancy by the density ratio at equal pressure,
//     B = g (T_p (1 + fac q_p) / (T_e (1 + fac q_e)) - 1), fac = Rv/Rd - 1
//     (the primary: g (Tv_p - Tv_e) / Tv_e).  num/den - 1 is ~2e-3, so one
//     ulp of the ratio is ~3e-5 of B: the division is IEEE and nothing is
//     contracted;
//   * evaporation/sublimation with its own saturation pressures and
//     constants (the wrapper's, L_s among them), the clear fraction as the
//     integral of the triangular RH PDF, 0.5 + (1 - rh) / (2 w), and the
//     limiters in the twin's order: subsaturation first, then the
//     available condensate.
//
// Design: one thread per point over the flat [ncol * K] index, the last
// block masked (no 256-column panes, no padding).  What bounds them on
// this card: bytes, 4 + 1 and 5 + 4 arrays of [ncol, K] (buoyancy does not
// read p), 8.8 and 15.9 MB at 13,824 x 32, 2.6 and 4.8 us at 3.35 TB/s; at
// that size each call is one launch and its time is the launch.
#include "column_common.cuh"

namespace {

__global__ void __launch_bounds__(kColThreads)
buoyancy_points(long long n, const float* __restrict__ t,
                const float* __restrict__ qv, const float* __restrict__ tp,
                const float* __restrict__ qp, float fac, float grav,
                float* __restrict__ b) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float num = tp[i] * (1.0f + fac * qp[i]);
  const float den = t[i] * (1.0f + fac * qv[i]);
  b[i] = grav * (num / den - 1.0f);
}

struct EvapConst {
  Thermo th;      // t_ice, eps, 1 - eps of the twin; hlv and rvgas unused
  float two_w;    // 2 pdf_width
  float f;        // 1 - exp(-dt / 900)
  float lv, ls, cp;
};

__global__ void __launch_bounds__(kColThreads)
evap_subl_pdf_points(long long n, const float* __restrict__ t_in,
                     const float* __restrict__ qv_in,
                     const float* __restrict__ ql_in,
                     const float* __restrict__ qi_in,
                     const float* __restrict__ p_in, EvapConst c,
                     float* __restrict__ t_out, float* __restrict__ qv_out,
                     float* __restrict__ ql_out, float* __restrict__ qi_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float t = t_in[i], qv = qv_in[i], ql = ql_in[i], qi = qi_in[i];
  const float p = p_in[i];
  const float qs_l = qsat_liquid(t, p, c.th);
  const float qs_i = qsat_ice(t, p, c.th);
  const float rh = qv / fmaxf(qs_l, 1.0e-12f);
  const float clear = fminf(fmaxf(0.5f + (1.0f - rh) * rcp(c.two_w), 0.0f),
                            1.0f);
  float evap = fminf(fmaxf(qs_l - qv, 0.0f), ql * clear * c.f);
  evap = fminf(evap, ql);
  float subl = fminf(fmaxf(qs_i - qv, 0.0f), qi * clear * c.f);
  subl = fminf(subl, qi);
  qv_out[i] = qv + evap + subl;
  ql_out[i] = ql - evap;
  qi_out[i] = qi - subl;
  t_out[i] = t - (c.lv * evap + c.ls * subl) * rcp(c.cp);
}

}  // namespace

// Every array [ncol, K].  Each entry returns the CUDA error of its launch,
// 0 when it launched.
extern "C" int buoyancy_f32(long long ncol, int K, const void* t,
                            const void* qv, const void* t_parcel,
                            const void* qv_parcel, float fac, float grav,
                            void* b, int device, void* stream) {
  const int rc = prepare(ncol, K, device);
  if (rc != 0 || ncol == 0) return rc;
  const long long n = ncol * K;
  buoyancy_points<<<col_blocks(n), kColThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      n, cf(t), cf(qv), cf(t_parcel), cf(qv_parcel), fac, grav, wf(b));
  return (int)cudaGetLastError();
}

// consts: t0, eps, 1 - eps, 2 pdf_width, 1 - exp(-dt / 900), L_v, L_s, c_p.
extern "C" int evap_subl_pdf_f32(long long ncol, int K, const void* t,
                                 const void* qv, const void* ql,
                                 const void* qi, const void* p,
                                 const void* consts, int n_consts,
                                 void* t_out, void* qv_out, void* ql_out,
                                 void* qi_out, int device, void* stream) {
  const int rc = prepare(ncol, K, device);
  if (rc != 0) return rc;
  if (n_consts != 8) return (int)cudaErrorInvalidValue;
  if (ncol == 0) return 0;
  const float* v = cf(consts);
  const EvapConst c = {{v[0], v[1], v[2], 0.0f, 0.0f}, v[3], v[4], v[5], v[6],
                       v[7]};
  const long long n = ncol * K;
  evap_subl_pdf_points<<<col_blocks(n), kColThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      n, cf(t), cf(qv), cf(ql), cf(qi), cf(p), c, wf(t_out), wf(qv_out),
      wf(ql_out), wf(qi_out));
  return (int)cudaGetLastError();
}
