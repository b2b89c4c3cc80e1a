// PPM transport of delp and pt (and, nonhydrostatic, w and delz) for one
// acoustic substep, for Hopper (sm_90a).
//
// Replaces the TPU kernel `dsw_transport`, k3 of
// geosongpu_tpu/dycore/sw_pallas.py::d_sw_substep_pallas (:553-581), whose
// body is dycore/sw.py::transport_part.  It computes exactly
// geosongpu_tpu_torch/ops/kernels/dsw.py::dsw_transport_plain: Courant
// numbers and area fluxes rebuilt from uct/vct, two fvtp2d passes (delp,
// then pt weighted by the mass flux) with the inner cross-updates, and the
// flux-divergence updates of delp and pt.  Every output is the whole padded
// array, edges included: the padded mass fluxes feed the accumulated-flux
// tracer transport.  In nonhydrostatic mode (the NH branch of k3,
// sw_pallas.py:554-579) w is transported like pt, its outer fluxes weighted
// by the mass flux and the update multiplied by 1/delp_new, and delz like
// delp, with the area fluxes and no mass flux, clamped at 1 m.
//
// Stages, launched back to back on the caller's stream: (1) fv_inner, the
// inner updates q_i/q_j of both fields; (2) fv_flux, the outer fluxes at
// every interface; (3) transport_update, per cell.  Intermediates go to
// scratch arrays the wrapper allocates.  The nonhydrostatic fields take a
// second pass through the same stages, (4) fv_inner and (5) fv_flux for
// (w, delz), then (6) nh_transport_update, rather than a 4-field loop:
// fv_inner holds 168 registers with two fields, and the pass reuses the
// first pass's scratch.
//
// What bounds it on this card: at c48-L72 (6 x 54 x 54 x 72 cells, 5.0 MB
// per field) the stages read and write about 17 field-sized arrays, ~90 MB,
// 27 us at 3.35 TB/s, for about 1,500 flops per cell (four PPM edges
// recomputed per interface value, each stage recomputing its neighbours'),
// 1.5 GFLOP, 22 us at 67 TFLOP/s f32.  The neighbour reads hit L1/L2, so the
// kernel is bound by instruction issue and load latency rather than by
// HBM.  A later design stages a (tile + 3-row halo) block of each field in
// shared memory (the substep's reach, sw_pallas.py:103-108) and computes
// each PPM edge once per cell instead of once per use.
#include "dsw_common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
transport_update(Metrics m, int F, int Ny, int Nx, int K,
                 const float* __restrict__ pd_x,
                 const float* __restrict__ pt_x,
                 const float* __restrict__ mfx, const float* __restrict__ mfy,
                 const float* __restrict__ tfx, const float* __restrict__ tfy,
                 float* __restrict__ delp_new, float* __restrict__ pt_new) {
  int f, j, i, k;
  if (!decode(F, Ny, Nx, K, f, j, i, k)) return;
  const long long o = off(Ny, Nx, K, f, j, i, k);
  const long long x0 = off(Ny, Nx + 1, K, f, j, i, k), x1 = x0 + K;
  const long long y0 = off(Ny + 1, Nx, K, f, j, i, k);
  const long long y1 = off(Ny + 1, Nx, K, f, j + 1, i, k);
  const float rarea = met(m, RAREA, f, j, i);
  const float d = pd_x[o] + ((mfx[x0] - mfx[x1]) + (mfy[y0] - mfy[y1])) * rarea;
  delp_new[o] = d;
  const float rd = 1.0f / d;
  pt_new[o] = (pt_x[o] * pd_x[o] +
               ((tfx[x0] - tfx[x1]) + (tfy[y0] - tfy[y1])) * rarea) * rd;
}

__global__ void __launch_bounds__(kThreads)
nh_transport_update(Metrics m, int F, int Ny, int Nx, int K,
                    const float* __restrict__ pd_x,
                    const float* __restrict__ pw_x,
                    const float* __restrict__ pz_x,
                    const float* __restrict__ delp_new,
                    const float* __restrict__ wfx,
                    const float* __restrict__ wfy,
                    const float* __restrict__ zfx,
                    const float* __restrict__ zfy, float* __restrict__ w_adv,
                    float* __restrict__ delz_adv) {
  int f, j, i, k;
  if (!decode(F, Ny, Nx, K, f, j, i, k)) return;
  const long long o = off(Ny, Nx, K, f, j, i, k);
  const long long x0 = off(Ny, Nx + 1, K, f, j, i, k), x1 = x0 + K;
  const long long y0 = off(Ny + 1, Nx, K, f, j, i, k);
  const long long y1 = off(Ny + 1, Nx, K, f, j + 1, i, k);
  const float rarea = met(m, RAREA, f, j, i);
  const float rd = 1.0f / delp_new[o];
  w_adv[o] = (pw_x[o] * pd_x[o] +
              ((wfx[x0] - wfx[x1]) + (wfy[y0] - wfy[y1])) * rarea) * rd;
  delz_adv[o] = fmaxf(
      pz_x[o] + ((zfx[x0] - zfx[x1]) + (zfy[y0] - zfy[y1])) * rarea, 1.0f);
}

}  // namespace

// pd_x/pd_y/pt_x/pt_y: [F, Ny, Nx, K] (the x- and y-order fills may be the
// same array: they are only read); uct [F, Ny, Nx+1, K], vct
// [F, Ny+1, Nx, K].  Scratch: q_i_d, q_j_d, q_i_t, q_j_t [F, Ny, Nx, K],
// tfx [F, Ny, Nx+1, K], tfy [F, Ny+1, Nx, K].  Outputs delp_new, pt_new
// [F, Ny, Nx, K], mfx [F, Ny, Nx+1, K], mfy [F, Ny+1, Nx, K].
// Nonhydrostatic (pz_x not null): pw_x/pw_y/pz_x/pz_y [F, Ny, Nx, K],
// scratch zfx [F, Ny, Nx+1, K] and zfy [F, Ny+1, Nx, K], outputs w_adv and
// delz_adv [F, Ny, Nx, K]; all eight are null otherwise.  Returns the CUDA
// error of the first failed launch, 0 when all launched.
extern "C" int dsw_transport_f32(
    const void* metrics, int F, int Ny, int Nx, int K, const void* pd_x,
    const void* pd_y, const void* pt_x, const void* pt_y, const void* uct,
    const void* vct, float dt, int hord, void* q_i_d, void* q_j_d,
    void* q_i_t, void* q_j_t, void* tfx, void* tfy, void* delp_new,
    void* pt_new, void* mfx, void* mfy, const void* pw_x, const void* pw_y,
    const void* pz_x, const void* pz_y, void* zfx, void* zfy, void* w_adv,
    void* delz_adv, int device, void* stream) {
  if (hord != 6 && hord != 8) return (int)cudaErrorInvalidValue;
  const int rc = check_grid(F, Ny, Nx, K);
  if (rc != 0) return rc;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Metrics& m = *static_cast<const Metrics*>(metrics);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const auto wf = [](void* p) { return static_cast<float*>(p); };
  FvFields fv = {};
  fv.nf = 2;
  fv.qx[0] = cf(pd_x);
  fv.qy[0] = cf(pd_y);
  fv.qx[1] = cf(pt_x);
  fv.qy[1] = cf(pt_y);
  fv.q_i[0] = wf(q_i_d);
  fv.q_j[0] = wf(q_j_d);
  fv.q_i[1] = wf(q_i_t);
  fv.q_j[1] = wf(q_j_t);
  fv.fx[0] = wf(mfx);
  fv.fy[0] = wf(mfy);
  fv.fx[1] = wf(tfx);
  fv.fy[1] = wf(tfy);
  err = launch_fvtp2d(m, F, Ny, Nx, K, fv, cf(uct), cf(vct), nullptr,
                      nullptr, dt, hord, s);
  if (err != cudaSuccess) return (int)err;
  transport_update<<<blocks_for((long long)F * Ny * Nx * K), kThreads, 0,
                     s>>>(m, F, Ny, Nx, K, cf(pd_x), cf(pt_x), wf(mfx),
                          wf(mfy), wf(tfx), wf(tfy), wf(delp_new),
                          wf(pt_new));
  err = cudaGetLastError();
  if (err != cudaSuccess || pz_x == nullptr) return (int)err;

  // nonhydrostatic pass: (w, delz) through the same stages; w's fluxes go
  // to tfx/tfy, which transport_update has consumed
  FvFields nh = fv;
  nh.second_area = 1;
  nh.qx[0] = cf(pw_x);
  nh.qy[0] = cf(pw_y);
  nh.qx[1] = cf(pz_x);
  nh.qy[1] = cf(pz_y);
  nh.fx[0] = wf(tfx);
  nh.fy[0] = wf(tfy);
  nh.fx[1] = wf(zfx);
  nh.fy[1] = wf(zfy);
  err = launch_fvtp2d(m, F, Ny, Nx, K, nh, cf(uct), cf(vct), cf(mfx), cf(mfy),
                      dt, hord, s);
  if (err != cudaSuccess) return (int)err;
  nh_transport_update<<<blocks_for((long long)F * Ny * Nx * K), kThreads, 0,
                        s>>>(m, F, Ny, Nx, K, cf(pd_x), cf(pw_x), cf(pz_x),
                             wf(delp_new), wf(tfx), wf(tfy), wf(zfx), wf(zfy),
                             wf(w_adv), wf(delz_adv));
  return (int)cudaGetLastError();
}
