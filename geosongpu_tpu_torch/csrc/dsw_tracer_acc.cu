// One z_tracer subcycle of one tracer, for Hopper (sm_90a).
//
// Replaces the TPU kernel `dsw_tracer_acc`
// (geosongpu_tpu/dycore/sw_pallas.py:377 tracer_interval_advect_pallas,
// face call :415-419; body :399-410).  It computes exactly
// geosongpu_tpu_torch/ops/kernels/dsw.py::dsw_tracer_acc_plain: delp
// advanced by the interval's accumulated mass fluxes, and fvtp2d of q with
// the Courant numbers and area fluxes rebuilt from the accumulated winds,
// its outer fluxes weighted by the accumulated mass fluxes, so q == const
// stays exactly constant.  Stages: (1) fvtp2d_tile, dsw_transport's fvtp2d
// stage (dsw_common.cuh) with one field instead of two, the fluxes to
// scratch; (2) tracer_update per cell.
//
// What bounds it on this card: its bytes.  At c48-L72 the 7 inputs and 2
// outputs are 9 field-sized arrays (~45 MB, 13 us at 3.35 TB/s), the
// stages move about 13 with the scratch fluxes, for about 170 operations
// per cell.  The tile computes each PPM edge once per cell and keeps the
// inner updates in shared memory; a later design handles all tracers of a
// subcycle in one launch.
#include "dsw_common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
tracer_update(Metrics m, int F, int Ny, int Nx, int K,
              const float* __restrict__ qx, const float* __restrict__ pd_x,
              const float* __restrict__ mfx, const float* __restrict__ mfy,
              const float* __restrict__ fx, const float* __restrict__ fy,
              float* __restrict__ delp_new, float* __restrict__ q_new) {
  int f, j, i, k;
  if (!decode(F, Ny, Nx, K, f, j, i, k)) return;
  const long long o = off(Ny, Nx, K, f, j, i, k);
  const long long x0 = off(Ny, Nx + 1, K, f, j, i, k), x1 = x0 + K;
  const long long y0 = off(Ny + 1, Nx, K, f, j, i, k);
  const long long y1 = off(Ny + 1, Nx, K, f, j + 1, i, k);
  const float rarea = met(m, RAREA, f, j, i);
  const float d = pd_x[o] + ((mfx[x0] - mfx[x1]) + (mfy[y0] - mfy[y1])) * rarea;
  delp_new[o] = d;
  const float qdp = qx[o] * pd_x[o] +
                    ((fx[x0] - fx[x1]) + (fy[y0] - fy[y1])) * rarea;
  q_new[o] = qdp / d;
}

}  // namespace

// qx/qy/pd_x: [F, Ny, Nx, K] (qx and qy may be the same array); uacc, mfx
// [F, Ny, Nx+1, K]; vacc, mfy [F, Ny+1, Nx, K].  Scratch: fx
// [F, Ny, Nx+1, K], fy [F, Ny+1, Nx, K].  Outputs delp_new, q_new
// [F, Ny, Nx, K].  Returns the CUDA error of the first failed launch, 0
// when all launched.
extern "C" int dsw_tracer_acc_f32(
    const void* metrics, int F, int Ny, int Nx, int K, const void* qx,
    const void* qy, const void* pd_x, const void* uacc, const void* vacc,
    const void* mfx, const void* mfy, float dt, int hord, void* fx, void* fy,
    void* delp_new, void* q_new, int device, void* stream) {
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
  fv.nf = 1;
  fv.qx[0] = cf(qx);
  fv.qy[0] = cf(qy);
  fv.fx[0] = wf(fx);
  fv.fy[0] = wf(fy);
  err = launch_fvtp2d(m, F, Ny, Nx, K, fv, cf(uacc), cf(vacc), cf(mfx),
                      cf(mfy), dt, hord, s);
  if (err != cudaSuccess) return (int)err;
  tracer_update<<<blocks_for((long long)F * Ny * Nx * K), kThreads, 0, s>>>(
      m, F, Ny, Nx, K, cf(qx), cf(pd_x), cf(mfx), cf(mfy), wf(fx), wf(fy),
      wf(delp_new), wf(q_new));
  return (int)cudaGetLastError();
}
