// One tracer of one acoustic substep, for Hopper (sm_90a).
//
// Replaces the TPU kernel `dsw_tracer`, k3b of
// geosongpu_tpu/dycore/sw_pallas.py::d_sw_substep_pallas (:586-603), the
// per-substep tracer transport of z_tracer=False.  It computes exactly
// geosongpu_tpu_torch/ops/kernels/dsw.py::dsw_tracer_plain: fvtp2d of q with
// the Courant numbers and area fluxes rebuilt from the substep's uct/vct,
// its outer fluxes weighted by the substep's mass fluxes (so q == const
// stays constant to rounding), and the flux-form update divided by the
// delp the transport kernel produced.  The fvtp2d stages are
// dsw_transport's (dsw_common.cuh) with one field, as in dsw_tracer_acc;
// the difference to that kernel is the divisor, which is passed in here
// and advanced from the accumulated mass fluxes there.
//
// What bounds it on this card: each of the 8 inputs is read and the one
// output written once, 9 field-sized arrays (45 MB at c48-L72, 13 us at
// 3.35 TB/s); the stages move about 11 with their scratch, for about 800
// flops per cell.  As in dsw_transport the recomputed PPM edges and their
// neighbour reads make it bound by instruction issue and load latency.  A
// later design handles all tracers of a substep in one launch and shares
// dsw_transport's staged tiles.
#include "dsw_common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
tracer_sub_update(Metrics m, int F, int Ny, int Nx, int K,
                  const float* __restrict__ qx,
                  const float* __restrict__ pd_x,
                  const float* __restrict__ delp_new,
                  const float* __restrict__ fx, const float* __restrict__ fy,
                  float* __restrict__ q_new) {
  int f, j, i, k;
  if (!decode(F, Ny, Nx, K, f, j, i, k)) return;
  const long long o = off(Ny, Nx, K, f, j, i, k);
  const long long x0 = off(Ny, Nx + 1, K, f, j, i, k), x1 = x0 + K;
  const long long y0 = off(Ny + 1, Nx, K, f, j, i, k);
  const long long y1 = off(Ny + 1, Nx, K, f, j + 1, i, k);
  const float rarea = met(m, RAREA, f, j, i);
  const float qdp = qx[o] * pd_x[o] +
                    ((fx[x0] - fx[x1]) + (fy[y0] - fy[y1])) * rarea;
  q_new[o] = qdp / delp_new[o];
}

}  // namespace

// qx/qy/pd_x/delp_new: [F, Ny, Nx, K] (qx and qy may be the same array);
// uct, mfx [F, Ny, Nx+1, K]; vct, mfy [F, Ny+1, Nx, K].  Scratch: q_i, q_j
// [F, Ny, Nx, K], fx [F, Ny, Nx+1, K], fy [F, Ny+1, Nx, K].  Output q_new
// [F, Ny, Nx, K].  Returns the CUDA error of the first failed launch, 0
// when all launched.
extern "C" int dsw_tracer_f32(
    const void* metrics, int F, int Ny, int Nx, int K, const void* qx,
    const void* qy, const void* pd_x, const void* delp_new, const void* uct,
    const void* vct, const void* mfx, const void* mfy, float dt, int hord,
    void* q_i, void* q_j, void* fx, void* fy, void* q_new, int device,
    void* stream) {
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
  fv.q_i[0] = wf(q_i);
  fv.q_j[0] = wf(q_j);
  fv.fx[0] = wf(fx);
  fv.fy[0] = wf(fy);
  err = launch_fvtp2d(m, F, Ny, Nx, K, fv, cf(uct), cf(vct), cf(mfx),
                      cf(mfy), dt, hord, s);
  if (err != cudaSuccess) return (int)err;
  tracer_sub_update<<<blocks_for((long long)F * Ny * Nx * K), kThreads, 0,
                      s>>>(m, F, Ny, Nx, K, cf(qx), cf(pd_x), cf(delp_new),
                           wf(fx), wf(fy), wf(q_new));
  return (int)cudaGetLastError();
}
