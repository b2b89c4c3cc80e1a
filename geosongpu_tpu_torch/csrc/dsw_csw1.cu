// C-grid half step, part 1, for Hopper (sm_90a).
//
// Replaces the TPU kernel `dsw_csw1`, k1 of
// geosongpu_tpu/dycore/sw_pallas.py::d_sw_substep_pallas (:482-493), whose
// body is dycore/sw.py::c_sw_part1.  It computes exactly
// geosongpu_tpu_torch/ops/kernels/dsw.py::dsw_csw1_plain: the C-grid normal
// winds uc/vc projected through cosa/rsina from the A-grid winds, the
// half-step upwind update of delp and pt, the centre kinetic energy and the
// absolute vorticity from the D-grid circulation.
//
// One launch over the corner-sized union [F, Ny+1, Nx+1, K]: a thread
// writes uc where (j, i) is an x-interface, vc where it is a y-interface,
// and the four centre outputs where it is a cell, recomputing the uc/vc of
// the two interfaces on each side that its fluxes need.
//
// What bounds it on this card: at c48-L72 it reads 8 field-sized inputs and
// writes 6 (~70 MB, 21 us at 3.35 TB/s) for ~120 flops per cell; the
// recomputed neighbour winds hit L1, so it should run near the HBM bound.
// A later design fuses it with the A-grid winds and the chart correction
// that now run as PyTorch glue before it.
#include "dsw_common.cuh"

namespace {

__device__ __forceinline__ float to_xiface(const Arr& a, int f, int j, int i,
                                           int k) {
  if (i == 0) return a(f, j, 0, k);
  if (i == a.C) return a(f, j, a.C - 1, k);
  return 0.5f * (a(f, j, i - 1, k) + a(f, j, i, k));
}

__device__ __forceinline__ float to_yiface(const Arr& a, int f, int j, int i,
                                           int k) {
  if (j == 0) return a(f, 0, i, k);
  if (j == a.R) return a(f, a.R - 1, i, k);
  return 0.5f * (a(f, j - 1, i, k) + a(f, j, i, k));
}

// uc at x-interface (j, i) and vc at y-interface (j, i)
__device__ __forceinline__ float uc_at(const Arr& ua, const Arr& va,
                                       const Metrics& m, int f, int j, int i,
                                       int k) {
  return (to_xiface(ua, f, j, i, k) -
          met(m, COSA_I, f, j, i) * to_xiface(va, f, j, i, k)) *
         met(m, RSINA_I, f, j, i);
}

__device__ __forceinline__ float vc_at(const Arr& ua, const Arr& va,
                                       const Metrics& m, int f, int j, int i,
                                       int k) {
  return (to_yiface(va, f, j, i, k) -
          met(m, COSA_J, f, j, i) * to_yiface(ua, f, j, i, k)) *
         met(m, RSINA_J, f, j, i);
}

__global__ void __launch_bounds__(kThreads)
csw1(Metrics m, int F, int Ny, int Nx, int K, const float* __restrict__ pu,
     const float* __restrict__ pv, const float* __restrict__ ua_p,
     const float* __restrict__ va_p, const float* __restrict__ pd_x_p,
     const float* __restrict__ pd_y_p, const float* __restrict__ pt_x_p,
     const float* __restrict__ pt_y_p, float dt2, float* __restrict__ uc,
     float* __restrict__ vc, float* __restrict__ delp_h,
     float* __restrict__ pt_h, float* __restrict__ ke,
     float* __restrict__ vort) {
  int f, j, i, k;
  if (!decode(F, Ny + 1, Nx + 1, K, f, j, i, k)) return;
  const Arr ua = {ua_p, Ny, Nx, K}, va = {va_p, Ny, Nx, K};
  if (j < Ny) uc[off(Ny, Nx + 1, K, f, j, i, k)] = uc_at(ua, va, m, f, j, i, k);
  if (i < Nx) vc[off(Ny + 1, Nx, K, f, j, i, k)] = vc_at(ua, va, m, f, j, i, k);
  if (j >= Ny || i >= Nx) return;

  const Arr pd_x = {pd_x_p, Ny, Nx, K}, pd_y = {pd_y_p, Ny, Nx, K};
  const Arr pt_x = {pt_x_p, Ny, Nx, K}, pt_y = {pt_y_p, Ny, Nx, K};
  const Line dxl = line_x(pd_x, f, j, k), txl = line_x(pt_x, f, j, k);
  const Line dyl = line_y(pd_y, f, i, k), tyl = line_y(pt_y, f, i, k);
  float fxm[2], fxt[2], fym[2], fyt[2];
  for (int s = 0; s < 2; ++s) {
    const int ii = i + s;
    const float u = uc_at(ua, va, m, f, j, ii, k);
    const float crx = u * dt2 * met(m, RDXC, f, j, ii);
    fxm[s] = upwind(dxl, ii, crx) * u * dt2 * met(m, DY, f, j, ii);
    fxt[s] = upwind(txl, ii, crx) * fxm[s];
    const int jj = j + s;
    const float v = vc_at(ua, va, m, f, jj, i, k);
    const float cry = v * dt2 * met(m, RDYC, f, jj, i);
    fym[s] = upwind(dyl, jj, cry) * v * dt2 * met(m, DX, f, jj, i);
    fyt[s] = upwind(tyl, jj, cry) * fym[s];
  }
  const long long o = off(Ny, Nx, K, f, j, i, k);
  const float rarea = met(m, RAREA, f, j, i);
  const float pdx = pd_x(f, j, i, k);
  const float dh = pdx + ((fxm[0] - fxm[1]) + (fym[0] - fym[1])) * rarea;
  delp_h[o] = dh;
  pt_h[o] = (pt_x(f, j, i, k) * pdx +
             ((fxt[0] - fxt[1]) + (fyt[0] - fyt[1])) * rarea) / dh;

  const float a = ua(f, j, i, k), b = va(f, j, i, k);
  ke[o] = 0.5f * met(m, RSIN2_C, f, j, i) *
          (a * a + b * b - 2.0f * met(m, COSA_C, f, j, i) * a * b);

  const Arr PU = {pu, Ny + 1, Nx, K}, PV = {pv, Ny, Nx + 1, K};
  const float circ = PU(f, j, i, k) * met(m, DX, f, j, i) +
                     PV(f, j, i + 1, k) * met(m, DY, f, j, i + 1) -
                     PU(f, j + 1, i, k) * met(m, DX, f, j + 1, i) -
                     PV(f, j, i, k) * met(m, DY, f, j, i);
  vort[o] = circ * rarea + met(m, FCOR, f, j, i);
}

// "area,rarea,...": the metric order the kernels index by (MetricId).
constexpr char kMetricNames[] =
    "area,rarea,dx,dy,dxc,dyc,fcor,rarea_c,cosa_i,rsina_i,cosa_j,rsina_j,"
    "rdx,rdy,rdxc,rdyc,cosa_c,rsin2_c,cosa_cn,rsin2_cn,phis,dw00,dw01,dw10,"
    "dw11,dr11,r12,r21,dr22,jwm,jwp,iwm,iwp,rdxc_c,rdyc_c,div_blend";

}  // namespace

// The metric field names in the order of the Metrics struct, comma-joined;
// the wrapper checks them against PaddedMetrics._fields.
extern "C" const char* dsw_metric_names() { return kMetricNames; }

// pu [F, Ny+1, Nx, K], pv [F, Ny, Nx+1, K]; ua, va and the four fills
// [F, Ny, Nx, K] (x- and y-order fills may alias: they are only read).
// Outputs uc [F, Ny, Nx+1, K], vc [F, Ny+1, Nx, K], delp_h, pt_h, ke, vort
// [F, Ny, Nx, K].  Returns the launch's CUDA error, 0 when launched.
extern "C" int dsw_csw1_f32(const void* metrics, int F, int Ny, int Nx, int K,
                            const void* pu, const void* pv, const void* ua,
                            const void* va, const void* pd_x,
                            const void* pd_y, const void* pt_x,
                            const void* pt_y, float dt2, void* uc, void* vc,
                            void* delp_h, void* pt_h, void* ke, void* vort,
                            int device, void* stream) {
  const int rc = check_grid(F, Ny, Nx, K);
  if (rc != 0) return rc;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Metrics& m = *static_cast<const Metrics*>(metrics);
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const auto wf = [](void* p) { return static_cast<float*>(p); };
  csw1<<<blocks_for((long long)F * (Ny + 1) * (Nx + 1) * K), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
      m, F, Ny, Nx, K, cf(pu), cf(pv), cf(ua), cf(va), cf(pd_x), cf(pd_y),
      cf(pt_x), cf(pt_y), dt2, wf(uc), wf(vc), wf(delp_h), wf(pt_h), wf(ke),
      wf(vort));
  return (int)cudaGetLastError();
}
