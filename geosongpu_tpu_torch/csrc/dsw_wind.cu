// D-grid wind update of one hydrostatic acoustic substep, for Hopper (sm_90a).
//
// Replaces the TPU kernel `dsw_wind`, k4 of
// geosongpu_tpu/dycore/sw_pallas.py::d_sw_substep_pallas (:641-702), whose
// compiled form folds the column integral of the refilled state into the
// kernel (_hydro_fields_kernel, :65) ahead of dycore/sw.py::wind_part.  It
// computes geosongpu_tpu_torch/ops/kernels/dsw.py::dsw_wind_plain: pkz and
// phi (+ phis) of the refilled delp/pt, their dw-weighted centre->corner
// interpolation with pt's, the corner kinetic energy from uct/vct, the
// PPM-upwinded vorticity flux (hord_mt), the exchange-form divergence
// damping from div_c, the optional rotational damping (vtx_damp) and the
// backward PGF.  Rows 0 and Ny of u and columns 0 and Nx of v keep pu/pv,
// as wind_part leaves them.  The blend damping form (div_c computed in the
// kernel, used above npx 96) is not here: the wrapper refuses it.
//
// Stages on the caller's stream: (1) hydro_columns (dsw_common.cuh), pkz
// and phi to scratch; (2) wind_update over [F, Ny+1, Nx+1, K], which
// recomputes each corner value it needs.  As in dsw_csw2 the sequential
// column sums differ from the plain version's torch.cumsum by f32
// rounding, which reaches the winds through the PGF.
//
// What bounds it on this card: at c48-L72 about 12 field-sized arrays move
// (~60 MB, 18 us at 3.35 TB/s); each u or v point recomputes two corner
// values of four fields (16 centre reads) and two PPM edges of vort, so it
// is bound by instruction issue and load latency.  A later design computes
// the corner fields once per corner in a shared-memory tile.
#include "dsw_common.cuh"

namespace {

struct WindIn {
  const float* pu;    // [F, Ny+1, Nx, K]
  const float* pv;    // [F, Ny, Nx+1, K]
  const float* uct;   // [F, Ny, Nx+1, K]
  const float* vct;   // [F, Ny+1, Nx, K]
  const float* pt;    // refilled pt [F, Ny, Nx, K]
  const float* pkz;   // column stage output
  const float* phi;
  const float* vort;  // absolute vorticity [F, Ny, Nx, K]
  const float* div_c; // [F, Ny+1, Nx+1, K]
};

// Corner kinetic energy at corner (jc, ic) from the edge-padded centred
// C-grid winds.
__device__ __forceinline__ float ke_corner(const Arr& uct, const Arr& vct,
                                           const Metrics& m, int f, int jc,
                                           int ic, int k, int Ny, int Nx) {
  const int jj = clampi(jc - 1, 0, Ny - 2);
  const int ii = clampi(ic - 1, 0, Nx - 2);
  const float ub = 0.5f * (uct(f, jj, ic, k) + uct(f, jj + 1, ic, k));
  const float vb = 0.5f * (vct(f, jc, ii, k) + vct(f, jc, ii + 1, k));
  return 0.5f * met(m, RSIN2_CN, f, jc, ic) *
         (ub * ub + vb * vb + 2.0f * met(m, COSA_CN, f, jc, ic) * ub * vb);
}

__global__ void __launch_bounds__(kThreads)
wind_update(Metrics m, int F, int Ny, int Nx, int K, WindIn in, float dt,
            int hord_mt, float d2dt, float vtxdt, int use_vtx, float cp_air,
            float* __restrict__ u_new, float* __restrict__ v_new) {
  int f, j, i, k;
  if (!decode(F, Ny + 1, Nx + 1, K, f, j, i, k)) return;
  const Arr uct = {in.uct, Ny, Nx + 1, K}, vct = {in.vct, Ny + 1, Nx, K};
  const Arr pt = {in.pt, Ny, Nx, K}, pkz = {in.pkz, Ny, Nx, K};
  const Arr phi = {in.phi, Ny, Nx, K}, vort = {in.vort, Ny, Nx, K};
  const Arr div = {in.div_c, Ny + 1, Nx + 1, K};

  if (i < Nx) {  // u at (j, i), between corners (j, i) and (j, i+1)
    const long long o = off(Ny + 1, Nx, K, f, j, i, k);
    float out = in.pu[o];
    if (j > 0 && j < Ny) {
      const float cry = vct(f, j, i, k) * dt * met(m, RDYC, f, j, i);
      const float vort_u = ppm_flux(line_y(vort, f, i, k), j, cry, hord_mt);
      const float rdx = met(m, RDX, f, j, i);
      const float dke = (ke_corner(uct, vct, m, f, j, i + 1, k, Ny, Nx) -
                         ke_corner(uct, vct, m, f, j, i, k, Ny, Nx)) * rdx;
      const float pt0 = corner_w(pt, m, f, j, i, k);
      const float pt1 = corner_w(pt, m, f, j, i + 1, k);
      const float pt_u = 0.5f * (pt1 + pt0);
      const float pgf = ((corner_w(phi, m, f, j, i + 1, k) -
                          corner_w(phi, m, f, j, i, k)) +
                         cp_air * pt_u * (corner_w(pkz, m, f, j, i + 1, k) -
                                          corner_w(pkz, m, f, j, i, k))) *
                        rdx;
      const float ddiv = d2dt * met(m, DX, f, j, i) *
                         (div(f, j, i + 1, k) - div(f, j, i, k));
      float acc = vort_u * vct(f, j, i, k) - dke - pgf + ddiv;
      if (use_vtx) {
        const float z1 = vort(f, j, i, k) - met(m, FCOR, f, j, i);
        const float z0 = vort(f, j - 1, i, k) - met(m, FCOR, f, j - 1, i);
        acc = acc - vtxdt * met(m, DYC, f, j, i) * (z1 - z0);
      }
      out = out + dt * acc;
    }
    u_new[o] = out;
  }
  if (j < Ny) {  // v at (j, i), between corners (j, i) and (j+1, i)
    const long long o = off(Ny, Nx + 1, K, f, j, i, k);
    float out = in.pv[o];
    if (i > 0 && i < Nx) {
      const float crx = uct(f, j, i, k) * dt * met(m, RDXC, f, j, i);
      const float vort_v = ppm_flux(line_x(vort, f, j, k), i, crx, hord_mt);
      const float rdy = met(m, RDY, f, j, i);
      const float dke = (ke_corner(uct, vct, m, f, j + 1, i, k, Ny, Nx) -
                         ke_corner(uct, vct, m, f, j, i, k, Ny, Nx)) * rdy;
      const float pt0 = corner_w(pt, m, f, j, i, k);
      const float pt1 = corner_w(pt, m, f, j + 1, i, k);
      const float pt_v = 0.5f * (pt1 + pt0);
      const float pgf = ((corner_w(phi, m, f, j + 1, i, k) -
                          corner_w(phi, m, f, j, i, k)) +
                         cp_air * pt_v * (corner_w(pkz, m, f, j + 1, i, k) -
                                          corner_w(pkz, m, f, j, i, k))) *
                        rdy;
      const float ddiv = d2dt * met(m, DY, f, j, i) *
                         (div(f, j + 1, i, k) - div(f, j, i, k));
      float acc = -vort_v * uct(f, j, i, k) - dke - pgf + ddiv;
      if (use_vtx) {
        const float z1 = vort(f, j, i, k) - met(m, FCOR, f, j, i);
        const float z0 = vort(f, j, i - 1, k) - met(m, FCOR, f, j, i - 1);
        acc = acc + vtxdt * met(m, DXC, f, j, i) * (z1 - z0);
      }
      out = out + dt * acc;
    }
    v_new[o] = out;
  }
}

}  // namespace

// pu [F, Ny+1, Nx, K], pv [F, Ny, Nx+1, K], uct [F, Ny, Nx+1, K], vct
// [F, Ny+1, Nx, K]; delp_f, pt_f (the refilled post-transport state) and
// vort [F, Ny, Nx, K]; div_c [F, Ny+1, Nx+1, K].  d2dt = d2_bg / dt and
// vtxdt = vtx_damp / dt, as the plain version rounds them; use_vtx is
// vtx_damp > 0.  Scratch: pkz, phi [F, Ny, Nx, K].  Outputs u
// [F, Ny+1, Nx, K], v [F, Ny, Nx+1, K].  Returns the CUDA error of the
// first failed launch, 0 when all launched.
extern "C" int dsw_wind_f32(const void* metrics, int F, int Ny, int Nx, int K,
                            const void* pu, const void* pv, const void* uct,
                            const void* vct, const void* delp_f,
                            const void* pt_f, const void* vort,
                            const void* div_c, float ptop, float p00,
                            float kappa, float cp_air, float dt, int hord_mt,
                            float d2dt, float vtxdt, int use_vtx, void* pkz,
                            void* phi, void* u_new, void* v_new, int device,
                            void* stream) {
  if (hord_mt != 6 && hord_mt != 8) return (int)cudaErrorInvalidValue;
  const int rc = check_grid(F, Ny, Nx, K);
  if (rc != 0) return rc;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Metrics& m = *static_cast<const Metrics*>(metrics);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  float* pkz_w = static_cast<float*>(pkz);
  float* phi_w = static_cast<float*>(phi);
  err = launch_hydro(m, F, Ny, Nx, K, cf(delp_f), cf(pt_f), ptop, p00,
                     kappa, cp_air, pkz_w, phi_w, s);
  if (err != cudaSuccess) return (int)err;
  const WindIn in = {cf(pu), cf(pv), cf(uct), cf(vct), cf(pt_f),
                     pkz_w, phi_w, cf(vort), cf(div_c)};
  wind_update<<<blocks_for((long long)F * (Ny + 1) * (Nx + 1) * K), kThreads,
                0, s>>>(m, F, Ny, Nx, K, in, dt, hord_mt, d2dt, vtxdt,
                        use_vtx, cp_air, static_cast<float*>(u_new),
                        static_cast<float*>(v_new));
  return (int)cudaGetLastError();
}
