// C-grid half step, part 2, for Hopper (sm_90a).
//
// Replaces the TPU kernel `dsw_csw2`, k2 of
// geosongpu_tpu/dycore/sw_pallas.py::d_sw_substep_pallas (:510-532), whose
// compiled form folds the column integral of the half state into the kernel
// (_hydro_fields_kernel, :65) ahead of dycore/sw.py::c_sw_part2.  It
// computes geosongpu_tpu_torch/ops/kernels/dsw.py::dsw_csw2_plain: pkz and
// phi of the half state (+ phis), the 3-point chart resample of pt, pkz,
// phi, ke and vort, and the time-centred winds uct/vct from the half-step
// PGF, the KE gradient and vorticity x transverse wind.  The first and last
// interface of each line keep uc/vc, as c_sw_part2 leaves them.
//
// Stages on the caller's stream: (1) hydro_columns, one thread per column
// walking K (dsw_common.cuh); (2) csw2_resample, the five chart-resampled
// centre fields to scratch; (3) csw2_winds over [F, Ny+1, Nx+1, K].  The
// column sums are sequential (in double) while the plain version takes
// torch.cumsum, so the two differ by f32 rounding of pe and phi; that moves
// uct/vct by up to ~1e-3 m/s through the PGF, and the check against the
// plain version carries a wind floor for it.
//
// What bounds it on this card: at c48-L72 about 16 field-sized arrays move
// (~80 MB, 24 us at 3.35 TB/s); the column stage runs one thread per column
// (17,496 threads), with two transcendentals per interface, and its strided
// K walk uses each 32-byte sector over several iterations.  A later design
// gives the column stage one warp per column with a warp scan, and fuses
// the resample into the wind stage through a shared-memory tile.
#include "dsw_common.cuh"

namespace {

constexpr int kResampled = 5;  // pt_h, pkz, phi, ke, vort

struct Resample {
  const float* in[kResampled];
  float* out[kResampled];
};

__global__ void __launch_bounds__(kThreads)
csw2_resample(Metrics m, int F, int Ny, int Nx, int K, Resample r) {
  int f, j, i, k;
  if (!decode(F, Ny, Nx, K, f, j, i, k)) return;
  const long long o = off(Ny, Nx, K, f, j, i, k);
  for (int n = 0; n < kResampled; ++n) {
    const Arr a = {r.in[n], Ny, Nx, K};
    r.out[n][o] = chart_resample(a, m, f, j, i, k);
  }
}

// c: the resampled pt_h, pkz, phi, ke, vort, in that order.
__global__ void __launch_bounds__(kThreads)
csw2_winds(Metrics m, int F, int Ny, int Nx, int K,
           const float* __restrict__ uc_p, const float* __restrict__ vc_p,
           Resample c, float dt2, float cp_air, float* __restrict__ uct,
           float* __restrict__ vct) {
  int f, j, i, k;
  if (!decode(F, Ny + 1, Nx + 1, K, f, j, i, k)) return;
  const Arr uc = {uc_p, Ny, Nx + 1, K}, vc = {vc_p, Ny + 1, Nx, K};
  const Arr pt = {c.out[0], Ny, Nx, K}, pkz = {c.out[1], Ny, Nx, K};
  const Arr phi = {c.out[2], Ny, Nx, K}, ke = {c.out[3], Ny, Nx, K};
  const Arr vort = {c.out[4], Ny, Nx, K};
  if (j < Ny) {  // x-interface (j, i) between cells i-1 and i
    float out = uc(f, j, i, k);
    if (i > 0 && i < Nx) {
      const int l = i - 1;
      const float rd = met(m, RDXC_C, f, j, i);
      const float ptx = 0.5f * (pt(f, j, l, k) + pt(f, j, i, k));
      const float gx = ((phi(f, j, i, k) - phi(f, j, l, k)) +
                        cp_air * ptx * (pkz(f, j, i, k) - pkz(f, j, l, k))) *
                       rd;
      const float kex = (ke(f, j, i, k) - ke(f, j, l, k)) * rd;
      const float vortx = 0.5f * (vort(f, j, l, k) + vort(f, j, i, k));
      const float vcx = 0.25f * (vc(f, j, l, k) + vc(f, j, i, k) +
                                 vc(f, j + 1, l, k) + vc(f, j + 1, i, k));
      out = out + dt2 * (vortx * vcx - kex - gx);
    }
    uct[off(Ny, Nx + 1, K, f, j, i, k)] = out;
  }
  if (i < Nx) {  // y-interface (j, i) between cells j-1 and j
    float out = vc(f, j, i, k);
    if (j > 0 && j < Ny) {
      const int b = j - 1;
      const float rd = met(m, RDYC_C, f, j, i);
      const float pty = 0.5f * (pt(f, b, i, k) + pt(f, j, i, k));
      const float gy = ((phi(f, j, i, k) - phi(f, b, i, k)) +
                        cp_air * pty * (pkz(f, j, i, k) - pkz(f, b, i, k))) *
                       rd;
      const float key = (ke(f, j, i, k) - ke(f, b, i, k)) * rd;
      const float vorty = 0.5f * (vort(f, b, i, k) + vort(f, j, i, k));
      const float ucy = 0.25f * (uc(f, b, i, k) + uc(f, b, i + 1, k) +
                                 uc(f, j, i, k) + uc(f, j, i + 1, k));
      out = out + dt2 * (-vorty * ucy - key - gy);
    }
    vct[off(Ny + 1, Nx, K, f, j, i, k)] = out;
  }
}

}  // namespace

// uc [F, Ny, Nx+1, K], vc [F, Ny+1, Nx, K]; delp_h, pt_h, ke and the
// chart-corrected vort [F, Ny, Nx, K].  Scratch: 7 arrays [F, Ny, Nx, K]
// back to back (pkz, phi, then the resampled pt_h, pkz, phi, ke, vort).
// Outputs uct [F, Ny, Nx+1, K], vct [F, Ny+1, Nx, K].  Returns the CUDA
// error of the first failed launch, 0 when all launched.
extern "C" int dsw_csw2_f32(const void* metrics, int F, int Ny, int Nx, int K,
                            const void* uc, const void* vc,
                            const void* delp_h, const void* pt_h,
                            const void* ke, const void* vort, float ptop,
                            float p00, float kappa, float cp_air, float dt2,
                            void* scratch, void* uct, void* vct, int device,
                            void* stream) {
  const int rc = check_grid(F, Ny, Nx, K);
  if (rc != 0) return rc;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Metrics& m = *static_cast<const Metrics*>(metrics);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = (long long)F * Ny * Nx * K;
  float* w = static_cast<float*>(scratch);
  float* pkz = w;
  float* phi = w + cells;
  err = launch_hydro(m, F, Ny, Nx, K, static_cast<const float*>(delp_h),
                     static_cast<const float*>(pt_h), ptop, p00, kappa,
                     cp_air, pkz, phi, s);
  if (err != cudaSuccess) return (int)err;
  Resample r = {};
  r.in[0] = static_cast<const float*>(pt_h);
  r.in[1] = pkz;
  r.in[2] = phi;
  r.in[3] = static_cast<const float*>(ke);
  r.in[4] = static_cast<const float*>(vort);
  for (int n = 0; n < kResampled; ++n) r.out[n] = w + (2 + n) * cells;
  csw2_resample<<<blocks_for(cells), kThreads, 0, s>>>(m, F, Ny, Nx, K, r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  csw2_winds<<<blocks_for((long long)F * (Ny + 1) * (Nx + 1) * K), kThreads,
               0, s>>>(m, F, Ny, Nx, K, static_cast<const float*>(uc),
                       static_cast<const float*>(vc), r, dt2, cp_air,
                       static_cast<float*>(uct), static_cast<float*>(vct));
  return (int)cudaGetLastError();
}
