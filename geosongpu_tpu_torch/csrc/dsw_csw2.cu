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
// Stages on the caller's stream: (1) hydro_columns (dsw_common.cuh), pkz and
// phi of the half state to scratch, a tile of neighbouring columns per
// block; (2) csw2_winds, a tile of kTJ x kTI interface points per block,
// walking K in chunks of kTK levels.  The column sums are kept in double
// and rounded once, in the order of the plain version's cumsum_k, so kernel
// and plain version agree operation by operation.
//
// What bounds it on this card: its bytes.  8 field-sized arrays must move
// (6 read, 2 written; ~40 MB at c48-L72, 0.54 GB at c192-L72, where no
// field fits the 50 MB L2), and the two scratch fields are written and read
// once more.  The design keeps everything else out of device memory: the
// five chart-resampled fields exist only in shared memory.  Per chunk of
// levels a block stages the raw pt_h, pkz, phi, ke and vort of its tile
// with a two-cell rim, resamples each once per cell of the tile and its
// one-cell rim (the 3-point y resample of three columns, then the x
// resample; the weights sit in registers over all chunks), and forms its
// interface points from those; the rim is re-read by the neighbouring
// blocks, out of L2.  The next chunk's cells are fetched into registers
// while this chunk computes.
#include "dsw_common.cuh"

namespace {

constexpr int kResampled = 5;  // pt_h, pkz, phi, ke, vort

struct CentreFields {
  const float* p[kResampled];
};

// What a block stages per chunk of levels, for its points j0 .. j0+kTJ-1 by
// i0 .. i0+kTI-1: the raw cells from (j0-2, i0-2), from which it resamples
// the cells j0-1 .. j0+kTJ-1 by i0-1 .. i0+kTI-1.
using RawPlan = StagePlan<kTJ + 3, kTI + 3>;
constexpr int kRawI = kTI + 3, kResI = kTI + 1;
constexpr int kResCount = (kTJ + 1) * (kTI + 1) * kTK;
constexpr int kResPer = (kResCount + kTileThreads - 1) / kTileThreads;

__global__ void __launch_bounds__(kTileThreads)
csw2_winds(Metrics m, int F, int Ny, int Nx, int K,
           const float* __restrict__ uc, const float* __restrict__ vc,
           CentreFields in, float dt2, float cp_air, float* __restrict__ uct,
           float* __restrict__ vct) {
  __shared__ float raw[kResampled][RawPlan::kCount];
  __shared__ float res[kResampled][kResCount];
  const int f = blockIdx.z, j0 = blockIdx.y * kTJ, i0 = blockIdx.x * kTI;
  const int tid = threadIdx.x, kl = tid % kTK;

  RawPlan plan;
  plan.init(Ny, Nx, K, f, j0 - 2, i0 - 2);

  // _resample_to_chart of the thread's tile cells (jj, ii) = raw cells
  // (jj + 1, ii + 1): the y-strip 3-point resample of the west, own and
  // east column (weights jwm, jwp), then the x-strip resample of those
  // (iwm, iwp).  Each staged cell stands for the clamped cell, whose weights
  // it takes, as the plain version's edge-replicating shifts do.
  int rs[kResPer];  // raw cell (jj, ii), lane kl; -1 past the tile
  float jwm[kResPer][3], jwp[kResPer][3], iwm[kResPer], iwp[kResPer];
#pragma unroll
  for (int r = 0; r < kResPer; ++r) {
    const int e = tid + r * kTileThreads;
    const int cell = e / kTK, jj = cell / kResI, ii = cell % kResI;
    rs[r] = e < kResCount ? tile_at(kRawI, jj, ii, kl) : -1;
    const int cj = clampi(j0 - 1 + jj, 0, Ny - 1);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int gi = clampi(i0 - 2 + ii + d, 0, Nx - 1);
      jwm[r][d] = met32(m, JWM, f, cj, gi);
      jwp[r][d] = met32(m, JWP, f, cj, gi);
    }
    const int ci = clampi(i0 - 1 + ii, 0, Nx - 1);
    iwm[r] = met32(m, IWM, f, cj, ci);
    iwp[r] = met32(m, IWP, f, cj, ci);
  }

  // the thread's point (j, i): x-interface and y-interface
  const int ti = (tid / kTK) % kTI, tj = tid / (kTK * kTI);
  const int j = j0 + tj, i = i0 + ti;
  const bool on_x = j < Ny && i <= Nx, on_y = i < Nx && j <= Ny;
  const bool in_x = on_x && i > 0 && i < Nx, in_y = on_y && j > 0 && j < Ny;
  const int ox = on_x ? cell_off(Ny, Nx + 1, K, f, j, i) : -1;
  const int oy = on_y ? cell_off(Ny + 1, Nx, K, f, j, i) : -1;
  const float rdx = in_x ? met32(m, RDXC_C, f, j, i) : 0.0f;
  const float rdy = in_y ? met32(m, RDYC_C, f, j, i) : 0.0f;
  // uc (j, i) and vc (j, i), level 0, for the transverse averages
  const float* u0 =
      uc + cell_off(Ny, Nx + 1, K, f, min(j, Ny - 1), min(i, Nx));
  const float* v0 =
      vc + cell_off(Ny + 1, Nx, K, f, min(j, Ny), min(i, Nx - 1));
  const int xrow = (Nx + 1) * K, yrow = Nx * K;
  // cell (j, i) and its west and south neighbours in the resampled tile
  const int o = tile_at(kResI, tj + 1, ti + 1, kl);
  const int ow = tile_at(kResI, tj + 1, ti, kl);
  const int os = tile_at(kResI, tj, ti + 1, kl);
  const float* pt = res[0];
  const float* pkz = res[1];
  const float* phi = res[2];
  const float* ke = res[3];
  const float* vort = res[4];

  // Registers for the next chunk's cells, fetched while this one computes.
  float next[kResampled][RawPlan::kPer];
#pragma unroll
  for (int n = 0; n < kResampled; ++n)
    plan.fetch(next[n], in.p[n], min(kl, K - 1));
  for (int k0 = 0; k0 < K; k0 += kTK) {
    // raw was last read before the barrier that ended the resampling of
    // the previous chunk, res before the one below
#pragma unroll
    for (int n = 0; n < kResampled; ++n) plan.commit(raw[n], next[n]);
    __syncthreads();
    if (k0 + kTK < K) {
#pragma unroll
      for (int n = 0; n < kResampled; ++n)
        plan.fetch(next[n], in.p[n], min(k0 + kTK + kl, K - 1));
    }
#pragma unroll
    for (int r = 0; r < kResPer; ++r) {
      if (rs[r] < 0) continue;
#pragma unroll
      for (int n = 0; n < kResampled; ++n) {
        const float* c0 = raw[n] + rs[r];
        float y[3];  // chart_y of the west, own and east column
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float c = c0[tile_at(kRawI, 1, d, 0)];
          y[d] = c + (jwm[r][d] * (c0[tile_at(kRawI, 0, d, 0)] - c) +
                      jwp[r][d] * (c0[tile_at(kRawI, 2, d, 0)] - c));
        }
        res[n][tid + r * kTileThreads] =
            y[1] + (iwm[r] * (y[0] - y[1]) + iwp[r] * (y[2] - y[1]));
      }
    }
    __syncthreads();

    const int k = k0 + kl;
    if (k >= K) continue;  // the last chunk: no barrier follows
    if (on_x) {  // x-interface (j, i) between cells i-1 and i
      float out = uc[ox + k];
      if (in_x) {
        const float ptx = 0.5f * (pt[ow] + pt[o]);
        const float gx =
            ((phi[o] - phi[ow]) + cp_air * ptx * (pkz[o] - pkz[ow])) * rdx;
        const float kex = (ke[o] - ke[ow]) * rdx;
        const float vortx = 0.5f * (vort[ow] + vort[o]);
        const float* v = v0 + k;
        const float vcx = 0.25f * (v[-K] + v[0] + v[yrow - K] + v[yrow]);
        out = out + dt2 * (vortx * vcx - kex - gx);
      }
      uct[ox + k] = out;
    }
    if (on_y) {  // y-interface (j, i) between cells j-1 and j
      float out = vc[oy + k];
      if (in_y) {
        const float pty = 0.5f * (pt[os] + pt[o]);
        const float gy =
            ((phi[o] - phi[os]) + cp_air * pty * (pkz[o] - pkz[os])) * rdy;
        const float key = (ke[o] - ke[os]) * rdy;
        const float vorty = 0.5f * (vort[os] + vort[o]);
        const float* u = u0 + k;
        const float ucy = 0.25f * (u[-xrow] + u[K - xrow] + u[0] + u[K]);
        out = out + dt2 * (-vorty * ucy - key - gy);
      }
      vct[oy + k] = out;
    }
  }
}

}  // namespace

// uc [F, Ny, Nx+1, K], vc [F, Ny+1, Nx, K]; delp_h, pt_h, ke and the
// chart-corrected vort [F, Ny, Nx, K].  Scratch: pkz, phi [F, Ny, Nx, K].
// Outputs uct [F, Ny, Nx+1, K], vct [F, Ny+1, Nx, K].  Returns the CUDA
// error of the first failed launch, 0 when all launched.
extern "C" int dsw_csw2_f32(const void* metrics, int F, int Ny, int Nx, int K,
                            const void* uc, const void* vc,
                            const void* delp_h, const void* pt_h,
                            const void* ke, const void* vort, float ptop,
                            float p00, float kappa, float cp_air, float dt2,
                            void* pkz, void* phi, void* uct, void* vct,
                            int device, void* stream) {
  const int rc = check_grid(F, Ny, Nx, K);
  if (rc != 0) return rc;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Metrics& m = *static_cast<const Metrics*>(metrics);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  err = launch_hydro(m, F, Ny, Nx, K, cf(delp_h), cf(pt_h), ptop, p00, kappa,
                     cp_air, static_cast<float*>(pkz),
                     static_cast<float*>(phi), s);
  if (err != cudaSuccess) return (int)err;
  const CentreFields in = {{cf(pt_h), cf(pkz), cf(phi), cf(ke), cf(vort)}};
  csw2_winds<<<tile_grid(F, Ny + 1, Nx + 1), kTileThreads, 0, s>>>(
      m, F, Ny, Nx, K, cf(uc), cf(vc), in, dt2, cp_air,
      static_cast<float*>(uct), static_cast<float*>(vct));
  return (int)cudaGetLastError();
}
