// D-grid wind update of one acoustic substep, for Hopper (sm_90a).
//
// Replaces the TPU kernel `dsw_wind`, k4 of
// geosongpu_tpu/dycore/sw_pallas.py::d_sw_substep_pallas (:641-702), whose
// compiled form folds the column integral of the refilled state into the
// kernel (_hydro_fields_kernel, :65) ahead of dycore/sw.py::wind_part.  It
// computes geosongpu_tpu_torch/ops/kernels/dsw.py::dsw_wind_plain: pkz and
// phi (+ phis) of the refilled delp/pt, their dw-weighted centre->corner
// interpolation with pt's, the corner kinetic energy from uct/vct, the
// PPM-upwinded vorticity flux (hord_mt), the divergence damping, the
// optional rotational damping (vtx_damp) and the backward PGF.  Rows 0 and
// Ny of u and columns 0 and Nx of v keep pu/pv, as wind_part leaves them.
//
// The damping divergence is either passed in (the exchange form, computed
// by the glue) or, in the blend form the model takes above npx 96
// (dycore/sw.py wind_part, div_c_in=None), computed here by the
// blend_divergence stage: the corner-dual contour of pu/pv, edge-replicated
// from the core corners, replaced by the dw-weighted centre-to-corner
// interpolation of the cell divergence of uct/vct where div_blend is set.
// In nonhydrostatic mode the PGF takes three more corner-interpolated
// fields, the p', phi' and rho of dsw_nh_pert.cu (the NH branch of k4,
// sw_pallas.py:658-670).
//
// Stages on the caller's stream: (1) hydro_columns (dsw_common.cuh), pkz
// and phi to scratch, a tile of neighbouring columns per block; (2)
// blend_divergence over [F, Ny+1, Nx+1, K] to scratch, in the blend form
// only, one thread per corner and level; (3) wind_update, a tile of kTJ x
// kTI points per block, walking K in chunks of kTK levels.  The column sums
// are kept in double as the plain version's are, so kernel and plain
// version agree operation by operation.
//
// What bounds it on this card: its bytes.  At c48-L72 about 12 field-sized
// arrays move (~60 MB, 18 us at 3.35 TB/s; 15 with the nonhydrostatic
// fields), at c192-L72 0.63 GB.  What kept the first design (one thread
// per point, everything from device memory) far from that was not bytes
// but instructions and exposed load latency: every u and v point
// interpolated its two corners of every field itself, so each corner value
// was computed about four times from 4 centre and 5 metric reads, and read
// 12 cells of vort for its two PPM fluxes.  Here a block stages what its
// points need per chunk of levels in shared memory - the centre values of
// pt, pkz, phi (and rho, phi', p') with a one-cell rim, uct, vct, div_c,
// and vort with the three-cell rim of the PPM lines - computes the
// dw-weighted corner value of each field and the corner kinetic energy
// once per corner of the tile (the corner weights staged once per block),
// and forms its u and v points from shared memory alone.  The next chunk's
// values are fetched into registers while this chunk computes, so no phase
// waits on device memory.  Each corner value is the same expression in the
// same order wherever it is used, so the bits do not depend on the tile.
// blend_divergence keeps the first design; folding it into the tile needs
// pu, pv, uct and vct with a second rim.
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
  const float* pp;    // nonhydrostatic p', phi', rho [F, Ny, Nx, K], or
  const float* php;   // null
  const float* rho;
};

// Cell divergence of the time-centred C-grid winds at centre (j, i):
// -(ddx(uct dy) + ddy(vct dx)) rarea.
__device__ __forceinline__ float div_cell(const Arr& uct, const Arr& vct,
                                          const Metrics& m, int f, int j,
                                          int i, int k) {
  const float dx_ = uct(f, j, i, k) * met(m, DY, f, j, i) -
                    uct(f, j, i + 1, k) * met(m, DY, f, j, i + 1);
  const float dy_ = vct(f, j, i, k) * met(m, DX, f, j, i) -
                    vct(f, j + 1, i, k) * met(m, DX, f, j + 1, i);
  return -(dx_ + dy_) * met(m, RAREA, f, j, i);
}

// Dual-edge normal flux of the D-grid u at u-point (j, i): the transverse
// wind is the 4-point mean of pv, edge-replicated in j.
__device__ __forceinline__ float dual_uf(const Arr& pu, const Arr& pv,
                                         const Metrics& m, int f, int j,
                                         int i, int k, int Ny) {
  const int ja = clampi(j, 1, Ny - 1);
  const float vm0 = 0.5f * (pv(f, ja - 1, i, k) + pv(f, ja - 1, i + 1, k));
  const float vm1 = 0.5f * (pv(f, ja, i, k) + pv(f, ja, i + 1, k));
  const float vu = 0.5f * (vm0 + vm1);
  return (pu(f, j, i, k) - met(m, COSA_J, f, j, i) * vu) *
         met(m, RSINA_J, f, j, i) * met(m, DYC, f, j, i);
}

// ... of the D-grid v at v-point (j, i).
__device__ __forceinline__ float dual_vf(const Arr& pu, const Arr& pv,
                                         const Metrics& m, int f, int j,
                                         int i, int k, int Nx) {
  const int ia = clampi(i, 1, Nx - 1);
  const float um0 = 0.5f * (pu(f, j, ia - 1, k) + pu(f, j + 1, ia - 1, k));
  const float um1 = 0.5f * (pu(f, j, ia, k) + pu(f, j + 1, ia, k));
  const float uv = 0.5f * (um0 + um1);
  return (pv(f, j, i, k) - met(m, COSA_I, f, j, i) * uv) *
         met(m, RSINA_I, f, j, i) * met(m, DXC, f, j, i);
}

// The blend damping divergence at every corner.
__global__ void __launch_bounds__(kThreads)
blend_divergence(Metrics m, int F, int Ny, int Nx, int K,
                 const float* __restrict__ pu_, const float* __restrict__ pv_,
                 const float* __restrict__ uct_,
                 const float* __restrict__ vct_, float* __restrict__ div_c) {
  int f, jc, ic, k;
  if (!decode(F, Ny + 1, Nx + 1, K, f, jc, ic, k)) return;
  const Arr pu = {pu_, Ny + 1, Nx, K}, pv = {pv_, Ny, Nx + 1, K};
  const Arr uct = {uct_, Ny, Nx + 1, K}, vct = {vct_, Ny + 1, Nx, K};
  float out;
  if (met(m, DIV_BLEND, f, jc, ic) > 0.5f) {
    const int j0 = clampi(jc - 1, 0, Ny - 1), j1 = clampi(jc, 0, Ny - 1);
    const int i0 = clampi(ic - 1, 0, Nx - 1), i1 = clampi(ic, 0, Nx - 1);
    out = corner_w4(div_cell(uct, vct, m, f, j0, i0, k),
                    div_cell(uct, vct, m, f, j0, i1, k),
                    div_cell(uct, vct, m, f, j1, i0, k),
                    div_cell(uct, vct, m, f, j1, i1, k),
                    met(m, DW00, f, jc, ic), met(m, DW01, f, jc, ic),
                    met(m, DW10, f, jc, ic), met(m, DW11, f, jc, ic));
  } else {
    const int j = clampi(jc, 1, Ny - 1), i = clampi(ic, 1, Nx - 1);
    const float du = dual_uf(pu, pv, m, f, j, i, k, Ny) -
                     dual_uf(pu, pv, m, f, j, i - 1, k, Ny);
    const float dv = dual_vf(pu, pv, m, f, j, i, k, Nx) -
                     dual_vf(pu, pv, m, f, j - 1, i, k, Nx);
    out = (du + dv) * met(m, RAREA_C, f, j, i);
  }
  div_c[off(Ny + 1, Nx + 1, K, f, jc, ic, k)] = out;
}

// What a block stages per chunk of levels, for its points j0 .. j0+kTJ-1 by
// i0 .. i0+kTI-1 and their corners j0 .. j0+kTJ by i0 .. i0+kTI:
using CentPlan = StagePlan<kTJ + 2, kTI + 2>;  // centres from (j0-1, i0-1)
using UctPlan = StagePlan<kTJ + 3, kTI + 1>;   // uct from (j0-2, i0)
using VctPlan = StagePlan<kTJ + 1, kTI + 3>;   // vct from (j0, i0-2)
using CornPlan = StagePlan<kTJ + 1, kTI + 1>;  // div_c from (j0, i0)
using VortPlan = StagePlan<kTJ + 5, kTI + 5>;  // vort from (j0-3, i0-3)
constexpr int kCentI = kTI + 2, kUctI = kTI + 1, kVctI = kTI + 3;
constexpr int kCornI = kTI + 1, kVortI = kTI + 5;
constexpr int kCorners = (kTJ + 1) * (kTI + 1);
enum CornerMetric {
  kDw00, kDw01, kDw10, kDw11, kRsin2, kCosa, kCornerMetrics
};

// NF corner-interpolated fields: pt, pkz, phi, and in nonhydrostatic mode
// rho, phi', p'.
template <int NF>
struct WindTiles {
  float cent[NF][CentPlan::kCount];
  float corn[NF + 1][CornPlan::kCount];  // the NF fields, then ke
  float uct[UctPlan::kCount];
  float vct[VctPlan::kCount];
  float div[CornPlan::kCount];
  float vort[VortPlan::kCount];
  float cmet[kCornerMetrics][kCorners];
};

template <int NF>
__global__ void __launch_bounds__(kTileThreads)
wind_update(Metrics m, int F, int Ny, int Nx, int K, WindIn in, float dt,
            int hord_mt, float d2dt, float vtxdt, int use_vtx, float cp_air,
            float* __restrict__ u_new, float* __restrict__ v_new) {
  extern __shared__ float wind_tiles[];
  WindTiles<NF>& t = *reinterpret_cast<WindTiles<NF>*>(wind_tiles);
  const int f = blockIdx.z, j0 = blockIdx.y * kTJ, i0 = blockIdx.x * kTI;
  const int tid = threadIdx.x, kl = tid % kTK;
  const float* fields[6] = {in.pt, in.pkz, in.phi, in.rho, in.php, in.pp};

  CentPlan cent_plan;
  UctPlan uct_plan;
  VctPlan vct_plan;
  CornPlan div_plan;
  VortPlan vort_plan;
  cent_plan.init(Ny, Nx, K, f, j0 - 1, i0 - 1);
  uct_plan.init(Ny, Nx + 1, K, f, j0 - 2, i0);
  vct_plan.init(Ny + 1, Nx, K, f, j0, i0 - 2);
  div_plan.init(Ny + 1, Nx + 1, K, f, j0, i0);
  vort_plan.init(Ny, Nx, K, f, j0 - 3, i0 - 3);
  stage_metric<kTJ + 1, kTI + 1>(t.cmet[kDw00], m, DW00, f, j0, i0);
  stage_metric<kTJ + 1, kTI + 1>(t.cmet[kDw01], m, DW01, f, j0, i0);
  stage_metric<kTJ + 1, kTI + 1>(t.cmet[kDw10], m, DW10, f, j0, i0);
  stage_metric<kTJ + 1, kTI + 1>(t.cmet[kDw11], m, DW11, f, j0, i0);
  stage_metric<kTJ + 1, kTI + 1>(t.cmet[kRsin2], m, RSIN2_CN, f, j0, i0);
  stage_metric<kTJ + 1, kTI + 1>(t.cmet[kCosa], m, COSA_CN, f, j0, i0);

  // Corner (cj, ci) of the tile: _center_to_corner_w of each field from the
  // staged cells (cj, ci) .. (cj + 1, ci + 1), and the corner kinetic
  // energy from the staged uct, vct.  A corner past the face takes the
  // clamped corner's weights and winds; no written point uses it.
  int cc[CornPlan::kPer];  // the thread's corner; -1 past the tile
  int cs[CornPlan::kPer];  // staged cell (cj, ci), lane kl
  int su[CornPlan::kPer];  // staged uct (jj, ic), below it (jj + 1, ic)
  int sv[CornPlan::kPer];  // staged vct (jc, ii), beside it (jc, ii + 1)
#pragma unroll
  for (int r = 0; r < CornPlan::kPer; ++r) {
    const int e = tid + r * kTileThreads;
    const int cell = e / kTK, cj = cell / kCornI, ci = cell % kCornI;
    cc[r] = e < CornPlan::kCount ? cell : -1;
    cs[r] = tile_at(kCentI, cj, ci, kl);
    const int jc = min(j0 + cj, Ny), ic = min(i0 + ci, Nx);
    su[r] = tile_at(kUctI, clampi(jc - 1, 0, Ny - 2) - (j0 - 2), ic - i0, kl);
    sv[r] = tile_at(kVctI, jc - j0, clampi(ic - 1, 0, Nx - 2) - (i0 - 2), kl);
  }

  // the thread's point (j, i): u between corners (j, i) and (j, i+1), v
  // between corners (j, i) and (j+1, i)
  const int ti = (tid / kTK) % kTI, tj = tid / (kTK * kTI);
  const int j = j0 + tj, i = i0 + ti;
  const bool on_u = i < Nx && j <= Ny, on_v = j < Ny && i <= Nx;
  const bool in_u = on_u && j > 0 && j < Ny, in_v = on_v && i > 0 && i < Nx;
  const int ou = on_u ? cell_off(Ny + 1, Nx, K, f, j, i) : -1;
  const int ov = on_v ? cell_off(Ny, Nx + 1, K, f, j, i) : -1;
  float rdyc = 0.0f, rdx = 0.0f, dx = 0.0f, vtx_u = 0.0f, fc_u = 0.0f;
  if (in_u) {
    rdyc = met32(m, RDYC, f, j, i);
    rdx = met32(m, RDX, f, j, i);
    dx = met32(m, DX, f, j, i);
    if (use_vtx) {
      vtx_u = vtxdt * met32(m, DYC, f, j, i);
      fc_u = met32(m, FCOR, f, j - 1, i);
    }
  }
  float rdxc = 0.0f, rdy = 0.0f, dy = 0.0f, vtx_v = 0.0f, fc_v = 0.0f;
  if (in_v) {
    rdxc = met32(m, RDXC, f, j, i);
    rdy = met32(m, RDY, f, j, i);
    dy = met32(m, DY, f, j, i);
    if (use_vtx) {
      vtx_v = vtxdt * met32(m, DXC, f, j, i);
      fc_v = met32(m, FCOR, f, j, i - 1);
    }
  }
  const float fc = use_vtx && (in_u || in_v) ? met32(m, FCOR, f, j, i) : 0.0f;
  // corner (j, i) and its east and south neighbours in the corner tiles
  const int o = tile_at(kCornI, tj, ti, kl);
  const int oe = tile_at(kCornI, tj, ti + 1, kl);
  const int os = tile_at(kCornI, tj + 1, ti, kl);
  const float* pt_c = t.corn[0];
  const float* pkz_c = t.corn[1];
  const float* phi_c = t.corn[2];
  const float* rho_c = t.corn[NF > 3 ? 3 : 0];
  const float* php_c = t.corn[NF > 3 ? 4 : 0];
  const float* pp_c = t.corn[NF > 3 ? 5 : 0];
  const float* ke_c = t.corn[NF];
  // vort (j, i) in its tile, the lines through it, vct and uct at (j, i)
  const int ovort = tile_at(kVortI, tj + 3, ti + 3, kl);
  const TileLine vort_y = {t.vort + tile_at(kVortI, 0, ti + 3, kl),
                           kVortI * kTK, j0 - 3, Ny};
  const TileLine vort_x = {t.vort + tile_at(kVortI, tj + 3, 0, kl), kTK,
                           i0 - 3, Nx};
  const int ovct = tile_at(kVctI, tj, ti + 2, kl);
  const int ouct = tile_at(kUctI, tj + 2, ti, kl);

  // Registers for the next chunk's values, fetched while this one computes.
  float n_cent[NF][CentPlan::kPer], n_uct[UctPlan::kPer];
  float n_vct[VctPlan::kPer], n_div[CornPlan::kPer], n_vort[VortPlan::kPer];
  float n_pu = 0.0f, n_pv = 0.0f;
  const auto fetch = [&](int k) {
#pragma unroll
    for (int n = 0; n < NF; ++n) cent_plan.fetch(n_cent[n], fields[n], k);
    uct_plan.fetch(n_uct, in.uct, k);
    vct_plan.fetch(n_vct, in.vct, k);
    div_plan.fetch(n_div, in.div_c, k);
    vort_plan.fetch(n_vort, in.vort, k);
    if (on_u) n_pu = in.pu[ou + k];
    if (on_v) n_pv = in.pv[ov + k];
  };
  fetch(min(kl, K - 1));
  for (int k0 = 0; k0 < K; k0 += kTK) {
#pragma unroll
    for (int n = 0; n < NF; ++n) cent_plan.commit(t.cent[n], n_cent[n]);
    uct_plan.commit(t.uct, n_uct);
    vct_plan.commit(t.vct, n_vct);
    div_plan.commit(t.div, n_div);
    vort_plan.commit(t.vort, n_vort);
    const float pu = n_pu, pv = n_pv;
    __syncthreads();
    if (k0 + kTK < K) fetch(min(k0 + kTK + kl, K - 1));
#pragma unroll
    for (int r = 0; r < CornPlan::kPer; ++r) {
      if (cc[r] < 0) continue;
      const int e = tid + r * kTileThreads;
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        const float* c = t.cent[n] + cs[r];
        t.corn[n][e] = corner_w4(
            c[0], c[kTK], c[kCentI * kTK], c[(kCentI + 1) * kTK],
            t.cmet[kDw00][cc[r]], t.cmet[kDw01][cc[r]], t.cmet[kDw10][cc[r]],
            t.cmet[kDw11][cc[r]]);
      }
      // corner kinetic energy from the edge-padded centred C-grid winds
      const float ub = 0.5f * (t.uct[su[r]] + t.uct[su[r] + kUctI * kTK]);
      const float vb = 0.5f * (t.vct[sv[r]] + t.vct[sv[r] + kTK]);
      t.corn[NF][e] =
          0.5f * t.cmet[kRsin2][cc[r]] *
          (ub * ub + vb * vb + 2.0f * t.cmet[kCosa][cc[r]] * ub * vb);
    }
    __syncthreads();

    const int k = k0 + kl;
    if (k < K) {
      if (on_u) {
        float out = pu;
        if (in_u) {
          const float vc = t.vct[ovct];
          const float cry = vc * dt * rdyc;
          const float vort_u = ppm_flux(vort_y, j, cry, hord_mt);
          const float dke = (ke_c[oe] - ke_c[o]) * rdx;
          const float pt_u = 0.5f * (pt_c[oe] + pt_c[o]);
          float pgf = ((phi_c[oe] - phi_c[o]) +
                       cp_air * pt_u * (pkz_c[oe] - pkz_c[o])) * rdx;
          if (NF > 3) {
            const float rho_u = fmaxf(0.5f * (rho_c[oe] + rho_c[o]), 1.0e-8f);
            pgf = pgf + ((php_c[oe] - php_c[o]) +
                         (pp_c[oe] - pp_c[o]) / rho_u) * rdx;
          }
          const float ddiv = d2dt * dx * (t.div[oe] - t.div[o]);
          float acc = vort_u * vc - dke - pgf + ddiv;
          if (use_vtx) {
            const float z1 = t.vort[ovort] - fc;
            const float z0 = t.vort[ovort - kVortI * kTK] - fc_u;
            acc = acc - vtx_u * (z1 - z0);
          }
          out = out + dt * acc;
        }
        u_new[ou + k] = out;
      }
      if (on_v) {
        float out = pv;
        if (in_v) {
          const float uc = t.uct[ouct];
          const float crx = uc * dt * rdxc;
          const float vort_v = ppm_flux(vort_x, i, crx, hord_mt);
          const float dke = (ke_c[os] - ke_c[o]) * rdy;
          const float pt_v = 0.5f * (pt_c[os] + pt_c[o]);
          float pgf = ((phi_c[os] - phi_c[o]) +
                       cp_air * pt_v * (pkz_c[os] - pkz_c[o])) * rdy;
          if (NF > 3) {
            const float rho_v = fmaxf(0.5f * (rho_c[os] + rho_c[o]), 1.0e-8f);
            pgf = pgf + ((php_c[os] - php_c[o]) +
                         (pp_c[os] - pp_c[o]) / rho_v) * rdy;
          }
          const float ddiv = d2dt * dy * (t.div[os] - t.div[o]);
          float acc = -vort_v * uc - dke - pgf + ddiv;
          if (use_vtx) {
            const float z1 = t.vort[ovort] - fc;
            const float z0 = t.vort[ovort - kTK] - fc_v;
            acc = acc + vtx_v * (z1 - z0);
          }
          out = out + dt * acc;
        }
        v_new[ov + k] = out;
      }
    }
    // the next chunk overwrites tiles that the points above read
    __syncthreads();
  }
}

// wind_update<NF> on stream s; its tiles need more than the 48 KB of shared
// memory a launch gets without opting in when NF is 6.
template <int NF>
cudaError_t launch_wind_update(const Metrics& m, int F, int Ny, int Nx, int K,
                               const WindIn& in, float dt, int hord_mt,
                               float d2dt, float vtxdt, int use_vtx,
                               float cp_air, float* u_new, float* v_new,
                               cudaStream_t s) {
  const size_t bytes = sizeof(WindTiles<NF>);
  cudaError_t err = cudaFuncSetAttribute(
      wind_update<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  wind_update<NF><<<tile_grid(F, Ny + 1, Nx + 1), kTileThreads, bytes, s>>>(
      m, F, Ny, Nx, K, in, dt, hord_mt, d2dt, vtxdt, use_vtx, cp_air, u_new,
      v_new);
  return cudaGetLastError();
}

}  // namespace

// pu [F, Ny+1, Nx, K], pv [F, Ny, Nx+1, K], uct [F, Ny, Nx+1, K], vct
// [F, Ny+1, Nx, K]; delp_f, pt_f (the refilled post-transport state) and
// vort [F, Ny, Nx, K]; div_c [F, Ny+1, Nx+1, K]: the exchange-form damping
// divergence, or with blend != 0 scratch the blend stage fills.  pprime,
// phiprime, rho1 [F, Ny, Nx, K]: the nonhydrostatic fields, all three null
// in hydrostatic mode.  d2dt = d2_bg / dt and vtxdt = vtx_damp / dt, as
// the plain version rounds them; use_vtx is vtx_damp > 0.  Scratch: pkz,
// phi [F, Ny, Nx, K].  Outputs u [F, Ny+1, Nx, K], v [F, Ny, Nx+1, K].
// Returns the CUDA error of the first failed launch, 0 when all launched.
extern "C" int dsw_wind_f32(const void* metrics, int F, int Ny, int Nx, int K,
                            const void* pu, const void* pv, const void* uct,
                            const void* vct, const void* delp_f,
                            const void* pt_f, const void* vort,
                            void* div_c, int blend, const void* pprime,
                            const void* phiprime, const void* rho1,
                            float ptop, float p00,
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
  if (blend) {
    const long long ncorner = (long long)F * (Ny + 1) * (Nx + 1) * K;
    blend_divergence<<<blocks_for(ncorner), kThreads, 0, s>>>(
        m, F, Ny, Nx, K, cf(pu), cf(pv), cf(uct), cf(vct),
        static_cast<float*>(div_c));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const WindIn in = {cf(pu), cf(pv), cf(uct), cf(vct), cf(pt_f),
                     pkz_w, phi_w, cf(vort), cf(div_c), cf(pprime),
                     cf(phiprime), cf(rho1)};
  float* u_w = static_cast<float*>(u_new);
  float* v_w = static_cast<float*>(v_new);
  err = in.pp != nullptr
            ? launch_wind_update<6>(m, F, Ny, Nx, K, in, dt, hord_mt, d2dt,
                                    vtxdt, use_vtx, cp_air, u_w, v_w, s)
            : launch_wind_update<3>(m, F, Ny, Nx, K, in, dt, hord_mt, d2dt,
                                    vtxdt, use_vtx, cp_air, u_w, v_w, s);
  return (int)err;
}
