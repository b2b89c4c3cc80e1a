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
// (dycore/sw.py wind_part, div_c_in=None), formed here at every corner: the
// corner-dual contour of pu/pv, edge-replicated from the core corners,
// replaced by the dw-weighted centre-to-corner interpolation of the cell
// divergence of uct/vct where div_blend is set.  In nonhydrostatic mode the
// PGF takes three more corner-interpolated fields, the p', phi' and rho of
// dsw_nh_pert.cu (the NH branch of k4, sw_pallas.py:658-670).
//
// Stages on the caller's stream: (1) hydro_columns (dsw_common.cuh), pkz
// and phi to scratch, a tile of neighbouring columns per block; (2)
// wind_update<NF, Blend>, a tile of kTJ x kTI points per block, walking K
// in chunks of kTK levels.  The column sums are kept in double as the plain
// version's are, so kernel and plain version agree operation by operation.
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
//
// The blend form (Blend = true) forms the damping divergence in the same
// corner phase instead of reading div_c: it stages pu and pv with a
// one-cell rim, and uct and vct one cell wider across the flow than the
// exchange form does.  A dual corner takes the contour of its four dual
// fluxes from the staged pu/pv; a cell corner interpolates the cell
// divergence of uct/vct, which is formed once per staged cell and chunk
// behind one more barrier, taken only by blocks with a cell corner (the
// band along the face edges and around the cube corners).  The point's own
// pu and pv then come from the staged tiles too.  So no div_c [F, Ny+1,
// Nx+1, K] is written and read back, and no corner's fluxes are read from
// device memory.  The dual corners are dealt so that no thread takes two
// corners of both kinds, as the corner phase, between two barriers, is
// where the blend form adds its time (PERF.md, row 5bd).  The exchange form
// compiles as before: the blend tiles and phases exist only in the Blend
// instances.
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
  const float* div_c; // [F, Ny+1, Nx+1, K]; null in the blend form
  const float* pp;    // nonhydrostatic p', phi', rho [F, Ny, Nx, K], or
  const float* php;   // null
  const float* rho;
};

// What a block stages per chunk of levels, for its points j0 .. j0+kTJ-1 by
// i0 .. i0+kTI-1 and their corners j0 .. j0+kTJ by i0 .. i0+kTI:
using CentPlan = StagePlan<kTJ + 2, kTI + 2>;  // centres from (j0-1, i0-1)
using CornPlan = StagePlan<kTJ + 1, kTI + 1>;  // div_c from (j0, i0)
using VortPlan = StagePlan<kTJ + 5, kTI + 5>;  // vort from (j0-3, i0-3)
// uct from (j0-2, i0-kB) and vct from (j0-kB, i0-2), where kB is 1 in the
// blend form, whose cell divergence reads them one cell further out
template <bool Blend>
struct WindPlans {
  static constexpr int kB = Blend ? 1 : 0;
  static constexpr int kUctI = kTI + 1 + 2 * kB;
  using Uct = StagePlan<kTJ + 3, kUctI>;
  using Vct = StagePlan<kTJ + 1 + 2 * kB, kTI + 3>;
};
// the blend form's pu and pv, both from (j0-1, i0-1)
using PuPlan = StagePlan<kTJ + 3, kTI + 2>;
using PvPlan = StagePlan<kTJ + 2, kTI + 3>;
constexpr int kCentI = kTI + 2, kVctI = kTI + 3;
constexpr int kCornI = kTI + 1, kVortI = kTI + 5;
constexpr int kPuI = kTI + 2, kPvI = kTI + 3;
constexpr int kCorners = (kTJ + 1) * (kTI + 1);
enum CornerMetric {
  kDw00, kDw01, kDw10, kDw11, kRsin2, kCosa, kCornerMetrics
};

// NF corner-interpolated fields: pt, pkz, phi, and in nonhydrostatic mode
// rho, phi', p'.
template <int NF, bool Blend>
struct WindTiles {
  float cent[NF][CentPlan::kCount];
  float corn[NF + 1][CornPlan::kCount];  // the NF fields, then ke
  float uct[WindPlans<Blend>::Uct::kCount];
  float vct[WindPlans<Blend>::Vct::kCount];
  float div[CornPlan::kCount];
  float vort[VortPlan::kCount];
  float cmet[kCornerMetrics][kCorners];
};

// The dual fluxes at u-points (j0 .. j0+kTJ) x (i0-1 .. i0+kTI) and at
// v-points (j0-1 .. j0+kTJ) x (i0 .. i0+kTI) of a block whose corners lie
// in the face.
constexpr int kUfI = kTI + 2, kVfI = kTI + 1;
enum DualMetric { kDualCosa, kDualRsina, kDualDc, kDualMetrics };

// What the blend form stages besides WindTiles: the metrics once per
// block, pu, pv and the cell divergence per chunk.
struct BlendTiles {
  float pu[PuPlan::kCount];
  float pv[PvPlan::kCount];
  float cell[CentPlan::kCount];  // div_cell of the staged cells
  float dy[(kTJ + 3) * (kTI + 3)];  // at the staged uct
  float dx[(kTJ + 3) * (kTI + 3)];  // at the staged vct
  float rarea[(kTJ + 2) * kCentI];  // at the staged cells
  float uf[kDualMetrics][(kTJ + 1) * kUfI];  // cosa_j, rsina_j, dyc
  float vf[kDualMetrics][(kTJ + 2) * kVfI];  // cosa_i, rsina_i, dxc
  float rarea_c[kCorners];  // from (j0, i0)
  float blend[kCorners];    // div_blend at the tile's corners
};

template <int NF, bool Blend>
constexpr size_t wind_tile_bytes() {
  return sizeof(WindTiles<NF, Blend>) + (Blend ? sizeof(BlendTiles) : 0);
}

template <int NF, bool Blend>
__global__ void __launch_bounds__(kTileThreads)
wind_update(Metrics m, int F, int Ny, int Nx, int K, WindIn in, float dt,
            int hord_mt, float d2dt, float vtxdt, int use_vtx, float cp_air,
            float* __restrict__ u_new, float* __restrict__ v_new) {
  using P = WindPlans<Blend>;
  constexpr int kB = P::kB, kUctI = P::kUctI;
  extern __shared__ float wind_tiles[];
  WindTiles<NF, Blend>& t =
      *reinterpret_cast<WindTiles<NF, Blend>*>(wind_tiles);
  BlendTiles& b = *reinterpret_cast<BlendTiles*>(
      wind_tiles + sizeof(WindTiles<NF, Blend>) / sizeof(float));
  const int f = blockIdx.z, j0 = blockIdx.y * kTJ, i0 = blockIdx.x * kTI;
  const int tid = threadIdx.x, kl = tid % kTK;
  const float* fields[6] = {in.pt, in.pkz, in.phi, in.rho, in.php, in.pp};

  CentPlan cent_plan;
  typename P::Uct uct_plan;
  typename P::Vct vct_plan;
  CornPlan div_plan;
  VortPlan vort_plan;
  PuPlan pu_plan;
  PvPlan pv_plan;
  cent_plan.init(Ny, Nx, K, f, j0 - 1, i0 - 1);
  uct_plan.init(Ny, Nx + 1, K, f, j0 - 2, i0 - kB);
  vct_plan.init(Ny + 1, Nx, K, f, j0 - kB, i0 - 2);
  vort_plan.init(Ny, Nx, K, f, j0 - 3, i0 - 3);
  if constexpr (Blend) {
    pu_plan.init(Ny + 1, Nx, K, f, j0 - 1, i0 - 1);
    pv_plan.init(Ny, Nx + 1, K, f, j0 - 1, i0 - 1);
  } else {
    div_plan.init(Ny + 1, Nx + 1, K, f, j0, i0);
  }
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
    su[r] = tile_at(kUctI, clampi(jc - 1, 0, Ny - 2) - (j0 - 2),
                    ic - (i0 - kB), kl);
    sv[r] = tile_at(kVctI, jc - (j0 - kB), clampi(ic - 1, 0, Nx - 2) -
                    (i0 - 2), kl);
  }
  // Blend form: the dual corners of a thread are not its corners above.
  // The tile has kCount corner elements for kTileThreads threads, so the
  // first kDualShift threads take two corners above and the others one;
  // the dual corners start kDualShift elements on (element tid +
  // kDualShift, and tid + kDualShift - kTileThreads where that is one), so
  // that no thread takes two of both.  dc: the corner, -1 for none; (dj,
  // di): the point of its dual contour, relative to (j0, i0).
  constexpr int kDualShift = CornPlan::kCount - kTileThreads;
  static_assert(kDualShift >= 0 && kDualShift < kTileThreads &&
                    kDualShift % kTK == 0 && kTileThreads % kTK == 0,
                "each thread takes one or two dual corners of its level");
  int dc[2], dj[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int e = tid + kDualShift - r * kTileThreads;
    const int cell = e / kTK, jc = min(j0 + cell / kCornI, Ny);
    const int ic = min(i0 + cell % kCornI, Nx);
    dc[r] = e >= 0 ? cell : -1;
    dj[r] = clampi(jc, 1, Ny - 1) - j0;
    di[r] = clampi(ic, 1, Nx - 1) - i0;
  }
  // the staged uct and vct cells of the thread's staged cells' divergence
  int cu[CentPlan::kPer], cv[CentPlan::kPer];
  // A block whose first corner row is Ny or first corner column Nx updates
  // no point (its points keep pu/pv), so it forms no dual corner: the
  // contour of its clamped corners lies outside its tiles.
  const bool dual_ok = j0 < Ny && i0 < Nx;
  bool has_cell = false;
  if constexpr (Blend) {
#pragma unroll
    for (int r = 0; r < CentPlan::kPer; ++r) {
      const int cell = (tid + r * kTileThreads) / kTK;
      const int jj = clampi(j0 - 1 + cell / kCentI, 0, Ny - 1);
      const int ii = clampi(i0 - 1 + cell % kCentI, 0, Nx - 1);
      cu[r] = (jj - (j0 - 2)) * kUctI + ii - (i0 - 1);
      cv[r] = (jj - (j0 - 1)) * kVctI + ii - (i0 - 2);
    }
    stage_metric<kTJ + 3, kTI + 3>(b.dy, m, DY, f, j0 - 2, i0 - 1);
    stage_metric<kTJ + 3, kTI + 3>(b.dx, m, DX, f, j0 - 1, i0 - 2);
    stage_metric<kTJ + 2, kTI + 2>(b.rarea, m, RAREA, f, j0 - 1, i0 - 1);
    stage_metric<kTJ + 1, kUfI>(b.uf[kDualCosa], m, COSA_J, f, j0, i0 - 1);
    stage_metric<kTJ + 1, kUfI>(b.uf[kDualRsina], m, RSINA_J, f, j0, i0 - 1);
    stage_metric<kTJ + 1, kUfI>(b.uf[kDualDc], m, DYC, f, j0, i0 - 1);
    stage_metric<kTJ + 2, kVfI>(b.vf[kDualCosa], m, COSA_I, f, j0 - 1, i0);
    stage_metric<kTJ + 2, kVfI>(b.vf[kDualRsina], m, RSINA_I, f, j0 - 1, i0);
    stage_metric<kTJ + 2, kVfI>(b.vf[kDualDc], m, DXC, f, j0 - 1, i0);
    stage_metric<kTJ + 1, kTI + 1>(b.rarea_c, m, RAREA_C, f, j0, i0);
    stage_metric<kTJ + 1, kTI + 1>(b.blend, m, DIV_BLEND, f, j0, i0);
    __syncthreads();
    for (int c = 0; c < kCorners; ++c) has_cell |= b.blend[c] > 0.5f;
  }

  // The blend form's damping divergence at corner r of the thread in the
  // dual form: dycore/sw.py's uf and vf (the transverse wind the 4-point
  // mean of the other component) at the corner's clamped point (j, i),
  // du = uf(j, i) - uf(j, i-1), dv = vf(j, i) - vf(j-1, i), times rarea_c.
  const auto dual_div = [&](int r) {
    const float* pu = b.pu + tile_at(kPuI, dj[r] + 1, di[r] + 1, kl);
    const float* pv = b.pv + tile_at(kPvI, dj[r] + 1, di[r] + 1, kl);
    constexpr int sy = kPuI * kTK, sx = kTK, ty = kPvI * kTK;
    // uf at u-point (j, i - a): pu there, pv of rows j-1, j, columns
    // i-a, i-a+1
    const auto uf = [&](int a) {
      const float* q = pv - a * sx;
      const float vm0 = 0.5f * (q[-ty] + q[-ty + sx]);
      const float vm1 = 0.5f * (q[0] + q[sx]);
      const float vu = 0.5f * (vm0 + vm1);
      const int o = dj[r] * kUfI + di[r] + 1 - a;
      return (pu[-a * sx] - b.uf[kDualCosa][o] * vu) * b.uf[kDualRsina][o] *
             b.uf[kDualDc][o];
    };
    // vf at v-point (j - a, i): pv there, pu of rows j-a, j-a+1, columns
    // i-1, i
    const auto vf = [&](int a) {
      const float* q = pu - a * sy;
      const float um0 = 0.5f * (q[-sx] + q[sy - sx]);
      const float um1 = 0.5f * (q[0] + q[sy]);
      const float uv = 0.5f * (um0 + um1);
      const int o = (dj[r] + 1 - a) * kVfI + di[r];
      return (pv[-a * ty] - b.vf[kDualCosa][o] * uv) * b.vf[kDualRsina][o] *
             b.vf[kDualDc][o];
    };
    const float du = uf(0) - uf(1);
    const float dv = vf(0) - vf(1);
    return (du + dv) * b.rarea_c[dj[r] * kCornI + di[r]];
  };

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
  const int ovct = tile_at(kVctI, tj + kB, ti + 2, kl);
  const int ouct = tile_at(kUctI, tj + 2, ti + kB, kl);
  // blend form: pu and pv at (j, i) in their tiles
  const int opu = tile_at(kPuI, tj + 1, ti + 1, kl);
  const int opv = tile_at(kPvI, tj + 1, ti + 1, kl);

  // Registers for the next chunk's values, fetched while this one computes.
  float n_cent[NF][CentPlan::kPer], n_uct[P::Uct::kPer];
  float n_vct[P::Vct::kPer], n_div[CornPlan::kPer], n_vort[VortPlan::kPer];
  float n_pu[PuPlan::kPer], n_pv[PvPlan::kPer];
  float n_pu0 = 0.0f, n_pv0 = 0.0f;
  const auto fetch = [&](int k) {
#pragma unroll
    for (int n = 0; n < NF; ++n) cent_plan.fetch(n_cent[n], fields[n], k);
    uct_plan.fetch(n_uct, in.uct, k);
    vct_plan.fetch(n_vct, in.vct, k);
    if constexpr (!Blend) div_plan.fetch(n_div, in.div_c, k);
    vort_plan.fetch(n_vort, in.vort, k);
    if constexpr (Blend) {
      pu_plan.fetch(n_pu, in.pu, k);
      pv_plan.fetch(n_pv, in.pv, k);
    } else {
      if (on_u) n_pu0 = in.pu[ou + k];
      if (on_v) n_pv0 = in.pv[ov + k];
    }
  };
  fetch(min(kl, K - 1));
  for (int k0 = 0; k0 < K; k0 += kTK) {
#pragma unroll
    for (int n = 0; n < NF; ++n) cent_plan.commit(t.cent[n], n_cent[n]);
    uct_plan.commit(t.uct, n_uct);
    vct_plan.commit(t.vct, n_vct);
    if constexpr (!Blend) div_plan.commit(t.div, n_div);
    vort_plan.commit(t.vort, n_vort);
    if constexpr (Blend) {
      pu_plan.commit(b.pu, n_pu);
      pv_plan.commit(b.pv, n_pv);
    }
    const float pu0 = n_pu0, pv0 = n_pv0;
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
    if constexpr (Blend) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (dc[r] >= 0 && !(b.blend[dc[r]] > 0.5f))
          t.div[dc[r] * kTK + kl] = dual_ok ? dual_div(r) : 0.0f;
    }
    if constexpr (Blend) {
      if (has_cell) {   // the same for every thread of the block
        // -(ddx(uct dy) + ddy(vct dx)) rarea at each staged cell
#pragma unroll
        for (int r = 0; r < CentPlan::kPer; ++r) {
          const int e = tid + r * kTileThreads;
          if (e >= CentPlan::kCount) continue;
          const float* u = t.uct + cu[r] * kTK + kl;
          const float* v = t.vct + cv[r] * kTK + kl;
          const float dx_ = u[0] * b.dy[cu[r]] - u[kTK] * b.dy[cu[r] + 1];
          const float dy_ = v[0] * b.dx[cv[r]] -
                            v[kVctI * kTK] * b.dx[cv[r] + kVctI];
          b.cell[e] = -(dx_ + dy_) * b.rarea[e / kTK];
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < CornPlan::kPer; ++r) {
          if (cc[r] < 0 || !(b.blend[cc[r]] > 0.5f)) continue;
          const float* c = b.cell + cs[r];
          t.div[tid + r * kTileThreads] = corner_w4(
              c[0], c[kTK], c[kCentI * kTK], c[(kCentI + 1) * kTK],
              t.cmet[kDw00][cc[r]], t.cmet[kDw01][cc[r]],
              t.cmet[kDw10][cc[r]], t.cmet[kDw11][cc[r]]);
        }
      }
    }
    __syncthreads();

    const int k = k0 + kl;
    if (k < K) {
      if (on_u) {
        float out = Blend ? b.pu[opu] : pu0;
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
        float out = Blend ? b.pv[opv] : pv0;
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

// wind_update<NF, Blend> on stream s; its tiles need more than the 48 KB of
// shared memory a launch gets without opting in, except in the exchange
// form with NF 3.
template <int NF, bool Blend>
cudaError_t launch_wind_update(const Metrics& m, int F, int Ny, int Nx, int K,
                               const WindIn& in, float dt, int hord_mt,
                               float d2dt, float vtxdt, int use_vtx,
                               float cp_air, float* u_new, float* v_new,
                               cudaStream_t s) {
  const size_t bytes = wind_tile_bytes<NF, Blend>();
  cudaError_t err = cudaFuncSetAttribute(
      wind_update<NF, Blend>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  wind_update<NF, Blend>
      <<<tile_grid(F, Ny + 1, Nx + 1), kTileThreads, bytes, s>>>(
          m, F, Ny, Nx, K, in, dt, hord_mt, d2dt, vtxdt, use_vtx, cp_air,
          u_new, v_new);
  return cudaGetLastError();
}

template <int NF>
cudaError_t launch_wind_form(const Metrics& m, int F, int Ny, int Nx, int K,
                             const WindIn& in, float dt, int hord_mt,
                             float d2dt, float vtxdt, int use_vtx,
                             float cp_air, float* u_new, float* v_new,
                             cudaStream_t s) {
  return in.div_c == nullptr
             ? launch_wind_update<NF, true>(m, F, Ny, Nx, K, in, dt, hord_mt,
                                            d2dt, vtxdt, use_vtx, cp_air,
                                            u_new, v_new, s)
             : launch_wind_update<NF, false>(m, F, Ny, Nx, K, in, dt,
                                             hord_mt, d2dt, vtxdt, use_vtx,
                                             cp_air, u_new, v_new, s);
}

}  // namespace

// pu [F, Ny+1, Nx, K], pv [F, Ny, Nx+1, K], uct [F, Ny, Nx+1, K], vct
// [F, Ny+1, Nx, K]; delp_f, pt_f (the refilled post-transport state) and
// vort [F, Ny, Nx, K]; div_c [F, Ny+1, Nx+1, K]: the exchange-form damping
// divergence, or null for the blend form, which the kernel forms itself.
// pprime, phiprime, rho1 [F, Ny, Nx, K]: the nonhydrostatic fields, all
// three null in hydrostatic mode.  d2dt = d2_bg / dt and vtxdt = vtx_damp /
// dt, as the plain version rounds them; use_vtx is vtx_damp > 0.  Scratch:
// pkz, phi [F, Ny, Nx, K].  Outputs u [F, Ny+1, Nx, K], v [F, Ny, Nx+1, K].
// Returns the CUDA error of the first failed launch, 0 when all launched.
extern "C" int dsw_wind_f32(const void* metrics, int F, int Ny, int Nx, int K,
                            const void* pu, const void* pv, const void* uct,
                            const void* vct, const void* delp_f,
                            const void* pt_f, const void* vort,
                            const void* div_c, const void* pprime,
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
  const WindIn in = {cf(pu), cf(pv), cf(uct), cf(vct), cf(pt_f),
                     pkz_w, phi_w, cf(vort), cf(div_c), cf(pprime),
                     cf(phiprime), cf(rho1)};
  float* u_w = static_cast<float*>(u_new);
  float* v_w = static_cast<float*>(v_new);
  err = in.pp != nullptr
            ? launch_wind_form<6>(m, F, Ny, Nx, K, in, dt, hord_mt, d2dt,
                                  vtxdt, use_vtx, cp_air, u_w, v_w, s)
            : launch_wind_form<3>(m, F, Ny, Nx, K, in, dt, hord_mt, d2dt,
                                  vtxdt, use_vtx, cp_air, u_w, v_w, s);
  return (int)err;
}
