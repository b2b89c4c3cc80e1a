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
// One stage, csw1: a block takes the x-interfaces, y-interfaces and cells
// of kTJ x kTI points (j0.., i0..) of the corner-sized union and walks K in
// chunks of kTK levels.  Per chunk it stages ua and va with a rim of one
// cell, the x-order fills pd_x and pt_x with an x-rim of one, the y-order
// fills with a y-rim of one, and pu and pv; it then (1) forms uc and the
// upwind fluxes fxm = upwind(pd_x) uc dt2 dy and fxt = upwind(pt_x) fxm once
// per x-interface of its cells (its points and the next column), vc, fym
// and fyt once per y-interface, into shared memory, and writes the uc and
// vc of its points; (2) forms delp_h, pt_h, ke and vort per cell from
// shared memory and registers.  The interface metrics sit in registers
// over all chunks, and the next chunk is fetched into registers while this
// one computes.
//
// What bounds it on this card: its bytes.  At c48-L72 it reads 8
// field-sized inputs and writes 6 (~70 MB, 21 us at 3.35 TB/s) for ~80
// operations per cell.  The first design (one thread per point) formed each
// C-grid wind three times and read every metric and neighbour from device
// memory.  A later design fuses the A-grid winds and the chart correction
// that now run as PyTorch glue before it.
#include "dsw_common.cuh"

namespace {

// What a block stages per chunk of levels, for its points j0 .. j0+kTJ-1 by
// i0 .. i0+kTI-1:
using AgridPlan = StagePlan<kTJ + 2, kTI + 2>;  // ua, va from (j0-1, i0-1)
using FillXPlan = StagePlan<kTJ, kTI + 2>;      // pd_x, pt_x from (j0, i0-1)
using FillYPlan = StagePlan<kTJ + 2, kTI>;      // pd_y, pt_y from (j0-1, i0)
using PuPlan = StagePlan<kTJ + 1, kTI>;         // pu from (j0, i0)
using PvPlan = StagePlan<kTJ, kTI + 1>;         // pv from (j0, i0)
constexpr int kAgI = kTI + 2, kFxI = kTI + 2;
// the interfaces of the block's cells: x-interfaces kTJ x (kTI + 1) from
// (j0, i0), then y-interfaces (kTJ + 1) x kTI from (j0, i0)
constexpr int kXif = kTJ * (kTI + 1), kYif = (kTJ + 1) * kTI;
constexpr int kIfCount = (kXif + kYif) * kTK;
constexpr int kIfPer = (kIfCount + kTileThreads - 1) / kTileThreads;

struct Csw1Tiles {
  float ua[AgridPlan::kCount];
  float va[AgridPlan::kCount];
  float pd_x[FillXPlan::kCount];
  float pt_x[FillXPlan::kCount];
  float pd_y[FillYPlan::kCount];
  float pt_y[FillYPlan::kCount];
  float pu[PuPlan::kCount];
  float pv[PvPlan::kCount];
  float fm[(kXif + kYif) * kTK];  // fxm at the x-interfaces, then fym
  float ft[(kXif + kYif) * kTK];  // fxt, then fyt
};

__global__ void __launch_bounds__(kTileThreads)
csw1(Metrics m, int F, int Ny, int Nx, int K, const float* __restrict__ pu,
     const float* __restrict__ pv, const float* __restrict__ ua,
     const float* __restrict__ va, const float* __restrict__ pd_x,
     const float* __restrict__ pd_y, const float* __restrict__ pt_x,
     const float* __restrict__ pt_y, float dt2, float* __restrict__ uc,
     float* __restrict__ vc, float* __restrict__ delp_h,
     float* __restrict__ pt_h, float* __restrict__ ke,
     float* __restrict__ vort) {
  __shared__ Csw1Tiles t;
  const int f = blockIdx.z, j0 = blockIdx.y * kTJ, i0 = blockIdx.x * kTI;
  const int tid = threadIdx.x, kl = tid % kTK;

  AgridPlan ag_plan;
  FillXPlan fx_plan;
  FillYPlan fy_plan;
  PuPlan pu_plan;
  PvPlan pv_plan;
  ag_plan.init(Ny, Nx, K, f, j0 - 1, i0 - 1);
  fx_plan.init(Ny, Nx, K, f, j0, i0 - 1);
  fy_plan.init(Ny, Nx, K, f, j0 - 1, i0);
  pu_plan.init(Ny + 1, Nx, K, f, j0, i0);
  pv_plan.init(Ny, Nx + 1, K, f, j0, i0);

  // The thread's interfaces, fixed over the chunks: element e of the
  // interface tile; its metrics (cosa, rsina, rdxc or rdyc, dy or dx) at
  // the clamped interface; the staged A-grid cells on its two sides (a1 the
  // edge cell of _center_to_xiface / _center_to_yiface at the first and
  // last interface, where mid is false); its line of fills; the output
  // offset of an interface the block owns, else -1.
  int ie[kIfPer], a0[kIfPer], a1[kIfPer], lb[kIfPer], ic[kIfPer];
  int iof[kIfPer];
  bool ix[kIfPer], mid[kIfPer];
  float cosa[kIfPer], rsina[kIfPer], rdc[kIfPer], dl[kIfPer];
#pragma unroll
  for (int r = 0; r < kIfPer; ++r) {
    const int e = tid + r * kTileThreads;
    const int cell = e / kTK;
    ie[r] = e < kIfCount ? e : -1;
    ix[r] = cell < kXif;
    if (ix[r]) {  // x-interface (j, i) between cells i-1 and i
      const int jj = cell / (kTI + 1), ii = cell % (kTI + 1);
      const int j = j0 + jj, i = i0 + ii;
      const int cj = min(j, Ny - 1), ci = min(i, Nx);
      cosa[r] = met32(m, COSA_I, f, cj, ci);
      rsina[r] = met32(m, RSINA_I, f, cj, ci);
      rdc[r] = met32(m, RDXC, f, cj, ci);
      dl[r] = met32(m, DY, f, cj, ci);
      mid[r] = i > 0 && i < Nx;
      a0[r] = tile_at(kAgI, jj + 1, ii, kl);
      a1[r] = tile_at(kAgI, jj + 1, i >= Nx ? ii : ii + 1, kl);
      lb[r] = tile_at(kFxI, jj, 0, kl);
      ic[r] = i;
      iof[r] = ii < kTI && j < Ny && i <= Nx
                   ? cell_off(Ny, Nx + 1, K, f, j, i) : -1;
    } else {  // y-interface (j, i) between cells j-1 and j
      const int c = cell - kXif, jj = c / kTI, ii = c % kTI;
      const int j = j0 + jj, i = i0 + ii;
      const int cj = min(j, Ny), ci = min(i, Nx - 1);
      cosa[r] = met32(m, COSA_J, f, cj, ci);
      rsina[r] = met32(m, RSINA_J, f, cj, ci);
      rdc[r] = met32(m, RDYC, f, cj, ci);
      dl[r] = met32(m, DX, f, cj, ci);
      mid[r] = j > 0 && j < Ny;
      a0[r] = tile_at(kAgI, jj, ii + 1, kl);
      a1[r] = tile_at(kAgI, j >= Ny ? jj : jj + 1, ii + 1, kl);
      lb[r] = tile_at(kTI, 0, ii, kl);
      ic[r] = j;
      iof[r] = jj < kTJ && j <= Ny && i < Nx
                   ? cell_off(Ny + 1, Nx, K, f, j, i) : -1;
    }
  }

  // the thread's cell (j, i) and its metrics
  const int ti = (tid / kTK) % kTI, tj = tid / (kTK * kTI);
  const int j = j0 + tj, i = i0 + ti;
  const bool in_cell = j < Ny && i < Nx;
  const int oc = in_cell ? cell_off(Ny, Nx, K, f, j, i) : -1;
  float rarea = 0.0f, rsin2 = 0.0f, cosa_c = 0.0f, fcor = 0.0f;
  float dx0 = 0.0f, dx1 = 0.0f, dy0 = 0.0f, dy1 = 0.0f;
  if (in_cell) {
    rarea = met32(m, RAREA, f, j, i);
    rsin2 = met32(m, RSIN2_C, f, j, i);
    cosa_c = met32(m, COSA_C, f, j, i);
    fcor = met32(m, FCOR, f, j, i);
    dx0 = met32(m, DX, f, j, i);
    dx1 = met32(m, DX, f, j + 1, i);
    dy0 = met32(m, DY, f, j, i);
    dy1 = met32(m, DY, f, j, i + 1);
  }
  // its x-interfaces i, i+1 and y-interfaces j, j+1 in the flux tiles
  const int fx0 = tile_at(kTI + 1, tj, ti, kl);
  const int fy0 = kXif * kTK + tile_at(kTI, tj, ti, kl);

  // Registers for the next chunk's values, fetched while this one computes.
  float n_ua[AgridPlan::kPer], n_va[AgridPlan::kPer];
  float n_pdx[FillXPlan::kPer], n_ptx[FillXPlan::kPer];
  float n_pdy[FillYPlan::kPer], n_pty[FillYPlan::kPer];
  float n_pu[PuPlan::kPer], n_pv[PvPlan::kPer];
  const auto fetch = [&](int k) {
    ag_plan.fetch(n_ua, ua, k);
    ag_plan.fetch(n_va, va, k);
    fx_plan.fetch(n_pdx, pd_x, k);
    fx_plan.fetch(n_ptx, pt_x, k);
    fy_plan.fetch(n_pdy, pd_y, k);
    fy_plan.fetch(n_pty, pt_y, k);
    pu_plan.fetch(n_pu, pu, k);
    pv_plan.fetch(n_pv, pv, k);
  };
  fetch(min(kl, K - 1));
  for (int k0 = 0; k0 < K; k0 += kTK) {
    // the staged tiles were last read before the barrier that ended phase
    // (1) of the previous chunk, the flux tiles before this barrier
    ag_plan.commit(t.ua, n_ua);
    ag_plan.commit(t.va, n_va);
    fx_plan.commit(t.pd_x, n_pdx);
    fx_plan.commit(t.pt_x, n_ptx);
    fy_plan.commit(t.pd_y, n_pdy);
    fy_plan.commit(t.pt_y, n_pty);
    pu_plan.commit(t.pu, n_pu);
    pv_plan.commit(t.pv, n_pv);
    __syncthreads();
    if (k0 + kTK < K) fetch(min(k0 + kTK + kl, K - 1));
    const int k = k0 + kl;
    // (1) uc, vc and the upwind fluxes once per interface
#pragma unroll
    for (int r = 0; r < kIfPer; ++r) {
      if (ie[r] < 0) continue;
      // the C-grid normal wind (own - cosa x transverse) rsina, both
      // interpolated to the interface
      const float* own = ix[r] ? t.ua : t.va;
      const float* other = ix[r] ? t.va : t.ua;
      const float wo = mid[r] ? 0.5f * (own[a0[r]] + own[a1[r]]) : own[a1[r]];
      const float wt =
          mid[r] ? 0.5f * (other[a0[r]] + other[a1[r]]) : other[a1[r]];
      const float w = (wo - cosa[r] * wt) * rsina[r];
      const float cr = w * dt2 * rdc[r];
      const TileLine dline =
          ix[r] ? TileLine{t.pd_x + lb[r], kTK, i0 - 1, Nx}
                : TileLine{t.pd_y + lb[r], kTI * kTK, j0 - 1, Ny};
      const TileLine tline =
          ix[r] ? TileLine{t.pt_x + lb[r], kTK, i0 - 1, Nx}
                : TileLine{t.pt_y + lb[r], kTI * kTK, j0 - 1, Ny};
      const float fm = upwind(dline, ic[r], cr) * w * dt2 * dl[r];
      t.fm[ie[r]] = fm;
      t.ft[ie[r]] = upwind(tline, ic[r], cr) * fm;
      if (iof[r] >= 0 && k < K) (ix[r] ? uc : vc)[iof[r] + k] = w;
    }
    // the thread's cell values, read before the next chunk's refill
    const float pdx = t.pd_x[tile_at(kFxI, tj, ti + 1, kl)];
    const float ptx = t.pt_x[tile_at(kFxI, tj, ti + 1, kl)];
    const float a = t.ua[tile_at(kAgI, tj + 1, ti + 1, kl)];
    const float b = t.va[tile_at(kAgI, tj + 1, ti + 1, kl)];
    const float pu0 = t.pu[tile_at(kTI, tj, ti, kl)];
    const float pu1 = t.pu[tile_at(kTI, tj + 1, ti, kl)];
    const float pv0 = t.pv[tile_at(kTI + 1, tj, ti, kl)];
    const float pv1 = t.pv[tile_at(kTI + 1, tj, ti + 1, kl)];
    __syncthreads();

    // (2) the cell's half-step delp and pt, kinetic energy and vorticity
    if (!in_cell || k >= K) continue;
    const float* fm = t.fm;
    const float* ft = t.ft;
    const float dh = pdx + ((fm[fx0] - fm[fx0 + kTK]) +
                            (fm[fy0] - fm[fy0 + kTI * kTK])) * rarea;
    delp_h[oc + k] = dh;
    pt_h[oc + k] = (ptx * pdx + ((ft[fx0] - ft[fx0 + kTK]) +
                                 (ft[fy0] - ft[fy0 + kTI * kTK])) * rarea) /
                   dh;
    ke[oc + k] = 0.5f * rsin2 * (a * a + b * b - 2.0f * cosa_c * a * b);
    const float circ = pu0 * dx0 + pv1 * dy1 - pu1 * dx1 - pv0 * dy0;
    vort[oc + k] = circ * rarea + fcor;
  }
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
  csw1<<<tile_grid(F, Ny + 1, Nx + 1), kTileThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
      m, F, Ny, Nx, K, cf(pu), cf(pv), cf(ua), cf(va), cf(pd_x), cf(pd_y),
      cf(pt_x), cf(pt_y), dt2, wf(uc), wf(vc), wf(delp_h), wf(pt_h), wf(ke),
      wf(vort));
  return (int)cudaGetLastError();
}
