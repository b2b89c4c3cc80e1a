// Device code shared by the fused substep kernels (dsw_*.cu), for Hopper.
//
// The TPU kernels of geosongpu_tpu/dycore/sw_pallas.py run the bodies of
// dycore/sw.py (c_sw_part1/2, transport_part, wind_part, fvtp2d) on whole
// faces in VMEM.  Here the same arithmetic is written point by point:
//
// * Every array is a contiguous [F, R, C, K] float32 tensor with its own
//   extents (centres [F, Ny, Nx, K], x-interfaces [F, Ny, Nx+1, K],
//   y-interfaces [F, Ny+1, Nx, K], corners [F, Ny+1, Nx+1, K]); K is the
//   innermost, contiguous axis.  The 36 PaddedMetrics fields are
//   [F, R, C, 1] and travel as one struct of pointers and extents.
// * The plain PyTorch versions pad and shift with edge replication
//   (ops/ppm.py _shift / _iface, dycore/sw.py _pad_edge /
//   _center_to_xiface).  A read at a clamped index reproduces that
//   composition exactly: reading array B, built from A by a clamped
//   shift, at a clamped index equals recomputing B's entry there.
// * Each expression keeps the operation order of its plain version, and
//   the library is built with --fmad=false, so that the horizontal
//   kernels agree with the plain versions operation by operation (a
//   hord-8 limiter branch cannot flip on an FMA rounding).  Python float
//   constants are rounded to float32 exactly as PyTorch rounds a scalar
//   operand of a float32 tensor.
// * Horizontal stages run one thread per (f, j, i, k) point, k fastest,
//   so that a warp reads neighbouring addresses; those of dsw_csw2 and
//   dsw_wind work on shared-memory tiles of points.  The column stage of
//   these two takes a tile of neighbouring columns per block; nh_columns
//   (dsw_nh_pert.cu) still runs one thread per column walking K.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kNumMetrics = 36;

// Field order of geosongpu_tpu_torch/dycore/sw.py::PaddedMetrics; the
// wrapper checks it against dsw_metric_names().
enum MetricId {
  AREA, RAREA, DX, DY, DXC, DYC, FCOR, RAREA_C, COSA_I, RSINA_I, COSA_J,
  RSINA_J, RDX, RDY, RDXC, RDYC, COSA_C, RSIN2_C, COSA_CN, RSIN2_CN, PHIS,
  DW00, DW01, DW10, DW11, DR11, R12, R21, DR22, JWM, JWP, IWM, IWP, RDXC_C,
  RDYC_C, DIV_BLEND
};

struct Metrics {
  const float* p[kNumMetrics];
  int rows[kNumMetrics];
  int cols[kNumMetrics];
};

// Python's 7.0 / 12.0, 1.0 / 12.0 and 2.0 / 3.0, rounded to float32.
constexpr float kC712 = (float)(7.0 / 12.0);
constexpr float kC112 = (float)(1.0 / 12.0);
constexpr float kC23 = (float)(2.0 / 3.0);

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float met(const Metrics& m, int id, int f, int j,
                                     int i) {
  return m.p[id][((long long)f * m.rows[id] + j) * m.cols[id] + i];
}

// A read-only [F, R, C, K] array.
struct Arr {
  const float* p;
  int R, C, K;
  __device__ __forceinline__ float operator()(int f, int j, int i,
                                              int k) const {
    return p[(((long long)f * R + j) * C + i) * K + k];
  }
  // clamp-to-edge read
  __device__ __forceinline__ float c(int f, int j, int i, int k) const {
    return (*this)(f, clampi(j, 0, R - 1), clampi(i, 0, C - 1), k);
  }
};

__device__ __forceinline__ long long off(int R, int C, int K, int f, int j,
                                         int i, int k) {
  return (((long long)f * R + j) * C + i) * K + k;
}

// One line of cells of an Arr along x (fixed f, j, k) or y (fixed f, i,
// k); operator() clamps the cell index to the line, as _shift and _iface
// replicate the edge cells.
struct Line {
  const float* base;
  long long stride;
  int n;
  __device__ __forceinline__ float operator()(int c) const {
    return base[(long long)clampi(c, 0, n - 1) * stride];
  }
};

__device__ __forceinline__ Line line_x(const Arr& a, int f, int j, int k) {
  return {a.p + off(a.R, a.C, a.K, f, j, 0, k), (long long)a.K, a.C};
}

__device__ __forceinline__ Line line_y(const Arr& a, int f, int i, int k) {
  return {a.p + off(a.R, a.C, a.K, f, 0, i, k), (long long)a.C * a.K, a.R};
}

// Flat thread index -> (f, j, i, k) over [F, R, C, K], k fastest.
__device__ __forceinline__ bool decode(int F, int R, int C, int K, int& f,
                                       int& j, int& i, int& k) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)F * R * C * K) return false;
  k = (int)(t % K);
  t /= K;
  i = (int)(t % C);
  t /= C;
  j = (int)(t % R);
  f = (int)(t / R);
  return true;
}

__host__ __forceinline__ unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// ---- PPM (ops/ppm.py) ------------------------------------------------

// The PPM functions take a line of cells as any type with operator()(cell)
// and the line's length n: a Line of device memory or a TileLine of a
// staged tile.

// _edges_ord4: al[c] = 7/12 (q[c-1] + q[c]) - 1/12 (q[c-2] + q[c+1])
template <class L>
__device__ __forceinline__ float edge_ord4(const L& q, int c) {
  return kC712 * (q(c - 1) + q(c)) - kC112 * (q(c - 2) + q(c + 1));
}

// _ppm_coeffs at cell c: edges aL, aR (aR = al shifted by +1 with edge
// replication), limited for hord 8, and a6.
template <class L>
__device__ __forceinline__ void ppm_coeffs(const L& q, int c, int hord,
                                           float& aL, float& aR, float& a6) {
  const float qc = q(c);
  aL = edge_ord4(q, c);
  aR = edge_ord4(q, clampi(c + 1, 0, q.n - 1));
  if (hord == 8) {
    if ((aR - qc) * (qc - aL) <= 0.0f) {
      aL = qc;
      aR = qc;
    }
    float da = aR - aL;
    a6 = 6.0f * (qc - 0.5f * (aL + aR));
    if (a6 * da > da * da) aL = 3.0f * qc - 2.0f * aR;
    da = aR - aL;
    a6 = 6.0f * (qc - 0.5f * (aL + aR));
    if (a6 * da < -da * da) aR = 3.0f * qc - 2.0f * aL;
  }
  a6 = 6.0f * (qc - 0.5f * (aL + aR));
}

// ppm_flux at interface i (between cells i-1 and i) of a line, Courant c.
template <class L>
__device__ __forceinline__ float ppm_flux(const L& q, int i, float c,
                                          int hord) {
  float aL, aR, a6;
  if (c >= 0.0f) {
    ppm_coeffs(q, clampi(i - 1, 0, q.n - 1), hord, aL, aR, a6);
    const float cpos = fmaxf(c, 0.0f);
    return aR - 0.5f * cpos * ((aR - aL) - (1.0f - kC23 * cpos) * a6);
  }
  ppm_coeffs(q, clampi(i, 0, q.n - 1), hord, aL, aR, a6);
  const float cneg = fmaxf(-c, 0.0f);
  return aL + 0.5f * cneg * ((aR - aL) + (1.0f - kC23 * cneg) * a6);
}

// upwind_flux: first-order upwind interface value
__device__ __forceinline__ float upwind(const Line& q, int i, float c) {
  return c >= 0.0f ? q(i - 1) : q(i);
}

// ---- staggering helpers (dycore/sw.py) -----------------------------------

// _center_to_corner_w from the four centre values around a corner and the
// corner's weights DW00 .. DW11: the 4-point average plus
// sum_k dw_k (a_k - avg4).
__device__ __forceinline__ float corner_w4(float a00, float a01, float a10,
                                           float a11, float dw00, float dw01,
                                           float dw10, float dw11) {
  const float avg4 = 0.25f * (a00 + a01 + a10 + a11);
  return avg4 + (dw00 * (a00 - avg4) + dw01 * (a01 - avg4) +
                 dw10 * (a10 - avg4) + dw11 * (a11 - avg4));
}

// ---- shared-memory tiles of the horizontal stencil stages ------------------
//
// csw2_winds (dsw_csw2.cu) and wind_update (dsw_wind.cu) give one block a
// tile of kTJ x kTI output points of one face and walk K in chunks of kTK
// levels; the thread index runs over the chunk's levels first, then i, then
// j, so a warp still reads runs along K.  Per chunk the block stages the
// centre cells its points need (the tile and a rim) in shared memory,
// derives each resampled or corner value once per cell of the tile there,
// and only then forms its points.  A staged cell outside the face holds the
// value at the clamped index, as Arr::c reads it; the derived values of such
// cells are never used by a point that is written.  What depends on (j, i)
// alone - offsets, metric weights - is set up once per thread and reused
// over the chunks, and the next chunk's cells are fetched into registers
// while this chunk is computed.
constexpr int kTJ = 8, kTI = 8, kTK = 8;
constexpr int kTileThreads = kTJ * kTI * kTK;

__host__ __forceinline__ dim3 tile_grid(int F, int R, int C) {
  return dim3((unsigned)((C + kTI - 1) / kTI), (unsigned)((R + kTJ - 1) / kTJ),
              (unsigned)F);
}

// Offset of level 0 of cell (j, i) of face f in an [F, R, C, K] array;
// check_grid keeps every such offset below 2^31.
__device__ __forceinline__ int cell_off(int R, int C, int K, int f, int j,
                                        int i) {
  return ((f * R + j) * C + i) * K;
}

// ... of a PaddedMetrics field.
__device__ __forceinline__ float met32(const Metrics& m, int id, int f, int j,
                                       int i) {
  return m.p[id][(f * m.rows[id] + j) * m.cols[id] + i];
}

// Offset of level lane kl of tile cell (jj, ii) in a staged tile NI cells
// wide.
__device__ __forceinline__ int tile_at(int NI, int jj, int ii, int kl) {
  return (jj * NI + ii) * kTK + kl;
}

// A thread's share of staging NJ x NI cells x kTK levels of an array: element
// e = threadIdx.x + r kTileThreads of the tile, r < kPer, is level lane
// threadIdx.x % kTK of cell e / kTK.
template <int NJ, int NI>
struct StagePlan {
  static constexpr int kCount = NJ * NI * kTK;
  static constexpr int kPer = (kCount + kTileThreads - 1) / kTileThreads;
  int g[kPer];  // cell_off of the clamped cell; -1 past the tile

  // The tile starts at cell (jb, ib) of face f of an [F, R, C, K] array.
  __device__ __forceinline__ void init(int R, int C, int K, int f, int jb,
                                       int ib) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int e = threadIdx.x + r * kTileThreads;
      const int cell = e / kTK;
      const int cj = clampi(jb + cell / NI, 0, R - 1);
      const int ci = clampi(ib + cell % NI, 0, C - 1);
      g[r] = e < kCount ? cell_off(R, C, K, f, cj, ci) : -1;
    }
  }
  // Level k of the thread's cells of array p, into registers.
  __device__ __forceinline__ void fetch(float (&v)[kPer],
                                        const float* __restrict__ p,
                                        int k) const {
#pragma unroll
    for (int r = 0; r < kPer; ++r)
      if (g[r] >= 0) v[r] = p[g[r] + k];
  }
  // ... from registers into the staged tile.
  __device__ __forceinline__ void commit(float* __restrict__ tile,
                                         const float (&v)[kPer]) const {
#pragma unroll
    for (int r = 0; r < kPer; ++r)
      if (g[r] >= 0) tile[threadIdx.x + r * kTileThreads] = v[r];
  }
};

// One line of cells through a staged tile: cell c of the face's line of n
// cells, clamped to the line like Line, lies at base[(c - first) stride].
struct TileLine {
  const float* base;
  int stride, first, n;
  __device__ __forceinline__ float operator()(int c) const {
    return base[(clampi(c, 0, n - 1) - first) * stride];
  }
};

// Stage the NJ x NI values of metric `id` that start at (jb, ib), clamped
// to the field: s[jj * NI + ii].  They do not depend on the level, so a
// block stages them once.
template <int NJ, int NI>
__device__ __forceinline__ void stage_metric(float* __restrict__ s,
                                             const Metrics& m, int id, int f,
                                             int jb, int ib) {
  for (int e = threadIdx.x; e < NJ * NI; e += kTileThreads)
    s[e] = met32(m, id, f, clampi(jb + e / NI, 0, m.rows[id] - 1),
                 clampi(ib + e % NI, 0, m.cols[id] - 1));
}

// ---- column integral (dycore/sw.py::_hydrostatic_fields) -------------
//
// pe = ptop + cumsum(delp), pk = (pe / P00)^kappa, peln = log(pe),
// pkz = dpk / (kappa dpeln), phi = rcumsum(cp pt dpk) - cp pt dpk / 2,
// + phis.  This is the port's plain form (pow and log), not the TPU
// kernel's exp(kappa (ln pe - ln P00)) form.  The running sums are kept in
// double and rounded once, as the plain version's cumsum_k does
// (ops/vertical.py), and pe / P00 is pe * (1/P00), the form PyTorch
// evaluates a division by a Python scalar in on the card.  Both matter: dpk
// of a thin layer is a difference of nearly equal pk, so one ulp of pe
// moves pkz by up to ~1e-4 relative and the substep winds by up to ~1e-2
// m/s at c48-L72.
//
// A block takes kColTile neighbouring columns: their C x K values are one
// contiguous run of each [F, R, C, K] array, so every global read and write
// is a run along K shared by a warp, and phi is written once.  Only the two
// running sums couple the levels of a column, so only they are walked by
// one thread per column (from shared memory, in the order of the plain
// version, hence the same bits); pow, log and the layer formulas run over
// all (column, level) points of the tile with every thread.  A row of the
// tile is padded to an odd number of floats, so the column walks of a warp
// fall in different banks.
constexpr int kColThreads = 128;
constexpr int kColTile = 32;

// fn(e, c, k) for the elements e = threadIdx.x + r kColThreads < n of a
// tile of columns: level k of the tile's column c; (c, k) advance without a
// division.
template <class Fn>
__device__ __forceinline__ void for_tile_elements(int n, int K, Fn fn) {
  int c = threadIdx.x / K, k = threadIdx.x % K;
  const int c_step = kColThreads / K, k_step = kColThreads % K;
  for (int e = threadIdx.x; e < n; e += kColThreads) {
    fn(e, c, k);
    c += c_step;
    k += k_step;
    if (k >= K) {
      k -= K;
      ++c;
    }
  }
}

__global__ void __launch_bounds__(kColThreads)
hydro_columns(const float* __restrict__ phis, long long ncol, int K, int C,
              const float* __restrict__ delp, const float* __restrict__ pt,
              float ptop, float p00, float kappa, float cp_air,
              float* __restrict__ pkz, float* __restrict__ phi) {
  extern __shared__ float col_smem[];
  const int Kp = K | 1;
  float* a = col_smem;    // delp, then pe, then log pe, of the lower interface
  float* b = a + C * Kp;  // pk of the lower interface
  float* d = b + C * Kp;  // pt, then cp pt dpk, then phi
  const long long col0 = (long long)blockIdx.x * C;
  const int nc = (int)min((long long)C, ncol - col0);
  const int n = nc * K;
  const long long base = col0 * K;
  const int tid = threadIdx.x;

  for_tile_elements(n, K, [&](int e, int c, int k) {
    a[c * Kp + k] = delp[base + e];
    d[c * Kp + k] = pt[base + e];
  });
  __syncthreads();
  if (tid < nc) {
    float* col = a + tid * Kp;
    double s = 0.0;
    for (int k = 0; k < K; ++k) {
      s += (double)col[k];
      col[k] = ptop + (float)s;
    }
  }
  __syncthreads();
  const float rp00 = 1.0f / p00;
  for_tile_elements(n, K, [&](int, int c, int k) {
    const float pe = a[c * Kp + k];
    b[c * Kp + k] = powf(pe * rp00, kappa);
    a[c * Kp + k] = logf(pe);
  });
  __syncthreads();
  const float pk_top = powf(ptop * rp00, kappa);
  const float ln_top = logf(ptop);
  for_tile_elements(n, K, [&](int e, int c, int k) {
    const int o = c * Kp + k;
    const float dpk = b[o] - (k > 0 ? b[o - 1] : pk_top);
    const float dln = a[o] - (k > 0 ? a[o - 1] : ln_top);
    pkz[base + e] = dpk / (kappa * dln);
    d[o] = cp_air * d[o] * dpk;
  });
  __syncthreads();
  if (tid < nc) {
    float* col = d + tid * Kp;
    const float ps = phis[col0 + tid];
    double acc = 0.0;
    for (int k = K - 1; k >= 0; --k) {
      const float dphi = col[k];
      acc += (double)dphi;
      col[k] = ((float)acc - 0.5f * dphi) + ps;
    }
  }
  __syncthreads();
  for_tile_elements(n, K, [&](int e, int c, int k) {
    phi[base + e] = d[c * Kp + k];
  });
}

// pkz and phi (+ phis) of every column of delp, pt [F, Ny, Nx, K].  The
// tile shrinks for a K whose three rows of 32 columns would not fit the 48
// KB of shared memory a launch gets without opting in.
__host__ __forceinline__ cudaError_t launch_hydro(
    const Metrics& m, int F, int Ny, int Nx, int K, const float* delp,
    const float* pt, float ptop, float p00, float kappa, float cp_air,
    float* pkz, float* phi, cudaStream_t s) {
  int C = kColTile;
  const size_t row = 3 * (size_t)(K | 1) * sizeof(float);
  while (C > 1 && C * row > 48 * 1024) C /= 2;
  if (C * row > 48 * 1024) return cudaErrorInvalidValue;
  const long long ncol = (long long)F * Ny * Nx;
  const unsigned blocks = (unsigned)((ncol + C - 1) / C);
  hydro_columns<<<blocks, kColThreads, C * row, s>>>(
      m.p[PHIS], ncol, K, C, delp, pt, ptop, p00, kappa, cp_air, pkz, phi);
  return cudaGetLastError();
}

// ---- fvtp2d (ops/fvtp2d.py), in three stages -------------------------
//
// Courant numbers and area fluxes are rebuilt from the advective winds u
// ([F, Ny, Nx+1, K]) and v ([F, Ny+1, Nx, K]) with the plain expressions
// crx = u dt rdxc, xfx = u dt dy, cry = v dt rdyc, yfx = v dt dx.
// Up to two fields are transported together.  Field 0's outer fluxes are
// weighted by the mass flux passed to the launch, or by the area flux when
// there is none; field 1's by field 0's fluxes (pt by the mass flux of delp
// in dsw_transport), or, with second_area set, by the area flux (delz
// beside the mass-weighted w in the nonhydrostatic pass).
constexpr int kMaxFv = 2;

struct FvFields {
  const float* qx[kMaxFv];  // x-order fills [F, Ny, Nx, K]
  const float* qy[kMaxFv];  // y-order fills
  float* q_i[kMaxFv];       // inner y-updates (scratch)
  float* q_j[kMaxFv];       // inner x-updates (scratch)
  float* fx[kMaxFv];        // [F, Ny, Nx+1, K]
  float* fy[kMaxFv];        // [F, Ny+1, Nx, K]
  int nf;
  int second_area;          // field 1 takes the area flux as its weight
};

// Stage 1, per cell: q_i = (qy area + ddy(fyy)) / (area + ddy(yfx)) with
// fyy = ppm_flux(qy, cry) yfx, and q_j likewise along x from qx.
__global__ void __launch_bounds__(kThreads)
fv_inner(Metrics m, int F, int Ny, int Nx, int K, FvFields fv,
         const float* __restrict__ u, const float* __restrict__ v, float dt,
         int hord) {
  int f, j, i, k;
  if (!decode(F, Ny, Nx, K, f, j, i, k)) return;
  const Arr U = {u, Ny, Nx + 1, K};
  const Arr V = {v, Ny + 1, Nx, K};
  const float area = met(m, AREA, f, j, i);
  const float v0 = V(f, j, i, k), v1 = V(f, j + 1, i, k);
  const float yfx0 = v0 * dt * met(m, DX, f, j, i);
  const float yfx1 = v1 * dt * met(m, DX, f, j + 1, i);
  const float cry0 = v0 * dt * met(m, RDYC, f, j, i);
  const float cry1 = v1 * dt * met(m, RDYC, f, j + 1, i);
  const float ray = 1.0f / (area + (yfx0 - yfx1));
  const float u0 = U(f, j, i, k), u1 = U(f, j, i + 1, k);
  const float xfx0 = u0 * dt * met(m, DY, f, j, i);
  const float xfx1 = u1 * dt * met(m, DY, f, j, i + 1);
  const float crx0 = u0 * dt * met(m, RDXC, f, j, i);
  const float crx1 = u1 * dt * met(m, RDXC, f, j, i + 1);
  const float rax = 1.0f / (area + (xfx0 - xfx1));
  const long long o = off(Ny, Nx, K, f, j, i, k);
  for (int n = 0; n < fv.nf; ++n) {
    const Arr qy = {fv.qy[n], Ny, Nx, K};
    const Line ly = line_y(qy, f, i, k);
    const float fyy0 = ppm_flux(ly, j, cry0, hord) * yfx0;
    const float fyy1 = ppm_flux(ly, j + 1, cry1, hord) * yfx1;
    fv.q_i[n][o] = (qy(f, j, i, k) * area + (fyy0 - fyy1)) * ray;
    const Arr qx = {fv.qx[n], Ny, Nx, K};
    const Line lx = line_x(qx, f, j, k);
    const float fxx0 = ppm_flux(lx, i, crx0, hord) * xfx0;
    const float fxx1 = ppm_flux(lx, i + 1, crx1, hord) * xfx1;
    fv.q_j[n][o] = (qx(f, j, i, k) * area + (fxx0 - fxx1)) * rax;
  }
}

// Stage 2, per interface over [F, Ny+1, Nx+1, K]: fx = ppm_flux(q_i, crx)
// times mfx (or xfx when mfx is null) for field 0, times field 0's fx (or
// xfx with second_area) for field 1; fy likewise from q_j.
__global__ void __launch_bounds__(kThreads)
fv_flux(Metrics m, int F, int Ny, int Nx, int K, FvFields fv,
        const float* __restrict__ u, const float* __restrict__ v,
        const float* __restrict__ mfx, const float* __restrict__ mfy,
        float dt, int hord) {
  int f, j, i, k;
  if (!decode(F, Ny + 1, Nx + 1, K, f, j, i, k)) return;
  if (j < Ny) {  // x-interface (j, i)
    const long long o = off(Ny, Nx + 1, K, f, j, i, k);
    const float uu = u[o];
    const float crx = uu * dt * met(m, RDXC, f, j, i);
    const float xfx = uu * dt * met(m, DY, f, j, i);
    float w = mfx ? mfx[o] : xfx;
    for (int n = 0; n < fv.nf; ++n) {
      const Arr qi = {fv.q_i[n], Ny, Nx, K};
      const float flux = ppm_flux(line_x(qi, f, j, k), i, crx, hord) * w;
      fv.fx[n][o] = flux;
      if (n == 0) w = fv.second_area ? xfx : flux;
    }
  }
  if (i < Nx) {  // y-interface (j, i)
    const long long o = off(Ny + 1, Nx, K, f, j, i, k);
    const float vv = v[o];
    const float cry = vv * dt * met(m, RDYC, f, j, i);
    const float yfx = vv * dt * met(m, DX, f, j, i);
    float w = mfy ? mfy[o] : yfx;
    for (int n = 0; n < fv.nf; ++n) {
      const Arr qj = {fv.q_j[n], Ny, Nx, K};
      const float flux = ppm_flux(line_y(qj, f, i, k), j, cry, hord) * w;
      fv.fy[n][o] = flux;
      if (n == 0) w = fv.second_area ? yfx : flux;
    }
  }
}

// Stages 1 and 2 back to back on stream s.
__host__ __forceinline__ cudaError_t launch_fvtp2d(
    const Metrics& m, int F, int Ny, int Nx, int K, const FvFields& fv,
    const float* u, const float* v, const float* mfx, const float* mfy,
    float dt, int hord, cudaStream_t s) {
  fv_inner<<<blocks_for((long long)F * Ny * Nx * K), kThreads, 0, s>>>(
      m, F, Ny, Nx, K, fv, u, v, dt, hord);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fv_flux<<<blocks_for((long long)F * (Ny + 1) * (Nx + 1) * K), kThreads, 0,
            s>>>(m, F, Ny, Nx, K, fv, u, v, mfx, mfy, dt, hord);
  return cudaGetLastError();
}

// Common argument checks of the C entries; 0 when the launch may go on.
__host__ __forceinline__ int check_grid(int F, int Ny, int Nx, int K) {
  if (F < 1 || Ny < 4 || Nx < 4 || K < 1) return (int)cudaErrorInvalidValue;
  if ((long long)F * (Ny + 1) * (Nx + 1) * K >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace
