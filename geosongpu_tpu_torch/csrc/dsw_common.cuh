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
// * The horizontal stencil stages (csw1, csw2_winds, fvtp2d_tile,
//   wind_update) work on shared-memory tiles of points, k fastest, so that
//   a warp reads neighbouring addresses; the per-cell updates run one
//   thread per (f, j, i, k) point.  The column
//   stages (hydro_columns here, nh_columns in dsw_nh_pert.cu) take a tile
//   of neighbouring columns per block (column_tile.cuh) and share its
//   staging and the pe sum (stage_columns_pe).
#pragma once

#include <cuda_runtime.h>

#include "column_tile.cuh"

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
};

__device__ __forceinline__ long long off(int R, int C, int K, int f, int j,
                                         int i, int k) {
  return (((long long)f * R + j) * C + i) * K + k;
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

// edge_ord4 and ppm_flux take a line of cells as any type with
// operator()(cell) and the line's length n: a TileLine of a staged tile.

// _edges_ord4: al[c] = 7/12 (q[c-1] + q[c]) - 1/12 (q[c-2] + q[c+1])
template <class L>
__device__ __forceinline__ float edge_ord4(const L& q, int c) {
  return kC712 * (q(c - 1) + q(c)) - kC112 * (q(c - 2) + q(c + 1));
}

// The PPM value at an interface with Courant number c from the upwind
// cell's mean qc and edges aL, aR (aR = al shifted by +1 with edge
// replication), as _ppm_coeffs (the hord-8 limiter, then a6) and ppm_flux
// form it.
__device__ __forceinline__ float ppm_value(float c, float qc, float aL,
                                          float aR, int hord) {
  float a6;
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
  if (c >= 0.0f) {
    const float cpos = fmaxf(c, 0.0f);
    return aR - 0.5f * cpos * ((aR - aL) - (1.0f - kC23 * cpos) * a6);
  }
  const float cneg = fmaxf(-c, 0.0f);
  return aL + 0.5f * cneg * ((aR - aL) + (1.0f - kC23 * cneg) * a6);
}

// ppm_flux at interface i (between cells i-1 and i) of a line, Courant c,
// the upwind cell's edges computed from the line.
template <class L>
__device__ __forceinline__ float ppm_flux(const L& q, int i, float c,
                                          int hord) {
  const int cc = clampi(c >= 0.0f ? i - 1 : i, 0, q.n - 1);
  return ppm_value(c, q(cc), edge_ord4(q, cc),
                   edge_ord4(q, clampi(cc + 1, 0, q.n - 1)), hord);
}

// Lines of a staged tile whose every slot holds the value of the clamped
// cell (a slot past the face repeats the edge cell, as _shift and _iface
// do), S floats from cell to cell: edge_ord4 at the cell q points to, and
// ppm_flux at interface i of a line of n cells from its cell means q0 and
// stored edges al0, both pointing at cell 0.
template <int S>
__device__ __forceinline__ float edge_at(const float* q) {
  return kC712 * (q[-S] + q[0]) - kC112 * (q[-2 * S] + q[S]);
}

template <int S>
__device__ __forceinline__ float ppm_line(const float* q0, const float* al0,
                                          int i, int n, float c, int hord) {
  const int cc = clampi(c >= 0.0f ? i - 1 : i, 0, n - 1);
  return ppm_value(c, q0[cc * S], al0[cc * S], al0[(cc + 1) * S], hord);
}

// upwind_flux: first-order upwind interface value
template <class L>
__device__ __forceinline__ float upwind(const L& q, int i, float c) {
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
// csw1 (dsw_csw1.cu), csw2_winds (dsw_csw2.cu), fvtp2d_tile (below) and
// wind_update (dsw_wind.cu) give one block a tile of kTJ x kTI output points
// of one face and walk K in chunks of kTK
// levels; the thread index runs over the chunk's levels first, then i, then
// j, so a warp still reads runs along K.  Per chunk the block stages the
// centre cells its points need (the tile and a rim) in shared memory,
// derives each resampled or corner value once per cell of the tile there,
// and only then forms its points.  A staged cell outside the face holds the
// value at the clamped index, as a clamped read gives it; the derived values of such
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
// cells, clamped to the line as _shift and _iface replicate the edge cells,
// lies at base[(c - first) stride].
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

// The column stages' common start, for a block of T threads: stage NR
// arrays [ncol, K] of the block's nc columns (from column col0) into the row
// blocks dst[r] (column c at c Kp), then pe of the lower interface of each
// layer into the row block pe: ptop plus the running sum of the staged row
// dp, kept in double and rounded once, one thread per column (pe may be dp
// itself).  Ends with a barrier.
template <int T, int NR>
__device__ __forceinline__ void stage_columns_pe(
    const float* const (&src)[NR], float* const (&dst)[NR],
    const float* dp, float* pe, long long col0, int nc, int K, int Kp,
    float ptop) {
  const long long base = col0 * K;
  for_tile_elements<T>(nc * K, K, [&](int e, int c, int k) {
#pragma unroll
    for (int r = 0; r < NR; ++r) dst[r][c * Kp + k] = src[r][base + e];
  });
  __syncthreads();
  if ((int)threadIdx.x < nc) {
    const float* x = dp + threadIdx.x * Kp;
    float* y = pe + threadIdx.x * Kp;
    double s = 0.0;
    for (int k = 0; k < K; ++k) {
      s += (double)x[k];
      y[k] = ptop + (float)s;
    }
  }
  __syncthreads();
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

  stage_columns_pe<kColThreads, 2>({delp, pt}, {a, d}, a, a, col0, nc, K,
                                   Kp, ptop);
  const float rp00 = 1.0f / p00;
  for_tile_elements<kColThreads>(n, K, [&](int, int c, int k) {
    const float pe = a[c * Kp + k];
    b[c * Kp + k] = powf(pe * rp00, kappa);
    a[c * Kp + k] = logf(pe);
  });
  __syncthreads();
  const float pk_top = powf(ptop * rp00, kappa);
  const float ln_top = logf(ptop);
  for_tile_elements<kColThreads>(n, K, [&](int e, int c, int k) {
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
  for_tile_elements<kColThreads>(n, K, [&](int e, int c, int k) {
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

// ---- fvtp2d (ops/fvtp2d.py) on a tile ---------------------------------
//
// Courant numbers and area fluxes are rebuilt from the advective winds u
// ([F, Ny, Nx+1, K]) and v ([F, Ny+1, Nx, K]) with the plain expressions
// crx = u dt rdxc, xfx = u dt dy, cry = v dt rdyc, yfx = v dt dx.
// Up to two fields are transported together.  Field 0's outer fluxes are
// weighted by the mass flux passed to the launch, or by the area flux when
// there is none; field 1's by field 0's fluxes (pt by the mass flux of delp
// in dsw_transport), or, with second_area set, by the area flux (delz
// beside the mass-weighted w in the nonhydrostatic pass).
//
// fvtp2d_tile gives a block the x-interfaces and y-interfaces of kTJ x kTI
// points (j0.., i0..) of one face - the corner-sized union, as wind_update's
// points - and walks K in chunks of kTK levels.  The outer flux fx at
// x-interface i reads the inner update q_i at cells i-3 .. i+2 of its row,
// and q_i at a cell reads qy at rows j-3 .. j+3 of its column; fy and q_j
// likewise with the axes swapped.  So per chunk the block stages qy, qx, u
// and v over the tile with a rim of 3 and derives, each value once, in
// shared memory: (1) the order-4 PPM edges of qy along y and of qx along x
// per cell, (2) fyy per y-interface and fxx per x-interface (the limiter on
// the upwind cell's stored edges), (3) q_i and q_j per cell of the tile and
// its x-rim or y-rim, (4) the edges of q_i along x and of q_j along y, and
// (5) fx and fy at the thread's point.  q_i and q_j never leave shared
// memory.  Each phase runs over every field before the barrier that ends
// it, its elements in an unrolled loop, so that a thread has independent
// work to issue while a shared-memory read is in flight.
//
// A staged cell outside the face holds the clamped cell, and each derived
// tile slot is computed at the clamped cell of its line, so that every slot
// holds the value of the clamped cell and the phases read their lines
// without clamping (edge_at, ppm_line); only the upwind cell of a flux is
// clamped, as in ppm_flux.  So each value is the plain version's to the bit.
constexpr int kMaxFv = 2;

struct FvFields {
  const float* qx[kMaxFv];  // x-order fills [F, Ny, Nx, K]
  const float* qy[kMaxFv];  // y-order fills
  float* fx[kMaxFv];        // [F, Ny, Nx+1, K]
  float* fy[kMaxFv];        // [F, Ny+1, Nx, K]
  int nf;
  int second_area;          // field 1 takes the area flux as its weight
};

// The staged and derived regions of fvtp2d_tile, rows x columns from a
// first cell relative to (j0, i0):
constexpr int kFvQyJ = kTJ + 6, kFvQyI = kTI + 5;  // qy cells from (-3, -3)
constexpr int kFvQxJ = kTJ + 5, kFvQxI = kTI + 6;  // qx cells from (-3, -3)
constexpr int kFvVJ = kTJ + 1, kFvVI = kTI + 5;    // v, fyy from (0, -3)
constexpr int kFvUJ = kTJ + 5, kFvUI = kTI + 1;    // u, fxx from (-3, 0)
constexpr int kFvAyJ = kTJ + 3, kFvAyI = kTI + 5;  // edges of qy from (-1, -3)
constexpr int kFvAxJ = kTJ + 5, kFvAxI = kTI + 3;  // edges of qx from (-3, -1)
constexpr int kFvQiI = kTI + 5;                    // q_i: kTJ rows from (0, -3)
constexpr int kFvQjJ = kTJ + 5;                    // q_j: kTI cols from (-3, 0)
constexpr int kFvEiI = kTI + 2;                    // edges of q_i from (0, -1)
constexpr int kFvEjJ = kTJ + 2;                    // edges of q_j from (-1, 0)
constexpr int kFvAreaJ = kTJ + 5, kFvAreaI = kTI + 5;  // area from (-3, -3)
using FvQyPlan = StagePlan<kFvQyJ, kFvQyI>;
using FvQxPlan = StagePlan<kFvQxJ, kFvQxI>;
using FvVPlan = StagePlan<kFvVJ, kFvVI>;
using FvUPlan = StagePlan<kFvUJ, kFvUI>;
// buffer a of a field holds the edges of qy and qx, then q_i and q_j;
// buffer b fyy and fxx, then the edges of q_i and q_j
constexpr int kFvACells =
    kFvAyJ * kFvAyI + kFvAxJ * kFvAxI > kTJ * kFvQiI + kFvQjJ * kTI
        ? kFvAyJ * kFvAyI + kFvAxJ * kFvAxI
        : kTJ * kFvQiI + kFvQjJ * kTI;
constexpr int kFvBCells =
    kFvVJ * kFvVI + kFvUJ * kFvUI > kTJ * kFvEiI + kFvEjJ * kTI
        ? kFvVJ * kFvVI + kFvUJ * kFvUI
        : kTJ * kFvEiI + kFvEjJ * kTI;

template <int NF>
struct FvTiles {
  float qy[NF][FvQyPlan::kCount];
  float qx[NF][FvQxPlan::kCount];
  float u[FvUPlan::kCount];
  float v[FvVPlan::kCount];
  float a[NF][kFvACells * kTK];
  float b[NF][kFvBCells * kTK];
  float rdyc[kFvVJ * kFvVI];  // at the staged v
  float dx[kFvVJ * kFvVI];
  float rdxc[kFvUJ * kFvUI];  // at the staged u
  float dy[kFvUJ * kFvUI];
  float area[kFvAreaJ * kFvAreaI];
};

// fn(e, jj, ii) for the thread's elements e of an NJ x NI tile of cells,
// level lane threadIdx.x % kTK of cell (jj, ii).
template <int NJ, int NI, class Fn>
__device__ __forceinline__ void tile_cells(Fn fn) {
  constexpr int kCount = NJ * NI * kTK;
#pragma unroll
  for (int r = 0; r < (kCount + kTileThreads - 1) / kTileThreads; ++r) {
    const int e = threadIdx.x + r * kTileThreads;
    if (e < kCount) {
      const int cell = e / kTK;
      fn(e, cell / NI, cell % NI);
    }
  }
}

template <int NF>
__global__ void __launch_bounds__(kTileThreads)
fvtp2d_tile(Metrics m, int F, int Ny, int Nx, int K, FvFields fv,
            const float* __restrict__ u, const float* __restrict__ v,
            const float* __restrict__ mfx, const float* __restrict__ mfy,
            float dt, int hord) {
  extern __shared__ float fv_smem[];
  FvTiles<NF>& t = *reinterpret_cast<FvTiles<NF>*>(fv_smem);
  const int f = blockIdx.z, j0 = blockIdx.y * kTJ, i0 = blockIdx.x * kTI;
  const int tid = threadIdx.x, kl = tid % kTK;

  FvQyPlan qy_plan;
  FvQxPlan qx_plan;
  FvUPlan u_plan;
  FvVPlan v_plan;
  qy_plan.init(Ny, Nx, K, f, j0 - 3, i0 - 3);
  qx_plan.init(Ny, Nx, K, f, j0 - 3, i0 - 3);
  u_plan.init(Ny, Nx + 1, K, f, j0 - 3, i0);
  v_plan.init(Ny + 1, Nx, K, f, j0, i0 - 3);
  stage_metric<kFvVJ, kFvVI>(t.rdyc, m, RDYC, f, j0, i0 - 3);
  stage_metric<kFvVJ, kFvVI>(t.dx, m, DX, f, j0, i0 - 3);
  stage_metric<kFvUJ, kFvUI>(t.rdxc, m, RDXC, f, j0 - 3, i0);
  stage_metric<kFvUJ, kFvUI>(t.dy, m, DY, f, j0 - 3, i0);
  stage_metric<kFvAreaJ, kFvAreaI>(t.area, m, AREA, f, j0 - 3, i0 - 3);
  // field n's derived tiles
  const auto aly = [&](int n) { return t.a[n]; };  // edges of qy, then q_i
  const auto alx = [&](int n) { return t.a[n] + kFvAyJ * kFvAyI * kTK; };
  const auto qi = [&](int n) { return t.a[n]; };
  const auto qj = [&](int n) { return t.a[n] + kTJ * kFvQiI * kTK; };
  const auto fyy = [&](int n) { return t.b[n]; };  // fyy, then edges of q_i
  const auto fxx = [&](int n) { return t.b[n] + kFvVJ * kFvVI * kTK; };
  const auto ali = [&](int n) { return t.b[n]; };
  const auto alj = [&](int n) { return t.b[n] + kTJ * kFvEiI * kTK; };

  // the thread's point (j, i): x-interface (j, i) between cells i-1 and i,
  // y-interface (j, i) between cells j-1 and j
  const int ti = (tid / kTK) % kTI, tj = tid / (kTK * kTI);
  const int j = j0 + tj, i = i0 + ti;
  const bool on_x = j < Ny && i <= Nx, on_y = i < Nx && j <= Ny;
  const int ox = on_x ? cell_off(Ny, Nx + 1, K, f, j, i) : -1;
  const int oy = on_y ? cell_off(Ny + 1, Nx, K, f, j, i) : -1;
  const float rdxc = on_x ? met32(m, RDXC, f, j, i) : 0.0f;
  const float dy = on_x ? met32(m, DY, f, j, i) : 0.0f;
  const float rdyc = on_y ? met32(m, RDYC, f, j, i) : 0.0f;
  const float dx = on_y ? met32(m, DX, f, j, i) : 0.0f;
  // cell 0 of the thread's q_i row and q_j column and of their edges
  const int qi_row = tile_at(kFvQiI, tj, 3 - i0, kl);
  const int ali_row = tile_at(kFvEiI, tj, 1 - i0, kl);
  const int qj_col = tile_at(kTI, 3 - j0, ti, kl);
  const int alj_col = tile_at(kTI, 1 - j0, ti, kl);

  // Registers for the next chunk's values, fetched while this one computes.
  float n_qy[NF][FvQyPlan::kPer], n_qx[NF][FvQxPlan::kPer];
  float n_u[FvUPlan::kPer], n_v[FvVPlan::kPer];
  float n_mx = 0.0f, n_my = 0.0f;
  const auto fetch = [&](int k) {
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      qy_plan.fetch(n_qy[n], fv.qy[n], k);
      qx_plan.fetch(n_qx[n], fv.qx[n], k);
    }
    u_plan.fetch(n_u, u, k);
    v_plan.fetch(n_v, v, k);
    if (mfx != nullptr && on_x) n_mx = mfx[ox + k];
    if (mfy != nullptr && on_y) n_my = mfy[oy + k];
  };
  fetch(min(kl, K - 1));
  for (int k0 = 0; k0 < K; k0 += kTK) {
    // the tiles committed here were last read before the barrier that
    // ended phase (3) of the previous chunk
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      qy_plan.commit(t.qy[n], n_qy[n]);
      qx_plan.commit(t.qx[n], n_qx[n]);
    }
    u_plan.commit(t.u, n_u);
    v_plan.commit(t.v, n_v);
    const float mx = n_mx, my = n_my;
    __syncthreads();
    if (k0 + kTK < K) fetch(min(k0 + kTK + kl, K - 1));
    const int k = k0 + kl;
    // the thread's winds, read before any later barrier
    const float uu = t.u[tile_at(kFvUI, tj + 3, ti, kl)];
    const float vv = t.v[tile_at(kFvVI, tj, ti + 3, kl)];
    // Each phase runs over all fields before the barrier that ends it.
    // (1) edges of qy along y and of qx along x
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      const float* qy = t.qy[n];
      const float* qx = t.qx[n];
      tile_cells<kFvAyJ, kFvAyI>([&](int e, int jj, int ii) {
        const int c = min(j0 - 1 + jj, Ny - 1);
        aly(n)[e] = edge_at<kFvQyI * kTK>(
            qy + tile_at(kFvQyI, c - (j0 - 3), ii, kl));
      });
      tile_cells<kFvAxJ, kFvAxI>([&](int e, int jj, int ii) {
        const int c = min(i0 - 1 + ii, Nx - 1);
        alx(n)[e] = edge_at<kTK>(qx + tile_at(kFvQxI, jj, c - (i0 - 3), kl));
      });
    }
    __syncthreads();
    // (2) fyy = ppm_flux(qy, cry) yfx per y-interface, fxx per x-interface
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      const float* qy = t.qy[n];
      const float* qx = t.qx[n];
      tile_cells<kFvVJ, kFvVI>([&](int e, int jj, int ii) {
        const float w = t.v[e];
        const int c = jj * kFvVI + ii;
        const float cry = w * dt * t.rdyc[c];
        const float yfx = w * dt * t.dx[c];
        fyy(n)[e] = ppm_line<kFvQyI * kTK>(
                        qy + tile_at(kFvQyI, 3 - j0, ii, kl),
                        aly(n) + tile_at(kFvAyI, 1 - j0, ii, kl), j0 + jj, Ny,
                        cry, hord) * yfx;
      });
      tile_cells<kFvUJ, kFvUI>([&](int e, int jj, int ii) {
        const float w = t.u[e];
        const int c = jj * kFvUI + ii;
        const float crx = w * dt * t.rdxc[c];
        const float xfx = w * dt * t.dy[c];
        fxx(n)[e] = ppm_line<kTK>(qx + tile_at(kFvQxI, jj, 3 - i0, kl),
                                  alx(n) + tile_at(kFvAxI, jj, 1 - i0, kl),
                                  i0 + ii, Nx, crx, hord) * xfx;
      });
    }
    __syncthreads();
    // (3) q_i = (qy area + ddy(fyy)) / (area + ddy(yfx)) per cell of the
    // tile and its x-rim, q_j likewise along x
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      const float* qy = t.qy[n];
      const float* qx = t.qx[n];
      tile_cells<kTJ, kFvQiI>([&](int e, int jj, int ii) {
        const float area = t.area[(jj + 3) * kFvAreaI + ii];
        const int s0 = tile_at(kFvVI, jj, ii, kl), s1 = s0 + kFvVI * kTK;
        const float yfx0 = t.v[s0] * dt * t.dx[jj * kFvVI + ii];
        const float yfx1 = t.v[s1] * dt * t.dx[(jj + 1) * kFvVI + ii];
        const float ray = 1.0f / (area + (yfx0 - yfx1));
        qi(n)[e] = (qy[tile_at(kFvQyI, jj + 3, ii, kl)] * area +
                    (fyy(n)[s0] - fyy(n)[s1])) * ray;
      });
      tile_cells<kFvQjJ, kTI>([&](int e, int jj, int ii) {
        const float area = t.area[jj * kFvAreaI + ii + 3];
        const int s0 = tile_at(kFvUI, jj, ii, kl), s1 = s0 + kTK;
        const float xfx0 = t.u[s0] * dt * t.dy[jj * kFvUI + ii];
        const float xfx1 = t.u[s1] * dt * t.dy[jj * kFvUI + ii + 1];
        const float rax = 1.0f / (area + (xfx0 - xfx1));
        qj(n)[e] = (qx[tile_at(kFvQxI, jj, ii + 3, kl)] * area +
                    (fxx(n)[s0] - fxx(n)[s1])) * rax;
      });
    }
    __syncthreads();
    // (4) edges of q_i along x and of q_j along y
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      tile_cells<kTJ, kFvEiI>([&](int e, int jj, int ii) {
        const int c = min(i0 - 1 + ii, Nx - 1);
        ali(n)[e] =
            edge_at<kTK>(qi(n) + tile_at(kFvQiI, jj, c - (i0 - 3), kl));
      });
      tile_cells<kFvEjJ, kTI>([&](int e, int jj, int ii) {
        const int c = min(j0 - 1 + jj, Ny - 1);
        alj(n)[e] =
            edge_at<kTI * kTK>(qj(n) + tile_at(kTI, c - (j0 - 3), ii, kl));
      });
    }
    __syncthreads();
    // (5) fx = ppm_flux(q_i, crx) w and fy = ppm_flux(q_j, cry) w at the
    // thread's interfaces; field 1 is weighted by field 0's fluxes or the
    // area fluxes.  The next chunk's phase (1) comes after its own barrier.
    if (k >= K) continue;
    if (on_x) {
      const float crx = uu * dt * rdxc;
      const float xfx = uu * dt * dy;
      float w = mfx != nullptr ? mx : xfx;
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        const float flux =
            ppm_line<kTK>(qi(n) + qi_row, ali(n) + ali_row, i, Nx, crx,
                          hord) * w;
        fv.fx[n][ox + k] = flux;
        w = fv.second_area ? xfx : flux;
      }
    }
    if (on_y) {
      const float cry = vv * dt * rdyc;
      const float yfx = vv * dt * dx;
      float w = mfy != nullptr ? my : yfx;
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        const float flux =
            ppm_line<kTI * kTK>(qj(n) + qj_col, alj(n) + alj_col, j, Ny, cry,
                                hord) * w;
        fv.fy[n][oy + k] = flux;
        w = fv.second_area ? yfx : flux;
      }
    }
  }
}

template <int NF>
cudaError_t launch_fv_tile(const Metrics& m, int F, int Ny, int Nx, int K,
                           const FvFields& fv, const float* u, const float* v,
                           const float* mfx, const float* mfy, float dt,
                           int hord, cudaStream_t s) {
  const size_t bytes = sizeof(FvTiles<NF>);
  cudaError_t err = cudaFuncSetAttribute(
      fvtp2d_tile<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  fvtp2d_tile<NF><<<tile_grid(F, Ny + 1, Nx + 1), kTileThreads, bytes, s>>>(
      m, F, Ny, Nx, K, fv, u, v, mfx, mfy, dt, hord);
  return cudaGetLastError();
}

// fvtp2d of fv.nf (1 or 2) fields on stream s, one launch; with two fields
// the tiles need more than the 48 KB of shared memory a launch gets without
// opting in.
__host__ __forceinline__ cudaError_t launch_fvtp2d(
    const Metrics& m, int F, int Ny, int Nx, int K, const FvFields& fv,
    const float* u, const float* v, const float* mfx, const float* mfy,
    float dt, int hord, cudaStream_t s) {
  return fv.nf == 2
             ? launch_fv_tile<2>(m, F, Ny, Nx, K, fv, u, v, mfx, mfy, dt,
                                 hord, s)
             : launch_fv_tile<1>(m, F, Ny, Nx, K, fv, u, v, mfx, mfy, dt,
                                 hord, s);
}

// Common argument checks of the C entries; 0 when the launch may go on.
__host__ __forceinline__ int check_grid(int F, int Ny, int Nx, int K) {
  if (F < 1 || Ny < 4 || Nx < 4 || K < 1) return (int)cudaErrorInvalidValue;
  if ((long long)F * (Ny + 1) * (Nx + 1) * K >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace
