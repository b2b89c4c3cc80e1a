// The A-grid winds of a substep, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference forms the A-grid winds as XLA
// glue before its first substep kernel (geosongpu_tpu/dycore/sw_pallas.py:
// 475-479, the full-array form of dycore/sw.py:606 `a_grid_winds`).  In
// the port that glue was 44 full-field PyTorch launches a call (the two
// averages, the halo basis rotation, the y and x chart resamples with
// their edge-padding copies), each moving a whole [F, Ny, Nx, K] field
// through device memory.  This kernel computes exactly
// geosongpu_tpu_torch/ops/kernels/dsw.py::agrid_winds_plain, which is
// dycore/sw.py::a_grid_winds, in one launch:
//
//   ua = 0.5 (pu[j] + pu[j+1]),  va = 0.5 (pv[i] + pv[i+1]);
//   (ua, va) <- (ua + (dr11 ua + r12 va), va + (r21 ua + dr22 va));
//   a <- a + (jwm (a[j-1] - a) + jwp (a[j+1] - a))   rows clamped, then
//   a <- a + (iwm (a[i-1] - a) + iwp (a[i+1] - a))   columns clamped,
//
// each operation in the plain version's order, built with --fmad=false.
// No term is skipped where a weight is zero: 0 x (am - a) added to -0.0
// gives +0.0 there, as in the plain version, so the result is the plain
// version's bit for bit, signed zeros included.  The edge replication of
// the plain version's _pad_edge is a clamped index: at the first and last
// row and column am - a is exactly 0.  Any F (six faces or the stacked
// blocks of a sharded step), Ny, Nx and K: on a stacked block the resample
// reads a block's own halo cells as the plain version does.
//
// What bounds it on this card: its bytes.  A c192-L72 call reads pu and pv
// and writes ua and va once (4 x ~68 MB) and reads the eight 2-D metrics
// dr11, r12, r21, dr22, jwm, jwp, iwm, iwp (7.5 MB): 279 MB, 0.083 ms at
// 3.35 TB/s, for 32 operations a point.
//
// Design: K is the contiguous innermost axis, so threads run along K: a
// block of (kvc, kAgThreads / kvc) threads takes kvc runs of V levels of a
// chunk of at most kAgChunk levels (V = 4, 16-byte accesses, where K is a
// multiple of 4 and the arrays are 16-byte aligned; V = 1 otherwise, as
// for JW06's 26 levels) for a tile of kAgTJ x kAgTI cells of one slot.  It
// stages pu for (kAgTJ + 3) x (kAgTI + 2) cells and pv for (kAgTJ + 2) x
// (kAgTI + 3), rims included, and the eight metrics of the cells each
// stage reads, in shared memory, with asynchronous copies that every
// thread starts before it waits once; forms the averaged and rotated ua,
// va of the (kAgTJ + 2) x (kAgTI + 2) cells around the tile there, every
// slot the value of its clamped cell; y-resamples them into kAgTJ x (kAgTI
// + 2) slots over the staged pu and pv; and x-resamples into registers,
// writing ua and va once.  A block reads each metric once a cell, for all
// its levels.  Every global read and write is a run along K shared by
// neighbouring threads.
#include "dsw_common.cuh"

namespace {

constexpr int kAgTJ = 8, kAgTI = 8;  // cells of a block's tile
constexpr int kAgThreads = 192;
constexpr int kAgChunk = 24;         // at most this many levels a block
// the staged tiles, in cells: pu and pv from (j0 - 1, i0 - 1), the rotated
// winds from (j0 - 1, i0 - 1), the y-resampled winds from (j0, i0 - 1)
constexpr int kAgPuI = kAgTI + 2, kAgPuCells = (kAgTJ + 3) * kAgPuI;
constexpr int kAgPvI = kAgTI + 3, kAgPvCells = (kAgTJ + 2) * kAgPvI;
constexpr int kAgAI = kAgTI + 2, kAgACells = (kAgTJ + 2) * kAgAI;
constexpr int kAgBCells = kAgTJ * kAgAI;
// the y-resampled winds take the place of pu and pv, whose last reads
// precede the barrier before they are written
constexpr int kAgStage = kAgPuCells + kAgPvCells > 2 * kAgBCells
                             ? kAgPuCells + kAgPvCells
                             : 2 * kAgBCells;
constexpr int kAgCells = kAgStage + 2 * kAgACells;
// the metrics of each stage's cells, staged once a block: dr11, r12, r21,
// dr22 of the rotated cells, jwm and jwp of the y-resampled ones, iwm and
// iwp of the tile's
constexpr int kAgOut = kAgTJ * kAgTI;
constexpr int kAgMetrics = 4 * kAgACells + 2 * kAgBCells + 2 * kAgOut;

// V neighbouring levels of one cell
template <int V>
struct Levels {
  float x[V];
};

template <int V>
__device__ __forceinline__ Levels<V> load(const float* p) {
  Levels<V> r;
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r.x[0] = t.x;
    r.x[1] = t.y;
    r.x[2] = t.z;
    r.x[3] = t.w;
  } else {
    r.x[0] = *p;
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store(float* p, const Levels<V>& r) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.x[0], r.x[1], r.x[2], r.x[3]);
  } else {
    *p = r.x[0];
  }
}

// the V floats at src into dst, as an asynchronous copy from device into
// shared memory (cp.async; V = 4: 16 bytes through L2 alone): a thread
// starts every copy of its part of the tiles before it waits for them
template <int V>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  if constexpr (V == 4) {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                 "l"(src)
                 : "memory");
#else
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
#endif
  } else {
    async_copy4(dst, src);
  }
}

// n values of a centred [F, Ny, Nx] metric field p of slot f from cell (jb,
// ib), ni a row, each the value of its clamped cell, into t: thread tid of
// nt copies its share asynchronously
__device__ __forceinline__ void copy_metric_async(float* t, const float* p,
                                                  int n, int ni, int f,
                                                  int Ny, int Nx, int jb,
                                                  int ib, int tid, int nt) {
  for (int e = tid; e < n; e += nt) {
    const int j = clampi(jb + e / ni, 0, Ny - 1);
    const int i = clampi(ib + e % ni, 0, Nx - 1);
    async_copy4(t + e, p + (f * Ny + j) * Nx + i);
  }
}

// _resample_y_strip / _resample_x_strip at one cell: a + (wm (am - a) +
// wp (ap - a)), am and ap the neighbours on the two sides
template <int V>
__device__ __forceinline__ Levels<V> resample(const Levels<V>& am,
                                              const Levels<V>& a,
                                              const Levels<V>& ap, float wm,
                                              float wp) {
  Levels<V> r;
#pragma unroll
  for (int q = 0; q < V; ++q)
    r.x[q] = a.x[q] + (wm * (am.x[q] - a.x[q]) + wp * (ap.x[q] - a.x[q]));
  return r;
}

template <int V>
__global__ void __launch_bounds__(kAgThreads)
agrid_winds(Metrics m, int Ny, int Nx, int K, int chunks,
            const float* __restrict__ pu, const float* __restrict__ pv,
            float* __restrict__ ua, float* __restrict__ va) {
  extern __shared__ float4 agrid_smem_[];
  float* const s = reinterpret_cast<float*>(agrid_smem_);
  const int C = blockDim.x * V;  // floats a cell of a tile holds
  const int f = blockIdx.z / chunks;
  const int j0 = blockIdx.y * kAgTJ, i0 = blockIdx.x * kAgTI;
  const int lane = threadIdx.x * V;
  const int k = (blockIdx.z % chunks) * C + lane;
  const bool live = k < K;
  float* const t_pu = s;
  float* const t_pv = s + kAgPuCells * C;
  float* const t_bu = s;
  float* const t_bv = s + kAgBCells * C;
  float* const t_ua = s + kAgStage * C;
  float* const t_va = t_ua + kAgACells * C;
  float* const t_rot = t_va + kAgACells * C;  // dr11, r12, r21, dr22
  float* const t_jw = t_rot + 4 * kAgACells;  // jwm, jwp
  float* const t_iw = t_jw + 2 * kAgBCells;   // iwm, iwp
  const auto at = [&](float* t, int cell) { return t + cell * C + lane; };

  // (1) pu and pv of the tile and its rims, and the metrics, each slot its
  // clamped cell
  if (live) {
    for (int c = threadIdx.y; c < kAgPuCells; c += blockDim.y) {
      const int j = clampi(j0 - 1 + c / kAgPuI, 0, Ny);
      const int i = clampi(i0 - 1 + c % kAgPuI, 0, Nx - 1);
      copy_async<V>(at(t_pu, c), pu + cell_off(Ny + 1, Nx, K, f, j, i) + k);
    }
    for (int c = threadIdx.y; c < kAgPvCells; c += blockDim.y) {
      const int j = clampi(j0 - 1 + c / kAgPvI, 0, Ny - 1);
      const int i = clampi(i0 - 1 + c % kAgPvI, 0, Nx);
      copy_async<V>(at(t_pv, c), pv + cell_off(Ny, Nx + 1, K, f, j, i) + k);
    }
  }
  {
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nt = blockDim.x * blockDim.y;
    const auto rot = [&](float* t, const float* p) {
      copy_metric_async(t, p, kAgACells, kAgAI, f, Ny, Nx, j0 - 1, i0 - 1,
                        tid, nt);
    };
    rot(t_rot, m.p[DR11]);
    rot(t_rot + kAgACells, m.p[R12]);
    rot(t_rot + 2 * kAgACells, m.p[R21]);
    rot(t_rot + 3 * kAgACells, m.p[DR22]);
    copy_metric_async(t_jw, m.p[JWM], kAgBCells, kAgAI, f, Ny, Nx, j0,
                      i0 - 1, tid, nt);
    copy_metric_async(t_jw + kAgBCells, m.p[JWP], kAgBCells, kAgAI, f, Ny, Nx,
                      j0, i0 - 1, tid, nt);
    copy_metric_async(t_iw, m.p[IWM], kAgOut, kAgTI, f, Ny, Nx, j0, i0, tid,
                      nt);
    copy_metric_async(t_iw + kAgOut, m.p[IWP], kAgOut, kAgTI, f, Ny, Nx, j0,
                      i0, tid, nt);
  }
  async_copy_wait();
  __syncthreads();

  // (2) the averaged and rotated winds of cell (cj, ci), the clamped cell
  // of each slot: its pu rows cj, cj + 1 and pv columns ci, ci + 1 lie in
  // the staged tiles at rows and columns from r and q
  if (live) {
    for (int c = threadIdx.y; c < kAgACells; c += blockDim.y) {
      const int cj = clampi(j0 - 1 + c / kAgAI, 0, Ny - 1);
      const int ci = clampi(i0 - 1 + c % kAgAI, 0, Nx - 1);
      const int r = cj - (j0 - 1), q = ci - (i0 - 1);
      const Levels<V> u0 = load<V>(at(t_pu, r * kAgPuI + q));
      const Levels<V> u1 = load<V>(at(t_pu, (r + 1) * kAgPuI + q));
      const Levels<V> v0 = load<V>(at(t_pv, r * kAgPvI + q));
      const Levels<V> v1 = load<V>(at(t_pv, r * kAgPvI + q + 1));
      const float dr11 = t_rot[c], r12 = t_rot[kAgACells + c];
      const float r21 = t_rot[2 * kAgACells + c];
      const float dr22 = t_rot[3 * kAgACells + c];
      Levels<V> a, b;
#pragma unroll
      for (int n = 0; n < V; ++n) {
        const float x = 0.5f * (u0.x[n] + u1.x[n]);
        const float y = 0.5f * (v0.x[n] + v1.x[n]);
        a.x[n] = x + (dr11 * x + r12 * y);
        b.x[n] = y + (r21 * x + dr22 * y);
      }
      store<V>(at(t_ua, c), a);
      store<V>(at(t_va, c), b);
    }
  }
  __syncthreads();

  // (3) the y-resample of the tile's rows over its columns and their
  // neighbours: rows j - 1, j, j + 1 of slot column ii in the rotated tiles
  if (live) {
    for (int c = threadIdx.y; c < kAgBCells; c += blockDim.y) {
      const int jj = c / kAgAI, ii = c % kAgAI, j = j0 + jj;
      if (j >= Ny) continue;
      const float wm = t_jw[c], wp = t_jw[kAgBCells + c];
      const int a0 = jj * kAgAI + ii;
      store<V>(at(t_bu, c),
               resample<V>(load<V>(at(t_ua, a0)), load<V>(at(t_ua, a0 + kAgAI)),
                           load<V>(at(t_ua, a0 + 2 * kAgAI)), wm, wp));
      store<V>(at(t_bv, c),
               resample<V>(load<V>(at(t_va, a0)), load<V>(at(t_va, a0 + kAgAI)),
                           load<V>(at(t_va, a0 + 2 * kAgAI)), wm, wp));
    }
  }
  __syncthreads();

  // (4) the x-resample of the tile's cells: columns i - 1, i, i + 1 of its
  // row in the y-resampled tiles; ua and va written once
  if (live) {
    for (int c = threadIdx.y; c < kAgOut; c += blockDim.y) {
      const int jj = c / kAgTI, ii = c % kAgTI, j = j0 + jj, i = i0 + ii;
      if (j >= Ny || i >= Nx) continue;
      const float wm = t_iw[c], wp = t_iw[kAgOut + c];
      const int b0 = jj * kAgAI + ii;
      const int o = cell_off(Ny, Nx, K, f, j, i) + k;
      store<V>(ua + o, resample<V>(load<V>(at(t_bu, b0)),
                                   load<V>(at(t_bu, b0 + 1)),
                                   load<V>(at(t_bu, b0 + 2)), wm, wp));
      store<V>(va + o, resample<V>(load<V>(at(t_bv, b0)),
                                   load<V>(at(t_bv, b0 + 1)),
                                   load<V>(at(t_bv, b0 + 2)), wm, wp));
    }
  }
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

}  // namespace

// pu [F, Ny+1, Nx, K], pv [F, Ny, Nx+1, K]; outputs ua, va [F, Ny, Nx, K].
// The level width V, the chunk of levels a block takes and the launch
// geometry follow from K and the arrays' alignment alone.  Returns the
// launch's CUDA error, 0 when launched.
extern "C" int agrid_winds_f32(const void* metrics, int F, int Ny, int Nx,
                               int K, const void* pu, const void* pv, void* ua,
                               void* va, int device, void* stream) {
  const int rc = check_grid(F, Ny, Nx, K);
  if (rc != 0) return rc;
  const bool vec = K % 4 == 0 && aligned16(pu) && aligned16(pv) &&
                   aligned16(ua) && aligned16(va);
  const int V = vec ? 4 : 1;
  // the fewest chunks of at most kAgChunk levels, then the fewest runs of
  // V levels a chunk
  const int runs = K / V, per = kAgChunk / V;
  const int chunks = (runs + per - 1) / per;
  const int kvc = (runs + chunks - 1) / chunks;
  if ((long long)F * chunks > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Metrics& m = *static_cast<const Metrics*>(metrics);
  const dim3 grid((unsigned)((Nx + kAgTI - 1) / kAgTI),
                  (unsigned)((Ny + kAgTJ - 1) / kAgTJ), (unsigned)(F * chunks));
  const dim3 block((unsigned)kvc, (unsigned)(kAgThreads / kvc));
  const size_t smem = sizeof(float) * (kAgCells * kvc * V + kAgMetrics);
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const auto wf = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    agrid_winds<4><<<grid, block, smem, s>>>(m, Ny, Nx, K, chunks, cf(pu),
                                             cf(pv), wf(ua), wf(va));
  else
    agrid_winds<1><<<grid, block, smem, s>>>(m, Ny, Nx, K, chunks, cf(pu),
                                             cf(pv), wf(ua), wf(va));
  return (int)cudaGetLastError();
}
