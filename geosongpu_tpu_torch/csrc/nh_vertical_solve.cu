// The implicit vertical acoustic solve of the nonhydrostatic substep, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference solves this system in the XLA
// glue between its kernels k3 and k4 (geosongpu_tpu/dycore/sw_pallas.py:
// 618-630, and alike dycore/sw.py:1184-1197), as the pair of jax.lax.scans
// of geosongpu_tpu/dycore/nh_solver.py:57 and :66, which its compiler runs
// on the device.  The port's plain version
// (geosongpu_tpu_torch/dycore/sw.py::nh_vertical_glue) walks the K-1
// interior interfaces from the host, eight launches an interface and two
// sweeps a call; this kernel computes the same function in one launch:
//
//   interface w = 0.5 (w[k-1] + w[k]), 0 at the lid and the ground;
//   the gas-law anchor p0 = (delp / (g max(delz, 1))) R T, with
//   T = pt pkz, pkz from pe = ptop + cumsum(delp) by pow and log, and the
//   hydrostatic mid pressure p_mid = (pe_hi + pe_lo) / 2;
//   two Newton linearisations (nh_solver.py::vertical_acoustic_solve): from
//   z* (the advected delz first, unclamped) the adiabat through the anchor
//   p* = p0 (max(delz, 1) / max(z*, 1))^gamma, its slope s = gamma p* / z*,
//   the tridiagonal a, b, c, rhs over the interior interfaces, solved by
//   Thomas (forward elimination, then back substitution), and
//   z* = delz + dt (w_top - w_bot);
//   delz clamped at 1 m and layer w = 0.5 (w_top + w_bot).
//
// To the bit: as in nh_columns (dsw_nh_pert.cu), pe is a double running sum
// rounded once (cumsum_k), pe / P00 is pe * (1/P00), ** and log are powf
// and logf; dt / (rho_i dz_i), a Python number over a tensor, is what
// PyTorch forms for it (Tensor.__rtruediv__: the reciprocal, times dt); every
// other product, sum and division keeps the plain version's operands and
// order; a clamp is x < 1 ? 1 : x, which keeps a NaN as torch.clamp does
// (fmaxf would drop it).
//
// Design: a block takes kColTile neighbouring columns (column_tile.cuh) and
// keeps eleven row blocks of C x (K | 1) floats in shared memory: 102,784
// bytes at K = 72, over the 48 KB a launch gets without opting in, so the
// launch opts in.  Two such blocks fit on an SM, as many resident columns as
// four blocks of 16 columns, but here the warp that runs the sweeps is full.
// The staging, the pe sum (stage_columns_pe), pow, log and each
// linearisation run over all (column, level) points of the tile with every
// thread; only the two sweeps of each linearisation are one thread a
// column, reading the coefficients' terms from the tile's rows, keeping c'
// and d' there and writing the solution over d'.  Outputs are written once,
// coalesced.
//
// What bounds it on this card: 4 inputs and 2 outputs of a field each (30.2
// MB at c48-L72, 9.0 us at 3.35 TB/s) against ~180 operations a point
// (benchmark/bounds.py): bytes.  The sweeps are 2 x 2 x (K - 1) dependent
// steps a column, each with a division, latency the tile does not hide;
// that is later work.
#include "dsw_common.cuh"

namespace {

constexpr int kSolveRows = 11;  // the tile's row blocks of C x (K | 1) floats
constexpr int kSolveThreads = 256;
constexpr int kNewtonIters = 2;  // vertical_acoustic_solve's n_iter

// torch.clamp(x, min=1.0): NaN stays NaN
__device__ __forceinline__ float clamp1(float x) { return x < 1.0f ? 1.0f : x; }

__global__ void __launch_bounds__(kSolveThreads)
nh_vertical_columns(long long ncol, int K, int C,
                    const float* __restrict__ w_adv,
                    const float* __restrict__ delz_adv,
                    const float* __restrict__ pt_new,
                    const float* __restrict__ delp_new, float dt, float ptop,
                    float p00, float kappa, float gamma, float grav,
                    float rdgas, float* __restrict__ w_out,
                    float* __restrict__ delz_out) {
  extern __shared__ float col_smem[];
  const int Kp = K | 1;
  const int rows = C * Kp;
  float* dp = col_smem;   // delp
  float* dz = dp + rows;  // the advected delz
  float* zt = dz + rows;  // z*
  float* p0 = zt + rows;  // the gas-law anchor
  float* ph = p0 + rows;  // the hydrostatic mid pressure
  float* wi = ph + rows;  // interface w of the layer w (slot i-1: interface i)
  float* sr = wi + rows;  // pe of the lower interface, then s = gamma p*/z*
  float* tr = sr + rows;  // pt, then the linearised p'
  float* rr = tr + rows;  // pk of the lower interface, then rho
  float* cr = rr + rows;  // the layer w, then c'
  float* xr = cr + rows;  // d', then the solution
  const long long col0 = (long long)blockIdx.x * C;
  const int nc = (int)min((long long)C, ncol - col0);
  const int n = nc * K;
  const long long base = col0 * K;
  const int tid = threadIdx.x;

  stage_columns_pe<kSolveThreads, 4>({delp_new, pt_new, delz_adv, w_adv},
                                     {dp, tr, dz, cr}, dp, sr, col0, nc, K,
                                     Kp, ptop);
  const float rp00 = 1.0f / p00;
  for_tile_elements<kSolveThreads>(n, K, [&](int, int c, int k) {
    rr[c * Kp + k] = powf(sr[c * Kp + k] * rp00, kappa);
  });
  __syncthreads();
  // nh_solver.py::full_pressure, the interface w, z* = delz
  const float pk_top = powf(ptop * rp00, kappa);
  const float ln_top = logf(ptop);
  for_tile_elements<kSolveThreads>(n, K, [&](int, int c, int k) {
    const int o = c * Kp + k;
    const float pe_hi = sr[o];
    const float pe_lo = k > 0 ? sr[o - 1] : ptop;
    const float pk_lo = k > 0 ? rr[o - 1] : pk_top;
    const float ln_lo = k > 0 ? logf(pe_lo) : ln_top;
    const float pkz = (rr[o] - pk_lo) / (kappa * (logf(pe_hi) - ln_lo));
    const float t = tr[o] * pkz;
    const float rho = dp[o] / (grav * clamp1(dz[o]));
    p0[o] = rho * rdgas * t;
    ph[o] = 0.5f * (pe_hi + pe_lo);
    zt[o] = dz[o];
    if (k < K - 1) wi[o] = 0.5f * (cr[o] + cr[o + 1]);
  });
  __syncthreads();

  for (int it = 0; it < kNewtonIters; ++it) {
    // the linearisation of p' around z* at every layer
    for_tile_elements<kSolveThreads>(n, K, [&](int, int c, int k) {
      const int o = c * Kp + k;
      const float z = zt[o];
      const float zs = clamp1(z);
      const float p_star = p0[o] * powf(clamp1(dz[o]) / zs, gamma);
      const float s = gamma * p_star / zs;
      tr[o] = p_star - ph[o] - s * (dz[o] - z);
      sr[o] = s;
      rr[o] = dp[o] / (grav * zs);
    });
    __syncthreads();
    // Thomas over the interior interfaces, one thread a column: interface
    // j + 1 lies between layers j (above) and j + 1 (below)
    if (tid < nc) {
      const int b0 = tid * Kp;
      float cp = 0.0f, dq = 0.0f;
      for (int j = 0; j < K - 1; ++j) {
        const int o = b0 + j;
        const float rho_i = 0.5f * (rr[o] + rr[o + 1]);
        const float dz_i = 0.5f * (zt[o] + zt[o + 1]);
        const float alpha = (1.0f / (rho_i * dz_i)) * dt;
        const float up = dt * sr[o];
        const float dn = dt * sr[o + 1];
        const float b = 1.0f + alpha * (up + dn);
        const float a = -alpha * up;
        const float cc = -alpha * dn;
        const float d = wi[o] + alpha * (tr[o + 1] - tr[o]);
        const float denom = b - a * cp;
        dq = (d - a * dq) / denom;
        cp = cc / denom;
        cr[o] = cp;
        xr[o] = dq;
      }
      float x = 0.0f;
      for (int j = K - 2; j >= 0; --j) {
        x = xr[b0 + j] - cr[b0 + j] * x;
        xr[b0 + j] = x;
      }
    }
    __syncthreads();
    // z* from the solved interface w; the last linearisation's is the result
    const bool last = it == kNewtonIters - 1;
    for_tile_elements<kSolveThreads>(n, K, [&](int e, int c, int k) {
      const int o = c * Kp + k;
      const float top = k > 0 ? xr[o - 1] : 0.0f;
      const float bot = k < K - 1 ? xr[o] : 0.0f;
      const float z = dz[o] + dt * (top - bot);
      zt[o] = z;
      if (last) {
        delz_out[base + e] = clamp1(z);
        w_out[base + e] = 0.5f * (top + bot);
      }
    });
    __syncthreads();
  }
}

// The tile shrinks for a K whose eleven rows of kColTile columns would not
// fit the shared memory a block may opt in to.
cudaError_t launch_solve(long long ncol, int K, const float* w_adv,
                         const float* delz_adv, const float* pt_new,
                         const float* delp_new, float dt, float ptop,
                         float p00, float kappa, float gamma, float grav,
                         float rdgas, float* w_out, float* delz_out,
                         int device, cudaStream_t s) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t row = kSolveRows * (size_t)(K | 1) * sizeof(float);
  int C = kColTile;
  while (C > 1 && C * row > (size_t)optin) C /= 2;
  if (C * row > (size_t)optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(nh_vertical_columns,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(C * row));
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((ncol + C - 1) / C);
  nh_vertical_columns<<<blocks, kSolveThreads, C * row, s>>>(
      ncol, K, C, w_adv, delz_adv, pt_new, delp_new, dt, ptop, p00, kappa,
      gamma, grav, rdgas, w_out, delz_out);
  return cudaGetLastError();
}

}  // namespace

// w_adv, delz_adv (the nonhydrostatic transport's outputs), pt_new, delp_new
// and the outputs w_new, delz_new: [F, Ny, Nx, K], K >= 2.  Returns the CUDA
// error of the launch, 0 when it launched.
extern "C" int nh_vertical_solve_f32(int F, int Ny, int Nx, int K,
                                     const void* w_adv, const void* delz_adv,
                                     const void* pt_new, const void* delp_new,
                                     float dt, float ptop, float p00,
                                     float kappa, float gamma, float grav,
                                     float rdgas, void* w_new, void* delz_new,
                                     int device, void* stream) {
  if (F < 1 || Ny < 1 || Nx < 1 || K < 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const auto wf = [](void* p) { return static_cast<float*>(p); };
  return (int)launch_solve((long long)F * Ny * Nx, K, cf(w_adv),
                           cf(delz_adv), cf(pt_new), cf(delp_new), dt, ptop,
                           p00, kappa, gamma, grav, rdgas, wf(w_new),
                           wf(delz_new), device,
                           static_cast<cudaStream_t>(stream));
}
