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
// To the bit: the arithmetic of a column is nh_vertical_columns.cuh, which
// keeps the plain version's operands and order (and its forms of pe / P00,
// ** and dt / x); pe is a double running sum rounded once.
//
// What bounds it on this card: 4 inputs and 2 outputs of a field each (30.2
// MB at c48-L72, 9.0 us at 3.35 TB/s) against ~180 operations a point
// (benchmark/bounds.py): bytes.  What sets its time is latency: each
// linearisation ends in a Thomas solve of K - 1 dependent steps a column,
// two IEEE divisions each, that only one thread a column can walk.
//
// Design.  Every column of a call is resident at once where the card
// holds them (the NH c48-L72 step's 17,496 columns on 132 SMs), so that the
// sweeps of all columns run side by side and the pointwise work around
// them is spread over every SM:
//
// * A column takes 4 (K - 1 | 1) + (K | 1) floats of the tile, 1,428 bytes
//   at K = 72: the tridiagonal as 16-byte rows (a, b, c, d) of its interior
//   interfaces and a row for the solution; the anchor's four layer rows
//   (delp, pe, pk, log pe) use the same memory first.  The odd pitches keep
//   the sweeps' column walks in different banks.  The launch takes the
//   fewest waves of kSolveBlocksPerSM blocks an SM and spreads the columns
//   evenly over them (67 a block at c48-L72: 262 blocks, one wave); for a K
//   too large for two blocks an SM it takes one, down to one column a
//   block.  Measured against four blocks of 256 threads (34 columns), one
//   of 1,024 (133), five float rows a column in place of the 16-byte rows,
//   and p0 and p_mid kept in the tile (seven rows, two waves): PERF.md.
// * What the linearisations read besides the tile comes from device memory
//   (L2; the four inputs are 20 MB at c48-L72), each turn's reads issued a
//   turn ahead: delp, delz and w as the wrapper passes them, and the anchor
//   p0 and the mid pressure, written once into the two outputs, which hold
//   them until the results replace them.
// * Only the Thomas chain is left in the sweeps.  An all-thread phase forms
//   a, b, c and d of every interior interface: warps walk the tile's levels
//   31 at a time, each lane linearises one layer and takes the layer below
//   from the next lane (__shfl_down_sync), lane 31 only feeding lane 30.
//   The forward sweep loads the next row (one 16-byte load) before this
//   step's divisions, and its chain is denom = b - a c', d' = (d - a d') /
//   denom, c' = c / denom: both IEEE divisions, sharing denom's reciprocal
//   and written out without the compiler's branch regions
//   (nh_vertical_columns.cuh); (c', d') go over (a, b).  The backward sweep
//   x = d' - c' x writes the solution row.
// * The second linearisation forms z* from the first solution as it reads
//   it, so z* needs no row; the first starts from z* = delz, where p* = p0
//   exactly.
// * A block has 512 threads, more than its columns: the pointwise phases
//   (pow, log, the linearisations) need the warps to hide their latency,
//   and the sweeps run on the first ceil(C / 32) warps while the others
//   wait at the barrier.  delp is staged by cp.async; the pe sum is one
//   thread a column, in the plain version's order.
// * The launch reads the device's limits and opts the kernel in to its
//   shared memory once per device, not on every call.
#include <cuda_runtime.h>

#include <algorithm>
#include <mutex>

#include "column_tile.cuh"
#include "nh_vertical_columns.cuh"

namespace {

constexpr int kSolveThreads = 512;
constexpr int kSolveBlocksPerSM = 2;
constexpr int kNewtonIters = 2;  // vertical_acoustic_solve's n_iter
constexpr int kWarpLevels = 31;  // the layers a warp linearises into rows
constexpr unsigned kFullWarp = 0xffffffffu;

// for_tile_elements (column_tile.cuh) with each element's device-memory
// reads, load(e), issued a turn ahead: fn(e, c, k, load(e))
template <int T, class Load, class Fn>
__device__ __forceinline__ void for_tile_elements_ahead(int n, int L,
                                                        Load load, Fn fn) {
  int c = threadIdx.x / L, k = threadIdx.x % L;
  const int c_step = T / L, k_step = T % L;
  auto next = load(min((int)threadIdx.x, n - 1));
  for (int e = threadIdx.x; e < n; e += T) {
    const auto cur = next;
    next = load(min(e + T, n - 1));
    fn(e, c, k, cur);
    c += c_step;
    k += k_step;
    if (k >= L) {
      k -= L;
      ++c;
    }
  }
}

// a layer's values in device memory that a linearisation reads
struct LayerInputs {
  float delz, delp, w, p0, ph;
};

__global__ void __launch_bounds__(kSolveThreads, kSolveBlocksPerSM)
nh_vertical_columns(long long ncol, int K, int C,
                    const float* __restrict__ w_adv,
                    const float* __restrict__ delz_adv,
                    const float* __restrict__ pt_new,
                    const float* __restrict__ delp_new, float dt, float ptop,
                    float p00, float kappa, float gamma, float grav,
                    float rdgas, float* __restrict__ w_out,
                    float* __restrict__ delz_out) {
  extern __shared__ float col_smem[];
  const int P = K | 1;            // a layer row's pitch
  const int M = K - 1;            // interior interfaces a column
  const int PQ = M | 1;           // the tridiagonal's pitch, in rows
  // the anchor's four layer rows, then the tridiagonal and the solution
  const int rows = C * P;
  float* const ra = col_smem;   // delp
  float* const rb = ra + rows;  // pe
  float* const rc = rb + rows;  // pk
  float* const rd = rc + rows;  // log pe
  nhv::Row* const q = reinterpret_cast<nhv::Row*>(col_smem);
  float* const rx = col_smem + 4 * C * PQ;  // the solution x
  const long long col0 = (long long)blockIdx.x * C;
  const int nc = (int)min((long long)C, ncol - col0);
  const int n = nc * K;
  const long long base = col0 * K;
  const float* const w_g = w_adv + base;
  const float* const dz_g = delz_adv + base;
  const float* const pt_g = pt_new + base;
  const float* const dp_g = delp_new + base;
  float* const p0_g = w_out + base;     // the anchor until the result
  float* const ph_g = delz_out + base;  // the mid pressure until the result
  const int tid = threadIdx.x;

  // pe of each layer's lower interface, pk and log pe
  for_tile_elements<kSolveThreads>(n, K, [&](int e, int c, int k) {
    async_copy4(ra + c * P + k, dp_g + e);
  });
  async_copy_wait();
  __syncthreads();
  if (tid < nc) nhv::column_pe(ra + tid * P, rb + tid * P, K, ptop);
  __syncthreads();
  const float rp00 = 1.0f / p00;
  for_tile_elements<kSolveThreads>(n, K, [&](int, int c, int k) {
    const int o = c * P + k;
    rc[o] = nhv::interface_pk(rb[o], rp00, kappa);
    rd[o] = logf(rb[o]);
  });
  __syncthreads();
  // nh_solver.py::full_pressure: the anchor and the mid pressure
  const float pk_top = nhv::interface_pk(ptop, rp00, kappa);
  const float ln_top = logf(ptop);
  for_tile_elements_ahead<kSolveThreads>(
      n, K, [&](int e) { return make_float2(pt_g[e], dz_g[e]); },
      [&](int e, int c, int k, float2 pt_dz) {
        const int o = c * P + k;
        const bool lid = k == 0;
        const nhv::Anchor an = nhv::anchor(
            lid ? ptop : rb[o - 1], rb[o], lid ? pk_top : rc[o - 1], rc[o],
            lid ? ln_top : rd[o - 1], rd[o], pt_dz.x, ra[o], pt_dz.y, kappa,
            grav, rdgas);
        p0_g[e] = an.p0;
        ph_g[e] = an.ph;
      });
  __syncthreads();

  // a warp's lanes take levels e0 + lane of the tile, e0 = 31 v for the
  // warp's turns v = warp, warp + W, ...; (c, k) advance without division,
  // and each turn's device-memory reads are issued a turn ahead
  const int lane = tid & 31;
  const int warp_levels = kWarpLevels * (kSolveThreads / 32);
  const int c_step = warp_levels / K, k_step = warp_levels % K;
  const int e_first = kWarpLevels * (tid >> 5) + lane;
  const int c_first = e_first / K, k_first = e_first % K;
  const auto inputs = [&](int e) {
    e = min(e, n - 1);
    return LayerInputs{dz_g[e], dp_g[e], w_g[e], p0_g[e], ph_g[e]};
  };
  for (int it = 0; it < kNewtonIters; ++it) {
    const bool first = it == 0;
    // the linearisation at every layer, the coefficients at every interior
    // interface; z* from the previous solution, delz at first
    int c = c_first, k = k_first;
    LayerInputs next = inputs(e_first);
    for (int e = e_first; e - lane < n; e += warp_levels) {
      const LayerInputs in = next;
      next = inputs(e + warp_levels);
      nhv::Layer up = {0.0f, 0.0f, 0.0f, 0.0f};
      if (e < n) {
        const int o = c * P + k;
        const float z =
            first ? in.delz
                  : nhv::z_star(in.delz, k > 0 ? rx[o - 1] : 0.0f,
                                k < M ? rx[o] : 0.0f, dt);
        up = nhv::linearise(z, in.p0, in.ph, in.delz, in.delp, gamma, grav,
                            first);
      }
      const float w = in.w;
      const nhv::Layer dn = {__shfl_down_sync(kFullWarp, up.s, 1),
                             __shfl_down_sync(kFullWarp, up.ptil, 1),
                             __shfl_down_sync(kFullWarp, up.rho, 1),
                             __shfl_down_sync(kFullWarp, up.z, 1)};
      const float w_dn = __shfl_down_sync(kFullWarp, w, 1);
      if (e < n && lane < kWarpLevels && k < M) {
        q[c * PQ + k] = nhv::coefficients(up, dn, 0.5f * (w + w_dn), dt);
      }
      c += c_step;
      k += k_step;
      if (k >= K) {
        k -= K;
        ++c;
      }
    }
    __syncthreads();
    // Thomas over the interior interfaces, one thread a column: interface
    // j + 1 lies between layers j (above) and j + 1 (below)
    if (tid < nc) {
      nhv::thomas_forward(q + tid * PQ, M);
      nhv::thomas_backward(q + tid * PQ, rx + tid * P, M);
    }
    __syncthreads();
  }
  // z* of the last solution, delz clamped at 1 m, the layer w
  for_tile_elements<kSolveThreads>(n, K, [&](int e, int c, int k) {
    const int o = c * P + k;
    const float top = k > 0 ? rx[o - 1] : 0.0f;
    const float bot = k < M ? rx[o] : 0.0f;
    delz_out[base + e] = nhv::clamp1(nhv::z_star(dz_g[e], top, bot, dt));
    w_out[base + e] = 0.5f * (top + bot);
  });
}

// The floats a column takes in the tile: four layer rows for the anchor,
// which the tridiagonal's rows and the solution's row then reuse
long long tile_floats(int K) {
  const long long P = K | 1, PQ = (K - 1) | 1;
  return std::max(4 * P, 4 * PQ + P);
}

// A device's limits, read and the kernel opted in once per device
struct SolveDevice {
  bool ready = false;
  int sms = 0, smem_sm = 0, reserved = 0, optin = 0;
};

constexpr int kMaxDevices = 64;
SolveDevice g_devices[kMaxDevices];
std::mutex g_devices_mutex;

cudaError_t solve_device(int device, SolveDevice* out) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_devices_mutex);
  SolveDevice& d = g_devices[device];
  if (!d.ready) {
    const cudaDeviceAttr attrs[4] = {
        cudaDevAttrMultiProcessorCount,
        cudaDevAttrMaxSharedMemoryPerMultiprocessor,
        cudaDevAttrReservedSharedMemoryPerBlock,
        cudaDevAttrMaxSharedMemoryPerBlockOptin};
    int* const vals[4] = {&d.sms, &d.smem_sm, &d.reserved, &d.optin};
    for (int i = 0; i < 4; ++i) {
      const cudaError_t err = cudaDeviceGetAttribute(vals[i], attrs[i], device);
      if (err != cudaSuccess) return err;
    }
    // the opt-in limit covers every tile; the carveout asks for all of the
    // SM's shared memory, so that the tiles are resident side by side
    cudaError_t err = cudaFuncSetAttribute(
        nh_vertical_columns, cudaFuncAttributeMaxDynamicSharedMemorySize,
        d.optin);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(nh_vertical_columns,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    d.ready = true;
  }
  *out = d;
  return cudaSuccess;
}

// The tile: the most columns that kSolveBlocksPerSM blocks an SM hold
// (fewer blocks an SM for a large K), then the fewest waves of such blocks
// over the device's SMs, and the columns spread evenly over them.
cudaError_t launch_solve(long long ncol, int K, const float* w_adv,
                         const float* delz_adv, const float* pt_new,
                         const float* delp_new, float dt, float ptop,
                         float p00, float kappa, float gamma, float grav,
                         float rdgas, float* w_out, float* delz_out,
                         int device, cudaStream_t s) {
  SolveDevice d;
  const cudaError_t err = solve_device(device, &d);
  if (err != cudaSuccess) return err;
  const long long col_bytes = tile_floats(K) * sizeof(float);
  long long fit = 0;
  int per_sm = kSolveBlocksPerSM;
  for (; per_sm >= 1; per_sm /= 2) {
    fit = std::min((long long)(d.smem_sm / per_sm - d.reserved),
                   (long long)d.optin) / col_bytes;
    if (fit >= 1) break;
  }
  if (fit < 1) return cudaErrorInvalidValue;
  fit = std::min(fit, (long long)kSolveThreads);  // a sweep thread a column
  const long long slots = (long long)d.sms * per_sm;
  const long long waves = (ncol + slots * fit - 1) / (slots * fit);
  const long long C = (ncol + waves * slots - 1) / (waves * slots);
  const long long blocks = (ncol + C - 1) / C;
  nh_vertical_columns<<<(unsigned)blocks, kSolveThreads, C * col_bytes, s>>>(
      ncol, K, (int)C, w_adv, delz_adv, pt_new, delp_new, dt, ptop, p00,
      kappa, gamma, grav, rdgas, w_out, delz_out);
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
  // the wrapper calls on the tensors' device, which is then current
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const auto wf = [](void* p) { return static_cast<float*>(p); };
  return (int)launch_solve((long long)F * Ny * Nx, K, cf(w_adv),
                           cf(delz_adv), cf(pt_new), cf(delp_new), dt, ptop,
                           p00, kappa, gamma, grav, rdgas, wf(w_new),
                           wf(delz_new), device,
                           static_cast<cudaStream_t>(stream));
}
