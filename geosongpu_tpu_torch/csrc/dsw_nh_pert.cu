// p', phi' and rho of the solved nonhydrostatic state, for Hopper (sm_90a).
//
// Replaces the TPU kernel stage `_nh_pert_kernel`
// (geosongpu_tpu/dycore/sw_pallas.py:82-100, called inside k4 `dsw_wind` at
// :669).  It computes exactly
// geosongpu_tpu_torch/dycore/sw.py::nh_perturbation_fields on the refilled
// delp/pt/delz: pe = ptop + cumsum(delp), pkz from pk = (pe / P00)^kappa and
// log(pe), T = pt pkz, rho = delp / (g max(delz, 1)),
// p' = rho R T - p_mid, and phi' as the reverse column sum of
// g delz - R T delp / p_mid less half the layer's own term.  The
// nonhydrostatic dsw_wind wrapper launches it first and hands the three
// fields to the wind update.
//
// This is the port's plain form (pow and log), not the TPU kernel's
// exp(kappa (ln pe - ln P00)).  p' is a difference of two numbers near
// 1e5 Pa that cancel in balance, and the phi' terms cancel likewise, so as
// in hydro_columns (dsw_common.cuh) the running sums are kept in double
// and rounded once, as the plain version's cumsum_k does, pe / P00 is
// pe * (1/P00), and every product keeps the plain version's order.
//
// A block takes a tile of neighbouring columns, as hydro_columns does
// (dsw_common.cuh), and shares its staging and pe sum (stage_columns_pe):
// delp, pt and delz are staged with coalesced reads into rows of odd pitch,
// one thread per column runs the two double sums (pe down the column, then
// the reverse sum of the phi' terms) in the plain version's order, and pow,
// log and the layer formulas run over all (column, level) points of the tile
// with every thread; rho, p' and phi' are each written once, coalesced.
// What bounds it on this card: 3 inputs and 3 outputs of one field each (24
// MB at c48-L72, 7 us at 3.35 TB/s) against one powf, two logf and three
// divisions per point.
#include "dsw_common.cuh"

namespace {

constexpr int kNhRows = 5;  // the tile's row blocks of C x (K | 1) floats
// 256 threads, 9 points of a 32-column tile each at K = 72: a quarter less
// device time than 128 at c48-L72, where the launch is a single wave.
constexpr int kNhThreads = 256;

__global__ void __launch_bounds__(kNhThreads)
nh_columns(long long ncol, int K, int C, const float* __restrict__ delp,
           const float* __restrict__ pt, const float* __restrict__ delz,
           float ptop, float p00, float kappa, float grav, float rdgas,
           float* __restrict__ pp, float* __restrict__ php,
           float* __restrict__ rho) {
  extern __shared__ float col_smem[];
  const int Kp = K | 1;
  float* dp = col_smem;      // delp
  float* tp = dp + C * Kp;   // pt, then the phi' terms, then phi'
  float* dz = tp + C * Kp;   // delz
  float* pe = dz + C * Kp;   // pe of the lower interface
  float* pk = pe + C * Kp;   // pk of the lower interface
  const long long col0 = (long long)blockIdx.x * C;
  const int nc = (int)min((long long)C, ncol - col0);
  const int n = nc * K;
  const long long base = col0 * K;
  const int tid = threadIdx.x;

  stage_columns_pe<kNhThreads, 3>({delp, pt, delz}, {dp, tp, dz}, dp, pe,
                                  col0, nc, K, Kp, ptop);
  const float rp00 = 1.0f / p00;
  for_tile_elements<kNhThreads>(n, K, [&](int, int c, int k) {
    pk[c * Kp + k] = powf(pe[c * Kp + k] * rp00, kappa);
  });
  __syncthreads();
  const float pk_top = powf(ptop * rp00, kappa);
  const float ln_top = logf(ptop);
  for_tile_elements<kNhThreads>(n, K, [&](int e, int c, int k) {
    const int o = c * Kp + k;
    const float pe_hi = pe[o];
    const float pe_lo = k > 0 ? pe[o - 1] : ptop;
    const float pk_lo = k > 0 ? pk[o - 1] : pk_top;
    const float ln_lo = k > 0 ? logf(pe_lo) : ln_top;
    const float pkz = (pk[o] - pk_lo) / (kappa * (logf(pe_hi) - ln_lo));
    const float p_mid = 0.5f * (pe_hi + pe_lo);
    const float t1 = tp[o] * pkz;
    const float r = dp[o] / (grav * fmaxf(dz[o], 1.0f));
    rho[base + e] = r;
    pp[base + e] = r * rdgas * t1 - p_mid;
    tp[o] = grav * dz[o] - rdgas * t1 * dp[o] / p_mid;
  });
  __syncthreads();
  if (tid < nc) {
    float* col = tp + tid * Kp;
    double acc = 0.0;
    for (int k = K - 1; k >= 0; --k) {
      const float d = col[k];
      acc += (double)d;
      col[k] = (float)acc - 0.5f * d;
    }
  }
  __syncthreads();
  for_tile_elements<kNhThreads>(n, K, [&](int e, int c, int k) {
    php[base + e] = tp[c * Kp + k];
  });
}

// The tile shrinks for a K whose five rows of kColTile columns would not
// fit the 48 KB of shared memory a launch gets without opting in.
cudaError_t launch_nh(long long ncol, int K, const float* delp,
                      const float* pt, const float* delz, float ptop,
                      float p00, float kappa, float grav, float rdgas,
                      float* pp, float* php, float* rho, cudaStream_t s) {
  int C = kColTile;
  const size_t row = kNhRows * (size_t)(K | 1) * sizeof(float);
  while (C > 1 && C * row > 48 * 1024) C /= 2;
  if (C * row > 48 * 1024) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((ncol + C - 1) / C);
  nh_columns<<<blocks, kNhThreads, C * row, s>>>(
      ncol, K, C, delp, pt, delz, ptop, p00, kappa, grav, rdgas, pp, php,
      rho);
  return cudaGetLastError();
}

}  // namespace

// delp_f, pt_f, delz_f (the refilled post-solve state) and the outputs
// pprime, phiprime, rho1: [F, Ny, Nx, K].  Returns the CUDA error of the
// launch, 0 when it launched.
extern "C" int dsw_nh_pert_f32(int F, int Ny, int Nx, int K,
                               const void* delp_f, const void* pt_f,
                               const void* delz_f, float ptop, float p00,
                               float kappa, float grav, float rdgas,
                               void* pprime, void* phiprime, void* rho1,
                               int device, void* stream) {
  const int rc = check_grid(F, Ny, Nx, K);
  if (rc != 0) return rc;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const auto wf = [](void* p) { return static_cast<float*>(p); };
  return (int)launch_nh((long long)F * Ny * Nx, K, cf(delp_f), cf(pt_f),
                        cf(delz_f), ptop, p00, kappa, grav, rdgas,
                        wf(pprime), wf(phiprime), wf(rho1),
                        static_cast<cudaStream_t>(stream));
}
