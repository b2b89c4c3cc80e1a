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
// One thread per (f, j, i) column walks K twice.  What bounds it on this
// card: 3 inputs and 3 outputs of one field each (30 MB at c48-L72, 9 us
// at 3.35 TB/s) against one powf, one logf and three divisions per cell;
// a thread's reads are K floats apart from its neighbour's, so the
// achieved rate is set by the uncoalesced column walk.  A later design
// stages a tile of columns through shared memory.
#include "dsw_common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
nh_columns(long long ncol, int K, const float* __restrict__ delp,
           const float* __restrict__ pt, const float* __restrict__ delz,
           float ptop, float p00, float kappa, float grav, float rdgas,
           float* __restrict__ pp, float* __restrict__ php,
           float* __restrict__ rho) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= ncol) return;
  const long long base = t * K;
  const float rp00 = 1.0f / p00;
  double s = 0.0;
  float pe_lo = ptop;
  float pk_lo = powf(ptop * rp00, kappa);
  float ln_lo = logf(ptop);
  for (int k = 0; k < K; ++k) {
    const float dp = delp[base + k];
    const float dz = delz[base + k];
    s += (double)dp;
    const float pe_hi = ptop + (float)s;
    const float pk_hi = powf(pe_hi * rp00, kappa);
    const float ln_hi = logf(pe_hi);
    const float pkz = (pk_hi - pk_lo) / (kappa * (ln_hi - ln_lo));
    const float p_mid = 0.5f * (pe_hi + pe_lo);
    const float t1 = pt[base + k] * pkz;
    const float r = dp / (grav * fmaxf(dz, 1.0f));
    rho[base + k] = r;
    pp[base + k] = r * rdgas * t1 - p_mid;
    php[base + k] = grav * dz - rdgas * t1 * dp / p_mid;
    pe_lo = pe_hi;
    pk_lo = pk_hi;
    ln_lo = ln_hi;
  }
  double acc = 0.0;
  for (int k = K - 1; k >= 0; --k) {
    const float d = php[base + k];
    acc += (double)d;
    php[base + k] = (float)acc - 0.5f * d;
  }
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
  const long long ncol = (long long)F * Ny * Nx;
  nh_columns<<<blocks_for(ncol), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      ncol, K, cf(delp_f), cf(pt_f), cf(delz_f), ptop, p00, kappa, grav,
      rdgas, wf(pprime), wf(phiprime), wf(rho1));
  return (int)cudaGetLastError();
}
