// The cube-corner chart corrections, for Hopper (sm_90a): the two apply
// operations of geosongpu_tpu_torch/core/chart_corners.py::ChartCorners, each
// one launch that patches the corner squares of the caller's array in place.
//
// Replaces no Pallas kernel: the reference applies its chart corners as XLA
// glue (geosongpu_tpu/core/chart_corners.py:467 `_apply_scalar`, :504
// `_apply_agrid`).  In the port that glue was a loop over the four corners
// of slices, reshapes, einsums and slice assignments after a clone of the
// whole padded field: 28 launches a scalar call, 40 an A-grid call, about
// 1.1 ms of host time each.  It computes what
// geosongpu_tpu_torch/ops/kernels/chart.py's plain versions compute:
//
//   chart_scalar: in each corner c's W x W square (W = h + 2) of every slot f
//     out[w] = base[w] + sum_p Wd[f, c, w, p] (samp[p] - base[w]),
//   samp the corner's P x P patch (P = h + 4) and base the square's own
//   values, both read before any slot is written (deviation form: a uniform
//   field is left bit for bit);
//
//   chart_agrid: in each corner's W x W square of ua and va, where the mask
//   is set,
//     rec[r] = sum_s Wst[f, c, r, s] samp[s],
//   samp the (P+1) x P patch of pu then the P x (P+1) patch of pv, rows r
//   the W x W square of ua then that of va.
//
// The taps are summed in one fixed order, with fused multiply-adds (fmaf:
// one rounding a tap, whatever --fmad says): the scalar sum as two chains,
// p from 0 to ceil(PP/2) - 1 and from ceil(PP/2) up, added at the end; the
// A-grid sum as one chain, s from 0 up.  That is the order in which
// torch.einsum's batched products (cuBLAS gemv and gemm) summed these taps
// on an H100 at the c192-L72 shapes, bit for bit: the einsum form the port
// ran before, which the benchmark's plain reference still runs.  The order
// was fitted on torch 2.11.0+cu128 with cuBLAS 12.9.2 (nvidia-cublas-cu12
// 12.9.2.10); another torch or cuBLAS may pick other kernels at these
// shapes, and tests/test_torch_cuda.py::test_chart_kernels_equal_plain,
// which holds the kernels to the einsum form on the card, then shows it.
// Another order (one chain of separate products and sums) moved single
// steps of the c192 model by up to a third of a field's change, through
// limiter branches that a last-bit difference at a cube corner flips.  The
// plain versions emulate fmaf exactly, so they match to the bit.
//
// What bounds it on this card: nothing but latency.  A c192-L72 scalar call
// reads 4 x 49 samples and 4 x 25 x 49 weights a slot and level chunk and
// writes 4 x 25 values a slot and level (~0.34 MB in, ~0.17 MB out: under
// 1 us at 3.35 TB/s), against ~1 MFLOP.
//
// Design: arrays are [F, Ny, Nx, K], K the trailing dims flattened, K minor.
// A block takes one slot and a chunk of kChartChunk levels, so that its
// reads of a patch slot are one 32-byte run.  chart_scalar takes all four
// corners in one block: in blocks only a few cells wide (bn >= 4, Nx >= 2W)
// one corner's patch reaches into another corner's square, and the patch
// must be read before either square is written; a block that stages every
// patch of its slot, then waits at one barrier, then writes, has nothing to
// race with.  Its weights (4 x WW x PP floats, 19.6 KB at h = 3) and samples
// (4 x PP x kChartChunk) sit in shared memory.  chart_agrid reads pu and pv
// and writes ua and va, so its corners are independent: a block a (level
// chunk, corner, slot), weights 2 WW x S floats (22.4 KB at h = 3).
// Threads take (row, level) with the level fastest.
#include <cuda_runtime.h>

namespace {

constexpr int kChartThreads = 256;
constexpr int kChartChunk = 8;                   // levels a block takes
constexpr size_t kChartSmemDefault = 48 * 1024;  // above it: opt-in
constexpr size_t kChartSmemMax = 227 * 1024;

// corner c: 0 SW, 1 SE, 2 NW, 3 NE; north = c >> 1, east = c & 1.  The
// first row (column) of a span of `span` slots at the corner's end of `n`.
__host__ __device__ __forceinline__ int corner_start(bool far, int n,
                                                     int span) {
  return far ? n - span : 0;
}

__global__ void __launch_bounds__(kChartThreads)
chart_scalar(float* __restrict__ a, const float* __restrict__ wts, int Ny,
             int Nx, long long K, int h) {
  extern __shared__ float chart_smem_[];
  const int P = h + 4, W = h + 2, PP = P * P, WW = W * W;
  float* s_w = chart_smem_;            // [4][WW][PP]
  float* s_x = s_w + 4 * WW * PP;      // [4][PP][kChartChunk]
  const long long k0 = (long long)blockIdx.x * kChartChunk;
  const int nk = (int)min((long long)kChartChunk, K - k0);
  float* af = a + (long long)blockIdx.y * Ny * Nx * K + k0;
  const float* wf = wts + (long long)blockIdx.y * 4 * WW * PP;

  for (int i = threadIdx.x; i < 4 * WW * PP; i += kChartThreads)
    s_w[i] = wf[i];
  for (int i = threadIdx.x; i < 4 * PP * kChartChunk; i += kChartThreads) {
    const int k = i % kChartChunk, cp = i / kChartChunk;
    const int c = cp / PP, p = cp - c * PP;
    if (k < nk) {
      const int y = corner_start(c >> 1, Ny, P) + p / P;
      const int x = corner_start(c & 1, Nx, P) + p % P;
      s_x[i] = af[((long long)y * Nx + x) * K + k];
    }
  }
  __syncthreads();   // every patch is staged before any square is written

  const int off = P - W;   // the square's offset inside the patch, far side
  for (int i = threadIdx.x; i < 4 * WW * kChartChunk; i += kChartThreads) {
    const int k = i % kChartChunk, cw = i / kChartChunk;
    const int c = cw / WW, w = cw - c * WW;
    if (k >= nk) continue;
    const int wy = w / W, wx = w - wy * W;
    const float* xs = s_x + c * PP * kChartChunk + k;
    const int py = wy + ((c >> 1) ? off : 0), px = wx + ((c & 1) ? off : 0);
    const float base = xs[(py * P + px) * kChartChunk];
    const float* wr = s_w + cw * PP;
    const int half = (PP + 1) / 2;
    float lo = 0.0f, hi = 0.0f;
    for (int p = 0; p < half; ++p)
      lo = fmaf(wr[p], xs[p * kChartChunk] - base, lo);
    for (int p = half; p < PP; ++p)
      hi = fmaf(wr[p], xs[p * kChartChunk] - base, hi);
    const int y = corner_start(c >> 1, Ny, W) + wy;
    const int x = corner_start(c & 1, Nx, W) + wx;
    af[((long long)y * Nx + x) * K + k] = base + (lo + hi);
  }
}

__global__ void __launch_bounds__(kChartThreads)
chart_agrid(float* __restrict__ ua, float* __restrict__ va,
            const float* __restrict__ pu, const float* __restrict__ pv,
            const float* __restrict__ wts,
            const unsigned char* __restrict__ mask, int mask_slot_stride,
            int Ny, int Nx, long long K, int h) {
  extern __shared__ float chart_smem_[];
  const int P = h + 4, W = h + 2, WW = W * W;
  const int SU = (P + 1) * P, S = 2 * SU;  // pu patch, then pv patch
  float* s_w = chart_smem_;            // [2 WW][S]
  float* s_x = s_w + 2 * WW * S;       // [S][kChartChunk]
  const int c = blockIdx.y, f = blockIdx.z;
  const long long k0 = (long long)blockIdx.x * kChartChunk;
  const int nk = (int)min((long long)kChartChunk, K - k0);
  const float* wf = wts + ((long long)f * 4 + c) * 2 * WW * S;
  const unsigned char* mf = mask + (long long)f * mask_slot_stride + c * WW;
  const float* puf = pu + (long long)f * (Ny + 1) * Nx * K + k0;
  const float* pvf = pv + (long long)f * Ny * (Nx + 1) * K + k0;
  // both patches start at the same row and column of their arrays
  const int y0 = corner_start(c >> 1, Ny, P), x0 = corner_start(c & 1, Nx, P);

  for (int i = threadIdx.x; i < 2 * WW * S; i += kChartThreads)
    s_w[i] = wf[i];
  for (int i = threadIdx.x; i < S * kChartChunk; i += kChartThreads) {
    const int k = i % kChartChunk, s = i / kChartChunk;
    if (k < nk) {
      if (s < SU) {
        const int y = y0 + s / P, x = x0 + s % P;
        s_x[i] = puf[((long long)y * Nx + x) * K + k];
      } else {
        const int t = s - SU;
        const int y = y0 + t / (P + 1), x = x0 + t % (P + 1);
        s_x[i] = pvf[((long long)y * (Nx + 1) + x) * K + k];
      }
    }
  }
  __syncthreads();

  const long long slot = (long long)f * Ny * Nx * K + k0;
  for (int i = threadIdx.x; i < 2 * WW * kChartChunk; i += kChartThreads) {
    const int k = i % kChartChunk, r = i / kChartChunk;
    const int comp = r / WW, w = r - comp * WW;
    if (k >= nk || !mf[w]) continue;
    const float* xs = s_x + k;
    const float* wr = s_w + r * S;
    float acc = 0.0f;
    for (int s = 0; s < S; ++s) acc = fmaf(wr[s], xs[s * kChartChunk], acc);
    const int wy = w / W, wx = w - wy * W;
    const int y = corner_start(c >> 1, Ny, W) + wy;
    const int x = corner_start(c & 1, Nx, W) + wx;
    (comp ? va : ua)[slot + ((long long)y * Nx + x) * K + k] = acc;
  }
}

// The checks every entry starts with: the shapes a corner needs (the patch
// fits, the four squares do not overlap), the grid, the shared memory (with
// the opt-in above 48 KB), and the device.  0 when the launch may go on.
template <typename Kernel>
int prepare_chart(Kernel kernel, int F, int Ny, int Nx, long long K, int h,
                  size_t bytes, int device) {
  if (F < 1 || h < 1 || K < 1 || Ny < 2 * (h + 2) || Nx < 2 * (h + 2) ||
      Ny < h + 4 || Nx < h + 4 || F > 65535 ||
      (K + kChartChunk - 1) / kChartChunk > 2147483647LL ||
      bytes > kChartSmemMax) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bytes > kChartSmemDefault) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// a: [F, Ny, Nx, K], patched in place; w: [F, 4, W*W, P*P].  Returns the
// CUDA error of the launch, 0 when it launched.
extern "C" int chart_scalar_f32(void* a, const void* w, int F, int Ny, int Nx,
                                long long K, int h, int device,
                                void* stream) {
  const int P = h + 4, W = h + 2;
  const size_t bytes =
      (size_t)4 * P * P * (W * W + kChartChunk) * sizeof(float);
  const int rc = prepare_chart(chart_scalar, F, Ny, Nx, K, h, bytes, device);
  if (rc != 0) return rc;
  const dim3 grid((unsigned)((K + kChartChunk - 1) / kChartChunk),
                  (unsigned)F);
  chart_scalar<<<grid, kChartThreads, bytes,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(a), static_cast<const float*>(w), Ny, Nx, K, h);
  return (int)cudaGetLastError();
}

// ua, va: [F, Ny, Nx, K], patched in place where the mask is set; pu:
// [F, Ny+1, Nx, K]; pv: [F, Ny, Nx+1, K]; w: [F, 4, 2 W*W, 2 (P+1) P];
// mask: [mask_slots, 4, W*W] bytes, mask_slots 1 (every slot) or F.
extern "C" int chart_agrid_f32(void* ua, void* va, const void* pu,
                               const void* pv, const void* w,
                               const void* mask, int mask_slots, int F,
                               int Ny, int Nx, long long K, int h, int device,
                               void* stream) {
  const int P = h + 4, W = h + 2, S = 2 * (P + 1) * P;
  const size_t bytes = (size_t)S * (2 * W * W + kChartChunk) * sizeof(float);
  if (mask_slots != 1 && mask_slots != F) return (int)cudaErrorInvalidValue;
  const int rc = prepare_chart(chart_agrid, F, Ny, Nx, K, h, bytes, device);
  if (rc != 0) return rc;
  const dim3 grid((unsigned)((K + kChartChunk - 1) / kChartChunk), 4u,
                  (unsigned)F);
  chart_agrid<<<grid, kChartThreads, bytes,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(ua), static_cast<float*>(va),
      static_cast<const float*>(pu), static_cast<const float*>(pv),
      static_cast<const float*>(w), static_cast<const unsigned char*>(mask),
      mask_slots == 1 ? 0 : 4 * W * W, Ny, Nx, K, h);
  return (int)cudaGetLastError();
}
