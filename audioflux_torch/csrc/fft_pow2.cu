// Batched forward complex FFT, fp32, power-of-two n in [2048, 32768].
//
// Replaces the TPU kernel audioflux_tpu/ops/pallas_fft.py:fft4_fwd (the
// four-step Pallas FFT).  Unlike that kernel it writes the spectrum in
// natural bin order: the TPU's "T-layout" only saved a relayout there.
//
// What bounds it on the card: a row reads 4 or 8 bytes and writes 8 bytes
// per point, against 5 n log2 n flops (about 4.6 flops per byte at
// n = 2048), so device memory is the bound; the shared-memory passes of the
// transform come next.  The design keeps every pass on chip and makes few
// of them (radix-16 Stockham passes, fft_smem.cuh):
//   * n <= 16384: one block per row, n/16 threads; the row (at most
//     139 KB with padding) lives in dynamic shared memory for all passes,
//     so device memory sees one read and one write per point;
//   * n = 32768 (256 KB, more than a block's 227 KB of shared memory):
//     four-step split n = n1 * n2 (n1 = 128) through a device scratch
//     buffer: column FFTs of length n1 with the twiddle W_n^(t2 k1) applied
//     on the way out, then row FFTs of length n2 that write bin
//     k1 + n1 k2 in natural order.

#include <cstdint>

#include "fft_smem.cuh"

using afx::cmul;
using afx::fft_smem;
using afx::pad;
using afx::seq_stride;

namespace {

constexpr int kMaxSinglePassLog2 = 14;
constexpr int kLog2N1 = 7;   // four-step column length 128
constexpr int kCols = 16;    // columns per block in the column pass
constexpr int kRows = 8;     // rows per block in the row pass

// One row per block; blockDim.x = n / 16.
__global__ void __launch_bounds__(1024)
fft_row_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
               float* __restrict__ yr, float* __restrict__ yi,
               const float2* __restrict__ tw, int log2n) {
  extern __shared__ float2 z[];
  const int n = 1 << log2n;
  const size_t off = static_cast<size_t>(blockIdx.x) << log2n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    z[pad(i)] = make_float2(xr[off + i], xi ? xi[off + i] : 0.f);
  }
  __syncthreads();
  fft_smem(z, log2n, tw, log2n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float2 v = z[pad(i)];
    yr[off + i] = v.x;
    yi[off + i] = v.y;
  }
}

// Four-step, pass 1: for kCols columns t2 of row blockIdx.x, the length-n1
// FFT over t1 of x[t1 * n2 + t2], times W_n^(t2 k1), into y[k1 * n2 + t2].
// blockDim.x = kCols * n1 / 16.
__global__ void __launch_bounds__(128)
fft_col_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
               float2* __restrict__ y, const float2* __restrict__ tw,
               int log2n) {
  extern __shared__ float2 z[];
  const int n1 = 1 << kLog2N1;
  const int stride = seq_stride(n1);
  const int log2n2 = log2n - kLog2N1;
  const int c0 = blockIdx.y * kCols;
  const size_t off = static_cast<size_t>(blockIdx.x) << log2n;
  for (int idx = threadIdx.x; idx < n1 * kCols; idx += blockDim.x) {
    const int t1 = idx / kCols, c = idx % kCols;
    const size_t g = off + (static_cast<size_t>(t1) << log2n2) + c0 + c;
    z[c * stride + pad(t1)] = make_float2(xr[g], xi ? xi[g] : 0.f);
  }
  __syncthreads();
  fft_smem(z, kLog2N1, tw, log2n);
  const int n = 1 << log2n;
  for (int idx = threadIdx.x; idx < n1 * kCols; idx += blockDim.x) {
    const int k1 = idx / kCols, c = idx % kCols;
    const int t2 = c0 + c;
    const float2 w = __ldg(&tw[(t2 * k1) & (n - 1)]);
    y[off + (static_cast<size_t>(k1) << log2n2) + t2] =
        cmul(z[c * stride + pad(k1)], w);
  }
}

// Four-step, pass 2: for kRows rows k1 of row blockIdx.x, the length-n2
// FFT over t2 of y[k1 * n2 + t2], written to bin k1 + n1 * k2.
// blockDim.x = kRows * n2 / 16.
__global__ void __launch_bounds__(1024)
fft_rowpass_kernel(const float2* __restrict__ y, float* __restrict__ yr,
                   float* __restrict__ yi, const float2* __restrict__ tw,
                   int log2n) {
  extern __shared__ float2 z[];
  const int n1 = 1 << kLog2N1;
  const int log2n2 = log2n - kLog2N1;
  const int n2 = 1 << log2n2;
  const int stride = seq_stride(n2);
  const int r0 = blockIdx.y * kRows;
  const size_t off = static_cast<size_t>(blockIdx.x) << log2n;
  for (int idx = threadIdx.x; idx < kRows * n2; idx += blockDim.x) {
    const int r = idx >> log2n2, t2 = idx & (n2 - 1);
    z[r * stride + pad(t2)] =
        y[off + (static_cast<size_t>(r0 + r) << log2n2) + t2];
  }
  __syncthreads();
  fft_smem(z, log2n2, tw, log2n);
  for (int idx = threadIdx.x; idx < kRows * n2; idx += blockDim.x) {
    const int r = idx % kRows, k2 = idx / kRows;
    const float2 v = z[r * stride + pad(k2)];
    const size_t o = off + r0 + r + static_cast<size_t>(n1) * k2;
    yr[o] = v.x;
    yi[o] = v.y;
  }
}

}  // namespace

// xr, xi: (batch, n) fp32 rows (xi may be null: real input).
// yr, yi: (batch, n) fp32 natural-order spectrum.  scratch: batch * n
// float2, used only when n > 2^14.  tw: n float2, exp(-2 pi i k / n).
// Returns the CUDA error code of the launches (0 on success).
extern "C" int af_fft_pow2_fwd(const float* xr, const float* xi, float* yr,
                               float* yi, void* scratch, const void* tw,
                               long long batch, int log2n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* twf = static_cast<const float2*>(tw);
  if (batch <= 0) return 0;
  if (log2n < 11 || log2n > 15 || batch > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (log2n <= kMaxSinglePassLog2) {
    const int smem = static_cast<int>(sizeof(float2)) * seq_stride(1 << log2n);
    cudaError_t e = cudaFuncSetAttribute(
        fft_row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    fft_row_kernel<<<static_cast<unsigned>(batch), (1 << log2n) / 16, smem,
                     st>>>(xr, xi, yr, yi, twf, log2n);
    return static_cast<int>(cudaGetLastError());
  }
  const int n1 = 1 << kLog2N1;
  const int n2 = 1 << (log2n - kLog2N1);
  float2* y = static_cast<float2*>(scratch);
  fft_col_kernel<<<dim3(static_cast<unsigned>(batch), n2 / kCols),
                   kCols * n1 / 16, sizeof(float2) * seq_stride(n1) * kCols,
                   st>>>(xr, xi, y, twf, log2n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  fft_rowpass_kernel<<<dim3(static_cast<unsigned>(batch), n1 / kRows),
                       kRows * n2 / 16, sizeof(float2) * seq_stride(n2) * kRows,
                       st>>>(y, yr, yi, twf, log2n);
  return static_cast<int>(cudaGetLastError());
}
