// Batched complex FFT, fp32, power-of-two n in [2048, 32768]: forward,
// inverse, and the fused autocorrelation 0.5 * Im(ifft(fft(x + i y)^2)).
//
// Replaces the TPU kernels audioflux_tpu/ops/pallas_fft.py:fft4_fwd,
// fft4_inv and fft4_autocorr (the four-step Pallas FFT).  Unlike those
// kernels it reads and writes natural bin order: the TPU's "T-layout" only
// saved a relayout there.
//
// The inverse is the forward transform between two conjugations,
// ifft(z) = conj(fft(conj(z))) / n: the imaginary part changes sign on the
// way in and on the way out and the exact power-of-two 1/n is folded into
// the store, so both directions share every pass and every twiddle.
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
//     k1 + n1 k2 in natural order;
//   * the autocorrelation reads its two operands once and writes one real
//     row: at n <= 16384 the forward passes, the square and the inverse
//     passes run on the row in shared memory in one launch; at n = 32768
//     the square is fused into the middle of the split (column FFTs, then
//     per k1 a row FFT, the square and the first inverse row FFT in place
//     in the scratch buffer, then the inverse column FFTs).

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

// Direction of a transform: the imaginary part is multiplied by `sign` on
// the way in and by `sign * scale` on the way out, the real part by
// `scale`.  Forward: (1, 1).  Inverse: (-1, 1/n).
struct Dir {
  float sign, scale;
};

// One row per block; blockDim.x = n / 16.  yi may be null (the imaginary
// output is then not written).
__global__ void __launch_bounds__(1024)
fft_row_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
               float* __restrict__ yr, float* __restrict__ yi,
               const float2* __restrict__ tw, int log2n, Dir d) {
  extern __shared__ float2 z[];
  const int n = 1 << log2n;
  const size_t off = static_cast<size_t>(blockIdx.x) << log2n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    z[pad(i)] = make_float2(xr[off + i], xi ? d.sign * xi[off + i] : 0.f);
  }
  __syncthreads();
  fft_smem(z, log2n, tw, log2n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float2 v = z[pad(i)];
    yr[off + i] = d.scale * v.x;
    if (yi) yi[off + i] = d.sign * d.scale * v.y;
  }
}

// The fused autocorrelation of one row per block (n <= 16384):
// out = 0.5 * Im(ifft(fft(xr + i xi)^2)).  With S = fft(z)^2 and
// F = fft(conj(S)), ifft(S) = conj(F) / n, so out = -0.5 / n * Im(F).
__global__ void __launch_bounds__(1024)
autocorr_row_kernel(const float* __restrict__ xr,
                    const float* __restrict__ xi, float* __restrict__ out,
                    const float2* __restrict__ tw, int log2n) {
  extern __shared__ float2 z[];
  const int n = 1 << log2n;
  const size_t off = static_cast<size_t>(blockIdx.x) << log2n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    z[pad(i)] = make_float2(xr[off + i], xi[off + i]);
  }
  __syncthreads();
  fft_smem(z, log2n, tw, log2n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float2 v = z[pad(i)];
    z[pad(i)] = make_float2(v.x * v.x - v.y * v.y, -2.f * v.x * v.y);
  }
  __syncthreads();
  fft_smem(z, log2n, tw, log2n);
  const float s = -0.5f / static_cast<float>(n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    out[off + i] = s * z[pad(i)].y;
  }
}

// Four-step, pass 1: for kCols columns t2 of row blockIdx.x, the length-n1
// FFT over t1 of x[t1 * n2 + t2], times W_n^(t2 k1), into y[k1 * n2 + t2].
// blockDim.x = kCols * n1 / 16.
__global__ void __launch_bounds__(128)
fft_col_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
               float2* __restrict__ y, const float2* __restrict__ tw,
               int log2n, float sign) {
  extern __shared__ float2 z[];
  const int n1 = 1 << kLog2N1;
  const int stride = seq_stride(n1);
  const int log2n2 = log2n - kLog2N1;
  const int c0 = blockIdx.y * kCols;
  const size_t off = static_cast<size_t>(blockIdx.x) << log2n;
  for (int idx = threadIdx.x; idx < n1 * kCols; idx += blockDim.x) {
    const int t1 = idx / kCols, c = idx % kCols;
    const size_t g = off + (static_cast<size_t>(t1) << log2n2) + c0 + c;
    z[c * stride + pad(t1)] = make_float2(xr[g], xi ? sign * xi[g] : 0.f);
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
// blockDim.x = kRows * n2 / 16.  yi may be null.
__global__ void __launch_bounds__(1024)
fft_rowpass_kernel(const float2* __restrict__ y, float* __restrict__ yr,
                   float* __restrict__ yi, const float2* __restrict__ tw,
                   int log2n, Dir d) {
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
    yr[o] = d.scale * v.x;
    if (yi) yi[o] = d.sign * d.scale * v.y;
  }
}

// Autocorrelation at n = 32768, middle step, in place in the scratch
// buffer.  For kRows rows k1 of row blockIdx.x: the length-n2 FFT over t2
// of y[k1 * n2 + t2] gives the spectrum's bins k1 + n1 k2; they are
// squared and conjugated; the length-n2 FFT over k2 gives index j2 of the
// transform F = fft(conj(S)) split as bin = k1 + n1 k2, output index
// j1 n2 + j2; times W_n^(k1 j2), back into y[k1 * n2 + j2].
// blockDim.x = kRows * n2 / 16.
__global__ void __launch_bounds__(1024)
autocorr_mid_kernel(float2* __restrict__ y, const float2* __restrict__ tw,
                    int log2n) {
  extern __shared__ float2 z[];
  const int log2n2 = log2n - kLog2N1;
  const int n2 = 1 << log2n2;
  const int n = 1 << log2n;
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
    const int r = idx >> log2n2, k2 = idx & (n2 - 1);
    const float2 v = z[r * stride + pad(k2)];
    z[r * stride + pad(k2)] =
        make_float2(v.x * v.x - v.y * v.y, -2.f * v.x * v.y);
  }
  __syncthreads();
  fft_smem(z, log2n2, tw, log2n);
  for (int idx = threadIdx.x; idx < kRows * n2; idx += blockDim.x) {
    const int r = idx >> log2n2, j2 = idx & (n2 - 1);
    const float2 w = __ldg(&tw[((r0 + r) * j2) & (n - 1)]);
    y[off + (static_cast<size_t>(r0 + r) << log2n2) + j2] =
        cmul(z[r * stride + pad(j2)], w);
  }
}

// Autocorrelation at n = 32768, last step: for kCols columns j2 of row
// blockIdx.x, the length-n1 FFT over k1 of y[k1 * n2 + j2] gives
// F[j1 * n2 + j2]; out = -0.5 / n * Im(F).  blockDim.x = kCols * n1 / 16.
__global__ void __launch_bounds__(128)
autocorr_colout_kernel(const float2* __restrict__ y, float* __restrict__ out,
                       const float2* __restrict__ tw, int log2n) {
  extern __shared__ float2 z[];
  const int n1 = 1 << kLog2N1;
  const int stride = seq_stride(n1);
  const int log2n2 = log2n - kLog2N1;
  const int c0 = blockIdx.y * kCols;
  const size_t off = static_cast<size_t>(blockIdx.x) << log2n;
  for (int idx = threadIdx.x; idx < n1 * kCols; idx += blockDim.x) {
    const int k1 = idx / kCols, c = idx % kCols;
    z[c * stride + pad(k1)] =
        y[off + (static_cast<size_t>(k1) << log2n2) + c0 + c];
  }
  __syncthreads();
  fft_smem(z, kLog2N1, tw, log2n);
  const float s = -0.5f / static_cast<float>(1 << log2n);
  for (int idx = threadIdx.x; idx < n1 * kCols; idx += blockDim.x) {
    const int j1 = idx / kCols, c = idx % kCols;
    out[off + (static_cast<size_t>(j1) << log2n2) + c0 + c] =
        s * z[c * stride + pad(j1)].y;
  }
}

}  // namespace

namespace {

bool bad_args(long long batch, int log2n) {
  return log2n < 11 || log2n > 15 || batch > INT32_MAX;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int transform(const float* xr, const float* xi, float* yr, float* yi,
              void* scratch, const void* tw, long long batch, int log2n,
              Dir d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* twf = static_cast<const float2*>(tw);
  if (batch <= 0) return 0;
  if (bad_args(batch, log2n)) return static_cast<int>(cudaErrorInvalidValue);
  if (log2n <= kMaxSinglePassLog2) {
    const int smem = static_cast<int>(sizeof(float2)) * seq_stride(1 << log2n);
    cudaError_t e = allow_smem(fft_row_kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    fft_row_kernel<<<static_cast<unsigned>(batch), (1 << log2n) / 16, smem,
                     st>>>(xr, xi, yr, yi, twf, log2n, d);
    return static_cast<int>(cudaGetLastError());
  }
  const int n1 = 1 << kLog2N1;
  const int n2 = 1 << (log2n - kLog2N1);
  float2* y = static_cast<float2*>(scratch);
  fft_col_kernel<<<dim3(static_cast<unsigned>(batch), n2 / kCols),
                   kCols * n1 / 16, sizeof(float2) * seq_stride(n1) * kCols,
                   st>>>(xr, xi, y, twf, log2n, d.sign);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  fft_rowpass_kernel<<<dim3(static_cast<unsigned>(batch), n1 / kRows),
                       kRows * n2 / 16, sizeof(float2) * seq_stride(n2) * kRows,
                       st>>>(y, yr, yi, twf, log2n, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xr, xi: (batch, n) fp32 rows (xi may be null: real input).
// yr, yi: (batch, n) fp32 natural-order spectrum.  scratch: batch * n
// float2, used only when n > 2^14.  tw: n float2, exp(-2 pi i k / n).
// Returns the CUDA error code of the launches (0 on success).
extern "C" int af_fft_pow2_fwd(const float* xr, const float* xi, float* yr,
                               float* yi, void* scratch, const void* tw,
                               long long batch, int log2n, void* stream) {
  return transform(xr, xi, yr, yi, scratch, tw, batch, log2n, Dir{1.f, 1.f},
                   stream);
}

// The inverse, 1/n included: yr, yi (batch, n) natural-order spectrum ->
// xr, xi (batch, n) signal.  xi may be null: the imaginary output is then
// not written.  scratch and tw as above.
extern "C" int af_fft_pow2_inv(const float* yr, const float* yi, float* xr,
                               float* xi, void* scratch, const void* tw,
                               long long batch, int log2n, void* stream) {
  return transform(yr, yi, xr, xi, scratch, tw, batch, log2n,
                   Dir{-1.f, 1.f / static_cast<float>(1 << log2n)}, stream);
}

// out = 0.5 * Im(ifft(fft(xr + i xi)^2)), all (batch, n) fp32.  scratch and
// tw as above.
extern "C" int af_fft_pow2_autocorr(const float* xr, const float* xi,
                                    float* out, void* scratch, const void* tw,
                                    long long batch, int log2n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* twf = static_cast<const float2*>(tw);
  if (batch <= 0) return 0;
  if (bad_args(batch, log2n)) return static_cast<int>(cudaErrorInvalidValue);
  if (log2n <= kMaxSinglePassLog2) {
    const int smem = static_cast<int>(sizeof(float2)) * seq_stride(1 << log2n);
    cudaError_t e = allow_smem(autocorr_row_kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    autocorr_row_kernel<<<static_cast<unsigned>(batch), (1 << log2n) / 16,
                          smem, st>>>(xr, xi, out, twf, log2n);
    return static_cast<int>(cudaGetLastError());
  }
  const int n1 = 1 << kLog2N1;
  const int n2 = 1 << (log2n - kLog2N1);
  const unsigned b = static_cast<unsigned>(batch);
  float2* y = static_cast<float2*>(scratch);
  fft_col_kernel<<<dim3(b, n2 / kCols), kCols * n1 / 16,
                   sizeof(float2) * seq_stride(n1) * kCols, st>>>(
      xr, xi, y, twf, log2n, 1.f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  autocorr_mid_kernel<<<dim3(b, n1 / kRows), kRows * n2 / 16,
                        sizeof(float2) * seq_stride(n2) * kRows, st>>>(
      y, twf, log2n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  autocorr_colout_kernel<<<dim3(b, n2 / kCols), kCols * n1 / 16,
                           sizeof(float2) * seq_stride(n1) * kCols, st>>>(
      y, out, twf, log2n);
  return static_cast<int>(cudaGetLastError());
}
