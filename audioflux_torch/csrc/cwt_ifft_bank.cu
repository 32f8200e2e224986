// The CWT/PWT filterbank convolution in the frequency domain, fp32:
//   out[b, j, m] = ifft(bank[j] * F[b])[pad + m],  0 <= m < length,
// 1/N included, times i when `det` (the derivative bank).  F is the (B, N)
// complex spectrum of the padded signal, bank the (num, N) real wavelet
// bank, N a power of two in [2^14, 2^17].
//
// Replaces the TPU kernel audioflux_tpu/ops/pallas_cwt.py:cwt_ifft_bank.
// That kernel contracts dense DFT matrices on the matrix unit; this one is
// a four-step FFT, and shares nothing with it but the contract.
//
// What bounds it on the card: a band-row reads little (its share of F and
// the nonzero part of its bank row) and writes 8 * length bytes, against
// 5 N log2 N flops: device memory is the bound.  A band's N complex points
// (512 KB at N = 65536) do not fit a block's shared memory, so the
// transform is split N = n1 * n2 (n1 = 2^ceil(log2 N / 2)) into two
// launches that meet in a scratch buffer:
//   * pass 1 (cwt_col_kernel): for 16 columns t2, load bank * conj(F) at
//     k = t1 * n2 + t2 (the product never exists in device memory), run the
//     length-n1 FFTs over t1 in shared memory, multiply by W_N^(t2 k1) and
//     store y[k1 * n2 + t2];
//   * pass 2 (cwt_row_kernel): for 16 rows k1, the length-n2 FFTs over t2;
//     bin k2 is sample n = k1 + n1 * k2 of conj(ifft) * N, and only the
//     samples pad <= n < pad + length are stored, conjugated, scaled by the
//     exact power of two 1/N and rotated by i when det.
// The host function walks the B * num band-rows in chunks of `chunk` rows
// and reuses one scratch buffer, which bounds the scratch (8 N bytes a
// row).  Chunks small enough for the scratch to stay in the 50 MB L2 cache
// measured slower on the H100 than large ones (each pair of launches ends
// in a tail of idle SMs, which costs more than the saved device-memory
// traffic), so the caller's default is a large chunk.
//
// Support slicing: the banks are analytic, a band's nonzero bins are a
// leading run, so only the first rows_h[j] rows t1 of the (n1, n2) view
// hold a nonzero.  Pass 1 loads those rows only and takes the rest as the
// exact zeros they are; the result is the same value for value.
//
// The inverse is the forward transform between two conjugations,
// ifft(z) = conj(fft(conj(z))) / N, so the passes and the float64-built
// twiddle table exp(-2 pi i k / N) are those of fft_pow2.cu.

#include <cstdint>

#include "fft_smem.cuh"

using afx::cmul;
using afx::fft_smem;
using afx::pad;
using afx::seq_stride;

namespace {

constexpr int kCols = 16;  // columns t2 per block in pass 1
constexpr int kRows = 16;  // rows k1 per block in pass 2

// Pass 1.  grid (rows of this chunk, n2 / kCols), blockDim.x = n1.
// Band-row r = row0 + blockIdx.x is clip r / num, band r % num.
__global__ void __launch_bounds__(512)
cwt_col_kernel(const float2* __restrict__ F, const float* __restrict__ bank,
               const int* __restrict__ rows_h, float2* __restrict__ y,
               const float2* __restrict__ tw, int log2n, int log2n1, int num,
               long long row0) {
  extern __shared__ float2 z[];
  const int n = 1 << log2n;
  const int n1 = 1 << log2n1;
  const int log2n2 = log2n - log2n1;
  const int stride = seq_stride(n1);
  const long long r = row0 + blockIdx.x;
  const int j = static_cast<int>(r % num);
  const float2* Fb = F + ((r / num) << log2n);
  const float* bk = bank + (static_cast<size_t>(j) << log2n);
  const int c0 = blockIdx.y * kCols;
  const int h = rows_h ? min(rows_h[j], n1) : n1;
  for (int idx = threadIdx.x; idx < n1 * kCols; idx += blockDim.x) {
    const int t1 = idx / kCols, c = idx % kCols;
    float2 v = make_float2(0.f, 0.f);
    if (t1 < h) {
      const int g = (t1 << log2n2) + c0 + c;
      const float2 f = Fb[g];
      const float w = bk[g];
      v = make_float2(w * f.x, -(w * f.y));
    }
    z[c * stride + pad(t1)] = v;
  }
  __syncthreads();
  fft_smem(z, log2n1, tw, log2n);
  float2* yr = y + (static_cast<size_t>(blockIdx.x) << log2n);
  for (int idx = threadIdx.x; idx < n1 * kCols; idx += blockDim.x) {
    const int k1 = idx / kCols, c = idx % kCols;
    const int t2 = c0 + c;
    const float2 w = __ldg(&tw[(t2 * k1) & (n - 1)]);
    yr[(k1 << log2n2) + t2] = cmul(z[c * stride + pad(k1)], w);
  }
}

// Pass 2.  grid (rows of this chunk, n1 / kRows), blockDim.x = n2.
__global__ void __launch_bounds__(256)
cwt_row_kernel(const float2* __restrict__ y, float2* __restrict__ out,
               const float2* __restrict__ tw, int log2n, int log2n1, int pad_n,
               int length, long long row0, int det) {
  extern __shared__ float2 z[];
  const int log2n2 = log2n - log2n1;
  const int n2 = 1 << log2n2;
  const int stride = seq_stride(n2);
  const int r0 = blockIdx.y * kRows;
  const float2* yr = y + (static_cast<size_t>(blockIdx.x) << log2n);
  for (int idx = threadIdx.x; idx < kRows * n2; idx += blockDim.x) {
    const int r = idx >> log2n2, t2 = idx & (n2 - 1);
    z[r * stride + pad(t2)] = yr[((r0 + r) << log2n2) + t2];
  }
  __syncthreads();
  fft_smem(z, log2n2, tw, log2n);
  const float scale = 1.f / static_cast<float>(1 << log2n);
  float2* o = out + static_cast<size_t>(row0 + blockIdx.x) * length;
  for (int idx = threadIdx.x; idx < kRows * n2; idx += blockDim.x) {
    const int r = idx % kRows, k2 = idx / kRows;
    const int m = r0 + r + (k2 << log2n1) - pad_n;
    if (m < 0 || m >= length) continue;
    const float2 v = z[r * stride + pad(k2)];
    const float re = scale * v.x, im = -scale * v.y;
    o[m] = det ? make_float2(-im, re) : make_float2(re, im);
  }
}

}  // namespace

// F: (batch, N) complex64.  bank: (num, N) fp32.  rows_h: num int32 leading
// row counts of the (n1, n2) view, or null for all n1.  out: (batch, num,
// length) complex64.  scratch: chunk * N float2.  tw: N float2,
// exp(-2 pi i k / N).  Returns the CUDA error code of the launches.
extern "C" int af_cwt_ifft_bank(const void* F, const float* bank,
                                const int* rows_h, void* out, void* scratch,
                                const void* tw, long long batch, int num,
                                int log2n, int pad_n, int length, int det,
                                long long chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = batch * num;
  if (total <= 0 || length <= 0) return 0;
  if (log2n < 14 || log2n > 17 || chunk <= 0 || pad_n < 0 ||
      static_cast<long long>(pad_n) + length > (1LL << log2n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int log2n1 = (log2n + 1) / 2;
  const int n1 = 1 << log2n1, n2 = 1 << (log2n - log2n1);
  const int smem1 = static_cast<int>(sizeof(float2)) * seq_stride(n1) * kCols;
  const int smem2 = static_cast<int>(sizeof(float2)) * seq_stride(n2) * kRows;
  cudaError_t e = cudaFuncSetAttribute(
      cwt_col_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(
      cwt_row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float2* twf = static_cast<const float2*>(tw);
  float2* y = static_cast<float2*>(scratch);
  for (long long row0 = 0; row0 < total; row0 += chunk) {
    const unsigned cnt =
        static_cast<unsigned>(total - row0 < chunk ? total - row0 : chunk);
    cwt_col_kernel<<<dim3(cnt, n2 / kCols), n1, smem1, st>>>(
        static_cast<const float2*>(F), bank, rows_h, y, twf, log2n, log2n1,
        num, row0);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    cwt_row_kernel<<<dim3(cnt, n1 / kRows), n2, smem2, st>>>(
        y, static_cast<float2*>(out), twf, log2n, log2n1, pad_n, length, row0,
        det);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}
