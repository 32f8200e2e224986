// Phase unwrap along time and backward difference in one pass, fp32:
//   k[j] in {-t, 0, t} from the principal difference of the wrapped samples
//   x[j], x[j-1] (k[0] = 0);  c = inclusive prefix sum of k;
//   y = x + c * 2 pi;  e[j] = y[j] - y[j-1],  e[0] = 0.
//
// Replaces the TPU kernel audioflux_tpu/ops/pallas_unwrap.py:unwrap_diff
// (the reference C's __vunwrap followed by a difference).  That kernel
// takes its prefix sum as a triangular matrix product; here it is a scan.
//
// What bounds it on the card: 4 bytes read and 4 written per sample against
// a dozen operations: device memory.  One block walks one row in chunks of
// blockDim.x samples; the wrap counts are scanned as int32 with warp
// shuffles and the warps' totals through shared memory, and the count at
// the end of a chunk is carried to the next, so the phase is read once and
// the difference written once (the second load of x[j-1] hits the cache).
// y[j-1] is recomputed from x[j-1] and c[j] - k[j], so no unwrapped phase
// crosses threads.
//
// Exactness: every fp32 operation is one of the plain version's, each
// rounded on its own (__fsub_rn, __fdiv_rn, __fmul_rn, __fadd_rn, so nvcc
// contracts no multiply-add), and the counts are integers, so the output
// equals the plain version's bit for bit.  The phases must be finite and
// the counts must fit 2^24, as a float holds them exactly.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr float kTwoPi = 6.28318548202514648f;  // float32(2 pi)
constexpr float kPi = 3.14159274101257324f;     // float32(pi)

__device__ __forceinline__ int wrap_count(float xc, float xp) {
  const float sub = fabsf(__fsub_rn(xc, xp));
  if (sub < kPi) return 0;
  const float t = floorf(__fdiv_rn(sub, kTwoPi));
  const float mod = __fsub_rn(sub, __fmul_rn(t, kTwoPi));
  const int ti = static_cast<int>(t) + (mod > kPi ? 1 : 0);
  return xc > xp ? -ti : ti;
}

__global__ void __launch_bounds__(kThreads)
unwrap_diff_kernel(const float* __restrict__ x, float* __restrict__ e,
                   long long T) {
  __shared__ int warp_tot[kThreads / 32];
  const float* xr = x + static_cast<size_t>(blockIdx.x) * T;
  float* er = e + static_cast<size_t>(blockIdx.x) * T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;  // the count at the end of the previous chunk
  for (long long base = 0; base < T; base += kThreads) {
    const long long j = base + threadIdx.x;
    const bool live = j < T;
    float xc = 0.f, xp = 0.f;
    int k = 0;
    if (live) {
      xc = xr[j];
      xp = j > 0 ? xr[j - 1] : xc;
      k = j > 0 ? wrap_count(xc, xp) : 0;
    }
    int c = k;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, c, o);
      if (lane >= o) c += v;
    }
    if (lane == 31) warp_tot[warp] = c;
    __syncthreads();
    int before = carry, total = carry;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      const int v = warp_tot[w];
      total += v;
      if (w < warp) before += v;
    }
    c += before;
    if (live) {
      const float y = __fadd_rn(xc, __fmul_rn(static_cast<float>(c), kTwoPi));
      const float yp =
          __fadd_rn(xp, __fmul_rn(static_cast<float>(c - k), kTwoPi));
      er[j] = j > 0 ? __fsub_rn(y, yp) : 0.f;
    }
    carry = total;
    __syncthreads();  // warp_tot is rewritten by the next chunk
  }
}

}  // namespace

// x, e: (rows, T) fp32, contiguous.  Returns the CUDA error code.
extern "C" int af_unwrap_diff(const float* x, float* e, long long rows,
                              long long T, void* stream) {
  if (rows <= 0 || T <= 0) return 0;
  if (rows > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  unwrap_diff_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, e, T);
  return static_cast<int>(cudaGetLastError());
}
