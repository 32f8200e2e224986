// Shared-memory FFT used by fft_pow2.cu and fused_mel_mfcc.cu.
//
// A Stockham (self-sorting) FFT: each pass reads R points per work item at
// stride L/R, twiddles them, runs an R-point DFT in registers and writes
// them at stride Ns; natural order in, natural order out, no bit reversal.
// Radix 16 while it fits, then one pass of radix 2, 4 or 8, so a
// 2048-point transform takes three passes over shared memory instead of
// the eleven stages of radix 2.
//
// Layout: `nseq` sequences of length L = 2^log2L, sequence q starting at
// float2 index q * seq_stride(L), element e at e + e/16 within it.  The
// padding keeps the stride-16 accesses of the first pass, and the
// different sequences read by one warp, on distinct banks.
//
// Each pass is in place: every thread reads all of its points into
// registers, the block synchronises, then every thread writes.  That
// needs blockDim.x * 16 == nseq * L (each thread holds 16 points).
//
// The twiddle table is built on the host in float64 and stored as fp32
// (tw[k] = exp(-2 pi i k / tw_n), all tw_n entries, tw_n >= L), so no
// fast-math sine or cosine enters the transform.
#pragma once

#include <cuda_runtime.h>

namespace afx {

__host__ __device__ constexpr int seq_stride(int L) { return L + (L >> 4) + 4; }

__device__ __forceinline__ int pad(int e) { return e + (e >> 4); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// One radix-2 decimation-in-time stage (halves of length 2^S) over v[0..R),
// with the 16th roots of unity as literals.  Every loop has a constant trip
// count, so after unrolling every index is a constant and v stays in
// registers.
template <int R, int S>
__device__ __forceinline__ void dit_stage(float2* v) {
  constexpr float kC[8] = {1.0f, 0.92387953251128674f, 0.70710678118654752f,
                           0.38268343236508978f, 0.0f, -0.38268343236508978f,
                           -0.70710678118654752f, -0.92387953251128674f};
  constexpr float kS[8] = {0.0f, -0.38268343236508978f, -0.70710678118654752f,
                           -0.92387953251128674f, -1.0f, -0.92387953251128674f,
                           -0.70710678118654752f, -0.38268343236508978f};
  constexpr int h = 1 << S;
#pragma unroll
  for (int b = 0; b < R / 2; ++b) {
    const int p = b & (h - 1);
    const int i0 = ((b >> S) << (S + 1)) + p;
    const float2 u = v[i0];
    float2 t = v[i0 + h];
    if (p != 0) t = cmul(t, make_float2(kC[p * (8 >> S)], kS[p * (8 >> S)]));
    v[i0] = make_float2(u.x + t.x, u.y + t.y);
    v[i0 + h] = make_float2(u.x - t.x, u.y - t.y);
  }
}

// R-point DFT (R = 2, 4, 8, 16) in registers: v holds the input in
// bit-reversed order, the output in natural order.
template <int R>
__device__ __forceinline__ void dft_reg(float2* v) {
  dit_stage<R, 0>(v);
  if constexpr (R > 2) dit_stage<R, 1>(v);
  if constexpr (R > 4) dit_stage<R, 2>(v);
  if constexpr (R > 8) dit_stage<R, 3>(v);
}

// One in-place Stockham pass of radix R over all sequences; Ns = 2^log2Ns
// is the product of the earlier passes' radices.
template <int R>
__device__ __forceinline__ void stockham_pass(float2* z, int log2L,
                                              int log2Ns,
                                              const float2* __restrict__ tw,
                                              int log2tw) {
  constexpr int kIt = 16 / R;
  constexpr int kLog2R = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : 4;
  const int log2per = log2L - kLog2R;  // work items per sequence: L / R
  const int per = 1 << log2per;
  const int stride = seq_stride(1 << log2L);
  const int ns = 1 << log2Ns;
  const int tw_shift = log2tw - log2Ns - kLog2R;
  constexpr int kRev16[16] = {0, 8, 4, 12, 2, 10, 6, 14,
                              1, 9, 5, 13, 3, 11, 7, 15};  // 4-bit reversal
  float2 v[16];
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int item = threadIdx.x + it * blockDim.x;
    const int q = item >> log2per, j = item & (per - 1);
    const int k = j & (ns - 1);
    float2* zq = z + q * stride;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float2 a = zq[pad(j + (r << log2per))];
      if (r > 0 && log2Ns > 0) a = cmul(a, __ldg(&tw[(k * r) << tw_shift]));
      v[it * R + (kRev16[r] >> (4 - kLog2R))] = a;
    }
    dft_reg<R>(v + it * R);
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int item = threadIdx.x + it * blockDim.x;
    const int q = item >> log2per, j = item & (per - 1);
    const int k = j & (ns - 1);
    const int dst = ((j - k) << kLog2R) + k;
    float2* zq = z + q * stride;
#pragma unroll
    for (int r = 0; r < R; ++r) zq[pad(dst + (r << log2Ns))] = v[it * R + r];
  }
  __syncthreads();
}

// The whole transform of every sequence (log2L >= 4).  The caller fills
// the sequences and synchronises first; the block is synchronised on
// return.
__device__ __forceinline__ void fft_smem(float2* z, int log2L,
                                         const float2* __restrict__ tw,
                                         int log2tw) {
  int log2Ns = 0;
  for (; log2Ns + 4 <= log2L; log2Ns += 4) {
    stockham_pass<16>(z, log2L, log2Ns, tw, log2tw);
  }
  switch (log2L - log2Ns) {
    case 1: stockham_pass<2>(z, log2L, log2Ns, tw, log2tw); break;
    case 2: stockham_pass<4>(z, log2L, log2Ns, tw, log2tw); break;
    case 3: stockham_pass<8>(z, log2L, log2Ns, tw, log2tw); break;
    default: break;
  }
}

}  // namespace afx
