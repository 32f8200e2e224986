// Register-resident DFTs of 16, 32 and 64 points for fused_mel_mfcc.cu.
//
// A thread holds all R points of one transform in registers and runs the
// log2 R radix-2 decimation-in-time stages there, with the 64th roots of
// unity as literals.  Every loop has a constant trip count, so after
// unrolling every index into the point array and into the root tables is a
// constant: the array stays in registers (ptxas must report no stack frame)
// and a multiplication by 1 or by -i costs no multiply.
#pragma once

#include <cuda_runtime.h>

namespace afx {

// x (< 256) with its low `bits` bits reversed.  No loop: the index of a
// register array must fold to a constant wherever it is used.
__host__ __device__ constexpr int bit_reverse(int x, int bits) {
  x = ((x & 0xF0) >> 4) | ((x & 0x0F) << 4);
  x = ((x & 0xCC) >> 2) | ((x & 0x33) << 2);
  x = ((x & 0xAA) >> 1) | ((x & 0x55) << 1);
  return x >> (8 - bits);
}

__host__ __device__ constexpr int ilog2(int x) {
  int r = 0;
  while ((1 << r) < x) ++r;
  return r;
}

// One radix-2 decimation-in-time stage over v[0..R): butterflies between
// halves of length 2^S, twiddle exp(-2 pi i p / 2^(S+1)).
template <int R, int S>
__device__ __forceinline__ void reg_dit_stage(float2* v) {
  // cos and -sin of 2 pi q / 64, q = 0..31
  constexpr float kC[32] = {
      1.0f, 0.99518472667219693f, 0.98078528040323043f,
      0.95694033573220882f, 0.92387953251128674f, 0.88192126434835505f,
      0.83146961230254524f, 0.77301045336273699f, 0.70710678118654757f,
      0.63439328416364549f, 0.55557023301960229f, 0.47139673682599781f,
      0.38268343236508984f, 0.29028467725446233f, 0.19509032201612833f,
      0.09801714032956077f, 0.0f, -0.098017140329560645f,
      -0.19509032201612819f, -0.29028467725446216f, -0.38268343236508973f,
      -0.4713967368259977f, -0.55557023301960196f, -0.63439328416364538f,
      -0.70710678118654746f, -0.77301045336273699f, -0.83146961230254535f,
      -0.88192126434835494f, -0.92387953251128674f, -0.95694033573220882f,
      -0.98078528040323043f, -0.99518472667219682f};
  constexpr float kS[32] = {
      0.0f, -0.098017140329560604f, -0.19509032201612825f,
      -0.29028467725446233f, -0.38268343236508978f, -0.47139673682599764f,
      -0.55557023301960218f, -0.63439328416364549f, -0.70710678118654746f,
      -0.77301045336273699f, -0.83146961230254524f, -0.88192126434835494f,
      -0.92387953251128674f, -0.95694033573220894f, -0.98078528040323043f,
      -0.99518472667219682f, -1.0f, -0.99518472667219693f,
      -0.98078528040323043f, -0.95694033573220894f, -0.92387953251128674f,
      -0.88192126434835505f, -0.83146961230254546f, -0.7730104533627371f,
      -0.70710678118654757f, -0.63439328416364549f, -0.55557023301960218f,
      -0.47139673682599786f, -0.38268343236508989f, -0.29028467725446239f,
      -0.19509032201612861f, -0.098017140329560826f};
  constexpr int h = 1 << S;
#pragma unroll
  for (int b = 0; b < R / 2; ++b) {
    const int p = b & (h - 1);
    const int i0 = ((b >> S) << (S + 1)) + p;
    const int q = p * (32 >> S);  // root index of 64
    const float2 u = v[i0];
    float2 t = v[i0 + h];
    if (q == 16) {
      t = make_float2(t.y, -t.x);  // times -i
    } else if (q != 0) {
      t = make_float2(t.x * kC[q] - t.y * kS[q], t.x * kS[q] + t.y * kC[q]);
    }
    v[i0] = make_float2(u.x + t.x, u.y + t.y);
    v[i0 + h] = make_float2(u.x - t.x, u.y - t.y);
  }
}

// R-point DFT (R = 2 .. 64) in registers: v holds the input in bit-reversed
// order (point j at v[bit_reverse(j, log2 R)]), the output in natural order.
template <int R>
__device__ __forceinline__ void reg_dft(float2* v) {
  reg_dit_stage<R, 0>(v);
  if constexpr (R > 2) reg_dit_stage<R, 1>(v);
  if constexpr (R > 4) reg_dit_stage<R, 2>(v);
  if constexpr (R > 8) reg_dit_stage<R, 3>(v);
  if constexpr (R > 16) reg_dit_stage<R, 4>(v);
  if constexpr (R > 32) reg_dit_stage<R, 5>(v);
}

}  // namespace afx
