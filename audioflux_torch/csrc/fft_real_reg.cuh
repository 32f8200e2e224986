// The real-row route's complex transform of N = n / 2 points in registers
// (fft_pow2.cu: real_fwd_kernel, real_inv_kernel; n = 8192, 16384, 32768).
//
// N = 64 * B with B = 64 C, C = 1, 2, 4.  One block of T = B threads holds
// one row, 64 points a thread, and the blocks are persistent: each walks
// its rows with the next row's input already in flight (cp.async, or a 1-D
// TMA bulk copy that completes on an mbarrier).  With j = j1 B + j2 and
// k = k1 + 64 k2:
//   pass 1: thread t runs the 64-point DFT over j1 of column j2 = t
//           (reg_dft, input in bit-reversed order), times W_N^(t k1), the
//           product of two exact fp32 twiddles W_N^(t r) W_N^(8 t q),
//           k1 = 8 q + r, from the host's table;
//   transpose: through the block's buffer of 64 rows of P = B + C floats,
//           real parts, then imaginary parts (half the bytes of a complex
//           buffer);
//   pass 2: thread u = g C + jb runs the 64-point DFT over ja of row
//           k1 = g at the points j2 = ja C + jb, times W_B^(jb ka), a
//           literal (w256) for each jb;
//   pass 3 (C > 1): the C-point DFT over jb across the C neighbouring
//           lanes of row g, by __shfl_xor butterflies (decimation in
//           frequency), which leaves lane jb with kb = bitrev_C(jb).
// Thread u then holds Z[g + 64 ka + 4096 kb] in v[ka], ka = 0..63.  Shared
// memory serves only the one transpose; with 64 complex points a thread,
// a row of 16384 points is 256 threads, and one such block an SM holds the
// row, its next row's staged input and the buffer (about 200 KB at most).
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fft_reg.cuh"
#include "fft_smem.cuh"

namespace afx {

template <int C>
struct RealRoute {
  static_assert(C == 1 || C == 2 || C == 4, "N = 4096, 8192 or 16384");
  static constexpr int kN = 4096 * C;      // points of the complex transform
  static constexpr int kB = 64 * C;        // columns = threads of a block
  static constexpr int kP = kB + C;        // a row of the transpose buffer
  static constexpr int kBuf = 64 * kP;     // words of the transpose buffer
  static constexpr int kLogC = C == 1 ? 0 : C == 2 ? 1 : 2;
  static constexpr int kPad = 16 / C;      // the pair buffer's skew a 4096
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- the mbarrier of a block's staging buffer (TMA bulk copies) ---------
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread: a 1-D TMA copy of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) from src into dst that completes its bytes of the
// barrier's current phase.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One thread: order the block's earlier reads of the staging buffer before
// the async proxy's writes, and make the barrier's one arrival of the
// phase, expecting `total` bytes.
__device__ __forceinline__ void bulk_expect(uint32_t total, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(total)
               : "memory");
}

// One thread: copy `bytes` from src into dst; the copy completes the
// barrier's current phase.
__device__ __forceinline__ void bulk_fetch(void* dst, const void* src,
                                           uint32_t bytes, uint64_t* bar) {
  bulk_expect(bytes, bar);
  bulk_copy(dst, src, bytes, bar);
}

// The same for two copies of `bytes` each that complete one phase
// together: the arrival expects both before either is issued.
__device__ __forceinline__ void bulk_fetch2(void* dst0, const void* src0,
                                            void* dst1, const void* src1,
                                            uint32_t bytes, uint64_t* bar) {
  bulk_expect(2 * bytes, bar);
  bulk_copy(dst0, src0, bytes, bar);
  bulk_copy(dst1, src1, bytes, bar);
}

// Every thread: wait until the phase of parity `phase` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(phase)
        : "memory");
  }
}

// All T threads: copy `count` floats of src into dst[s0 ..], asynchronously
// (cp.async; the caller commits).  `wide`: src and dst + s0 agree modulo
// 16 bytes, so the body goes as 16-byte copies, the ragged ends as floats;
// else every float alone.
__device__ __forceinline__ void fetch_floats(float* dst, const float* src,
                                             int count, int s0, bool wide,
                                             int t, int T) {
  dst += s0;
  int head = 0, body = 0;
  if (wide) {
    head = (4 - (s0 & 3)) & 3;
    if (head > count) head = count;
    body = (count - head) & ~3;
    for (int i = head + 4 * t; i < head + body; i += 4 * T) {
      __pipeline_memcpy_async(dst + i, src + i, 16);
    }
  }
  for (int i = t; i < head; i += T) __pipeline_memcpy_async(dst + i, src + i, 4);
  for (int i = head + body + t; i < count; i += T) {
    __pipeline_memcpy_async(dst + i, src + i, 4);
  }
}

// W_256^m = (cos, -sin of 2 pi m / 256), m < 192, as literals: the
// twiddles whose exponent an unrolled loop knows (pass 2's W_B^(jb ka) for
// each jb, the split's and the merge's W_128^i), so that they are
// immediates, exact to an fp32 rounding, and nothing is loaded
__device__ __forceinline__ float2 w256(int m) {
  constexpr float kC[192] = {
      1.0, 0.9996988186962042, 0.9987954562051724, 0.9972904566786902,
      0.9951847266721969, 0.99247953459871, 0.989176509964781,
      0.9852776423889412, 0.9807852804032304, 0.9757021300385286,
      0.970031253194544, 0.9637760657954398, 0.9569403357322088,
      0.9495281805930367, 0.9415440651830208, 0.932992798834739,
      0.9238795325112867, 0.9142097557035307, 0.9039892931234433,
      0.8932243011955153, 0.881921264348355, 0.8700869911087115,
      0.8577286100002721, 0.8448535652497071, 0.8314696123025452,
      0.8175848131515837, 0.8032075314806449, 0.7883464276266063,
      0.773010453362737, 0.7572088465064846, 0.7409511253549591,
      0.724247082951467, 0.7071067811865476, 0.6895405447370669,
      0.6715589548470183, 0.6531728429537768, 0.6343932841636455,
      0.6152315905806268, 0.5956993044924335, 0.5758081914178453,
      0.5555702330196023, 0.5349976198870973, 0.5141027441932217,
      0.4928981922297841, 0.4713967368259978, 0.4496113296546066,
      0.4275550934302822, 0.40524131400498986, 0.38268343236508984,
      0.3598950365349883, 0.33688985339222005, 0.3136817403988916,
      0.29028467725446233, 0.2667127574748984, 0.24298017990326398,
      0.21910124015686977, 0.19509032201612833, 0.17096188876030136,
      0.14673047445536175, 0.12241067519921628, 0.09801714032956077,
      0.07356456359966745, 0.049067674327418126, 0.024541228522912264,
      6.123233995736766e-17, -0.024541228522912142, -0.04906767432741801,
      -0.07356456359966733, -0.09801714032956065, -0.12241067519921615,
      -0.14673047445536164, -0.17096188876030124, -0.1950903220161282,
      -0.21910124015686966, -0.24298017990326387, -0.2667127574748983,
      -0.29028467725446216, -0.3136817403988914, -0.33688985339221994,
      -0.35989503653498817, -0.3826834323650897, -0.40524131400498975,
      -0.42755509343028186, -0.4496113296546067, -0.4713967368259977,
      -0.492898192229784, -0.5141027441932217, -0.534997619887097,
      -0.555570233019602, -0.5758081914178453, -0.5956993044924334,
      -0.6152315905806267, -0.6343932841636454, -0.6531728429537765,
      -0.6715589548470184, -0.6895405447370669, -0.7071067811865475,
      -0.7242470829514668, -0.7409511253549589, -0.7572088465064846,
      -0.773010453362737, -0.7883464276266062, -0.8032075314806448,
      -0.8175848131515836, -0.8314696123025453, -0.8448535652497071,
      -0.857728610000272, -0.8700869911087113, -0.8819212643483549,
      -0.8932243011955152, -0.9039892931234433, -0.9142097557035307,
      -0.9238795325112867, -0.9329927988347388, -0.9415440651830207,
      -0.9495281805930367, -0.9569403357322088, -0.9637760657954398,
      -0.970031253194544, -0.9757021300385285, -0.9807852804032304,
      -0.9852776423889412, -0.989176509964781, -0.99247953459871,
      -0.9951847266721968, -0.9972904566786902, -0.9987954562051724,
      -0.9996988186962042, -1.0, -0.9996988186962042, -0.9987954562051724,
      -0.9972904566786902, -0.9951847266721969, -0.99247953459871,
      -0.989176509964781, -0.9852776423889413, -0.9807852804032304,
      -0.9757021300385286, -0.970031253194544, -0.96377606579544,
      -0.9569403357322089, -0.9495281805930368, -0.9415440651830208,
      -0.932992798834739, -0.9238795325112868, -0.9142097557035307,
      -0.9039892931234434, -0.8932243011955153, -0.881921264348355,
      -0.8700869911087115, -0.8577286100002721, -0.8448535652497072,
      -0.8314696123025455, -0.8175848131515837, -0.8032075314806449,
      -0.7883464276266063, -0.7730104533627371, -0.7572088465064848,
      -0.7409511253549591, -0.724247082951467, -0.7071067811865477,
      -0.689540544737067, -0.6715589548470187, -0.6531728429537771,
      -0.6343932841636459, -0.6152315905806273, -0.5956993044924331,
      -0.5758081914178452, -0.5555702330196022, -0.5349976198870973,
      -0.5141027441932218, -0.4928981922297842, -0.47139673682599786,
      -0.44961132965460693, -0.4275550934302825, -0.40524131400499036,
      -0.38268343236509034, -0.35989503653498794, -0.33688985339221994,
      -0.31368174039889146, -0.29028467725446244, -0.26671275747489853,
      -0.24298017990326412, -0.2191012401568701, -0.19509032201612866,
      -0.1709618887603017, -0.1467304744553623, -0.12241067519921596,
      -0.09801714032956045, -0.07356456359966736, -0.04906767432741803,
      -0.02454122852291239};
  constexpr float kS[192] = {
      -0.0, -0.024541228522912288, -0.049067674327418015,
      -0.07356456359966743, -0.0980171403295606, -0.1224106751992162,
      -0.14673047445536175, -0.17096188876030122, -0.19509032201612825,
      -0.2191012401568698, -0.24298017990326387, -0.26671275747489837,
      -0.29028467725446233, -0.3136817403988915, -0.33688985339222005,
      -0.3598950365349881, -0.3826834323650898, -0.40524131400498986,
      -0.4275550934302821, -0.44961132965460654, -0.47139673682599764,
      -0.49289819222978404, -0.5141027441932217, -0.5349976198870972,
      -0.5555702330196022, -0.5758081914178453, -0.5956993044924334,
      -0.6152315905806268, -0.6343932841636455, -0.6531728429537768,
      -0.6715589548470183, -0.6895405447370668, -0.7071067811865475,
      -0.7242470829514669, -0.7409511253549591, -0.7572088465064845,
      -0.773010453362737, -0.7883464276266062, -0.8032075314806448,
      -0.8175848131515837, -0.8314696123025452, -0.844853565249707,
      -0.8577286100002721, -0.8700869911087113, -0.8819212643483549,
      -0.8932243011955153, -0.9039892931234433, -0.9142097557035307,
      -0.9238795325112867, -0.9329927988347388, -0.9415440651830208,
      -0.9495281805930367, -0.9569403357322089, -0.9637760657954398,
      -0.970031253194544, -0.9757021300385286, -0.9807852804032304,
      -0.9852776423889412, -0.989176509964781, -0.99247953459871,
      -0.9951847266721968, -0.9972904566786902, -0.9987954562051724,
      -0.9996988186962042, -1.0, -0.9996988186962042, -0.9987954562051724,
      -0.9972904566786902, -0.9951847266721969, -0.99247953459871,
      -0.989176509964781, -0.9852776423889412, -0.9807852804032304,
      -0.9757021300385286, -0.970031253194544, -0.9637760657954398,
      -0.9569403357322089, -0.9495281805930367, -0.9415440651830208,
      -0.9329927988347388, -0.9238795325112867, -0.9142097557035307,
      -0.9039892931234434, -0.8932243011955152, -0.881921264348355,
      -0.8700869911087115, -0.8577286100002721, -0.8448535652497072,
      -0.8314696123025455, -0.8175848131515837, -0.8032075314806449,
      -0.7883464276266063, -0.7730104533627371, -0.7572088465064847,
      -0.740951125354959, -0.7242470829514669, -0.7071067811865476,
      -0.689540544737067, -0.6715589548470186, -0.6531728429537766,
      -0.6343932841636455, -0.6152315905806269, -0.5956993044924335,
      -0.5758081914178454, -0.5555702330196022, -0.5349976198870972,
      -0.5141027441932218, -0.49289819222978415, -0.47139673682599786,
      -0.4496113296546069, -0.42755509343028203, -0.4052413140049899,
      -0.3826834323650899, -0.35989503653498833, -0.33688985339222033,
      -0.3136817403988914, -0.2902846772544624, -0.2667127574748985,
      -0.24298017990326407, -0.21910124015687005, -0.1950903220161286,
      -0.17096188876030122, -0.1467304744553618, -0.12241067519921635,
      -0.09801714032956083, -0.07356456359966773, -0.049067674327417966,
      -0.024541228522912326, -1.2246467991473532e-16, 0.02454122852291208,
      0.049067674327417724, 0.0735645635996675, 0.09801714032956059,
      0.1224106751992161, 0.14673047445536158, 0.17096188876030097,
      0.19509032201612836, 0.2191012401568698, 0.24298017990326382,
      0.26671275747489825, 0.2902846772544621, 0.3136817403988912,
      0.3368898533922201, 0.3598950365349881, 0.38268343236508967,
      0.4052413140049897, 0.4275550934302818, 0.44961132965460665,
      0.47139673682599764, 0.4928981922297839, 0.5141027441932216,
      0.5349976198870969, 0.555570233019602, 0.5758081914178453,
      0.5956993044924332, 0.6152315905806267, 0.6343932841636453,
      0.6531728429537765, 0.6715589548470184, 0.6895405447370668,
      0.7071067811865475, 0.7242470829514668, 0.7409511253549589,
      0.7572088465064842, 0.7730104533627367, 0.7883464276266059,
      0.803207531480645, 0.8175848131515838, 0.8314696123025452,
      0.844853565249707, 0.857728610000272, 0.8700869911087113,
      0.8819212643483549, 0.8932243011955152, 0.9039892931234431,
      0.9142097557035305, 0.9238795325112865, 0.932992798834739,
      0.9415440651830208, 0.9495281805930367, 0.9569403357322088,
      0.9637760657954398, 0.970031253194544, 0.9757021300385285,
      0.9807852804032303, 0.9852776423889411, 0.9891765099647809,
      0.9924795345987101, 0.9951847266721969, 0.9972904566786902,
      0.9987954562051724, 0.9996988186962042};
  return make_float2(kC[m], kS[m]);
}

// p, opaque to the compiler: loads through it are not hoisted out of the
// loop that calls this (a loop-invariant twiddle held in registers across
// a row's transform would take registers the transform needs)
__device__ __forceinline__ const float2* per_row(const float2* p) {
  asm volatile("" : "+l"(p));
  return p;
}

// The float offset of an address within its 16-byte word.
__device__ __forceinline__ int misalign4(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Times W_N^(t k1) on v[slot(k1)], k1 < 64, as the fp32 product of the
// two exact factors W_N^(t r) W_N^(8 t q), k1 = 8 q + r, read from fac:
// W_N^(t r) at [r B + t], W_N^(8 t q) at [8 B + q B + t] (r, q < 8).
template <int B, typename Slot>
__device__ __forceinline__ void pass1_twiddle(float2 (&v)[64],
                                              const float2* __restrict__ fac,
                                              int t, Slot slot) {
  const float2* pa = fac + t;
  const float2* pb = fac + 8 * B + t;
  float2 a[8];
#pragma unroll
  for (int r = 1; r < 8; ++r) a[r] = __ldg(pa + r * B);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float2 b = q ? __ldg(pb + q * B) : make_float2(1.f, 0.f);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (q == 0 && r == 0) continue;
      const float2 w = q == 0 ? a[r] : r == 0 ? b : cmul(a[r], b);
      const int i = slot(8 * q + r);
      v[i] = cmul(v[i], w);
    }
  }
}

// The transform of one row (see the note at the top).  On entry thread t
// holds z[j1 B + t] at v[bit_reverse(j1, 6)] (64 points).  Thread u =
// g C + jb ends with Z[g + 64 ka + 4096 bit_reverse(jb, log2 C)]; each of
// its 64 outputs is handed to epi(ka, value) as soon as it is final, and
// stays in v[ka].  fac: the pass-1 factors of N = RealRoute<C>::kN points
// (pass1_twiddle).  buf: the transpose buffer, RealRoute<C>::kBuf words,
// float2 (kCplx: one pass through it) or float (real parts, then imaginary
// parts: half the bytes, two passes); the block is synchronised on entry
// to the first write and after the last read.  `full` false skips the
// arithmetic (a timing cut: epi then sees the input).
template <int C, bool kCplx, typename Epi>
__device__ __forceinline__ void real_route_transform(
    float2 (&v)[64], void* buf, const float2* __restrict__ fac, int t,
    bool full, Epi&& epi) {
  using R = RealRoute<C>;
  constexpr int B = R::kB, P = R::kP;
  const int g = t / C, jb = t % C;
  if (!full) {
#pragma unroll
    for (int ka = 0; ka < 64; ++ka) epi(ka, v[ka]);
    return;
  }
  fac = per_row(fac);
  reg_dft<64>(v);
  pass1_twiddle<B>(v, fac, t, [](int k1) { return k1; });
  // the transpose: column t of row k1 at [k1 P + t]; thread u reads row g
  // at the points ja C + jb
  if constexpr (kCplx) {
    float2* b2 = static_cast<float2*>(buf);
#pragma unroll
    for (int k1 = 0; k1 < 64; ++k1) b2[k1 * P + t] = v[k1];
    __syncthreads();
#pragma unroll
    for (int ja = 0; ja < 64; ++ja) {
      v[bit_reverse(ja, 6)] = b2[g * P + ja * C + jb];
    }
    __syncthreads();
  } else {
    float* b1 = static_cast<float*>(buf);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int k1 = 0; k1 < 64; ++k1) b1[k1 * P + t] = c ? v[k1].y : v[k1].x;
      __syncthreads();
#pragma unroll
      for (int ja = 0; ja < 64; ++ja) {
        const float w = b1[g * P + ja * C + jb];
        if (c) {
          v[bit_reverse(ja, 6)].y = w;
        } else {
          v[bit_reverse(ja, 6)].x = w;
        }
      }
      __syncthreads();
    }
  }
  reg_dft<64>(v);
  // output ka at a time: times W_B^(jb ka) = W_256^(jb ka 4 / C), a literal
  // for each jb; then the C-point DFT over jb across the lanes of row g,
  // decimation in frequency (the upper lane of a pair takes p - v, the
  // lower v + p), which leaves lane jb with kb = bit_reverse(jb)
  const float sg1 = jb & 1 ? -1.f : 1.f;
  const float sg2 = jb & 2 ? -1.f : 1.f;
#pragma unroll
  for (int ka = 0; ka < 64; ++ka) {
    if constexpr (C > 1) {
      if (ka > 0) {
        float2 w = jb == 0 ? make_float2(1.f, 0.f) : w256(4 / C * ka);
        if constexpr (C == 4) {
          w = jb == 2 ? w256(2 * ka) : jb == 3 ? w256(3 * ka) : w;
        }
        v[ka] = cmul(v[ka], w);
      }
#pragma unroll
      for (int h = C / 2; h >= 1; h /= 2) {
        const float sg = h == 2 ? sg2 : sg1;
        const float px = __shfl_xor_sync(0xffffffffu, v[ka].x, h);
        const float py = __shfl_xor_sync(0xffffffffu, v[ka].y, h);
        const float x = fmaf(sg, v[ka].x, px), y = fmaf(sg, v[ka].y, py);
        // W_4^1 = -i on the odd upper lane of the first stage at C = 4
        const bool rot = h == 2 && jb == 3;
        v[ka] = make_float2(rot ? y : x, rot ? -x : y);
      }
    }
    epi(ka, v[ka]);
  }
}

// The same N-point transform (F = DFT(S), the forward's sign) with its
// passes in the opposite order, for a row that real_route_transform left
// in place: on entry thread u = g C + jb holds S[g + 64 ka + 4096 kb] at
// v[ka], kb = bit_reverse(jb, log2 C); on exit thread t holds F[t + B m1]
// at v[m1], the layout real_route_transform reads.  With k = k1 + 64 k2
// (k1 = g, k2 = ka + 64 kb) and m = m2 + B m1 (m2 = ma C + mb),
//   F[m] = sum_k1 W_64^(k1 m1) W_N^(k1 m2)
//          sum_ka W_64^(ka ma) W_B^(ka mb) sum_kb W_C^(kb mb) S[k]:
//   the C-point DFT over kb across the lanes of row g, decimation in time
//           (input in bit-reversed order across the lanes, so lane jb ends
//           with mb = jb; lane 3's value times -i before the second stage
//           at C = 4);
//   times W_B^(ka jb), read from lit (C > 1: the block's table of them in
//           shared memory, W_B^(jb ka) at [jb 65 + ka], exact fp32 table
//           entries; as literals they would be the forward's literals a
//           second time a row, which the compiler keeps in registers
//           across the rows and spills), and the 64-point DFT over ka:
//           G[g, ma C + jb] at the thread's v[ma];
//   the transpose through buf, written at [g P + ma C + jb], read at
//           [k1 P + t] (both free of bank conflicts);
//   times W_N^(t k1) (pass1_twiddle, the same two factors), and the
//           64-point DFT over k1.
// No bit-reversal pass: the register permutations fold into the unrolled
// indices.  buf as in real_route_transform (float: two passes).
template <int C>
__device__ __forceinline__ void route_transform_back(
    float2 (&v)[64], float* buf, const float2* __restrict__ fac,
    const float2* lit, int t) {
  using R = RealRoute<C>;
  constexpr int B = R::kB, P = R::kP;
  const int g = t / C, jb = t % C;
  fac = per_row(fac);
  float2 w[64];
#pragma unroll
  for (int ka = 0; ka < 64; ++ka) {
    float2 x = v[ka];
    if constexpr (C > 1) {
#pragma unroll
      for (int h = 1; h <= C / 2; h *= 2) {
        if (h == 2 && jb == 3) x = make_float2(x.y, -x.x);  // times -i
        const float px = __shfl_xor_sync(0xffffffffu, x.x, h);
        const float py = __shfl_xor_sync(0xffffffffu, x.y, h);
        const float sg = jb & h ? -1.f : 1.f;
        x = make_float2(fmaf(sg, x.x, px), fmaf(sg, x.y, py));
      }
      if (ka > 0) x = cmul(x, lit[jb * 65 + ka]);
    }
    w[bit_reverse(ka, 6)] = x;
  }
  reg_dft<64>(w);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int ma = 0; ma < 64; ++ma) {
      buf[g * P + ma * C + jb] = c ? w[ma].y : w[ma].x;
    }
    __syncthreads();
#pragma unroll
    for (int k1 = 0; k1 < 64; ++k1) {
      const float x = buf[k1 * P + t];
      if (c) {
        v[bit_reverse(k1, 6)].y = x;
      } else {
        v[bit_reverse(k1, 6)].x = x;
      }
    }
    __syncthreads();
  }
  pass1_twiddle<B>(v, fac, t, [](int k1) { return bit_reverse(k1, 6); });
  reg_dft<64>(v);
}

// route_transform_back's table W_B^(jb ka) (B = 64 C, jb < C, ka < 64) at
// lit[jb 65 + ka], from the n-point table tw (n a multiple of B): the
// entries tw[(n / B) jb ka].  All T threads of the block; the caller
// synchronises before the first use.
template <int C>
__device__ __forceinline__ void fill_back_literals(
    float2* lit, const float2* __restrict__ tw, int n, int t, int T) {
  for (int i = t; i < C * 64; i += T) {
    const int jb = i / 64, ka = i % 64;
    lit[jb * 65 + ka] = __ldg(tw + (n / (64 * C)) * jb * ka);
  }
}

}  // namespace afx
