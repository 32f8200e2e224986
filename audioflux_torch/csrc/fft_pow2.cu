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
// n = 2048), so device memory is the bound, and the design keeps every
// pass on chip:
//   * n = 2048, 4096 (HPSS, STFT, .spectrogram()): fft_reg_kernel, the
//     transform in registers.  n = A * B (64 x 32, 64 x 64); a group of
//     B threads owns one transform: each thread runs an A-point DFT of one
//     column in registers (fft_reg.cuh), times the twiddle W_n^(n2 k1) from
//     a table in shared memory laid out for conflict-free reads, the group
//     transposes through its own buffer (real parts, then imaginary parts;
//     __syncwarp, or a named barrier for the two warps at 4096), and each
//     thread runs the B-point DFTs of rows k1 and A - k1 (at 4096 one row).
//     Real rows (xi null) go in pairs, z = a + i b, one transform for two
//     rows: a thread holds bins k and n - k (the upper half of the partner
//     row comes through the buffer at 4096), separates A_k = (Z_k + conj
//     Z_{n-k}) / 2 and B_k = (Z_k - conj Z_{n-k}) / 2i, and writes bins k
//     and n - k of both full spectra; an odd batch's last row goes with
//     b = 0.  The inverse takes a null xi as zeros, one row a transform.
//     Blocks are persistent; each group fetches its next rows into its
//     staging buffer with cp.async (16 bytes where the address allows) as
//     soon as the first pass has read the current ones, so the loads of one
//     transform overlap the arithmetic and stores of the last.  Each output
//     row is written into the group's buffer and leaves as 16-byte words
//     (PERF.md compares this with storing the bins as floats straight from
//     registers); at 4096 with real input the buffer carries the partners'
//     halves, and those bins go out as floats.
//   * n = 8192..32768, a forward of real rows or an inverse with real
//     output (HPS, LHS and PEF at 32768, PEF's frames and xcorr at 8192,
//     every rfft and irfft from 8192 on): real_fwd_kernel /
//     real_inv_kernel.  A real row of n points is one complex row of
//     N = n / 2 points, z[m] = x[2m] + i x[2m+1], exactly as it lies in
//     memory as float2, so the work is half a complex transform's.  The
//     N-point transform runs in registers (fft_real_reg.cuh: 64 points a
//     thread, N / 64 threads a row, one transpose through shared memory
//     and, from N = 8192 on, a last factor of 2 or 4 across neighbouring
//     lanes by __shfl_xor), in persistent blocks, one row a block, that
//     stage the next row's input while this one is transformed: a 1-D TMA
//     bulk copy completing on an mbarrier where every row is 16-byte
//     aligned, cp.async elsewhere.  The forward reads only the live
//     samples: row r is x[r, 0:live] at offset lo of n zeros (HPS's 4,096
//     of 32,768, PEF's 8,192 at its pad, xcorr's n of 2n), zero-filled in
//     registers.  Its split pairs Z[k] with Z[N - k]: the transform's
//     output goes through the buffer once more (real, then imaginary
//     parts), the thread of pair k reads Z[k] and Z[N - k], E = (Z[k] +
//     conj Z[N - k]) / 2, O = (Z[k] - conj Z[N - k]) / 2i, X[k] = E + W^k O
//     and X[N - k] = conj(E - W^k O); X[0] and X[N] are Re Z[0] +- Im Z[0],
//     and X[N/2] = conj Z[N/2].  It writes only bins [0, bins) of the
//     natural spectrum, the mirror half as conj X[n - k] (HPS keeps 10,001
//     of 32,768).  The inverse returns Re(ifft(Y)) of a whole spectrum Y
//     (through its Hermitian part H[k] = (Y[k] + conj Y[n - k]) / 2, read
//     from device memory) or of a half spectrum, bins [0, n/2] with
//     Y[n - k] = conj Y[k] as irfft takes it (staged like the forward's
//     input; the imaginary parts of bins 0 and n/2 ignored): the thread of
//     point j forms E = H[j] + H[j + N] and O = (H[j] - H[j + N]) W^-j,
//     Z[j] = E + i O, runs the N-point inverse by the conjugation above
//     and writes x[2m] = Re z[m], x[2m+1] = Im z[m] as float2 straight
//     from registers.  No device buffer, no imaginary half, no mirror half
//     beyond the bins asked for;
//   * complex rows at n = 8192, 16384 (czt, the CWT's and PWT's inverses
//     below cwt_ifft_bank's lengths, hilbert, ST, NSGT, FST, deconv):
//     row_reg_kernel, the real-row route's register transform on all n
//     points (fft_real_reg.cuh at N = n = 4096 C, C = 2 or 4: 64 points a
//     thread, n / 64 threads a row, one transpose through shared memory,
//     the last factor across C lanes by __shfl_xor), in persistent blocks
//     that stage the next row's two planes while this one is transformed
//     (TMA bulk copies on an mbarrier where both planes are 16-byte
//     aligned, cp.async elsewhere; a null imaginary input is a plane of
//     zeros staged once).  The transform leaves bin g + 64 ka + 4096 kb
//     with the thread's v[ka], so for each ka a warp holds 32 / C
//     consecutive bins at each of C offsets: the stores go straight from
//     registers in natural order and fill whole 32-byte sectors.  Each
//     point is read once and written once (16 bytes), one block an SM at
//     16384 (about 198 KB of shared memory), two at 8192;
//   * complex rows at n = 32768 (256 KB, more than one SM's shared memory
//     or registers hold), and the autocorrelation there: cluster_kernel,
//     one launch of persistent clusters of two blocks, a row a cluster.
//     Each block stages its half of the row (TMA or cp.async), and after a
//     cluster barrier its threads read their points of both halves, the
//     partner's through distributed shared memory, for the one radix-2
//     step of decimation in frequency that splits the row: block 0
//     transforms a[j] = x[j] + x[j + n/2], block 1 b[j] = (x[j] -
//     x[j + n/2]) W_n^j, each n/2 points in registers as the real-row
//     route does (fft_real_reg.cuh, 256 threads), and they write X[2k] and
//     X[2k + 1].  Each point is read from device memory once and written
//     once; there is no device buffer.
//
// The autocorrelation (YIN's, 59,776 rows of 4096 a call) reads its two
// operands once and writes one real row: 12 bytes a point against two
// transforms, 10 n log2 n flops, so at n = 4096 bytes and operations bound
// it about alike (0.88 and 0.44 ms at YIN's size).  The square never
// leaves the chip:
//   * n = 2048, 4096: autocorr_reg_kernel, fft_reg_kernel's pieces (the
//     A x B split, the group's transpose buffer, persistent groups that
//     prefetch with cp.async, twiddles in shared memory).  The forward's
//     second pass leaves bin k = k1 + A k2 with the thread of row k1; the
//     square is taken there, and the inverse runs its passes in the
//     opposite order: the B-point DFT over k2 of the thread's own rows, the
//     twiddle W_n^(k1 j2), the transpose back, then the A-point DFT over k1
//     of column j2, which gives output j2 + B j1 in the thread that loaded
//     point j2 + B j1.  So a row crosses the buffer twice each way and
//     needs no bit-reversal pass.  The twiddle table has rows of B + 1, so
//     that the forward (a thread a column) and the inverse (a thread a row)
//     both read it free of bank conflicts.  With S = fft(z)^2 and F =
//     fft(conj(S)), ifft(S) = conj(F) / n, so out = -0.5 / n * Im(F): the
//     factor goes into the store of the imaginary part alone.  YIN's entry
//     (af_fft_pow2_autocorr_yin) stages each frame straight from its clip
//     (4-byte copies where the frame's address is not 16-byte aligned),
//     forms z[j] = frame[j] + i frame[lag - j] (j <= lag, else 0) from the
//     staged frame, and writes only lags >= auto_length, the part YIN
//     keeps: 4 bytes a point in, 2 out, so its operations bound it.
//     yin_reg_kernel (af_fft_pow2_yin_pitch) is the same entry with the
//     rest of YIN in place of the store (no TPU kernel: the JAX package's
//     tail is XLA code): the frame's squares go to the transpose buffer as
//     it is loaded and become its prefix sums there before the forward,
//     the energies e2 wait in a buffer of their own, and the lags the
//     inverse leaves become the difference function, the CMND row (stored)
//     and the first trough below the threshold (pitch and value stored):
//     one read of each frame and 4 bytes a CMND column out, so the
//     operations still bound it;
//   * n = 8192, 16384: acf_reg_kernel, the real-row route's register
//     transform of n points (fft_real_reg.cuh, 64 points a thread, C = 2
//     or 4), persistent blocks that stage the next row's operands (TMA
//     bulk copies on an mbarrier where the rows are 16-byte aligned,
//     cp.async elsewhere).  The forward leaves bin g + 64 ka + 4096 kb
//     with the thread's v[ka]; the square is taken there, and
//     route_transform_back runs the passes in the opposite order (the
//     lanes' C-point DFT, the 64-point DFT over ka, the transpose back,
//     the 64-point DFT over k1), which leaves output t + B m1 with the
//     thread that loaded point t + B m1: one transpose each way and no
//     bit reversal.  Its frames entry (af_fft_pow2_autocorr_frames, NCF's
//     and HarmonicRatio's rows, also at n = 4096) stages the frame's L <=
//     n/2 samples alone, forms z[j] = f[j] + i f[(-j) mod n] in registers
//     and writes only the lags asked for;
//   * n = 32768: in cluster_kernel, each block squares its half of the
//     bins and runs the inverse passes in the opposite order, which gives
//     the transforms E and O of the even and odd bins; F[m] = E[m] +
//     W_n^m O[m], F[m + n/2] = E[m] - W_n^m O[m], and of F only the
//     imaginary part is kept, so each block hands the other one float a
//     point through the transpose buffer.

#include <cuda_pipeline.h>

#include <cstdint>

#include "fft_real_reg.cuh"
#include "fft_reg.cuh"
#include "fft_smem.cuh"

using afx::bit_reverse;
using afx::cmul;
using afx::ilog2;
using afx::reg_dft;

namespace {

constexpr int kRealMinLog2 = 13;  // the real-row route from n = 8192 on
constexpr int kClusterLog2 = 15;  // complex rows here: two-block clusters
constexpr int kLitWords = 65;     // float2 a lane of the back literals' table

// Direction of a transform: the imaginary part is multiplied by `sign` on
// the way in and by `sign * scale` on the way out, the real part by
// `scale`.  Forward: (1, 1).  Inverse: (-1, 1/n).
struct Dir {
  float sign, scale;
};

constexpr int kRegThreads = 256;  // a block of fft_reg_kernel

// Floats of a group's transpose buffer in fft_reg_kernel: A x (B + 1), and
// where a thread ends with one row only (A == B), room for the upper
// halves of all rows as float2, B / 2 + 1 apart.
__host__ __device__ constexpr int reg_ex_words(int a, int b) {
  const int transpose = a * (b + 1);
  const int halves = a == b ? 2 * b * (b / 2 + 1) : 0;
  return transpose > halves ? transpose : halves;
}

// Shared-memory bytes of fft_reg_kernel<A, B>: the twiddle table, and per
// group a staging buffer of two rows and the transpose buffer.
__host__ __device__ constexpr int reg_smem_bytes(int a, int b) {
  return 8 * a * b + 4 * (kRegThreads / b) * (2 * a * b + reg_ex_words(a, b));
}

// Fetch n floats from src into dst (zeros where src is null), asynchronous:
// thread t of a group of T copies every T-th 16-byte word where the
// address allows, else every T-th float.
__device__ __forceinline__ void fetch_row(float* dst, const float* src,
                                         int n, int t, int T) {
  if (src == nullptr) {
    for (int i = 4 * t; i < n; i += 4 * T) {
      *reinterpret_cast<float4*>(dst + i) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = 4 * t; i < n; i += 4 * T) {
      __pipeline_memcpy_async(dst + i, src + i, 16);
    }
  } else {
    for (int i = t; i < n; i += T) {
      __pipeline_memcpy_async(dst + i, src + i, 4);
    }
  }
}

// Store the n floats of a group's buffer to out: 16-byte words where both
// addresses allow, else floats; `sync` is the group's barrier, before (the
// row stands in the buffer) and after (the buffer is free).
template <typename Sync>
__device__ __forceinline__ void flush_row(float* out, const float* ex, int n,
                                          int t, int T, Sync& sync) {
  sync();
  if (((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(ex)) &
       15) == 0) {
    const int words = n & ~3;
    for (int i = 4 * t; i < words; i += 4 * T) {
      *reinterpret_cast<float4*>(out + i) =
          *reinterpret_cast<const float4*>(ex + i);
    }
    for (int i = words + t; i < n; i += T) out[i] = ex[i];
  } else {
    for (int i = t; i < n; i += T) out[i] = ex[i];
  }
  sync();
}

// Whether fft_reg_kernel packs real rows in pairs: a forward with xi null.
// The inverse of real rows runs them one a transform with a zero imaginary
// part.
__host__ __device__ inline bool reg_pairs(const float* xi, Dir d) {
  return xi == nullptr && d.sign > 0.f;
}

// The register-resident transform of n = A * B points; groups of B threads,
// kRegThreads / B groups a block, persistent blocks.  Real pairs
// (reg_pairs): item q is rows 2q and 2q + 1 as one packed transform; else
// item q is row q.  `stages` cuts it for timing: 1 stores the first pass's
// output, 2 the second pass's, 3 is the whole kernel; every cut stores as
// many values as the whole kernel.
template <int A, int B>
__global__ void __launch_bounds__(kRegThreads)
fft_reg_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
               float* __restrict__ yr, float* __restrict__ yi,
               const float2* __restrict__ tw, long long batch, Dir d,
               int stages) {
  constexpr int T = B;           // a thread a first-pass column
  constexpr int N = A * B;
  constexpr int R2 = A / T;      // second-pass rows a thread ends with
  constexpr int EXS = reg_ex_words(A, B);
  constexpr int kGroups = kRegThreads / T;
  constexpr int kLogA = ilog2(A), kLogB = ilog2(B);
  static_assert(R2 == 1 || R2 == 2, "a group is A or A / 2 threads");
  extern __shared__ float4 smem4[];
  float2* tbl = reinterpret_cast<float2*>(smem4);
  float* stages_all = reinterpret_cast<float*>(tbl + N);
  const int tid = threadIdx.x;
  const int grp = tid / T, t = tid % T;
  float* stage = stages_all + grp * 2 * N;
  float* ex = stages_all + kGroups * 2 * N + grp * EXS;
  const bool real = reg_pairs(xi, d);
  const long long items = real ? (batch + 1) / 2 : batch;
  const long long stride = static_cast<long long>(gridDim.x) * kGroups;
  long long item = static_cast<long long>(blockIdx.x) * kGroups + grp;

  // the group's barrier: its lanes of the warp, or (two warps) a named
  // barrier of its own
  const unsigned gmask =
      T >= 32 ? 0xffffffffu
              : (((1u << (T & 31)) - 1u) << ((tid & 31) / T * T));
  auto group_sync = [&]() {
    if constexpr (T <= 32) {
      __syncwarp(gmask);
    } else {
      asm volatile("bar.sync %0, %1;" ::"r"(1 + grp), "r"(T) : "memory");
    }
  };
  auto fetch = [&](long long q) {
    const float* a = xr + (real ? 2 * q : q) * N;
    const float* b = real            ? (2 * q + 1 < batch ? a + N : nullptr)
                     : xi == nullptr ? nullptr
                                     : xi + q * N;
    fetch_row(stage, a, N, t, T);
    fetch_row(stage + N, b, N, t, T);
    __pipeline_commit();
  };

  // once a block: the twiddles W_n^(n2 k1) at [k1 * B + n2]
  for (int i = tid; i < N; i += kRegThreads) {
    tbl[i] = __ldg(&tw[(i / B) * (i % B)]);
  }
  if (item < items) fetch(item);
  __syncthreads();
  // the rows k1 this thread ends with: k1 and A - k1 (thread 0: 0 and A / 2)
  // where a group is A / 2 threads, else k1 alone
  const int k1r[2] = {t, R2 == 1 ? t : t == 0 ? A / 2 : A - t};

  for (; item < items; item += stride) {
    const long long ra = real ? 2 * item : item;  // output rows ra (, ra + 1)
    const bool has_b = real && ra + 1 < batch;
    __pipeline_wait_prior(0);
    group_sync();  // the group's rows stand in its staging buffer
    float2 v[A];
#pragma unroll
    for (int j = 0; j < A; ++j) {
      const int i = t + B * j;
      v[bit_reverse(j, kLogA)] = make_float2(stage[i], d.sign * stage[N + i]);
    }
    group_sync();  // the staging buffer is free: fetch the next rows
    if (item + stride < items) fetch(item + stride);
    reg_dft<A>(v);
#pragma unroll
    for (int k1 = 1; k1 < A; ++k1) v[k1] = cmul(v[k1], tbl[k1 * B + t]);
    // output row c of the item: real (a re, a im, b re, b im), complex
    // (re, im); null where there is none.  A row is written into the
    // group's buffer first and leaves by flush_row.
    auto out_row = [&](int c) -> float* {
      float* base = c & 1 ? yi : yr;
      if (base == nullptr || (c >= 2 && !has_b)) return nullptr;
      return base + (static_cast<size_t>(ra) + (c >> 1)) * N;
    };
    if (stages == 1) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float* const out = out_row(c);
        if (out == nullptr) continue;
#pragma unroll
        for (int k1 = 0; k1 < A; ++k1) {
          ex[t + B * k1] = c & 1 ? v[k1].y : v[k1].x;
        }
        flush_row(out, ex, N, t, T, group_sync);
      }
      continue;
    }
#pragma unroll
    for (int k1 = 0; k1 < A; ++k1) ex[k1 * (B + 1) + t] = v[k1].x;
    group_sync();
    float2 u[R2][B];
#pragma unroll
    for (int s = 0; s < R2; ++s) {
#pragma unroll
      for (int j = 0; j < B; ++j) {
        u[s][bit_reverse(j, kLogB)].x = ex[k1r[s] * (B + 1) + j];
      }
    }
    group_sync();
#pragma unroll
    for (int k1 = 0; k1 < A; ++k1) ex[k1 * (B + 1) + t] = v[k1].y;
    group_sync();
#pragma unroll
    for (int s = 0; s < R2; ++s) {
#pragma unroll
      for (int j = 0; j < B; ++j) {
        u[s][bit_reverse(j, kLogB)].y = ex[k1r[s] * (B + 1) + j];
      }
      reg_dft<B>(u[s]);
    }
    // u[s][k2] is bin k1r[s] + A k2
    group_sync();  // every thread has read its rows: the buffer is free
    if (!real || stages == 2) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float* const out = out_row(c);
        if (out == nullptr) continue;
        const float f = stages == 2 ? 1.f
                        : c & 1     ? d.sign * d.scale
                                    : d.scale;
#pragma unroll
        for (int s = 0; s < R2; ++s) {
#pragma unroll
          for (int k2 = 0; k2 < B; ++k2) {
            ex[k1r[s] + A * k2] = f * (c & 1 ? u[s][k2].y : u[s][k2].x);
          }
        }
        flush_row(out, ex, N, t, T, group_sync);
      }
      continue;
    }
    // Real pair.  Bin n - k of bin k = k1 + A k2 is row A - k1 at
    // B - 1 - k2 (row 0: itself at B - k2): the thread's other row, or (one
    // row a thread) the row of thread A - t, whose upper half comes through
    // the buffer.  Each (k, n - k) is separated once and both bins of both
    // spectra are written: A_{n-k} = conj A_k, B_{n-k} = conj B_k.
    if constexpr (R2 == 2) {
      // one output row a round through the buffer
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float* const out = out_row(c);
        if (out == nullptr) continue;
#pragma unroll
        for (int k2 = 0; k2 < B / 2; ++k2) {
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const float2 zk = u[s][k2];
            const float2 zn = t == 0
                ? u[s][s == 0 ? (B - k2) % B : B - 1 - k2]
                : u[1 - s][B - 1 - k2];
            const float2 z = c < 2
                ? make_float2(0.5f * (zk.x + zn.x), 0.5f * (zk.y - zn.y))
                : make_float2(0.5f * (zk.y + zn.y), 0.5f * (zn.x - zk.x));
            const float val = c & 1 ? z.y : z.x;
            const int k = k1r[s] + A * k2;
            const int km = (N - k) & (N - 1);
            ex[k] = val;
            if (km != k) ex[km] = c & 1 ? -val : val;
          }
        }
        if (t == 0) {  // bin n/2 is its own partner
          const float2 zk = u[0][B / 2];
          ex[N / 2] = c == 0 ? zk.x : c == 2 ? zk.y : 0.f;
        }
        flush_row(out, ex, N, t, T, group_sync);
      }
    } else {
      // one row a thread: the buffer carries the rows' upper halves, so the
      // bins go out as floats (a warp's stores cover 128 neighbouring bytes)
      float2* xh = reinterpret_cast<float2*>(ex);
#pragma unroll
      for (int k2 = B / 2; k2 < B; ++k2) {
        xh[t * (B / 2 + 1) + k2 - B / 2] = u[0][k2];
      }
      group_sync();
      float* const ar = out_row(0);
      float* const ai = out_row(1);
      auto put = [&](int k, float2 za, float2 zb) {
        const int km = (N - k) & (N - 1);
        ar[k] = za.x;
        ai[k] = za.y;
        if (km != k) {
          ar[km] = za.x;
          ai[km] = -za.y;
        }
        if (has_b) {
          ar[N + k] = zb.x;
          ai[N + k] = zb.y;
          if (km != k) {
            ar[N + km] = zb.x;
            ai[N + km] = -zb.y;
          }
        }
      };
#pragma unroll
      for (int k2 = 0; k2 < B / 2; ++k2) {
        const float2 zk = u[0][k2];
        const float2 zn =
            t == 0 ? u[0][(B - k2) % B]
                   : xh[((A - t) & (A - 1)) * (B / 2 + 1) + B / 2 - 1 - k2];
        put(t + A * k2,
            make_float2(0.5f * (zk.x + zn.x), 0.5f * (zk.y - zn.y)),
            make_float2(0.5f * (zk.y + zn.y), 0.5f * (zn.x - zk.x)));
      }
      if (t == 0) {  // bin n/2 is its own partner
        const float2 zk = u[0][B / 2];
        put(N / 2, make_float2(zk.x, 0.f), make_float2(zk.y, 0.f));
      }
    }
  }
}

// Shared-memory bytes of autocorr_reg_kernel<A, B>: the twiddle table in
// rows of B + 1, and per group a staging buffer of `rows` rows and the
// transpose buffer (A rows of B + 1).
__host__ __device__ constexpr int acf_smem_bytes(int a, int b, int rows) {
  return 8 * a * (b + 1) + 4 * (kRegThreads / b) * (rows * a * b + a * (b + 1));
}

// What autocorr_reg_kernel reads and writes.  The general entry: item q is
// rows q of xr and xi, written whole.  YIN (x set): item q is frame
// q % frames of clip q / frames, samples [f * slide, f * slide + n) of a
// clip of `samples`, and only lags [lag, n) are written.
struct AcfArgs {
  const float* xr;
  const float* xi;
  const float* x;
  long long samples;
  int frames, slide, lag;
  float* out;
  long long items;
};

// What yin_reg_kernel makes of YIN's lags (AcfArgs as YIN's entry takes
// them, out unused): the CMND over lags [min_index, max_index], a row of
// max_index - min_index + 1 floats an item to yin, and the pitch of the
// first trough below thresh and its CMND value to fre and value.
struct YinArgs {
  int min_index, max_index;
  float thresh, samplate;
  float* fre;
  float* value;
  float* yin;
};

// Floats of a group's YIN buffer in yin_reg_kernel: the energies e2 at lags
// 0..max_index in whole 16-byte words, then four words of scratch for the
// group's scans and its minimum.
__host__ __device__ constexpr int yin_words(int max_index) {
  return ((max_index + 4) & ~3) + 4;
}

// The exclusive prefix sum of x over the T threads of a group (one or two
// whole warps), in thread order; scr: a word of the group's scratch.
template <int T, typename Sync>
__device__ __forceinline__ float group_exclusive_sum(float x, int t,
                                                     float* scr, Sync& sync) {
  const int lane = t & 31;
  float inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc = __fadd_rn(inc, o);
  }
  float exc = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) exc = 0.f;
  if constexpr (T > 32) {
    static_assert(T == 64, "a group is one or two warps");
    if (t == 31) scr[0] = inc;
    sync();
    if (t >= 32) exc = __fadd_rn(scr[0], exc);
    sync();
  }
  return exc;
}

// The least x over the T threads of a group; scr: two words of scratch.
template <int T, typename Sync>
__device__ __forceinline__ int group_min(int x, int t, int* scr, Sync& sync) {
  x = __reduce_min_sync(0xffffffffu, x);
  if constexpr (T > 32) {
    if ((t & 31) == 0) scr[t >> 5] = x;
    sync();
    x = min(scr[0], scr[1]);
    sync();
  }
  return x;
}

// YIN's parabolic offset of a trough v2 between v1 and v3, in PyTorch's
// order of operations and roundings (mir/pitch_yin.py, ops/cuda_yin.py
// parabolic_offsets: -(v3 - v1) / 2 / (2 ((v1 + v3 - 2 v2) / 2) + 1e-16),
// 0 where it exceeds 1 in magnitude), no multiply-add contracted, so that
// the offsets derived from the CMND rows on the host are the ones used here.
__device__ __forceinline__ float parabolic_offset(float v1, float v2,
                                                  float v3) {
  const float num = __fmul_rn(-__fsub_rn(v3, v1), 0.5f);
  const float curv = __fsub_rn(__fadd_rn(v1, v3), __fmul_rn(2.f, v2));
  const float den = __fadd_rn(__fmul_rn(2.f, __fmul_rn(curv, 0.5f)), 1e-16f);
  const float off = __fdiv_rn(num, den);
  return fabsf(off) <= 1.f ? off : 0.f;
}

// The frame's energies, while the transpose buffer holds its squares (x_i^2
// at pad(i) = (i / B) P + i % B, P = B + 1): thread t sums its run [t A,
// t A + A) in order, the group's exclusive scan of the runs' sums starts
// each run's prefix, and the buffer takes the inclusive prefix sums csum[i]
// of the frame alone (one float32 scan a frame, never one over the clip).
// Then e2[k] = csum[lag + k] - csum[k], 0 below 1e-6 in magnitude, at lags
// k = 0..max_index into en.  A run of B = 64 is one row of the buffer, so a
// warp's reads fall in distinct banks; at B = 32 two rows, two ways.
template <int A, int B, typename Sync>
__device__ __forceinline__ void yin_energies(float* ex, float* en, float* scr,
                                             int lag, int max_index, int t,
                                             Sync& sync) {
  constexpr int P = B + 1;
  auto pad = [](int i) { return (i / B) * P + i % B; };
  float sum = 0.f;
#pragma unroll 8
  for (int m = 0; m < A; ++m) sum = __fadd_rn(sum, ex[pad(t * A + m)]);
  float run = group_exclusive_sum<B>(sum, t, scr, sync);
#pragma unroll 8
  for (int m = 0; m < A; ++m) {
    const int p = pad(t * A + m);
    run = __fadd_rn(run, ex[p]);
    ex[p] = run;
  }
  sync();
  for (int k = t; k <= max_index; k += B) {
    const float e = __fsub_rn(ex[pad(lag + k)], ex[pad(k)]);
    en[k] = fabsf(e) >= 1e-6f ? e : 0.f;
  }
  sync();  // the transpose buffer is free for the forward
}

// YIN past the difference function, which stands in ex at lags 0..max_index:
// the CMND yin[c] = d[m + c] / (sum(d[1..m + c]) / (m + c) + 1e-16) over the
// columns c of lags m + c = min_index..max_index, its row stored, and the
// first trough below thresh (the first column needs a strict rise after it,
// an interior column a strict fall before it and no fall after, the last
// column never counts) made into the frame's pitch and CMND value, both 0
// where there is none.  The scan: thread t sums an odd run of ch lags from
// 1 + t ch (an odd stride puts a warp's reads in distinct banks) and the
// group's exclusive scan starts each run; the trough: each thread's first
// of the columns t, t + T, ..., then the group's least.
template <int T, typename Sync>
__device__ __forceinline__ void yin_epilogue(float* ex, float* scr,
                                             long long item,
                                             const YinArgs& y, int t,
                                             Sync& sync) {
  const int mx = y.max_index, mn = y.min_index;
  const int ch = ((mx + T - 1) / T) | 1;
  const int k0 = 1 + t * ch, k1 = min(k0 + ch, mx + 1);
  float sum = 0.f;
  for (int k = k0; k < k1; ++k) sum = __fadd_rn(sum, ex[k]);
  float run = group_exclusive_sum<T>(sum, t, scr, sync);
  for (int k = k0; k < k1; ++k) {
    const float d = ex[k];
    run = __fadd_rn(run, d);
    if (k >= mn) {
      const float mean = __fdiv_rn(run, static_cast<float>(k));
      ex[k] = __fdiv_rn(d, __fadd_rn(mean, 1e-16f));
    }
  }
  sync();
  const int L = mx - mn + 1;
  const float* col = ex + mn;
  float* row = y.yin + item * L;
  int first = L;
  for (int c = t; c < L; c += T) {
    const float a = col[c];
    row[c] = a;
    if (first == L && c < L - 1 && a < y.thresh &&
        (c == 0 ? a < col[1] : a <= col[c + 1] && a < col[c - 1])) {
      first = c;
    }
  }
  first = group_min<T>(first, t, reinterpret_cast<int*>(scr) + 2, sync);
  if (t == 0) {
    float fre = 0.f, value = 0.f;
    if (first < L) {
      const float off =
          first == 0 ? 0.f
                     : parabolic_offset(col[first - 1], col[first],
                                        col[first + 1]);
      // samplate / (min_index + c + off), as PyTorch divides a number by a
      // tensor: the reciprocal, then the product
      fre = __fmul_rn(
          __frcp_rn(__fadd_rn(static_cast<float>(mn + first), off)),
          y.samplate);
      value = col[first];
    }
    y.fre[item] = fre;
    y.value[item] = value;
  }
}

// The autocorrelation 0.5 * Im(ifft(fft(z)^2)) of n = A * B points in
// registers (see the note at the top): groups of B threads, kRegThreads / B
// groups a block, persistent blocks.  kPitch (YIN's entry only): the
// squares of the staged frame go to the transpose buffer as it is loaded,
// the energies are taken there before the forward (yin_energies), and the
// lags go on to the pitch (yin_epilogue) in place of the store.
template <int A, int B, bool kYin, bool kPitch>
__device__ __forceinline__ void autocorr_reg_body(AcfArgs g,
                                                  const float2* __restrict__ tw,
                                                  YinArgs y) {
  static_assert(kYin || !kPitch, "the pitch needs YIN's entry");
  constexpr int T = B;           // a thread a first-pass column
  constexpr int N = A * B;
  constexpr int P = B + 1;       // a padded row of the table and the buffer
  constexpr int R2 = A / T;      // second-pass rows a thread holds
  constexpr int kStaged = kYin ? 1 : 2;
  constexpr int kGroups = kRegThreads / T;
  constexpr int kLogA = ilog2(A), kLogB = ilog2(B);
  static_assert(R2 == 1 || R2 == 2, "a group is A or A / 2 threads");
  extern __shared__ float4 smem4[];
  float2* tbl = reinterpret_cast<float2*>(smem4);
  float* stages_all = reinterpret_cast<float*>(tbl + A * P);
  const int tid = threadIdx.x;
  const int grp = tid / T, t = tid % T;
  float* stage = stages_all + grp * kStaged * N;
  float* ex = stages_all + kGroups * kStaged * N + grp * A * P;
  // kPitch: the group's energies and scratch (yin_words)
  const int yw = kPitch ? yin_words(y.max_index) : 0;
  float* en = stages_all + kGroups * (kStaged * N + A * P) + grp * yw;
  float* scr = en + yw - 4;
  const long long stride = static_cast<long long>(gridDim.x) * kGroups;
  long long item = static_cast<long long>(blockIdx.x) * kGroups + grp;

  const unsigned gmask =
      T >= 32 ? 0xffffffffu
              : (((1u << (T & 31)) - 1u) << ((tid & 31) / T * T));
  auto group_sync = [&]() {
    if constexpr (T <= 32) {
      __syncwarp(gmask);
    } else {
      asm volatile("bar.sync %0, %1;" ::"r"(1 + grp), "r"(T) : "memory");
    }
  };
  auto fetch = [&](long long q) {
    if constexpr (kYin) {
      fetch_row(stage,
                g.x + (q / g.frames) * g.samples +
                    (q % g.frames) * static_cast<long long>(g.slide),
                N, t, T);
    } else {
      fetch_row(stage, g.xr + q * N, N, t, T);
      fetch_row(stage + N, g.xi + q * N, N, t, T);
    }
    __pipeline_commit();
  };

  // once a block: W_n^(c k1) at [k1 * P + c]
  for (int i = tid; i < A * P; i += kRegThreads) {
    const int k1 = i / P, c = i % P;
    tbl[i] = c < B ? __ldg(&tw[k1 * c]) : make_float2(0.f, 0.f);
  }
  if (item < g.items) fetch(item);
  __syncthreads();
  // the rows k1 this thread holds: k1 and A - k1 (thread 0: 0 and A / 2)
  // where a group is A / 2 threads, else k1 alone
  const int k1r[2] = {t, R2 == 1 ? t : t == 0 ? A / 2 : A - t};
  const int lo = kYin ? g.lag : 0;     // the first lag written
  const long long out_len = N - lo;
  const float scale = -0.5f / static_cast<float>(N);

  for (; item < g.items; item += stride) {
    __pipeline_wait_prior(0);
    group_sync();  // the group's rows stand in its staging buffer
    float2 v[A];
#pragma unroll
    for (int j = 0; j < A; ++j) {
      const int i = t + B * j;
      float im;
      if constexpr (kYin) {
        im = i <= g.lag ? stage[g.lag - i] : 0.f;
      } else {
        im = stage[N + i];
      }
      const float re = stage[i];
      if constexpr (kPitch) ex[j * P + t] = __fmul_rn(re, re);
      v[bit_reverse(j, kLogA)] = make_float2(re, im);
    }
    group_sync();  // the staging buffer is free: fetch the next rows
    if (item + stride < g.items) fetch(item + stride);
    if constexpr (kPitch) {
      yin_energies<A, B>(ex, en, scr, g.lag, y.max_index, t, group_sync);
    }

    // forward: the A-point DFT of column t, times W_n^(t k1); the transpose
    // gives each thread its rows; the B-point DFT over n2 leaves bin
    // k1r[s] + A k2 at u[s][k2]
    reg_dft<A>(v);
#pragma unroll
    for (int k1 = 1; k1 < A; ++k1) v[k1] = cmul(v[k1], tbl[k1 * P + t]);
    float2 u[R2][B];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int k1 = 0; k1 < A; ++k1) ex[k1 * P + t] = c ? v[k1].y : v[k1].x;
      group_sync();
#pragma unroll
      for (int s = 0; s < R2; ++s) {
#pragma unroll
        for (int j = 0; j < B; ++j) {
          const float w = ex[k1r[s] * P + j];
          if (c) {
            u[s][bit_reverse(j, kLogB)].y = w;
          } else {
            u[s][bit_reverse(j, kLogB)].x = w;
          }
        }
      }
      group_sync();
    }
    // the square, conjugated, then the inverse in the opposite order: the
    // B-point DFT over k2 of each row, times W_n^(k1 j2)
#pragma unroll
    for (int s = 0; s < R2; ++s) {
      reg_dft<B>(u[s]);
      float2 w[B];
#pragma unroll
      for (int k2 = 0; k2 < B; ++k2) {
        const float2 z = u[s][k2];
        w[bit_reverse(k2, kLogB)] =
            make_float2(z.x * z.x - z.y * z.y, -2.f * z.x * z.y);
      }
      reg_dft<B>(w);
      const float2* row = tbl + k1r[s] * P;
      u[s][0] = w[0];
#pragma unroll
      for (int j2 = 1; j2 < B; ++j2) u[s][j2] = cmul(w[j2], row[j2]);
    }
    // the transpose back: column t of every row, then the A-point DFT over
    // k1 gives F[t + B j1] at v[j1]
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int s = 0; s < R2; ++s) {
#pragma unroll
        for (int j2 = 0; j2 < B; ++j2) {
          ex[k1r[s] * P + j2] = c ? u[s][j2].y : u[s][j2].x;
        }
      }
      group_sync();
#pragma unroll
      for (int k1 = 0; k1 < A; ++k1) {
        const float w = ex[k1 * P + t];
        if (c) {
          v[bit_reverse(k1, kLogA)].y = w;
        } else {
          v[bit_reverse(k1, kLogA)].x = w;
        }
      }
      group_sync();
    }
    reg_dft<A>(v);
    if constexpr (kPitch) {
      // the difference function d[k] = e2[0] + e2[k] - 2 acf[k] at lags
      // k = i - lag <= max_index, acf 0 below 1e-6 in magnitude
      const float e0 = en[0];
#pragma unroll
      for (int j1 = 0; j1 < A; ++j1) {
        const int k = t + B * j1 - lo;
        if (k >= 0 && k <= y.max_index) {
          float a = scale * v[j1].y;
          a = fabsf(a) >= 1e-6f ? a : 0.f;
          ex[k] = __fsub_rn(__fadd_rn(e0, en[k]), __fmul_rn(2.f, a));
        }
      }
      group_sync();
      yin_epilogue<T>(ex, scr, item, y, t, group_sync);
    } else {
#pragma unroll
      for (int j1 = 0; j1 < A; ++j1) {
        const int i = t + B * j1;
        if (i >= lo) ex[i] = scale * v[j1].y;
      }
      flush_row(g.out + item * out_len, ex + lo, static_cast<int>(out_len),
                t, T, group_sync);
    }
  }
}

template <int A, int B, bool kYin>
__global__ void __launch_bounds__(kRegThreads)
autocorr_reg_kernel(AcfArgs g, const float2* __restrict__ tw) {
  autocorr_reg_body<A, B, kYin, false>(g, tw, YinArgs{});
}

// YIN from the clips to the pitch: YIN's entry of the autocorrelation with
// the energies, the difference function, the CMND and the trough search in
// the epilogue (autocorr_reg_body's kPitch).
template <int A, int B>
__global__ void __launch_bounds__(kRegThreads)
yin_reg_kernel(AcfArgs g, YinArgs y, const float2* __restrict__ tw) {
  autocorr_reg_body<A, B, true, true>(g, tw, y);
}

// What row_reg_kernel reads and writes: complex rows of n = 4096 C
// points, xr and xi (xi null: zeros, the C entry's inverse of a spectrum
// with no imaginary part) -> yr and yi, natural order.  `stages` 1 stores
// what was loaded (a timing cut: the bytes without the arithmetic), 3 is
// the whole kernel.
struct RowArgs {
  const float* xr;
  const float* xi;
  float* yr;
  float* yi;
  long long batch;
  int stages;
  bool bulk;  // xr and xi 16-byte aligned: TMA
};

// Complex rows at n = 8192, 16384 (see the note at the top): persistent
// blocks of 64 C threads, one row a block at a time, the n-point transform
// of fft_real_reg.cuh in registers while the next row's two planes are
// staged (TMA bulk copies on an mbarrier where both planes are 16-byte
// aligned, cp.async elsewhere).  kInv: the inverse, the forward between
// two conjugations with the exact 1/n in the store.  The transform leaves
// Z[g + 64 ka + 4096 kb] with thread g C + jb at v[ka]; for a fixed ka a
// warp's lanes hold 32 / C consecutive g at each of the C values of kb, so
// the stores straight from registers fill whole 32-byte sectors of yr and
// yi.
template <int C, bool kInv>
__global__ void __launch_bounds__(64 * C)
row_reg_kernel(RowArgs a, const float2* __restrict__ tw) {
  using R = afx::RealRoute<C>;
  constexpr int N = R::kN, T = R::kB;
  constexpr int kImag = N + 8;      // the staged imaginary plane starts here
  constexpr float kScale = kInv ? 1.f / N : 1.f;
  constexpr float kSign = kInv ? -1.f : 1.f;
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);
  float* buf = stage + 2 * kImag;
  uint64_t* bar = reinterpret_cast<uint64_t*>(buf + R::kBuf);
  const int t = threadIdx.x;
  const float2* fac = tw + N + N / 8;
  auto fetch = [&](long long r) {
    const float* re = a.xr + r * N;
    const float* im = a.xi == nullptr ? nullptr : a.xi + r * N;
    if (a.bulk) {
      if (t == 0) {
        if (im != nullptr) {
          afx::bulk_fetch2(stage, re, stage + kImag, im, 4u * N, bar);
        } else {
          afx::bulk_fetch(stage, re, 4u * N, bar);
        }
      }
    } else {
      // at [0, N) whatever the address: 4-byte copies
      afx::fetch_floats(stage, re, N, 0, false, t, T);
      if (im != nullptr) {
        afx::fetch_floats(stage + kImag, im, N, 0, false, t, T);
      }
      __pipeline_commit();
    }
  };

  // a null xi: its plane stays zero and is read like a staged one
  if (a.xi == nullptr) {
    for (int i = t; i < N; i += T) stage[kImag + i] = 0.f;
  }
  if (a.bulk && t == 0) afx::mbar_init(bar);
  __syncthreads();
  long long row = blockIdx.x;
  uint32_t phase = 0;
  if (row < a.batch) fetch(row);
  for (; row < a.batch; row += gridDim.x) {
    if (a.bulk) {
      afx::mbar_wait(bar, phase);
      phase ^= 1u;
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // the row stands in the staging buffer
    float2 v[64];
#pragma unroll
    for (int j1 = 0; j1 < 64; ++j1) {
      const int j = j1 * T + t;
      v[bit_reverse(j1, 6)] = make_float2(stage[j], kSign * stage[kImag + j]);
    }
    __syncthreads();  // the staging buffer is free: fetch the next row
    if (row + gridDim.x < a.batch) fetch(row + gridDim.x);

    // t, opaque where the row goes on (the lanes' literal selections and
    // the store addresses are made again each row, not kept in registers
    // across the rows)
    int tl = t;
    asm volatile("" : "+r"(tl));
    const int g = tl / C, kb = bit_reverse(tl % C, R::kLogC);
    float* const oyr = a.yr + row * N + g + 4096 * kb;
    float* const oyi = a.yi + row * N + g + 4096 * kb;
    // the stores in a loop of their own after the transform: issued from
    // inside its last pass, between the lanes' shuffles, they made the
    // forward at 16384 a sixth slower
    afx::real_route_transform<C, false>(v, buf, fac, tl, a.stages > 1,
                                        [](int, float2) {});
#pragma unroll
    for (int ka = 0; ka < 64; ++ka) {
      oyr[64 * ka] = kScale * v[ka].x;
      oyi[64 * ka] = kSign * kScale * v[ka].y;
    }
  }
}

// What the real-row route's forward reads and writes: row r of x holds
// the `live` samples x[r, :] of an n-point row of zeros, at offset lo; bins
// [0, bins) of its spectrum go to row r of yr and yi.  `stages` cuts it for
// timing: 1 stores what it loaded, 2 the N-point transform, 3 is the whole
// kernel; every cut stores as many values as the whole kernel.
struct RealFwdArgs {
  const float* x;
  float* yr;
  float* yi;
  long long batch;
  int lo, live, bins, stages;
  int stage_floats;  // the staging buffer, floats (0: rows read directly)
  bool bulk;  // every row 16-byte aligned, live % 4 == 0, lo even: TMA
};

// The real-row route, forward (see the note at the top): persistent blocks
// of N / 64 threads, one row a block at a time.  The transpose buffer holds
// complex values (one pass through it); it and the staged next row fit a
// block's shared memory except for whole rows at n = 32768, which are read
// from device memory as the first pass needs them.
template <int C>
__global__ void __launch_bounds__(64 * C)
real_fwd_kernel(RealFwdArgs a, const float2* __restrict__ tw) {
  using R = afx::RealRoute<C>;
  constexpr int N = R::kN, T = R::kB, n = 2 * N;
  constexpr int kPairs = N / 2 / T;  // pairs (k, N - k) a thread: 32
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);
  float2* buf = reinterpret_cast<float2*>(stage + a.stage_floats);
  uint64_t* bar = reinterpret_cast<uint64_t*>(buf + R::kBuf);
  const int t = threadIdx.x;
  const int g = t / C, kb = bit_reverse(t % C, R::kLogC);
  const bool staged = a.stage_floats > 0;

  // x[r, i] lies at stage[s0 + i] with s0 = lo (mod 2), so that a point's
  // two samples (x[2j], x[2j+1] of the padded row) are one float2 word;
  // `wide`: the body can go as 16-byte copies (an odd lo with an even
  // address, or the other way round, leaves 4-byte copies)
  auto offset = [&](const float* src, bool& wide) -> int {
    if (a.bulk) {
      wide = true;
      return 0;
    }
    const int mis = afx::misalign4(src);
    wide = ((mis - a.lo) & 1) == 0;
    return wide ? mis : (a.lo & 1);
  };
  auto fetch = [&](long long r) {
    const float* src = a.x + r * a.live;
    if (a.bulk) {
      if (t == 0) afx::bulk_fetch(stage, src, 4u * a.live, bar);
    } else {
      bool wide;
      const int s0 = offset(src, wide);
      afx::fetch_floats(stage, src, a.live, s0, wide, t, T);
      __pipeline_commit();
    }
  };
  // a complex value of the pair buffer: bin k at slot(k), skewed a 4096 so
  // that the transform's lanes write to distinct banks
  auto slot = [](int k) { return k + (k >> 12) * R::kPad; };

  if (staged && a.bulk && t == 0) afx::mbar_init(bar);
  __syncthreads();
  long long row = blockIdx.x;
  uint32_t phase = 0;
  if (staged && row < a.batch) fetch(row);
  const unsigned live = static_cast<unsigned>(a.live);
  for (; row < a.batch; row += gridDim.x) {
    float2 v[64];
    // point j = j1 T + t: samples p = 2j, 2j + 1, live where lo <= p <
    // lo + live; zeros elsewhere
    if (staged) {
      if (a.bulk) {
        afx::mbar_wait(bar, phase);
        phase ^= 1u;
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();  // the row stands in the staging buffer
      bool wide;
      const int s0 = offset(a.x + row * a.live, wide);
#pragma unroll
      for (int j1 = 0; j1 < 64; ++j1) {
        // a point with no live sample reads stage[0] and drops it
        const int rel = 2 * (j1 * T + t) - a.lo;
        const unsigned r0 = static_cast<unsigned>(rel);
        const bool any = r0 + 1u < live + 1u;
        const float2 w =
            *reinterpret_cast<const float2*>(stage + (any ? s0 + rel : 0));
        v[bit_reverse(j1, 6)] =
            make_float2(r0 < live ? w.x : 0.f, r0 + 1u < live ? w.y : 0.f);
      }
      __syncthreads();  // the staging buffer is free: fetch the next row
      if (row + gridDim.x < a.batch) fetch(row + gridDim.x);
    } else {
      const float* src = a.x + row * a.live;
#pragma unroll
      for (int j1 = 0; j1 < 64; ++j1) {
        const int rel = 2 * (j1 * T + t) - a.lo;
        const unsigned r0 = static_cast<unsigned>(rel);
        v[bit_reverse(j1, 6)] =
            make_float2(r0 < live ? __ldg(src + rel) : 0.f,
                        r0 + 1u < live ? __ldg(src + rel + 1) : 0.f);
      }
    }

    // the pairs: the transform leaves Z in the buffer, and the thread of
    // k = t + T i reads Z[k] and Z[N - k] (k = 0: Z[0] and Z[N/2])
    afx::real_route_transform<C, true>(
        v, buf, tw + n, t, a.stages > 1,
        [&](int ka, float2 z) { buf[slot(g + 64 * ka + 4096 * kb)] = z; });
    __syncthreads();
    float2 za_[kPairs], zb_[kPairs];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int k = t + T * i;
      za_[i] = buf[slot(k)];
      zb_[i] = buf[slot(k == 0 ? N / 2 : N - k)];
    }
    __syncthreads();  // the buffer is free for the next row
    // the split and the stores: X[k] to bins k and n - k (conjugated),
    // X[N - k] to bins N - k and N + k; the thread of k = 0 (t = 0 in
    // round 0) writes X[0], X[N/2], its mirror and X[N] instead.
    // W_n^k = W_n^t W_128^i (T i / n = i / 128)
    float* const oyr = a.yr + row * a.bins;
    float* const oyi = a.yi + row * a.bins;
    auto put = [&](int b, float re, float im) {
      if (b < a.bins) {
        oyr[b] = re;
        oyi[b] = im;
      }
    };
    auto emit = [&](int i, float2 xa, float2 xb, float xn) {
      const int k = t + T * i;
      const bool k0 = i == 0 && t == 0;
      put(k, xa.x, xa.y);
      put(k0 ? N / 2 : N - k, xb.x, xb.y);
      put(k0 ? n - N / 2 : n - k, k0 ? xb.x : xa.x, k0 ? -xb.y : -xa.y);
      put(k0 ? N : N + k, k0 ? xn : xb.x, k0 ? 0.f : -xb.y);
    };
    // the cuts (stages < 3) store the pairs as they are, through the same
    // code
    const bool split = a.stages > 2;
    const float2 wt = __ldg(afx::per_row(tw) + t);
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const float2 za = za_[i], zb = zb_[i];
      const float2 e = make_float2(0.5f * (za.x + zb.x), 0.5f * (za.y - zb.y));
      const float2 o = make_float2(0.5f * (za.y + zb.y), 0.5f * (zb.x - za.x));
      const float2 wo = cmul(cmul(wt, afx::w256(2 * i)), o);
      float2 xa = make_float2(e.x + wo.x, e.y + wo.y);
      float2 xb = make_float2(e.x - wo.x, wo.y - e.y);
      if (i == 0 && t == 0) {  // X[0], X[N/2] = conj Z[N/2]
        xa = make_float2(za.x + za.y, 0.f);
        xb = make_float2(zb.x, -zb.y);
      }
      emit(i, split ? xa : za, split ? xb : zb, split ? za.x - za.y : za.x);
    }
  }
}

// What the real-row route's inverse reads and writes: rows of yr, yi (yi
// may be null: zeros) of in_bins values, a whole spectrum (n) or a half
// spectrum (n / 2 + 1); the real rows of x.  `stages` 1 cuts it before the
// transform (it stores the merged points), for timing.
struct RealInvArgs {
  const float* yr;
  const float* yi;
  float* x;
  long long batch;
  int in_bins, stages;
  int stage_floats;  // the staging buffer (half spectra), floats
};

// The real-row route, inverse (see the note at the top): persistent blocks
// of N / 64 threads, one row a block at a time; kHalf: the rows are half
// spectra (one instantiation a kind of input).  A half spectrum is staged
// (real parts at stage[0..], imaginary parts at stage[N + 8..], each at its
// address's offset within a 16-byte word), the next row's while this one
// is transformed; a whole spectrum is read from device memory, each value
// twice (by the points j and N - j), the second time from the cache.
template <int C, bool kHalf>
__global__ void __launch_bounds__(64 * C)
real_inv_kernel(RealInvArgs a, const float2* __restrict__ tw) {
  using R = afx::RealRoute<C>;
  constexpr int N = R::kN, T = R::kB, n = 2 * N;
  constexpr int kImag = N + 8;  // the staged imaginary parts start here
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);
  float* buf = stage + a.stage_floats;
  const int t = threadIdx.x;
  const int g = t / C, kb = bit_reverse(t % C, R::kLogC);
  auto fetch = [&](long long r) {
    const float* re = a.yr + r * a.in_bins;
    afx::fetch_floats(stage, re, N + 1, afx::misalign4(re), true, t, T);
    if (a.yi != nullptr) {
      const float* im = a.yi + r * a.in_bins;
      afx::fetch_floats(stage + kImag, im, N + 1, afx::misalign4(im), true, t,
                        T);
    }
    __pipeline_commit();
  };
  // E = A + B, O = (A - B) W^-j, Z[j] = E + i O; the transform takes
  // conj Z (the inverse by conjugation).  W_n^j = W_n^t W_128^j1 for
  // j = j1 T + t (T / n = 1 / 128)
  float2 wt;
  auto merge = [&](float2 A, float2 B, int j1) {
    const float2 w = cmul(wt, afx::w256(2 * j1));
    const float2 e = make_float2(A.x + B.x, A.y + B.y);
    const float2 o = cmul(make_float2(A.x - B.x, A.y - B.y),
                          make_float2(w.x, -w.y));
    return make_float2(e.x - o.y, -e.y - o.x);
  };
  // x = conj(F) / N of the halves' Z; A and B are H (half spectra) or 2 H
  const float s = (kHalf ? 1.f : 0.5f) / static_cast<float>(n);
  const bool pairs_ok = (reinterpret_cast<uintptr_t>(a.x) & 7) == 0;
  long long row = blockIdx.x;
  if (kHalf && row < a.batch) fetch(row);
  for (; row < a.batch; row += gridDim.x) {
    float2 v[64];
    wt = __ldg(afx::per_row(tw) + t);
    if constexpr (kHalf) {
      // A = H[j] = Y[j], B = H[j + N] = conj Y[N - j]; at j = 0 the real
      // parts of Y[0] and Y[N] alone, as irfft takes them
      __pipeline_wait_prior(0);
      __syncthreads();  // the row stands in the staging buffer
      const float* re = stage + afx::misalign4(a.yr + row * a.in_bins);
      const float* im =
          a.yi == nullptr
              ? nullptr
              : stage + kImag + afx::misalign4(a.yi + row * a.in_bins);
#pragma unroll
      for (int j1 = 0; j1 < 64; ++j1) {
        const int j = j1 * T + t;
        float2 A, B;
        if (j == 0) {
          A = make_float2(re[0], 0.f);
          B = make_float2(re[N], 0.f);
        } else {
          A = make_float2(re[j], im == nullptr ? 0.f : im[j]);
          B = make_float2(re[N - j], im == nullptr ? 0.f : -im[N - j]);
        }
        v[bit_reverse(j1, 6)] = merge(A, B, j1);
        // keep the loads of a later point from being hoisted this far: the
        // point's registers are the transform's, and no more are free
        if ((j1 & 7) == 7) asm volatile("" ::: "memory");
      }
      __syncthreads();  // the staging buffer is free: fetch the next row
      if (row + gridDim.x < a.batch) fetch(row + gridDim.x);
    } else {
      // A = Y[j] + conj Y[n - j], B = Y[N + j] + conj Y[N - j] (twice H[j]
      // and H[j + N])
      const float* yr = a.yr + row * n;
      const float* yi = a.yi == nullptr ? nullptr : a.yi + row * n;
      auto load = [&](int k) {
        return make_float2(__ldg(yr + k), yi == nullptr ? 0.f : __ldg(yi + k));
      };
#pragma unroll
      for (int j1 = 0; j1 < 64; ++j1) {
        const int j = j1 * T + t;
        const float2 y0 = load(j), y1 = load((n - j) & (n - 1));
        const float2 y2 = load(N + j), y3 = load(N - j);
        v[bit_reverse(j1, 6)] =
            merge(make_float2(y0.x + y1.x, y0.y - y1.y),
                  make_float2(y2.x + y3.x, y2.y - y3.y), j1);
        if ((j1 & 7) == 7) asm volatile("" ::: "memory");
      }
    }
    // the thread ends with F[m], m = g + 64 ka + 4096 kb: x[2m], x[2m+1]
    float* out = a.x + row * n;
    afx::real_route_transform<C, false>(
        v, buf, tw + n, t, a.stages > 1, [&](int ka, float2 f) {
          const int m = g + 64 * ka + 4096 * kb;
          const float2 val = make_float2(s * f.x, -s * f.y);
          if (pairs_ok) {
            reinterpret_cast<float2*>(out)[m] = val;
          } else {
            out[2 * m] = val.x;
            out[2 * m + 1] = val.y;
          }
        });
  }
}

// What acf_reg_kernel reads and writes.  The general entry: row r is n
// floats of xr and of xi (len = n).  The frames entry (xi null): row r is
// the len = L <= n / 2 samples of one frame, and the operands are formed in
// registers, z[j] = f[j] + i f[(-j) mod n] (zero past the frame).  Lags
// [0, lags) of the row's autocorrelation go to out (rows of `lags`).
struct AcfRegArgs {
  const float* xr;
  const float* xi;
  long long batch;
  int len, lags;
  float* out;
  bool bulk;  // every row 16-byte aligned and len % 4 == 0: TMA
};

// The autocorrelation 0.5 * Im(ifft(fft(z)^2)) of n = 4096 C points in
// registers (see the note at the top): persistent blocks of 64 C threads,
// one row a block at a time, the next row's operands staged while this
// one is transformed.  tw: the kernel table of n (its pass-1 factors of n
// points, and route_transform_back's twiddles, copied to shared memory).
template <int C, bool kFrames>
__global__ void __launch_bounds__(64 * C)
acf_reg_kernel(AcfRegArgs a, const float2* __restrict__ tw) {
  using R = afx::RealRoute<C>;
  constexpr int N = R::kN, T = R::kB;
  constexpr int kImag = N + 8;  // the staged imaginary operand starts here
  // the frames entry stages a frame at [0, L) of n floats whose tail stays
  // zero, so that both operands are read without a test
  constexpr int kStage = kFrames ? N : 2 * kImag;
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);
  float* buf = stage + kStage;
  float2* lit = reinterpret_cast<float2*>(buf + R::kBuf);
  uint64_t* bar = reinterpret_cast<uint64_t*>(lit + kLitWords * C);
  const int t = threadIdx.x;
  const float2* fac = tw + N + N / 8;
  auto fetch = [&](long long r) {
    const float* re = a.xr + r * a.len;
    const float* im = kFrames ? nullptr : a.xi + r * a.len;
    if (a.bulk) {
      if (t == 0) {
        if constexpr (kFrames) {
          afx::bulk_fetch(stage, re, 4u * a.len, bar);
        } else {
          afx::bulk_fetch2(stage, re, stage + kImag, im, 4u * a.len, bar);
        }
      }
    } else {
      // at [0, len) whatever the address: 4-byte copies
      afx::fetch_floats(stage, re, a.len, 0, false, t, T);
      if constexpr (!kFrames) {
        afx::fetch_floats(stage + kImag, im, a.len, 0, false, t, T);
      }
      __pipeline_commit();
    }
  };

  if constexpr (C > 1) afx::fill_back_literals<C>(lit, tw, N, t, T);
  if constexpr (kFrames) {
    for (int i = a.len + t; i < N; i += T) stage[i] = 0.f;
  }
  if (a.bulk && t == 0) afx::mbar_init(bar);
  __syncthreads();
  long long row = blockIdx.x;
  uint32_t phase = 0;
  if (row < a.batch) fetch(row);
  const float s = -0.5f / static_cast<float>(N);
  for (; row < a.batch; row += gridDim.x) {
    if (a.bulk) {
      afx::mbar_wait(bar, phase);
      phase ^= 1u;
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // the row stands in the staging buffer
    // the output's length, opaque: the 64 tests derived from it are made
    // again each row, not kept in registers across the rows
    int lags = a.lags;
    asm volatile("" : "+r"(lags));
    float2 v[64];
    if constexpr (kFrames) {
      // z[j] = f[j] + i f[(-j) mod n]: the staged frame, zero past L
#pragma unroll
      for (int j1 = 0; j1 < 64; ++j1) {
        const int j = j1 * T + t;
        v[bit_reverse(j1, 6)] =
            make_float2(stage[j], stage[(N - j) & (N - 1)]);
      }
    } else {
#pragma unroll
      for (int j1 = 0; j1 < 64; ++j1) {
        const int j = j1 * T + t;
        v[bit_reverse(j1, 6)] = make_float2(stage[j], stage[kImag + j]);
      }
    }
    __syncthreads();  // the staging buffer is free: fetch the next row
    if (row + gridDim.x < a.batch) fetch(row + gridDim.x);

    // the forward leaves Z[g + 64 ka + 4096 kb] at v[ka]; the square,
    // conjugated, stays there, and the transform in the opposite order
    // starts from it: F[t + T m1] at v[m1], out = -0.5 / n * Im(F)
    // t, opaque where the row goes on (the lanes' literal selections are
    // made again each row, not kept in registers across the rows)
    int tl = t;
    asm volatile("" : "+r"(tl));
    afx::real_route_transform<C, false>(v, buf, fac, tl, true,
                                        [](int, float2) {});
#pragma unroll
    for (int ka = 0; ka < 64; ++ka) {
      const float2 z = v[ka];
      v[ka] = make_float2(z.x * z.x - z.y * z.y, -2.f * z.x * z.y);
    }
    afx::route_transform_back<C>(v, buf, fac, lit, t);
    float* out = a.out + row * a.lags;
#pragma unroll
    for (int m1 = 0; m1 < 64; ++m1) {
      const int m = m1 * T + t;
      if (m < lags) out[m] = s * v[m1].y;
    }
  }
}

// --- thread block clusters of two (complex rows at n = 32768) -----------
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of both blocks: the writes to shared memory before it are
// seen by the other block's reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of `local` (this block's shared memory) in block `rank`'s,
// for ld_peer.
__device__ __forceinline__ unsigned peer_addr(const void* local,
                                              unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(afx::smem_u32(local)), "r"(rank));
  return r;
}

__device__ __forceinline__ float ld_peer(unsigned addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// What cluster_kernel reads and writes, rows of n = 32768: xr, xi (xi
// null: zeros) -> yr, yi (yi null: not written), or (kAcf) the
// autocorrelation of xr + i xi -> yr.
struct ClusterArgs {
  const float* xr;
  const float* xi;
  float* yr;
  float* yi;
  long long batch;
  Dir d;
  bool bulk;  // xr and xi 16-byte aligned: TMA
};

// Complex rows of n = 32768 (256 KB, more than a block's shared memory or
// registers hold): one cluster of two blocks a row, each block holding
// N = n / 2 points in registers (fft_real_reg.cuh at C = 4, 256 threads),
// persistent clusters (see the note at the top).  Block `rank` stages
// half `rank` of the row (TMA, or cp.async where unaligned); after a
// cluster barrier each thread reads its points j = j1 T + t of both halves,
// its own and the partner's through distributed shared memory, and forms
// by decimation in frequency a[j] = x[j] + x[j + N] (rank 0) or
// b[j] = (x[j] - x[j + N]) W_n^j (rank 1), whose N-point transforms are
// X[2k] and X[2k + 1].  The autocorrelation squares its half of the bins
// in place and runs the inverse passes in the opposite order, which leaves
// E (rank 0) and O (rank 1), the transforms of the even and odd bins of
// conj(S); F[m] = E[m] + W_n^m O[m] and F[m + N] = E[m] - W_n^m O[m], and
// only Im F is kept, so rank 0 hands Im E and rank 1 Im(W_n^m O) to the
// other through the transpose buffer.  tw: the n-point table, then the
// pass-1 factors of N points.
template <bool kAcf>
__global__ void __launch_bounds__(256)
cluster_kernel(ClusterArgs a, const float2* __restrict__ tw) {
  using R = afx::RealRoute<4>;
  constexpr int N = R::kN, T = R::kB, n = 2 * N;
  constexpr int kImag = N + 8;  // the staged imaginary half starts here
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);
  float* buf = stage + 2 * kImag;
  float2* lit = reinterpret_cast<float2*>(buf + R::kBuf);
  uint64_t* bar = reinterpret_cast<uint64_t*>(lit + kLitWords * 4);
  const int t = threadIdx.x;
  // few values live across a row (the row's registers are the
  // transforms'): the rank is read again where it is needed, the rest
  // comes from the kernel's parameters
  auto fetch = [&](long long r) {
    const unsigned rank = cluster_rank();
    const float* re = a.xr + r * n + rank * N;
    const float* im = a.xi == nullptr ? nullptr : a.xi + r * n + rank * N;
    if (a.bulk) {
      if (t == 0) {
        if (im != nullptr) {
          afx::bulk_fetch2(stage, re, stage + kImag, im, 4u * N, bar);
        } else {
          afx::bulk_fetch(stage, re, 4u * N, bar);
        }
      }
    } else {
      // at [0, N) whatever the address: 4-byte copies
      afx::fetch_floats(stage, re, N, 0, false, t, T);
      if (im != nullptr) afx::fetch_floats(stage + kImag, im, N, 0, false, t, T);
      __pipeline_commit();
    }
  };

  if constexpr (kAcf) afx::fill_back_literals<4>(lit, tw, n, t, T);
  if (a.bulk && t == 0) afx::mbar_init(bar);
  __syncthreads();
  long long row = blockIdx.x / 2;
  uint32_t phase = 0;
  if (row < a.batch) fetch(row);
  for (; row < a.batch; row += gridDim.x / 2) {
    if (a.bulk) {
      afx::mbar_wait(bar, phase);
      phase ^= 1u;
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    cluster_sync();  // both halves stand in the two blocks' staging buffers
    const bool has_im = a.xi != nullptr;
    float2 v[64];
    {
      // the partner's points first, all loads in a row, then this block's
      const unsigned peer = cluster_rank() ^ 1u;
      const unsigned peer_re = peer_addr(stage, peer);
      const unsigned peer_im = peer_addr(stage + kImag, peer);
#pragma unroll
      for (int j1 = 0; j1 < 64; ++j1) {
        const int j = j1 * T + t;
        v[bit_reverse(j1, 6)] =
            make_float2(ld_peer(peer_re + 4u * j),
                        has_im ? ld_peer(peer_im + 4u * j) : 0.f);
      }
    }
    {
      // rank 0: own + peer = x[j] + x[j + N]; rank 1: (peer - own) W_n^j.
      // One loop a rank (the rank is the block's): a twiddle load or
      // select in a loop both ranks run took registers the later passes
      // needed (ptxas spilled)
      const float2* twr = afx::per_row(tw);
      if (cluster_rank() == 0) {
#pragma unroll
        for (int j1 = 0; j1 < 64; ++j1) {
          const int j = j1 * T + t;
          const float2 p =
              make_float2(stage[j], has_im ? stage[kImag + j] : 0.f);
          const float2 q = v[bit_reverse(j1, 6)];
          v[bit_reverse(j1, 6)] =
              make_float2(p.x + q.x, a.d.sign * (p.y + q.y));
        }
      } else {
#pragma unroll
        for (int j1 = 0; j1 < 64; ++j1) {
          const int j = j1 * T + t;
          const float2 p =
              make_float2(stage[j], has_im ? stage[kImag + j] : 0.f);
          const float2 q = v[bit_reverse(j1, 6)];
          const float2 z = make_float2(q.x - p.x, a.d.sign * (q.y - p.y));
          v[bit_reverse(j1, 6)] = cmul(z, __ldg(twr + j));
        }
      }
    }
    cluster_sync();  // the partner has read this block's staging buffer
    if (row + gridDim.x / 2 < a.batch) fetch(row + gridDim.x / 2);
    // t, opaque where the row goes on (the lanes' literal selections are
    // made again each row, not kept in registers across the rows)
    int tl = t;
    if constexpr (kAcf) asm volatile("" : "+r"(tl));
    afx::real_route_transform<4, false>(v, buf, tw + n, tl, true,
                                        [](int, float2) {});
    if constexpr (!kAcf) {
      // thread u holds X[2 k + rank] at v[ka], k = g + 64 ka + 4096 kb
      const unsigned rank = cluster_rank();
      const int g = t / 4, kb = bit_reverse(t % 4, 2);
      float* oyr = a.yr + row * n + rank;
      float* oyi = a.yi == nullptr ? nullptr : a.yi + row * n + rank;
      const float fi = a.d.sign * a.d.scale;
#pragma unroll
      for (int ka = 0; ka < 64; ++ka) {
        const int k2 = 2 * (g + 64 * ka + 4096 * kb);
        oyr[k2] = a.d.scale * v[ka].x;
        if (oyi != nullptr) oyi[k2] = fi * v[ka].y;
      }
    } else {
#pragma unroll
      for (int ka = 0; ka < 64; ++ka) {
        const float2 z = v[ka];
        v[ka] = make_float2(z.x * z.x - z.y * z.y, -2.f * z.x * z.y);
      }
      afx::route_transform_back<4>(v, buf, tw + n, lit, t);
      // thread t holds E[m] or O[m] at v[m1], m = m1 T + t.  The barrier
      // keeps the twiddle loads below from being issued during the
      // transform, whose registers they would take
      __syncthreads();
      {
        const unsigned rank = cluster_rank();
        const float2* twm = afx::per_row(tw);
#pragma unroll
        for (int m1 = 0; m1 < 64; ++m1) {
          const int m = m1 * T + t;
          const float h = rank ? cmul(v[m1], __ldg(twm + m)).y : v[m1].y;
          buf[m] = h;
          v[m1].x = h;
        }
      }
      cluster_sync();  // both halves' imaginary parts stand in the buffers
      const unsigned rank = cluster_rank();
      const unsigned peer_buf = peer_addr(buf, rank ^ 1u);
#pragma unroll
      for (int m1 = 0; m1 < 64; ++m1) {
        v[m1].y = ld_peer(peer_buf + 4u * (m1 * T + t));
      }
      // rank 0: F[m] = E + W O; rank 1: F[m + N] = E - W O
      float* out = a.yr + row * n + rank * N;
      const float s = -0.5f / static_cast<float>(n);
      const float sg = rank ? -1.f : 1.f;
#pragma unroll
      for (int m1 = 0; m1 < 64; ++m1) {
        out[m1 * T + t] = s * fmaf(sg, v[m1].x, v[m1].y);
      }
    }
  }
  cluster_sync();  // no block leaves while its partner may read it
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

// The grid of a persistent kernel of `threads` threads and `smem` bytes
// of shared memory: enough blocks for `items` at `groups` items a block,
// at most what the card holds at once.
// The queries behind it are made once for each (device, kernel, threads,
// shared memory) and remembered: they cost a launch's worth of host time.
template <typename K>
cudaError_t persistent_grid(K kernel, int smem, long long items, int groups,
                            unsigned* grid, int threads = kRegThreads) {
  struct Seen {
    const void* kernel;
    int dev, threads, smem, resident;
  };
  static Seen seen[64];
  static int n_seen = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const void* key = reinterpret_cast<const void*>(kernel);
  int resident = 0;
  for (int i = 0; i < n_seen; ++i) {
    const Seen& s = seen[i];
    if (s.kernel == key && s.dev == dev && s.threads == threads &&
        s.smem == smem) {
      resident = s.resident;
    }
  }
  if (resident == 0) {
    // the kernel's limit once and for all: the most a block may have
    // (lowering it for a smaller call would refuse a later larger one)
    e = allow_smem(kernel, 232448);
    if (e != cudaSuccess) return e;
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    resident = sms * per_sm;
    if (n_seen < 64) seen[n_seen++] = Seen{key, dev, threads, smem, resident};
  }
  const long long want = (items + groups - 1) / groups;
  *grid = static_cast<unsigned>(want < resident ? want : resident);
  return cudaSuccess;
}

template <int A, int B>
int launch_reg(const float* xr, const float* xi, float* yr, float* yi,
               const float2* tw, long long batch, Dir d, int stages,
               cudaStream_t st) {
  constexpr int kSmem = reg_smem_bytes(A, B);
  static_assert(kSmem <= 232448, "a block's shared memory on sm_90");
  auto kernel = fft_reg_kernel<A, B>;
  const long long items = reg_pairs(xi, d) ? (batch + 1) / 2 : batch;
  unsigned grid = 0;
  cudaError_t e = persistent_grid(kernel, kSmem, items, kRegThreads / B, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kRegThreads, kSmem, st>>>(xr, xi, yr, yi, tw, batch, d,
                                           stages);
  return static_cast<int>(cudaGetLastError());
}

template <int A, int B, bool kYin>
int launch_acf(const AcfArgs& a, const float2* tw, cudaStream_t st) {
  constexpr int kSmem = acf_smem_bytes(A, B, kYin ? 1 : 2);
  static_assert(kSmem <= 232448, "a block's shared memory on sm_90");
  auto kernel = autocorr_reg_kernel<A, B, kYin>;
  unsigned grid = 0;
  cudaError_t e =
      persistent_grid(kernel, kSmem, a.items, kRegThreads / B, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kRegThreads, kSmem, st>>>(a, tw);
  return static_cast<int>(cudaGetLastError());
}

template <int A, int B>
int launch_yin(const AcfArgs& a, const YinArgs& y, const float2* tw,
               cudaStream_t st) {
  // at most 4096 energies a group: 230,976 bytes at n = 4096
  const int smem = acf_smem_bytes(A, B, 1) +
                   4 * (kRegThreads / B) * yin_words(y.max_index);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = yin_reg_kernel<A, B>;
  unsigned grid = 0;
  cudaError_t e =
      persistent_grid(kernel, smem, a.items, kRegThreads / B, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kRegThreads, smem, st>>>(a, y, tw);
  return static_cast<int>(cudaGetLastError());
}

// The real-row route at N = 4096 C: persistent blocks of 64 C threads,
// each with its staging buffer, the transpose buffer and an mbarrier.
template <int C>
int launch_real_fwd(RealFwdArgs a, const float2* tw, cudaStream_t st) {
  using R = afx::RealRoute<C>;
  constexpr int kFixed = 8 * R::kBuf + 16;  // the complex buffer, mbarrier
  a.stage_floats = (a.live + 8 + 3) & ~3;
  if (4 * a.stage_floats + kFixed > 232448) a.stage_floats = 0;
  a.bulk = (reinterpret_cast<uintptr_t>(a.x) & 15) == 0 && a.live % 4 == 0 &&
           a.lo % 2 == 0;
  const int smem = 4 * a.stage_floats + kFixed;
  auto kernel = real_fwd_kernel<C>;
  unsigned grid = 0;
  cudaError_t e = persistent_grid(kernel, smem, a.batch, 1, &grid, R::kB);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, R::kB, smem, st>>>(a, tw);
  return static_cast<int>(cudaGetLastError());
}

template <int C, bool kHalf>
int launch_real_inv(RealInvArgs a, const float2* tw, cudaStream_t st) {
  using R = afx::RealRoute<C>;
  a.stage_floats = kHalf ? 2 * (R::kN + 8) : 0;
  const int smem = 4 * (a.stage_floats + R::kBuf);
  auto kernel = real_inv_kernel<C, kHalf>;
  unsigned grid = 0;
  cudaError_t e = persistent_grid(kernel, smem, a.batch, 1, &grid, R::kB);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, R::kB, smem, st>>>(a, tw);
  return static_cast<int>(cudaGetLastError());
}

// The real-row route (n >= 2^kRealMinLog2): a forward of the real rows in
// (ir; `live` samples a row at offset lo) into bins [0, bins) of (or, oi),
// or the inverse of (ir, ii; rows of in_bins = live) into the real rows of
// or.
int launch_real(const float* ir, const float* ii, float* or_, float* oi,
                const float2* tw, long long batch, int log2n, int bins,
                int lo, int live, bool forward, int stages, cudaStream_t st) {
  const int c = log2n - kRealMinLog2;  // C = 1, 2, 4
  if (forward) {
    const RealFwdArgs a{ir, or_, oi, batch, lo, live, bins, stages, 0, false};
    return c == 0   ? launch_real_fwd<1>(a, tw, st)
           : c == 1 ? launch_real_fwd<2>(a, tw, st)
                    : launch_real_fwd<4>(a, tw, st);
  }
  const RealInvArgs a{ir, ii, or_, batch, live, stages, 0};
  if (live != 1 << log2n) {
    return c == 0   ? launch_real_inv<1, true>(a, tw, st)
           : c == 1 ? launch_real_inv<2, true>(a, tw, st)
                    : launch_real_inv<4, true>(a, tw, st);
  }
  return c == 0   ? launch_real_inv<1, false>(a, tw, st)
         : c == 1 ? launch_real_inv<2, false>(a, tw, st)
                  : launch_real_inv<4, false>(a, tw, st);
}

// Complex rows at n = 4096 C: persistent blocks of 64 C threads, each
// with its staging buffer of two planes, the transpose buffer and an
// mbarrier.
template <int C, bool kInv>
int launch_row(const RowArgs& a, const float2* tw, cudaStream_t st) {
  using R = afx::RealRoute<C>;
  constexpr int kSmem = 4 * (2 * (R::kN + 8) + R::kBuf) + 16;
  static_assert(kSmem <= 232448, "a block's shared memory on sm_90");
  auto kernel = row_reg_kernel<C, kInv>;
  unsigned grid = 0;
  cudaError_t e = persistent_grid(kernel, kSmem, a.batch, 1, &grid, R::kB);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, R::kB, kSmem, st>>>(a, tw);
  return static_cast<int>(cudaGetLastError());
}

// The complex rows at n = 8192 (C = 2) and 16384 (C = 4): stages 3 the
// whole kernel, 1 its load and store (a cut).
int launch_rows(const RowArgs& a, const float2* tw, int log2n, bool forward,
                cudaStream_t st) {
  const bool c2 = log2n == kRealMinLog2;
  if (!forward) {
    return c2 ? launch_row<2, true>(a, tw, st) : launch_row<4, true>(a, tw, st);
  }
  return c2 ? launch_row<2, false>(a, tw, st) : launch_row<4, false>(a, tw, st);
}

// The autocorrelation in registers at n = 4096 C: persistent blocks of
// 64 C threads with their staging buffer, the transpose buffer, the back
// transform's twiddles and an mbarrier.  tw: the kernel table of n.
template <int C, bool kFrames>
int launch_acf_reg(AcfRegArgs a, const float2* tw, cudaStream_t st) {
  using R = afx::RealRoute<C>;
  constexpr int n = R::kN;
  constexpr int kSmem = 4 * ((kFrames ? n : 2 * (n + 8)) + R::kBuf) +
                        8 * kLitWords * C + 16;
  static_assert(kSmem <= 232448, "a block's shared memory on sm_90");
  auto kernel = acf_reg_kernel<C, kFrames>;
  unsigned grid = 0;
  cudaError_t e = persistent_grid(kernel, kSmem, a.batch, 1, &grid, R::kB);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, R::kB, kSmem, st>>>(a, tw);
  return static_cast<int>(cudaGetLastError());
}

// Complex rows at n = 32768: one launch of persistent clusters of two
// blocks (cudaLaunchKernelExC with the cluster dimension), as many as the
// card holds at once (cudaOccupancyMaxActiveClusters, asked once a device
// and remembered).  A launch the card refuses returns its error.
constexpr int kClusterSmem =
    4 * (2 * (afx::RealRoute<4>::kN + 8) + afx::RealRoute<4>::kBuf) +
    8 * kLitWords * 4 + 16;
static_assert(kClusterSmem <= 232448, "a block's shared memory on sm_90");

// The launch configuration of cluster_kernel<kAcf> on stream st, and the
// clusters the device holds at once (asked once a device).
template <bool kAcf>
cudaError_t cluster_config(cudaStream_t st, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr, int* resident) {
  const void* fn = reinterpret_cast<const void*>(cluster_kernel<kAcf>);
  static int max_clusters[16] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 16) return cudaErrorInvalidDevice;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 2;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(2);
  cfg->blockDim = dim3(afx::RealRoute<4>::kB);
  cfg->dynamicSmemBytes = kClusterSmem;
  cfg->stream = st;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  if (max_clusters[dev] == 0) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kClusterSmem);
    if (e != cudaSuccess) return e;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, fn, cfg);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorLaunchOutOfResources;
    max_clusters[dev] = clusters;
  }
  *resident = max_clusters[dev];
  return cudaSuccess;
}

template <bool kAcf>
int launch_cluster(ClusterArgs a, const float2* tw, cudaStream_t st) {
  const void* fn = reinterpret_cast<const void*>(cluster_kernel<kAcf>);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int resident = 0;
  cudaError_t e = cluster_config<kAcf>(st, &cfg, &attr, &resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long clusters = a.batch < resident ? a.batch : resident;
  cfg.gridDim = dim3(2 * static_cast<unsigned>(clusters));
  void* args[] = {&a, &tw};
  e = cudaLaunchKernelExC(&cfg, fn, args);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// bins: the forward's count of leading natural-order bins, n except on the
// real-row route.  lo, live: the forward's input rows are `live` samples
// at offset lo of n-point rows of zeros (lo = 0, live = n except on the
// real-row route); the inverse's rows are `live` bins, n or (on the
// real-row route) the n / 2 + 1 of a half spectrum, and its lo is 0.
int transform(const float* xr, const float* xi, float* yr, float* yi,
              const void* tw, long long batch, int log2n,
              Dir d, int bins, int lo, int live, int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* twf = static_cast<const float2*>(tw);
  const bool forward = d.sign > 0.f;
  if (batch <= 0) return 0;
  const bool real_route =
      log2n >= kRealMinLog2 && (forward ? xi == nullptr : yi == nullptr);
  // the complex rows at 8192, 16384 (row_reg_kernel) take the cut of
  // stage 1, and always write an imaginary output
  const bool rows =
      !real_route && log2n >= kRealMinLog2 && log2n < kClusterLog2;
  if (bad_args(batch, log2n) || stages < 1 || stages > 3 ||
      (stages != 3 && log2n == kClusterLog2 && !real_route) ||
      (rows && (yi == nullptr || stages == 2))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = 1 << log2n;
  if (!forward) bins = n;
  const bool whole = lo == 0 && live == n;
  const bool span_ok =
      forward ? lo >= 0 && live >= 1 && live <= n - lo
              : lo == 0 && (live == n || live == n / 2 + 1);
  if (bins < 1 || bins > n || !span_ok ||
      ((bins != n || !whole) && !real_route)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (log2n == 11) {
    return launch_reg<64, 32>(xr, xi, yr, yi, twf, batch, d, stages, st);
  }
  if (log2n == 12) {
    return launch_reg<64, 64>(xr, xi, yr, yi, twf, batch, d, stages, st);
  }
  if (real_route) {
    return launch_real(xr, xi, yr, yi, twf, batch, log2n, bins, lo, live,
                       forward, stages, st);
  }
  if (rows) {
    const RowArgs a{xr, xi, yr, yi, batch, stages,
                    aligned16(xr) && (xi == nullptr || aligned16(xi))};
    return launch_rows(a, twf, log2n, forward, st);
  }
  // complex rows at n = 32768
  const ClusterArgs a{xr, xi, yr, yi, batch, d,
                      aligned16(xr) && (xi == nullptr || aligned16(xi))};
  return launch_cluster<false>(a, twf, st);
}

}  // namespace

// xr, xi: (batch, live) fp32 rows (xi may be null: real input), row r
// the samples [lo, lo + live) of an n-point row that is zero elsewhere
// (lo = 0 and live = n except for real input at n >= 8192).  yr, yi:
// (batch, bins) fp32, the first bins of the natural-order spectrum; bins
// < n only for real input at n >= 8192 (else bins = n).  tw: n + n/8 +
// n/4 float2, exp(-2 pi i k / n) for k < n, then the pass-1 factors of
// N = n/2 points (the real-row route's and the clusters'), W_N^(t r) at
// [n + r B + t] and W_N^(8 t q) at [n + 8 B + q B + t] (B = N/64, r, q <
// 8, t < B), then those of n points at [n + n/8 ..] (the autocorrelation
// in registers).  stages: 3 (the whole transform), or at n = 2048 and
// 4096 and on the real-row route 1 or 2 to cut the kernel for timing (the
// output is then not the spectrum); on the complex rows at 8192 and 16384
// 1 (the load and the store alone).  Returns the CUDA error code
// of the launch (0 on success).
extern "C" int af_fft_pow2_fwd(const float* xr, const float* xi, float* yr,
                               float* yi, const void* tw, long long batch,
                               int log2n, int bins, int lo, int live,
                               int stages, void* stream) {
  return transform(xr, xi, yr, yi, tw, batch, log2n, Dir{1.f, 1.f},
                   bins, lo, live, stages, stream);
}

// The inverse, 1/n included: yr, yi (batch, in_bins) natural-order
// spectrum -> xr, xi (batch, n) signal.  yi may be null (a spectrum with
// no imaginary part); xi may be null: the imaginary output is then not
// written (from n = 8192 on the real-row route).  in_bins: n, or on the
// real-row route n / 2 + 1, a half spectrum (bin n - k is conj Y[k]; the
// imaginary parts of bins 0 and n/2 are ignored, as irfft does).  tw and
// stages as above.
extern "C" int af_fft_pow2_inv(const float* yr, const float* yi, float* xr,
                               float* xi, const void* tw, long long batch,
                               int log2n, int in_bins, int stages,
                               void* stream) {
  return transform(yr, yi, xr, xi, tw, batch, log2n,
                   Dir{-1.f, 1.f / static_cast<float>(1 << log2n)}, 1 << log2n,
                   0, in_bins, stages, stream);
}

// out = 0.5 * Im(ifft(fft(xr + i xi)^2)), all (batch, n) fp32.  tw as
// above.
extern "C" int af_fft_pow2_autocorr(const float* xr, const float* xi,
                                    float* out, const void* tw,
                                    long long batch, int log2n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* twf = static_cast<const float2*>(tw);
  if (batch <= 0) return 0;
  if (bad_args(batch, log2n)) return static_cast<int>(cudaErrorInvalidValue);
  const bool bulk = aligned16(xr) && aligned16(xi);
  if (log2n == kClusterLog2) {
    return launch_cluster<true>(
        ClusterArgs{xr, xi, out, nullptr, batch, Dir{1.f, 1.f}, bulk}, twf,
        st);
  }
  if (log2n >= 13) {
    const int n = 1 << log2n;
    const AcfRegArgs a{xr, xi, batch, n, n, out, bulk};
    return log2n == 13 ? launch_acf_reg<2, false>(a, twf, st)
                       : launch_acf_reg<4, false>(a, twf, st);
  }
  const AcfArgs a{xr, xi, nullptr, 0, 0, 0, 0, out, batch};
  return log2n == 11 ? launch_acf<64, 32, false>(a, twf, st)
                     : launch_acf<64, 64, false>(a, twf, st);
}

// The autocorrelation of frames, n = 4096, 8192 or 16384: frames (rows, L)
// fp32, L <= n / 2; out (rows, lags) = lags [0, lags) of 0.5 * Im(ifft(
// fft(z)^2)), z[j] = f[j] + i f[(-j) mod n] (zero past the frame's L
// samples): the frame's autocorrelation, linear for lags below n - L + 1.
// tw as above.
extern "C" int af_fft_pow2_autocorr_frames(const float* frames, float* out,
                                           const void* tw, long long rows,
                                           int log2n, int len, int lags,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* twf = static_cast<const float2*>(tw);
  if (rows <= 0) return 0;
  const int n = 1 << log2n;
  if (log2n < 12 || log2n > 14 || len < 1 || len > n / 2 || lags < 1 ||
      lags > n || rows > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const AcfRegArgs a{frames, nullptr, rows, len, lags, out,
                     aligned16(frames) && len % 4 == 0};
  return log2n == 12   ? launch_acf_reg<1, true>(a, twf, st)
         : log2n == 13 ? launch_acf_reg<2, true>(a, twf, st)
                       : launch_acf_reg<4, true>(a, twf, st);
}

// The clusters of two blocks the current device holds at once for the
// complex rows at n = 32768 (acf: the autocorrelation's kernel), or minus
// the CUDA error code.
extern "C" int af_fft_pow2_resident_clusters(int acf) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int resident = 0;
  const cudaError_t e =
      acf ? cluster_config<true>(nullptr, &cfg, &attr, &resident)
          : cluster_config<false>(nullptr, &cfg, &attr, &resident);
  return e == cudaSuccess ? resident : -static_cast<int>(e);
}

// YIN's autocorrelation, n = 2048 or 4096: x (clips, samples) fp32, frame
// f of a clip at samples [f * slide, f * slide + n), f < frames;
// out (clips * frames, n - lag) = lags [lag, n) of 0.5 * Im(ifft(fft(z)^2)),
// z[j] = frame[j] + i (frame[lag - j] if j <= lag else 0).  tw: the n
// entries of the first table above.
extern "C" int af_fft_pow2_autocorr_yin(const float* x, float* out,
                                        const void* tw, long long clips,
                                        long long samples, int frames,
                                        int slide, int lag, int log2n,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* twf = static_cast<const float2*>(tw);
  if (clips <= 0 || frames <= 0) return 0;
  const int n = 1 << log2n;
  if ((log2n != 11 && log2n != 12) || slide < 1 || lag < 0 || lag >= n ||
      static_cast<long long>(frames - 1) * slide + n > samples ||
      clips > INT32_MAX / frames) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const AcfArgs a{nullptr, nullptr, x, samples, frames, slide, lag, out,
                  clips * frames};
  return log2n == 11 ? launch_acf<64, 32, true>(a, twf, st)
                     : launch_acf<64, 64, true>(a, twf, st);
}

// YIN from the clips to the pitch, n = 2048 or 4096: frames and their
// autocorrelation as af_fft_pow2_autocorr_yin takes them (x, clips,
// samples, frames, slide, lag), then per frame the energies, the
// difference function, the CMND over lags [min_index, max_index] (1 <=
// min_index, min_index + 2 <= max_index < n - lag) and the first trough
// below thresh: yin (clips * frames, max_index - min_index + 1) the CMND
// rows, fre and value (clips * frames) the pitch (samplate over the
// trough's lag and parabolic offset) and the CMND at the trough, 0 and 0
// where no column is a trough.  tw as YIN's entry takes it.
extern "C" int af_fft_pow2_yin_pitch(const float* x, float* fre, float* value,
                                     float* yin, const void* tw,
                                     long long clips, long long samples,
                                     int frames, int slide, int lag,
                                     int min_index, int max_index,
                                     float thresh, float samplate, int log2n,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* twf = static_cast<const float2*>(tw);
  if (clips <= 0 || frames <= 0) return 0;
  const int n = 1 << log2n;
  if ((log2n != 11 && log2n != 12) || slide < 1 || lag < 0 || lag >= n ||
      min_index < 1 || max_index < min_index + 2 || max_index >= n - lag ||
      static_cast<long long>(frames - 1) * slide + n > samples ||
      clips > INT32_MAX / frames) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const AcfArgs a{nullptr, nullptr, x, samples, frames, slide, lag, nullptr,
                  clips * frames};
  const YinArgs y{min_index, max_index, thresh, samplate, fre, value, yin};
  return log2n == 11 ? launch_yin<64, 32>(a, y, twf, st)
                     : launch_yin<64, 64>(a, y, twf, st);
}
