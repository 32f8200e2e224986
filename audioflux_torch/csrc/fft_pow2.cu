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
//     every rfft from 8192 on): real_fwd_kernel / real_inv_kernel, one
//     block per row, N / 16 threads, N = n / 2.  A real row of n points is
//     one complex row of N points, z[m] = x[2m] + i x[2m+1], exactly as it
//     lies in memory as float2; at n = 32768 that half row fills 139,296
//     bytes of fft_smem.cuh's padded layout, one block an SM, so the row
//     never leaves the chip, and the work is half a complex transform's.
//     The forward loads z with cp.async (8-byte copies: the layout's gap
//     every 16 points leaves every other 128-byte piece 8 bytes off a
//     16-byte boundary; 4-byte copies where a row is not 8-byte aligned),
//     runs the N-point transform with the N-point table (half the bytes of
//     the n-point one for its twiddle gathers), and splits in
//     place: the thread of k pairs Z[k] with Z[N - k], E = (Z[k] + conj
//     Z[N - k]) / 2, O = (Z[k] - conj Z[N - k]) / 2i, X[k] = E + W^k O and
//     X[N - k] = conj(E - W^k O); X[0] and X[N] are Re Z[0] +- Im Z[0], and
//     X[N/2] = conj Z[N/2].  It writes only bins [0, bins) of the natural
//     spectrum, the mirror half as conj X[n - k] (HPS keeps 10,001 of
//     32,768).  The inverse returns Re(ifft(Y)) of any Y, through the
//     Hermitian part H[k] = (Y[k] + conj Y[n - k]) / 2: the thread of k
//     reads Y[k], Y[N - k], Y[N + k] and Y[n - k] (each value of the row
//     once), forms E = H[k] + H[k + N] and O = (H[k] - H[k + N]) W^-k for
//     both k and N - k (halves dropped: the store scales by 1 / 2n), runs
//     the N-point inverse by the conjugation above and writes x[2m] =
//     Re z[m], x[2m+1] = Im z[m] as float2.  No device buffer, no
//     imaginary half, no mirror half beyond the bins asked for;
//   * complex rows at n = 8192, 16384: fft_row_kernel, one block per row,
//     n/16 threads; the row (at most 139 KB with padding) lives in dynamic
//     shared memory for the radix-16 Stockham passes of fft_smem.cuh, so
//     device memory sees one read and one write per point;
//   * complex rows at n = 32768 (256 KB, more than a block's 227 KB of
//     shared memory), and the autocorrelation there: four-step split
//     n = n1 * n2 (n1 = 128) through a device scratch buffer: column FFTs
//     of length n1 with the twiddle W_n^(t2 k1) applied on the way out,
//     then row FFTs of length n2 that write bin k1 + n1 k2 in natural
//     order.  No main path launches it.
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
//     keeps: 4 bytes a point in, 2 out, so its operations bound it;
//   * n = 8192, 16384: the forward passes, the square and the inverse
//     passes on the row in shared memory (fft_smem.cuh) in one launch; at
//     n = 32768 the square is fused into the middle of the split (column
//     FFTs, then per k1 a row FFT, the square and the first inverse row FFT
//     in place in the scratch buffer, then the inverse column FFTs).

#include <cuda_pipeline.h>

#include <cstdint>

#include "fft_reg.cuh"
#include "fft_smem.cuh"

using afx::bit_reverse;
using afx::cmul;
using afx::fft_smem;
using afx::ilog2;
using afx::pad;
using afx::reg_dft;
using afx::seq_stride;

namespace {

constexpr int kMaxSinglePassLog2 = 14;
constexpr int kRealMinLog2 = 13;  // the real-row route from n = 8192 on
constexpr int kLog2N1 = 7;   // four-step column length 128
constexpr int kCols = 16;    // columns per block in the column pass
constexpr int kRows = 8;     // rows per block in the row pass

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

// The autocorrelation 0.5 * Im(ifft(fft(z)^2)) of n = A * B points in
// registers (see the note at the top): groups of B threads, kRegThreads / B
// groups a block, persistent blocks.
template <int A, int B, bool kYin>
__global__ void __launch_bounds__(kRegThreads)
autocorr_reg_kernel(AcfArgs g, const float2* __restrict__ tw) {
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
      v[bit_reverse(j, kLogA)] = make_float2(stage[i], im);
    }
    group_sync();  // the staging buffer is free: fetch the next rows
    if (item + stride < g.items) fetch(item + stride);

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
#pragma unroll
    for (int j1 = 0; j1 < A; ++j1) {
      const int i = t + B * j1;
      if (i >= lo) ex[i] = scale * v[j1].y;
    }
    flush_row(g.out + item * out_len, ex + lo, static_cast<int>(out_len), t,
              T, group_sync);
  }
}

// One row per block (n = 8192, 16384); blockDim.x = n / 16.  yi may be null
// (the imaginary output is then not written).
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

// The real-row route, forward (n = 8192..32768, see the note at the top):
// one real row of x per block, N / 16 threads, N = n / 2; bins [0, bins)
// of the spectrum into yr, yi, rows `bins` apart.  `stages` cuts it for
// timing: 1 stores what it loaded, 2 the N-point transform, 3 is the whole
// kernel; every cut stores as many values as the whole kernel.
__global__ void __launch_bounds__(1024)
real_fwd_kernel(const float* __restrict__ x, float* __restrict__ yr,
                float* __restrict__ yi, const float2* __restrict__ tw,
                int log2n, int bins, int stages) {
  extern __shared__ float2 z[];
  const int N = 1 << (log2n - 1), n = 2 * N;
  const int T = blockDim.x;
  const float* row = x + (static_cast<size_t>(blockIdx.x) << log2n);
  // z[m] = (x[2m], x[2m+1]) into the padded layout
  if ((reinterpret_cast<uintptr_t>(row) & 7) == 0) {
    for (int m = threadIdx.x; m < N; m += T) {
      __pipeline_memcpy_async(&z[pad(m)], row + 2 * m, 8);
    }
  } else {
    for (int m = threadIdx.x; m < N; m += T) {
      __pipeline_memcpy_async(&z[pad(m)].x, row + 2 * m, 4);
      __pipeline_memcpy_async(&z[pad(m)].y, row + 2 * m + 1, 4);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  if (stages > 1) fft_smem(z, log2n - 1, tw + (1 << log2n), log2n - 1);
  // the split, in place: X[k] at z[pad(k)] for k < N, X[N] at z[pad(N)]
  for (int k = threadIdx.x; stages > 2 && k < N / 2; k += T) {
    if (k == 0) {
      const float2 v = z[0];
      const float2 h = z[pad(N / 2)];
      z[0] = make_float2(v.x + v.y, 0.f);
      z[pad(N)] = make_float2(v.x - v.y, 0.f);
      z[pad(N / 2)] = make_float2(h.x, -h.y);
      continue;
    }
    const float2 a = z[pad(k)], b = z[pad(N - k)];
    const float2 e = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
    const float2 o = make_float2(0.5f * (a.y + b.y), 0.5f * (b.x - a.x));
    const float2 wo = cmul(__ldg(&tw[k]), o);
    z[pad(k)] = make_float2(e.x + wo.x, e.y + wo.y);
    z[pad(N - k)] = make_float2(e.x - wo.x, wo.y - e.y);
  }
  __syncthreads();
  const size_t off = static_cast<size_t>(blockIdx.x) * bins;
  for (int k = threadIdx.x; k < bins; k += T) {
    const bool low = k <= N;
    const float2 v = z[pad(low ? k : n - k)];
    yr[off + k] = v.x;
    yi[off + k] = low ? v.y : -v.y;
  }
}

// The real-row route, inverse: x = Re(ifft(yr + i yi)) of one row per
// block (yi may be null: zeros), N / 16 threads, N = n / 2.  `stages` 1
// cuts it before the transform (it stores the merged halves), for timing.
__global__ void __launch_bounds__(1024)
real_inv_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
                float* __restrict__ x, const float2* __restrict__ tw,
                int log2n, int stages) {
  extern __shared__ float2 z[];
  const int N = 1 << (log2n - 1), n = 2 * N;
  const int T = blockDim.x;
  const size_t off = static_cast<size_t>(blockIdx.x) << log2n;
  const float* ar = yr + off;
  const float* ai = yi == nullptr ? nullptr : yi + off;
  auto load = [&](int k) {
    return make_float2(__ldg(ar + k), ai == nullptr ? 0.f : __ldg(ai + k));
  };
  // A = Y[k] + conj Y[n - k], B = Y[N + k] + conj Y[N - k] (twice H[k] and
  // H[k + N]); E = A + B, O = (A - B) W^-k; Z[k] = E + i O and Z[N - k] =
  // conj E + i conj O; the inverse's conjugation stores conj Z
  for (int k = threadIdx.x; k < N / 2; k += T) {
    if (k == 0) {
      // Z[0] = (A + B) + i (A - B) with A, B real; k = N/2 pairs with
      // itself: B = conj A, W^-(N/2) = i, so Z = 2 conj A
      const float a = 2.f * __ldg(ar), b = 2.f * __ldg(ar + N);
      const float2 p = load(N / 2), q = load(N + N / 2);
      z[0] = make_float2(a + b, b - a);
      z[pad(N / 2)] = make_float2(2.f * (p.x + q.x), 2.f * (p.y - q.y));
      continue;
    }
    const float2 yk = load(k), ynk = load(n - k);
    const float2 yNk = load(N + k), yNmk = load(N - k);
    const float2 A = make_float2(yk.x + ynk.x, yk.y - ynk.y);
    const float2 B = make_float2(yNk.x + yNmk.x, yNk.y - yNmk.y);
    const float2 e = make_float2(A.x + B.x, A.y + B.y);
    const float2 w = __ldg(&tw[k]);
    const float2 o = cmul(make_float2(A.x - B.x, A.y - B.y),
                          make_float2(w.x, -w.y));
    z[pad(k)] = make_float2(e.x - o.y, -e.y - o.x);
    z[pad(N - k)] = make_float2(e.x + o.y, e.y - o.x);
  }
  __syncthreads();
  if (stages > 1) fft_smem(z, log2n - 1, tw + (1 << log2n), log2n - 1);
  // z = conj(F) / N of the halves' Z, that is conj(F) / 2n here
  const float s = 0.5f / static_cast<float>(n);
  float* out = x + off;
  if ((reinterpret_cast<uintptr_t>(out) & 7) == 0) {
    float2* out2 = reinterpret_cast<float2*>(out);
    for (int m = threadIdx.x; m < N; m += T) {
      const float2 v = z[pad(m)];
      out2[m] = make_float2(s * v.x, -s * v.y);
    }
  } else {
    for (int m = threadIdx.x; m < N; m += T) {
      const float2 v = z[pad(m)];
      out[2 * m] = s * v.x;
      out[2 * m + 1] = -s * v.y;
    }
  }
}

// The fused autocorrelation of one row per block (n = 8192, 16384):
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

// The grid of a persistent kernel of kRegThreads threads and `smem` bytes
// of shared memory: enough blocks for `items` at `groups` items a block,
// at most what the card holds at once.
template <typename K>
cudaError_t persistent_grid(K kernel, int smem, long long items, int groups,
                            unsigned* grid) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kRegThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  const long long want = (items + groups - 1) / groups;
  const long long resident = static_cast<long long>(sms) * per_sm;
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

// The real-row route (n >= 2^kRealMinLog2): a forward of the real rows in
// (ir) into bins [0, bins) of (or, oi), or the inverse of (ir, ii) into the
// real rows of or.
int launch_real(const float* ir, const float* ii, float* or_, float* oi,
                const float2* tw, long long batch, int log2n, int bins,
                bool forward, int stages, cudaStream_t st) {
  const int half = 1 << (log2n - 1);
  const int smem = static_cast<int>(sizeof(float2)) * seq_stride(half);
  const unsigned grid = static_cast<unsigned>(batch);
  cudaError_t e = forward ? allow_smem(real_fwd_kernel, smem)
                          : allow_smem(real_inv_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (forward) {
    real_fwd_kernel<<<grid, half / 16, smem, st>>>(ir, or_, oi, tw, log2n,
                                                   bins, stages);
  } else {
    real_inv_kernel<<<grid, half / 16, smem, st>>>(ir, ii, or_, tw, log2n,
                                                   stages);
  }
  return static_cast<int>(cudaGetLastError());
}

// bins: the forward's count of leading natural-order bins, n except on the
// real-row route; the inverse ignores it.
int transform(const float* xr, const float* xi, float* yr, float* yi,
              void* scratch, const void* tw, long long batch, int log2n,
              Dir d, int bins, int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* twf = static_cast<const float2*>(tw);
  const bool forward = d.sign > 0.f;
  if (batch <= 0) return 0;
  const bool real_route =
      log2n >= kRealMinLog2 && (forward ? xi == nullptr : yi == nullptr);
  if (bad_args(batch, log2n) || stages < 1 || stages > 3 ||
      (stages != 3 && log2n > 12 && !real_route)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = 1 << log2n;
  if (!forward) bins = n;
  if (bins < 1 || bins > n || (bins != n && !real_route)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (log2n == 11) {
    return launch_reg<64, 32>(xr, xi, yr, yi, twf, batch, d, stages, st);
  }
  if (log2n == 12) {
    return launch_reg<64, 64>(xr, xi, yr, yi, twf, batch, d, stages, st);
  }
  if (real_route) {
    return launch_real(xr, xi, yr, yi, twf, batch, log2n, bins, forward,
                       stages, st);
  }
  if (log2n <= kMaxSinglePassLog2) {
    const int smem = static_cast<int>(sizeof(float2)) * seq_stride(1 << log2n);
    cudaError_t e = allow_smem(fft_row_kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    fft_row_kernel<<<static_cast<unsigned>(batch), (1 << log2n) / 16, smem,
                     st>>>(xr, xi, yr, yi, twf, log2n, d);
    return static_cast<int>(cudaGetLastError());
  }
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
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
// yr, yi: (batch, bins) fp32, the first bins of the natural-order spectrum;
// bins < n only for real input at n >= 8192 (else bins = n).  scratch:
// batch * n float2, used only by complex rows at n = 32768 (null
// elsewhere).  tw: 3n/2 float2, exp(-2 pi i k / n) for k < n, then
// exp(-2 pi i k / (n/2)) for k < n/2 (the real-row route's transform
// reads the second table).  stages: 3 (the whole
// transform), or at n = 2048 and 4096 and on the real-row route 1 or 2 to
// cut the kernel for timing (the output is then not the spectrum).
// Returns the CUDA error code of the launches (0 on success).
extern "C" int af_fft_pow2_fwd(const float* xr, const float* xi, float* yr,
                               float* yi, void* scratch, const void* tw,
                               long long batch, int log2n, int bins,
                               int stages, void* stream) {
  return transform(xr, xi, yr, yi, scratch, tw, batch, log2n, Dir{1.f, 1.f},
                   bins, stages, stream);
}

// The inverse, 1/n included: yr, yi (batch, n) natural-order spectrum ->
// xr, xi (batch, n) signal.  yi may be null (a spectrum with no imaginary
// part); xi may be null: the imaginary output is then not written (from
// n = 8192 on the real-row route; scratch is then unused).  bins is
// ignored; scratch, tw and stages as above.
extern "C" int af_fft_pow2_inv(const float* yr, const float* yi, float* xr,
                               float* xi, void* scratch, const void* tw,
                               long long batch, int log2n, int bins,
                               int stages, void* stream) {
  return transform(yr, yi, xr, xi, scratch, tw, batch, log2n,
                   Dir{-1.f, 1.f / static_cast<float>(1 << log2n)}, bins,
                   stages, stream);
}

// out = 0.5 * Im(ifft(fft(xr + i xi)^2)), all (batch, n) fp32.  scratch and
// tw as above (the second table unread).
extern "C" int af_fft_pow2_autocorr(const float* xr, const float* xi,
                                    float* out, void* scratch, const void* tw,
                                    long long batch, int log2n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* twf = static_cast<const float2*>(tw);
  if (batch <= 0) return 0;
  if (bad_args(batch, log2n)) return static_cast<int>(cudaErrorInvalidValue);
  const AcfArgs a{xr, xi, nullptr, 0, 0, 0, 0, out, batch};
  if (log2n == 11) return launch_acf<64, 32, false>(a, twf, st);
  if (log2n == 12) return launch_acf<64, 64, false>(a, twf, st);
  if (log2n <= kMaxSinglePassLog2) {
    const int smem = static_cast<int>(sizeof(float2)) * seq_stride(1 << log2n);
    cudaError_t e = allow_smem(autocorr_row_kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    autocorr_row_kernel<<<static_cast<unsigned>(batch), (1 << log2n) / 16,
                          smem, st>>>(xr, xi, out, twf, log2n);
    return static_cast<int>(cudaGetLastError());
  }
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
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
