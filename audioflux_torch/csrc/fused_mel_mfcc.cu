// Fused framing -> window -> real FFT -> power -> filterbank (mel) ->
// log10 -> DCT-II (cepstral coefficients), fp32.
//
// Replaces the TPU kernel audioflux_tpu/ops/pallas_spectrogram.py:
// fused_mel_mfcc (all of its Pallas variants).  For clip b and frame t:
//   frame  = x[b, t*slide : t*slide + n_fft] * window
//   P      = |rfft(frame)|^2 over the n_fft/2 + 1 bins
//   mel    = fb @ P                              -> mel[b, :, t]
//   cc     = dct @ log10(max(mel, 1e-8))         -> cc[b, :, t]
//
// What bounds it on the card: per frame it reads `slide` new samples and
// writes (num + cc) values, against about 2.5 n log2 n flops of real FFT
// plus the banded filterbank and the DCT; at the headline shape (n_fft
// 2048, slide 512, 128 bands, 13 coefficients) that is about 24 flops per
// byte of device traffic, so the fp32 operation rate is the bound, and
// below it the shared-memory traffic and the barriers of the stages.
// Device memory sees the audio once and the two outputs once.
//
// Two kernels share that contract.
//
// fused_reg_kernel (n_fft = 512, 1024, 2048, 4096) keeps the transform in
// registers and fuses the stages around it:
//   * Two real frames are packed as one complex FFT (z = a + i b); a group
//     of T threads (16, 32, or at n_fft 4096 two warps) owns the pair.
//   * n_fft = A * B.  A thread reads its points of both frames straight
//     from the staged audio span, times the window (no buffer of windowed
//     frames exists), runs an A-point DFT in registers (fft_reg.cuh),
//     applies the twiddle W_n^(n2 k1) from a table laid out for
//     conflict-free reads, and the group transposes through its own buffer
//     in shared memory, real parts and then imaginary parts, with
//     __syncwarp only (a named barrier at 4096).  Then each thread runs two
//     B-point DFTs, of the rows k1 and A - k1: it ends with bin k and with
//     bin n - k, so it separates the two frames (A = (Z_k + conj Z_{n-k})
//     / 2, B = (Z_k - conj Z_{n-k}) / 2i) without another exchange (4096 =
//     64 x 64 leaves a thread one row, and the upper half of row A - k1
//     comes through the buffer once more) and stores only the
//     n/2 + 1 powers of each, bin-major with the tile's frames side by
//     side.
//   * The block meets at a barrier once the tile's powers stand.  The
//     filterbank then gives a thread one band of four frames: a bin's four
//     powers are one 16-byte read and the weight one more, for four
//     multiply-adds (reading a power and a weight for every multiply-add
//     made the stage instruction-bound).  It runs over each band's nonzero
//     bin range (computed on the host; skipping exact zeros changes no sum)
//     in ascending order, and is as right for a dense bank; a warp takes
//     narrow and wide bands in turn.  fp32 sums in another order than a
//     matrix product's: the contract is 1e-5 of the peak against the plain
//     version.
//   * The DCT gives a thread every fourth band of one coefficient for four
//     frames, the four shares added by warp shuffles, with the DCT rows
//     and the band weights in shared memory (where they fit) once a block.
//   * Blocks are persistent: the grid is sized to the card, and a block
//     walks along consecutive tiles of a clip.  The window, the twiddle
//     table and the constants are loaded once a block.  The next tile's
//     audio span is fetched with cp.async (16 bytes where the address
//     allows, else 4) as soon as the transforms have read this tile's, so
//     the copy overlaps the filterbank, the DCT and the stores.  One span
//     buffer serves: the n_fft - slide samples that neighbouring tiles share
//     come from the L2 cache again.
//
// fused_pass_kernel serves every other power of two from 16 to 16384 with
// radix-16 Stockham passes over shared memory (fft_smem.cuh), one block per
// (clip, tile of frames).

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

// The kernel of the passes over shared memory.  One block per (clip, tile
// of `tile` frames), np * n_fft / 16 threads; np frame pairs are
// transformed at once; `staged` holds the tile's audio span in shared
// memory (else the frames are read from device memory).
__global__ void __launch_bounds__(1024)
fused_pass_kernel(const float* __restrict__ x, long long n, int n_frames,
                      int slide, int log2n, const float* __restrict__ window,
                      const float2* __restrict__ tw,
                      const int* __restrict__ band_lo,
                      const int* __restrict__ band_len,
                      const int* __restrict__ band_off,
                      const float* __restrict__ band_w,
                      const float* __restrict__ dct, int num, int cc,
                      float* __restrict__ mel, float* __restrict__ cc_out,
                      int tile, int np, int n_tiles, int staged) {
  // np transforms of n_fft points (padded); mel and log10(mel) of the
  // tile, each (num, tile); the audio span when staged
  extern __shared__ float2 z[];
  const int nfft = 1 << log2n;
  const int stride = seq_stride(nfft);
  float* mel_s = reinterpret_cast<float*>(z + static_cast<size_t>(np) * stride);
  float* logmel = mel_s + tile * num;
  float* span = logmel + tile * num;

  const int b = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x % n_tiles) * tile;
  const float* xb = x + static_cast<size_t>(b) * n;
  const int nf = 2 * np;  // frames per round
  const int nb = (nfft >> 1) + 1;

  if (staged) {
    // samples [t0 * slide, t0 * slide + span_len) of the clip, zero past
    // its end (those only feed frames >= n_frames, never written)
    const long long s0 = static_cast<long long>(t0) * slide;
    const int span_len = tile * slide + nfft - slide;
    const float* src = xb + s0;
    // 16-byte loads need a 16-byte aligned address: x may be a view at
    // any offset, so test the address itself
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && s0 + span_len <= n) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
      float4* dst4 = reinterpret_cast<float4*>(span);
      for (int i = threadIdx.x; i < span_len / 4; i += blockDim.x) {
        dst4[i] = __ldg(&src4[i]);
      }
    } else {
      for (int i = threadIdx.x; i < span_len; i += blockDim.x) {
        span[i] = s0 + i < n ? __ldg(&src[i]) : 0.f;
      }
    }
    __syncthreads();
  }

  for (int f0 = 0; f0 < tile; f0 += nf) {
    // frames t0 + f0 + 2q (real part) and +1 (imaginary part) of pair q
    for (int idx = threadIdx.x; idx < (np << log2n); idx += blockDim.x) {
      const int q = idx >> log2n, i = idx & (nfft - 1);
      const int fa = f0 + 2 * q;
      const float w = __ldg(&window[i]);
      float a, c;
      if (staged) {
        a = span[fa * slide + i] * w;
        c = span[(fa + 1) * slide + i] * w;
      } else {
        const int ta = t0 + fa;
        a = ta < n_frames
            ? __ldg(&xb[static_cast<size_t>(ta) * slide + i]) * w : 0.f;
        c = ta + 1 < n_frames
            ? __ldg(&xb[static_cast<size_t>(ta + 1) * slide + i]) * w : 0.f;
      }
      z[q * stride + pad(i)] = make_float2(a, c);
    }
    __syncthreads();
    fft_smem(z, log2n, tw, log2n);

    // power of both frames into slot k: (P_a[k], P_b[k]), k <= n/2
    for (int idx = threadIdx.x; idx < np * nb; idx += blockDim.x) {
      const int q = idx / nb, k = idx % nb;
      float2* zq = z + q * stride;
      const float2 zk = zq[pad(k)];
      const float2 zn = zq[pad((nfft - k) & (nfft - 1))];
      const float ar = zk.x + zn.x, ai = zk.y - zn.y;
      const float br = zk.x - zn.x, bi = zk.y + zn.y;
      zq[pad(k)] = make_float2(0.25f * (ar * ar + ai * ai),
                               0.25f * (br * br + bi * bi));
    }
    __syncthreads();

    // banded filterbank: band m of both frames of pair q
    for (int idx = threadIdx.x; idx < np * num; idx += blockDim.x) {
      const int q = idx % np, m = idx / np;
      const float2* zq = z + q * stride;
      const int lo = __ldg(&band_lo[m]);
      const float* w = band_w + __ldg(&band_off[m]);
      const int len = __ldg(&band_len[m]);
      float acc_a = 0.f, acc_b = 0.f;
      for (int j = 0; j < len; ++j) {
        const float wj = __ldg(&w[j]);
        const float2 p = zq[pad(lo + j)];
        acc_a = fmaf(wj, p.x, acc_a);
        acc_b = fmaf(wj, p.y, acc_b);
      }
      const int f = m * tile + f0 + 2 * q;
      mel_s[f] = acc_a;
      mel_s[f + 1] = acc_b;
      logmel[f] = log10f(fmaxf(acc_a, 1e-8f));
      logmel[f + 1] = log10f(fmaxf(acc_b, 1e-8f));
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < tile * num; idx += blockDim.x) {
    const int f = idx % tile, m = idx / tile;
    const int t = t0 + f;
    if (t < n_frames) {
      mel[(static_cast<size_t>(b) * num + m) * n_frames + t] = mel_s[m * tile + f];
    }
  }
  // DCT-II of log10(mel) over the bands, per frame of the tile
  for (int idx = threadIdx.x; idx < tile * cc; idx += blockDim.x) {
    const int f = idx % tile, c = idx / tile;
    const int t = t0 + f;
    if (t >= n_frames) continue;
    const float* d = dct + static_cast<size_t>(c) * num;
    float acc = 0.f;
    for (int m = 0; m < num; ++m) acc = fmaf(__ldg(&d[m]), logmel[m * tile + f], acc);
    cc_out[(static_cast<size_t>(b) * cc + c) * n_frames + t] = acc;
  }
}


// Floats of a pair's transpose buffer: A x (B + 1), and where a thread ends
// with one row only (T == A), room for the upper halves of all rows as
// float2, B / 2 + 1 apart.
__host__ __device__ constexpr int reg_ex_words(int a, int b, int t) {
  const int transpose = a * (b + 1);
  const int halves = t == a ? 2 * t * (b / 2 + 1) : 0;
  return transpose > halves ? transpose : halves;
}

// Fetch samples [s0, s0 + cap) of a clip of n samples into `span`, zeros
// past the clip's end.  cap is a multiple of 4.  Asynchronous: the caller
// waits with __pipeline_wait_prior(0) and a barrier.
__device__ __forceinline__ void fetch_span(float* span, const float* xb,
                                           long long s0, long long n,
                                           int cap) {
  const float* src = xb + s0;
  // a 16-byte copy needs a 16-byte address: x may be a view at any
  // offset and clips of odd length, so test the address itself
  const bool al = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int i = 4 * threadIdx.x; i < cap; i += 4 * blockDim.x) {
    if (al && s0 + i + 4 <= n) {
      __pipeline_memcpy_async(span + i, src + i, 16);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (s0 + i + e < n) {
          __pipeline_memcpy_async(span + i + e, src + i + e, 4);
        } else {
          span[i + e] = 0.f;
        }
      }
    }
  }
  __pipeline_commit();
}

// The register-resident kernel: n_fft = A * B, groups of T = B / C1 threads
// (A == 2 T or A == T), 2 * blockDim.x / T frames a tile.  `stages` cuts it to time
// the stages apart: 1 stops after the load, the window, the first pass and
// its store to the transpose buffer, 2 after the second pass and the power
// rows, 3 after the filterbank and log10, 4 is the whole kernel.  Every cut
// writes both outputs in full.
template <int A, int B, int C1>
__global__ void __launch_bounds__(256)
fused_reg_kernel(const float* __restrict__ x, long long n, int n_frames,
                 int slide, const float* __restrict__ window,
                 const float2* __restrict__ tw,
                 const int* __restrict__ band_lo,
                 const int* __restrict__ band_len,
                 const int* __restrict__ band_off,
                 const float* __restrict__ band_w, int band_w_len,
                 const float* __restrict__ dct, int num, int cc,
                 float* __restrict__ mel, float* __restrict__ cc_out,
                 int n_tiles, long long total_tiles, int consts_smem,
                 int stages) {
  constexpr int T = B / C1;
  constexpr int N = A * B;
  constexpr int NB = N / 2 + 1;     // bins of a frame
  constexpr int R2 = A / T;         // second-pass rows a thread ends with
  constexpr int EXS = reg_ex_words(A, B, T);
  constexpr int kLogA = ilog2(A), kLogB = ilog2(B);
  static_assert(R2 == 1 || R2 == 2, "a group is A or A / 2 threads");
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int tile = 2 * nthr / T;
  const int log2tile = 31 - __clz(tile);
  const int span_cap = (tile * slide + N - slide + 3) & ~3;
  float* span = reinterpret_cast<float*>(smem4);
  float2* tbl = reinterpret_cast<float2*>(span + span_cap);
  float* win = reinterpret_cast<float*>(tbl + N);
  // the tile's powers, bin-major: bin k of frame f at PT[k * PS + f].  The
  // four frames a filterbank thread takes are one 16-byte read, and the
  // stride PS = tile + 4 spreads the bins a warp stores over the banks.
  const int PS = tile + 4;
  float* PT = win + N;
  // the pairs' transpose buffers; once the transforms are done, mel (num,
  // tile) and log10(mel) (num, PS: padded like the powers, for the DCT's
  // 16-byte reads) of the tile
  float* exs = PT + NB * PS;
  const int ex_words = max(nthr / T * EXS, num * (tile + PS));
  float* mel_s = exs;
  float* logmel = mel_s + num * tile;
  float* w_s = exs + ex_words;
  float* dct_s = w_s + band_w_len;
  const int log2fg = log2tile - 2;  // groups of four frames in a tile

  const long long chunk = (total_tiles + gridDim.x - 1) / gridDim.x;
  const long long g0 = blockIdx.x * chunk;
  const long long g1 = g0 + chunk < total_tiles ? g0 + chunk : total_tiles;
  if (g0 >= g1) return;
  fetch_span(span, x + (g0 / n_tiles) * n,
             (g0 % n_tiles) * tile * static_cast<long long>(slide), n,
             span_cap);

  // once a block: the window, the twiddles W_n^(n2 k1) at [k1 * B + n2],
  // and the band weights and DCT rows where they fit
  for (int i = tid; i < N; i += nthr) {
    win[i] = __ldg(&window[i]);
    tbl[i] = __ldg(&tw[(i / B) * (i % B)]);
  }
  if (consts_smem) {
    for (int i = tid; i < band_w_len; i += nthr) w_s[i] = __ldg(&band_w[i]);
    for (int i = tid; i < cc * num; i += nthr) dct_s[i] = __ldg(&dct[i]);
  }

  const int pair = tid / T, t = tid % T;
  // the group's barrier: its lanes of the warp, or (two warps) a named
  // barrier of its own
  const unsigned gmask =
      T >= 32 ? 0xffffffffu
              : (((1u << (T & 31)) - 1u) << ((tid & 31) / T * T));
  auto group_sync = [&]() {
    if constexpr (T <= 32) {
      __syncwarp(gmask);
    } else {
      asm volatile("bar.sync %0, %1;" ::"r"(1 + pair), "r"(T) : "memory");
    }
  };
  float* ex = exs + pair * EXS;  // the pair's transpose buffer
  // the rows k1 this thread ends with: k1 and A - k1 (thread 0: 0 and A / 2)
  // where a group is A / 2 threads, else k1 alone
  const int k1r[2] = {t, R2 == 1 ? t : t == 0 ? A / 2 : A - t};

  for (long long g = g0; g < g1; ++g) {
    const long long b = g / n_tiles;
    const int t0 = static_cast<int>(g % n_tiles) * tile;
    const int ft = min(tile, n_frames - t0);  // frames of this tile
    __pipeline_wait_prior(0);
    __syncthreads();  // the span stands; the last tile's outputs are out

    if (2 * pair < ft) {
      const float* sa = span + 2 * pair * slide;
      const float* sb = sa + slide;
      float2 v[C1][A];
#pragma unroll
      for (int c = 0; c < C1; ++c) {
        const int n2 = t + T * c;
#pragma unroll
        for (int j = 0; j < A; ++j) {
          const int i = n2 + B * j;
          const float w = win[i];
          v[c][bit_reverse(j, kLogA)] = make_float2(sa[i] * w, sb[i] * w);
        }
        reg_dft<A>(v[c]);
#pragma unroll
        for (int k1 = 1; k1 < A; ++k1) {
          v[c][k1] = cmul(v[c][k1], tbl[k1 * B + n2]);
        }
#pragma unroll
        for (int k1 = 0; k1 < A; ++k1) ex[k1 * (B + 1) + n2] = v[c][k1].x;
      }
      group_sync();
      if (stages >= 2) {
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
        for (int c = 0; c < C1; ++c) {
#pragma unroll
          for (int k1 = 0; k1 < A; ++k1) {
            ex[k1 * (B + 1) + t + T * c] = v[c][k1].y;
          }
        }
        group_sync();
#pragma unroll
        for (int s = 0; s < R2; ++s) {
#pragma unroll
          for (int j = 0; j < B; ++j) {
            u[s][bit_reverse(j, kLogB)].y = ex[k1r[s] * (B + 1) + j];
          }
          reg_dft<B>(u[s]);
        }
        // u[s][k2] is bin k1r[s] + A k2.  Bin n - k of it is row A - k1 at
        // B - 1 - k2 (row 0: itself at B - k2): the thread's other row, or
        // (one row a thread) the row of thread A - t, whose upper half
        // comes through the buffer.
        float2* xh = reinterpret_cast<float2*>(ex);
        if constexpr (R2 == 1) {
          group_sync();
#pragma unroll
          for (int k2 = B / 2; k2 < B; ++k2) {
            xh[t * (B / 2 + 1) + k2 - B / 2] = u[0][k2];
          }
          group_sync();
        }
        float2* Pf = reinterpret_cast<float2*>(PT + 2 * pair);
#pragma unroll
        for (int k2 = 0; k2 < B / 2; ++k2) {
#pragma unroll
          for (int s = 0; s < R2; ++s) {
            const float2 zk = u[s][k2];
            float2 other;
            if constexpr (R2 == 1) {
              other = xh[((A - t) & (A - 1)) * (B / 2 + 1) + B / 2 - 1 - k2];
            } else {
              other = u[1 - s][B - 1 - k2];
            }
            const float2 self = u[s][s == 0 ? (B - k2) % B : B - 1 - k2];
            const float2 zn = t == 0 ? self : other;
            const float ar = zk.x + zn.x, ai = zk.y - zn.y;
            const float br = zk.x - zn.x, bi = zk.y + zn.y;
            const int k = k1r[s] + A * k2;
            Pf[k * (PS / 2)] = make_float2(0.25f * (ar * ar + ai * ai),
                                           0.25f * (br * br + bi * bi));
          }
        }
        if (t == 0) {  // bin n/2 is its own partner
          const float2 zk = u[0][B / 2];
          Pf[(N / 2) * (PS / 2)] = make_float2(zk.x * zk.x, zk.y * zk.y);
        }
      }
    }
    __syncthreads();  // the tile's powers stand; the span is free
    if (g + 1 < g1) {
      fetch_span(span, x + ((g + 1) / n_tiles) * n,
                 ((g + 1) % n_tiles) * tile * static_cast<long long>(slide),
                 n, span_cap);
    }

    if (stages >= 3) {
      // banded filterbank: band m of four frames a thread.  A round takes
      // nthr * 4 / tile bands; odd rounds run through theirs backwards, so
      // that a warp's bands are narrow in one round and wide in the next.
      const int bpr = nthr >> log2fg;
      const int f0 = (tid & ((1 << log2fg) - 1)) * 4;
      for (int base = 0, it = 0; base < num; base += bpr, ++it) {
        const int hi = min(num, base + bpr);
        const int ml = base + (tid >> log2fg);
        if (ml >= hi || f0 >= ft) continue;
        const int m = (it & 1) ? base + hi - 1 - ml : ml;
        const int off = __ldg(&band_off[m]);
        const int len = __ldg(&band_len[m]);
        const float* row = PT + __ldg(&band_lo[m]) * PS + f0;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int j = 0; j < len; ++j) {
          const float w = consts_smem ? w_s[off + j] : __ldg(&band_w[off + j]);
          const float4 p = *reinterpret_cast<const float4*>(row + j * PS);
          acc.x = fmaf(w, p.x, acc.x);
          acc.y = fmaf(w, p.y, acc.y);
          acc.z = fmaf(w, p.z, acc.z);
          acc.w = fmaf(w, p.w, acc.w);
        }
        *reinterpret_cast<float4*>(mel_s + m * tile + f0) = acc;
        *reinterpret_cast<float4*>(logmel + m * PS + f0) = make_float4(
            log10f(fmaxf(acc.x, 1e-8f)), log10f(fmaxf(acc.y, 1e-8f)),
            log10f(fmaxf(acc.z, 1e-8f)), log10f(fmaxf(acc.w, 1e-8f)));
      }
      __syncthreads();
    }

    for (int idx = tid; idx < num * tile; idx += nthr) {
      const int f = idx & (tile - 1), m = idx >> log2tile;
      if (f >= ft) continue;
      mel[(b * num + m) * n_frames + t0 + f] =
          stages >= 3 ? mel_s[idx] : PT[min(m, NB - 1) * PS + f];
    }
    // DCT-II of log10(mel) over the bands: every fourth band of
    // coefficient c for four frames a thread, the four shares in
    // neighbouring lanes (their reads on different banks) and added by
    // shuffles
    const int items = ((cc << (log2fg + 2)) + 31) & ~31;
    for (int idx = tid; idx < items; idx += nthr) {
      const int part = idx & 3, c = idx >> (log2fg + 2);
      const int fq = ((idx >> 2) & ((1 << log2fg) - 1)) * 4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < cc && stages >= 4) {
        for (int m = part; m < num; m += 4) {
          const float w = consts_smem ? dct_s[c * num + m]
                                      : __ldg(&dct[c * num + m]);
          const float4 p = *reinterpret_cast<const float4*>(logmel + m * PS + fq);
          acc.x = fmaf(w, p.x, acc.x);
          acc.y = fmaf(w, p.y, acc.y);
          acc.z = fmaf(w, p.z, acc.z);
          acc.w = fmaf(w, p.w, acc.w);
        }
      } else if (c < cc && stages == 3 && part == 0) {
        acc = *reinterpret_cast<const float4*>(logmel + c * PS + fq);
      }
#pragma unroll
      for (int d = 1; d < 4; d <<= 1) {
        acc.x += __shfl_xor_sync(0xffffffffu, acc.x, d);
        acc.y += __shfl_xor_sync(0xffffffffu, acc.y, d);
        acc.z += __shfl_xor_sync(0xffffffffu, acc.z, d);
        acc.w += __shfl_xor_sync(0xffffffffu, acc.w, d);
      }
      if (c < cc && part == 0) {
        float* o = cc_out + (b * cc + c) * n_frames + t0 + fq;
        if (fq < ft) o[0] = acc.x;
        if (fq + 1 < ft) o[1] = acc.y;
        if (fq + 2 < ft) o[2] = acc.z;
        if (fq + 3 < ft) o[3] = acc.w;
      }
    }
  }
}

template <int A, int B, int C1>
int launch_reg(const float* x, long long batch, long long n, int n_frames,
               int slide, const float* window, const void* tw,
               const int* band_lo, const int* band_len, const int* band_off,
               const float* band_w, int band_w_len, const float* dct, int num,
               int cc, float* mel, float* cc_out, int threads,
               int consts_smem, int stages, cudaStream_t st) {
  constexpr int T = B / C1, N = A * B;
  if (threads < T || threads > 256 || threads % 32 || stages < 1 ||
      stages > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile = 2 * threads / T;
  if (tile < 4 || tile & (tile - 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_tiles = (n_frames + tile - 1) / tile;
  const long long total = batch * n_tiles;
  if (n_tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t span_cap = (static_cast<size_t>(tile) * slide + N - slide + 3) & ~size_t{3};
  const size_t ex_words =
      static_cast<size_t>(threads / T) * reg_ex_words(A, B, T);
  const size_t ml_words = static_cast<size_t>(num) * (2 * tile + 4);
  size_t words = span_cap + 3 * static_cast<size_t>(N) +
                 static_cast<size_t>(N / 2 + 1) * (tile + 4) +
                 (ex_words > ml_words ? ex_words : ml_words);
  if (consts_smem) words += band_w_len + static_cast<size_t>(cc) * num;
  const size_t smem = sizeof(float) * words;
  auto kernel = fused_reg_kernel<A, B, C1>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const long long resident = static_cast<long long>(sms) * per_sm;
  const unsigned grid = static_cast<unsigned>(total < resident ? total : resident);
  kernel<<<grid, threads, smem, st>>>(
      x, n, n_frames, slide, window, static_cast<const float2*>(tw), band_lo,
      band_len, band_off, band_w, band_w_len, dct, num, cc, mel, cc_out,
      static_cast<int>(n_tiles), total, consts_smem, stages);
  return static_cast<int>(cudaGetLastError());
}

int launch_pass(const float* x, long long batch, long long n, int n_frames,
                int slide, int log2n, const float* window, const void* tw,
                const int* band_lo, const int* band_len, const int* band_off,
                const float* band_w, const float* dct, int num, int cc,
                float* mel, float* cc_out, int tile, int np, int staged,
                cudaStream_t st) {
  const long long threads = (static_cast<long long>(np) << log2n) / 16;
  if (tile < 2 || tile % 2 || np < 1 || (tile / 2) % np || log2n < 4 ||
      threads < 1 || threads > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_tiles = (n_frames + tile - 1) / tile;
  if (batch * n_tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t span_len = staged ? tile * slide + (1 << log2n) - slide : 0;
  const size_t smem = sizeof(float2) * seq_stride(1 << log2n) * np +
                      sizeof(float) * (2 * tile * num + span_len);
  cudaError_t e = cudaFuncSetAttribute(
      fused_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_pass_kernel<<<static_cast<unsigned>(batch * n_tiles),
                      static_cast<unsigned>(threads), smem, st>>>(
      x, n, n_frames, slide, log2n, window, static_cast<const float2*>(tw),
      band_lo, band_len, band_off, band_w, dct, num, cc, mel, cc_out, tile,
      np, static_cast<int>(n_tiles), staged);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (batch, n) fp32 clips.  window: n_fft.  tw: n_fft float2,
// exp(-2 pi i k / n_fft).  band_lo / band_len / band_off: num int32;
// band_w: band_w_len packed band weights.  dct: (cc, num).  mel: (batch,
// num, n_frames); cc_out: (batch, cc, n_frames).
//
// registers != 0 (n_fft 512 to 4096): the register-resident kernel
// with `threads` threads a block (a multiple of 32, at most 256; the tile
// is 2 * threads / T frames), `consts_smem`: the band weights and the DCT
// rows go to shared memory; `stages` 4 runs the whole kernel, 1..3 cut it
// (see fused_reg_kernel), for timing only.  registers == 0: the kernel of
// the shared-memory passes, `tile` (even) frames per block, `np` pairs per
// round (np divides tile / 2; np * n_fft / 16 threads), `staged`: hold the
// tile's audio span in shared memory.  The caller sizes all of them to the
// shared memory.  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int af_fused_mel_mfcc(const float* x, long long batch, long long n,
                                 int n_frames, int slide, int log2n,
                                 const float* window, const void* tw,
                                 const int* band_lo, const int* band_len,
                                 const int* band_off, const float* band_w,
                                 int band_w_len, const float* dct, int num,
                                 int cc, float* mel, float* cc_out,
                                 int registers, int threads, int consts_smem,
                                 int stages, int tile, int np, int staged,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || n_frames <= 0) return 0;
  if (!registers) {
    if (stages != 4) return static_cast<int>(cudaErrorInvalidValue);
    return launch_pass(x, batch, n, n_frames, slide, log2n, window, tw,
                       band_lo, band_len, band_off, band_w, dct, num, cc, mel,
                       cc_out, tile, np, staged, st);
  }
  decltype(&launch_reg<64, 32, 1>) fn;
  switch (log2n) {
    case 9: fn = launch_reg<32, 16, 1>; break;
    case 10: fn = launch_reg<32, 32, 2>; break;
    case 11: fn = launch_reg<64, 32, 1>; break;
    case 12: fn = launch_reg<64, 64, 1>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return fn(x, batch, n, n_frames, slide, window, tw, band_lo, band_len,
            band_off, band_w, band_w_len, dct, num, cc, mel, cc_out, threads,
            consts_smem, stages, st);
}
