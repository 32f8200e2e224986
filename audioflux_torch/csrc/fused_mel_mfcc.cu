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
// below it the shared-memory traffic of the transform.  The design keeps
// every intermediate on chip — device memory sees the audio once and the
// two outputs once — and makes few passes over shared memory:
//   * One block per (clip, tile of `tile` frames), np * n_fft / 16
//     threads.  The tile's audio span (tile * slide + n_fft - slide
//     samples) is read from device memory once, 16 bytes per load where
//     aligned, into shared memory; the frames are cut from it there (where
//     the span does not fit, frames are read from device memory).
//   * Two real frames are packed as one complex FFT (z = a + i b) and
//     separated afterwards (A = (Z_k + conj Z_{n-k}) / 2,
//     B = (Z_k - conj Z_{n-k}) / 2i): half the transforms.
//   * `np` such pairs are transformed at once by the whole block with
//     radix-16 Stockham passes in registers and shared memory (fp32,
//     float64-built twiddles; fft_smem.cuh): three passes at n_fft 2048.
//   * The power spectrum overwrites the transform in place: the thread of
//     bin k alone reads slots k and n-k, and writes slot k.
//   * The filterbank runs over each band's nonzero bin range only
//     (computed on the host from fb; skipping exact zeros changes no sum),
//     one thread per (band, frame pair): each weight and each power slot
//     is read once for both frames of the pair.
//   * mel and log10(mel) stay in shared memory until the tile is done;
//     then the DCT runs and both outputs are written band-major with the
//     frame index on the contiguous axis.

#include <cstdint>

#include "fft_smem.cuh"

using afx::fft_smem;
using afx::pad;
using afx::seq_stride;

namespace {

// STAGES cuts the kernel after a stage, to time the stages apart: 1 loads
// and windows the frames, 2 adds the transform, 3 the power spectrum and
// the filterbank, 4 (the kernel the wrapper runs) the DCT.  Every cut
// writes both outputs in full, so each moves the same device bytes.
template <int STAGES>
__global__ void __launch_bounds__(1024)
fused_mel_mfcc_kernel(const float* __restrict__ x, long long n, int n_frames,
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
    if (STAGES >= 2) fft_smem(z, log2n, tw, log2n);
    if (STAGES < 3) {
      __syncthreads();
      continue;
    }

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
    if (STAGES >= 4) {
      for (int m = 0; m < num; ++m) acc = fmaf(__ldg(&d[m]), logmel[m * tile + f], acc);
    }
    cc_out[(static_cast<size_t>(b) * cc + c) * n_frames + t] = acc;
  }
}

template <int STAGES>
int launch(const float* x, long long batch, long long n, int n_frames,
           int slide, int log2n, const float* window, const void* tw,
           const int* band_lo, const int* band_len, const int* band_off,
           const float* band_w, const float* dct, int num, int cc,
           float* mel, float* cc_out, int tile, int np, int staged,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || n_frames <= 0) return 0;
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
      fused_mel_mfcc_kernel<STAGES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_mel_mfcc_kernel<STAGES><<<static_cast<unsigned>(batch * n_tiles),
                                  static_cast<unsigned>(threads), smem, st>>>(
      x, n, n_frames, slide, log2n, window, static_cast<const float2*>(tw),
      band_lo, band_len, band_off, band_w, dct, num, cc, mel, cc_out, tile,
      np, static_cast<int>(n_tiles), staged);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (batch, n) fp32 clips.  window: n_fft.  tw: n_fft float2,
// exp(-2 pi i k / n_fft).  band_lo / band_len / band_off: num int32;
// band_w: packed band weights.  dct: (cc, num).  mel: (batch, num,
// n_frames); cc_out: (batch, cc, n_frames).  `tile` (even) frames per
// block, `np` pairs per round (np divides tile / 2; np * n_fft / 16
// threads); `staged`: hold the tile's audio span in shared memory.  The
// caller sizes all three to the shared memory.  `stages` 4 runs the whole
// kernel; 1..3 cut it after a stage (see fused_mel_mfcc_kernel), for
// timing only.  Returns the CUDA error code of the launch (0 on success).
extern "C" int af_fused_mel_mfcc(const float* x, long long batch, long long n,
                                 int n_frames, int slide, int log2n,
                                 const float* window, const void* tw,
                                 const int* band_lo, const int* band_len,
                                 const int* band_off, const float* band_w,
                                 const float* dct, int num, int cc,
                                 float* mel, float* cc_out, int tile, int np,
                                 int staged, int stages, void* stream) {
  using Launch = decltype(&launch<4>);
  constexpr Launch by_stages[] = {launch<1>, launch<2>, launch<3>, launch<4>};
  if (stages < 1 || stages > 4) return static_cast<int>(cudaErrorInvalidValue);
  return by_stages[stages - 1](x, batch, n, n_frames, slide, log2n, window,
                               tw, band_lo, band_len, band_off, band_w, dct,
                               num, cc, mel, cc_out, tile, np, staged, stream);
}
