// The CQT's octaves in one kernel, fp32: every octave's padded rect-window
// frames, their 512-point real transforms, the product with the octave's
// complex CQT kernel and the per-bin scale, written straight into the
// complex (batch, num, T) output (transforms/cqt.py, CQTBase.cqt).
//
// Replaces no TPU kernel: at a 512-point plan the JAX package's CQT is XLA
// code (its Pallas FFT starts at 2048).  It was added because the PyTorch
// form of an octave (pad, unfold copy, library rfft, four dense products
// over the real and imaginary planes, cat, scale, transpose) passed each
// octave's frames and spectra through device memory several times and
// multiplied a (bpo, 257) kernel with 4% nonzeros as a dense matrix.
//
// For octave o (its level x_o, slide s_o), clip b and output frame t:
//   frame = xp[(t0 + t) s_o : + 512], xp = x_o cut to (n // s_o) s_o
//           samples, with `left` zeros before it (CENTER: 256; RIGHT: 0)
//           and zeros after
//   X     = rfft(frame)                               (257 bins)
//   out[b, o bpo + r, t] = scale[o bpo + r] * sum_k K_o[r, k] X[k]
// over the kept bins of each row; frames past the octave's last are zero.
//
// What bounds it on the card: per frame a 512-point real transform (2.5 N
// log2 N = 11.5 kflop) and the product over the kernel's nonzeros (8 flop
// each, about 1 kflop at 12 bins an octave), against 512 samples read (of
// which only `slide` are new) and 12 complex values written: about 50
// flops a byte of device traffic, so the fp32 operation rate is the bound
// (84.4 GFLOP, 1.26 ms on an H100 at 128 clips x 30 s), and below it the
// rate at which the transform's instructions are dispatched.  The design
// keeps the instruction count a frame low and every intermediate on the
// chip:
//   * One block takes (octave, clip, tile of 64 frames): the grid is
//     uniform over the octaves (every octave of a plan has about T
//     frames), so one launch covers all of them.  The tile's span of the
//     padded level is copied once into shared memory with cp.async (16
//     bytes a copy where the level allows, so many copies are in flight at
//     once, where a load a thread would wait on each), zero outside the
//     cut level (the padding and the cut happen in this load).  The span
//     is sized from the frames a block can have, min(64, T); a plan whose
//     span would pass kSpanMax floats (slides above 186 at 64 frames) is
//     refused here, and ops/cuda_cqt.py's `supports` sends it to the plain
//     path.  Tile 64 beat 16, 32 and 128 on the card.
//   * A frame is one complex transform of 256 points, z[m] = x[2m] +
//     i x[2m + 1], split to the real spectrum.  256 = 16 x 16: a group of
//     16 threads owns a frame, each thread a 16-point DFT of one column in
//     registers (fft_reg.cuh), the twiddle W_256^(n2 k1) from a table in
//     shared memory, one exchange through the group's buffer (rows of 17
//     floats, the real parts and then the imaginary parts: conflict-free
//     both ways, and half the buffer of float2 rows, so that three blocks
//     fit on an SM), and a 16-point DFT of one row, which leaves
//     Z[t + 16 k2] with thread t.
//   * The split X[k] = (Z[k] + conj Z[256 - k]) / 2 + W_512^k (Z[k] -
//     conj Z[256 - k]) / 2i needs Z[256 - k]: thread 16 - t's register
//     15 - k2 (thread 0: its own (16 - k2) mod 16), taken by a shuffle
//     within the group.  Only the bins [lo, hi) that some kernel row
//     reads are split and kept (bins 29 to 70 of the benchmark's plan):
//     the columns k2 that hold none are skipped by the whole group.
//   * Once the tile's frames are split, a thread takes one (row, frame):
//     the row's run of consecutive bins (from its first nonzero to its
//     last, a table built once a plan) against the frame's kept bins in
//     shared memory, times the row's scale, stored with the frames of a
//     warp side by side, so a warp writes 32 consecutive outputs of a row.
// No TF32, no tensor cores: every product is an fp32 multiply-add.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fft_reg.cuh"
#include "fft_smem.cuh"

using afx::bit_reverse;
using afx::cmul;
using afx::reg_dft;

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 16;                 // threads a frame
constexpr int kGroups = kThreads / kGroup;
constexpr int kHalf = 256;                 // complex points a frame
constexpr int kFft = 2 * kHalf;            // the real transform's length
constexpr int kBins = kHalf + 1;
constexpr int kExStride = kGroup + 1;      // floats, a row of the exchange
constexpr int kMaxOctaves = 16;
constexpr int kLog2Tile = 6;
constexpr int kTile = 1 << kLog2Tile;      // output frames a block
constexpr int kSpanMax = 12288;            // floats of a staged span
constexpr int kSmemMax = 232448;           // a block's shared memory on sm_90

struct Level {
  const float* x;   // (batch, n)
  long long n;      // samples a clip
  long long cut;    // (n / slide) * slide: the samples the padding keeps
  int slide;
  int frames;       // n / slide + 1: the padded level's frames
};

struct Args {
  Level lv[kMaxOctaves];  // octave o reads lv[o] (o = 0 the lowest)
  const int* meta;        // (octaves, bpo, 3): first bin, run length, offset
  const float2* vals;     // the runs' kernel values, packed
  const float* scale;     // (octaves * bpo,)
  const float2* tw;       // 512 float2, exp(-2 pi i k / 512)
  float2* out;            // (batch, octaves * bpo, T)
  long long batch;
  int octaves, bpo, T, t_first, left, lo, hi, n_tiles;
  int span_cap;           // floats of the staged span
  int xs_stride;          // float2 a frame's kept bins take (odd)
};

__global__ void __launch_bounds__(kThreads)
cqt_octaves_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float2* tbl = reinterpret_cast<float2*>(smem4);              // 256
  float* span = reinterpret_cast<float*>(tbl + kHalf);         // span_cap
  float* ex = span + a.span_cap;                               // groups
  float2* xs = reinterpret_cast<float2*>(ex + kGroups * kGroup * kExStride);

  const int tid = threadIdx.x;
  long long bid = blockIdx.x;
  const int ti = static_cast<int>(bid % a.n_tiles);
  bid /= a.n_tiles;
  const long long b = bid % a.batch;
  const int o = static_cast<int>(bid / a.batch);
  // level o without a dynamic index into the parameters (which would copy
  // them to local memory)
  Level L = a.lv[0];
#pragma unroll
  for (int i = 1; i < kMaxOctaves; ++i) {
    if (i == o) L = a.lv[i];
  }
  const int t_out = ti * kTile;                      // first output frame
  const int t_oct = a.t_first + t_out;               // the octave's frame
  const int n_out = min(kTile, a.T - t_out);         // frames to write
  const int live = max(0, min(n_out, L.frames - t_oct));  // frames it has
  const float* xb = L.x + b * L.n;
  // padded position p is sample p - left of the level, kept in [0, cut)
  const long long q_first = static_cast<long long>(t_oct) * L.slide - a.left;

  // the twiddles W_256^(k1 n2) = W_512^(2 k1 n2) at [k1 * 16 + n2]
  for (int i = tid; i < kHalf; i += kThreads) {
    tbl[i] = __ldg(&a.tw[2 * (i >> 4) * (i & 15)]);
  }
  if (live > 0) {
    // span_cap >= len rounded up to 4: the last copy may run past len
    const int len = (live - 1) * L.slide + kFft;
    const bool al =
        (reinterpret_cast<uintptr_t>(xb) & 15) == 0 && (q_first & 3) == 0;
    for (int i = 4 * tid; i < len; i += 4 * kThreads) {
      const long long q = q_first + i;
      if (al && q >= 0 && q + 4 <= L.cut) {
        __pipeline_memcpy_async(span + i, xb + q, 16);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (q + e >= 0 && q + e < L.cut) {
            __pipeline_memcpy_async(span + i + e, xb + q + e, 4);
          } else {
            span[i + e] = 0.f;
          }
        }
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
  }
  __syncthreads();

  const int g = tid / kGroup, t = tid % kGroup;
  const unsigned gmask = 0xffffu << (tid & 16);      // the group's lanes
  float* exg = ex + g * kGroup * kExStride;
  const bool even = L.slide % 2 == 0;
  for (int f = g; f < live; f += kGroups) {
    // point m = t + 16 j of z at v[bit_reverse(j)]
    float2 v[kGroup];
    const float* fr = span + f * L.slide;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int i = 2 * (t + kGroup * j);
      v[bit_reverse(j, 4)] = even ? *reinterpret_cast<const float2*>(fr + i)
                                  : make_float2(fr[i], fr[i + 1]);
    }
    reg_dft<kGroup>(v);
#pragma unroll
    for (int k1 = 1; k1 < kGroup; ++k1) {
      v[k1] = cmul(v[k1], tbl[k1 * kGroup + t]);
    }
    // column t of the exchange, then row t: the real parts, then the
    // imaginary parts
    float2 u[kGroup];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int k1 = 0; k1 < kGroup; ++k1) {
        exg[k1 * kExStride + t] = c ? v[k1].y : v[k1].x;
      }
      __syncwarp(gmask);
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const float w = exg[t * kExStride + j];
        if (c) {
          u[bit_reverse(j, 4)].y = w;
        } else {
          u[bit_reverse(j, 4)].x = w;
        }
      }
      __syncwarp(gmask);  // the buffer is free again
    }
    reg_dft<kGroup>(u);  // u[k2] = Z[t + 16 k2]

    float2* xf = xs + f * a.xs_stride;  // bin k at xf[k - lo]
    const int src = (kGroup - t) & (kGroup - 1);
#pragma unroll
    for (int k2 = 0; k2 < kGroup; ++k2) {
      // the group skips a column that holds no kept bin
      if (kGroup * k2 + kGroup <= a.lo || kGroup * k2 >= a.hi) continue;
      const float2 mine = u[(kGroup - k2) & (kGroup - 1)];
      float2 p = u[kGroup - 1 - k2];
      p.x = __shfl_sync(gmask, p.x, src, kGroup);
      p.y = __shfl_sync(gmask, p.y, src, kGroup);
      if (t == 0) p = mine;  // Z[256 - 16 k2] is its own
      const int k = t + kGroup * k2;
      if (k < a.lo || k >= a.hi) continue;
      const float2 z = u[k2];
      const float2 e = make_float2(0.5f * (z.x + p.x), 0.5f * (z.y - p.y));
      const float2 d = make_float2(0.5f * (z.y + p.y), 0.5f * (p.x - z.x));
      const float2 w = __ldg(&a.tw[k]);
      const float2 wd = cmul(w, d);
      xf[k - a.lo] = make_float2(e.x + wd.x, e.y + wd.y);
    }
    if (t == 0 && a.hi > kHalf) {  // the Nyquist bin: Re Z[0] - Im Z[0]
      xf[kHalf - a.lo] = make_float2(u[0].x - u[0].y, 0.f);
    }
  }
  __syncthreads();

  // (row, frame) a thread, frames fastest: a warp's stores are one row's
  // consecutive outputs
  const int num = a.octaves * a.bpo;
  for (int idx = tid; idx < a.bpo * kTile; idx += kThreads) {
    const int r = idx >> kLog2Tile, f = idx & (kTile - 1);
    if (f >= n_out) continue;
    const int row = o * a.bpo + r;
    float2 acc = make_float2(0.f, 0.f);
    if (f < live) {
      const int* m = a.meta + 3 * row;
      const int start = __ldg(&m[0]), len = __ldg(&m[1]);
      const float2* kv = a.vals + __ldg(&m[2]);
      const float2* xf = xs + f * a.xs_stride + (start - a.lo);
      for (int j = 0; j < len; ++j) {
        const float2 k = __ldg(&kv[j]);
        const float2 x = xf[j];
        acc.x = fmaf(k.x, x.x, acc.x);
        acc.x = fmaf(-k.y, x.y, acc.x);
        acc.y = fmaf(k.x, x.y, acc.y);
        acc.y = fmaf(k.y, x.x, acc.y);
      }
      const float s = __ldg(&a.scale[row]);
      acc = make_float2(acc.x * s, acc.y * s);
    }
    a.out[(b * num + row) * a.T + t_out + f] = acc;
  }
}

}  // namespace

// levels[o], o < octaves: (batch, lengths[o]) fp32 clips, octave o's level
// (o = 0 the lowest), framed at slides[o] >= 1.  meta: (octaves, bpo, 3)
// int32, each row's first kept bin, run length and offset into vals (run
// bins in [lo, hi), 0 <= lo < hi <= 257); vals: the runs' complex kernel
// values as float2; scale: (octaves * bpo,) fp32; tw: 512 float2
// exp(-2 pi i k / 512).  out: (batch, octaves * bpo, T) complex64, output
// frame t of octave o its frame t_first + t.  left: the zeros before each
// cut level (256 CENTER, 0 RIGHT).  (min(64, T) - 1) * max(slides) + 512
// must be at most kSpanMax.  Returns the CUDA error code of the launch (0
// on success).
extern "C" int af_cqt_octaves(const void* const* levels,
                              const long long* lengths, const int* slides,
                              int octaves, long long batch, const int* meta,
                              const void* vals, const float* scale,
                              const void* tw, void* out, int bpo, int T,
                              int t_first, int left, int lo, int hi,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (octaves < 1 || octaves > kMaxOctaves || batch <= 0 || bpo < 1 ||
      T < 1 || t_first < 0 || left < 0 || lo < 0 || lo >= hi || hi > kBins) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  int max_slide = 1;
  for (int o = 0; o < octaves; ++o) {
    const long long n = lengths[o];
    const int s = slides[o];
    if (s < 1 || n < 0 || n / s + 1 > INT32_MAX) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.lv[o] = Level{static_cast<const float*>(levels[o]), n, n / s * s, s,
                    static_cast<int>(n / s + 1)};
    if (s > max_slide) max_slide = s;
  }
  a.meta = meta;
  a.vals = static_cast<const float2*>(vals);
  a.scale = scale;
  a.tw = static_cast<const float2*>(tw);
  a.out = static_cast<float2*>(out);
  a.batch = batch;
  a.octaves = octaves;
  a.bpo = bpo;
  a.T = T;
  a.t_first = t_first;
  a.left = left;
  a.lo = lo;
  a.hi = hi;
  a.n_tiles = (T + kTile - 1) / kTile;
  // the span of the most frames a block has, rounded up to 4 floats: the
  // last copy may run past its length
  const long long span =
      static_cast<long long>((T < kTile ? T : kTile) - 1) * max_slide + kFft;
  a.span_cap = static_cast<int>((span + 3) & ~3LL);
  a.xs_stride = (hi - lo) | 1;
  const long long blocks = static_cast<long long>(octaves) * batch * a.n_tiles;
  // at most 2 + 48 + 17 + 128.5 KB (all 257 bins kept): always below
  // kSmemMax once the span fits
  const long long smem =
      8LL * kHalf + 4LL * a.span_cap + 4LL * kGroups * kGroup * kExStride +
      8LL * kTile * a.xs_stride;
  if (span > kSpanMax || blocks > INT32_MAX || smem > kSmemMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaFuncSetAttribute(
      cqt_octaves_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cqt_octaves_kernel<<<static_cast<unsigned>(blocks), kThreads,
                       static_cast<size_t>(smem), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
