// Phase unwrap along time and backward difference in one pass, fp32:
//   k[j] in {-t, 0, t} from the principal difference of the wrapped samples
//   x[j], x[j-1] (k[0] = 0);  c = inclusive prefix sum of k;
//   y = x + c * 2 pi;  e[j] = y[j] - y[j-1],  e[0] = 0.
// and Synsq's whole map from the CWT cells to the bin index around it.
//
// Replaces the TPU kernel audioflux_tpu/ops/pallas_unwrap.py:unwrap_diff
// (the reference C's __vunwrap followed by a difference).  That kernel
// takes its prefix sum as a triangular matrix product; here it is a scan.
//
// What bounds it on the card: 4 bytes read and 4 written per sample against
// a dozen operations: device memory.  A block walks one row in tiles of
// kTile = 8192 samples; each thread owns a run of kRun = 16 consecutive
// samples and counts the wraps of its run serially.  One block-wide scan a
// tile (warp shuffles, the warps' totals through shared memory, one
// barrier: the totals alternate between two arrays) gives each run the
// count before it, and the count at the end of a tile is carried to the
// next.  The sample before a run comes from the neighbouring lane by a
// shuffle, or by one load at a warp's edge, and y[j-1] is recomputed from
// x[j-1] and the count before it, so no unwrapped phase crosses threads.
// A warp's span of a tile (32 runs) comes in by cp.async as 16-byte words,
// each instruction 512 neighbouring bytes, into the threads' runs in
// shared memory, swizzled so that the copies and the threads' reads both
// meet the banks without conflicts; the next tile's copy is issued as soon
// as the words are read, so it overlaps the scan and the stores.  The
// outputs leave the same way through a second buffer.  A row's ragged end
// and rows at unaligned addresses go one sample at a time.  Two blocks of
// 512 share an SM, so a thread has 64 registers: no spill is allowed.
//
// Synsq's entry (af_synsq_bins) reads the complex cells D (8 bytes) and
// writes an int32 bin (4 bytes) a cell, in the same pass: the phase
// atan2(re, im) (the reference's argument order), the unwrap and the
// difference, the last column's copy of the one before it, / 2 pi, the
// bin of the band layout (log, linear, or the nearest band by a binary
// search over fre / samplate staged in shared memory), and with a
// threshold the drop code: a cell whose power re^2 + im^2 is not above
// thresh^2, or whose bin is out of range, gets num.  Without a threshold an
// out-of-range cell gets -1.  Its phases lie in [-pi, pi], so a wrap count
// is -1, 0 or 1 and a run's counts fit one word; the bins are made a word
// at a time in the output buffer, so few values are live at once.  Where
// the last column starts a run, the thread recomputes e[T-2] from two more
// cells.  atan2f, log2f and three IEEE divisions a cell make it about as
// much arithmetic as bytes at the card's rates.
//
// Exactness: every fp32 operation is one of the plain version's, each
// rounded on its own (__fsub_rn, __fdiv_rn, __fmul_rn, __fadd_rn, so nvcc
// contracts no multiply-add), atan2f and log2f are CUDA's own (no
// fast-math), as PyTorch's CUDA atan2 and log2 call them, and the counts
// are integers, so the output equals the plain version's bit for bit.  The
// phases must be finite and the counts must fit 2^24, as a float holds
// them exactly.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kRun = 16;                  // samples a thread
constexpr int kTile = kThreads * kRun;    // samples a block scan
constexpr int kWarps = kThreads / 32;
constexpr float kTwoPi = 6.28318548202514648f;  // float32(2 pi)
constexpr float kPi = 3.14159274101257324f;     // float32(pi)
constexpr int kMaxFre = 8192;             // band frequencies staged
constexpr long long kMaxT = 1 << 30;      // samples a row (int indices)

enum BinKind { kLog = 0, kLinear = 1, kNearest = 2 };

// Synsq's bin map: the band frequencies (nf of them, ascending), the scale
// kind, the bin count, the sample rate, and the threshold when has_thresh.
struct BinMap {
  const float* fre;
  int nf, kind, num;
  float samplate, thresh;
  int has_thresh;
};

__device__ __forceinline__ int wrap_count(float xc, float xp) {
  const float sub = fabsf(__fsub_rn(xc, xp));
  if (sub < kPi) return 0;
  const float t = floorf(__fdiv_rn(sub, kTwoPi));
  const float mod = __fsub_rn(sub, __fmul_rn(t, kTwoPi));
  const int ti = static_cast<int>(t) + (mod > kPi ? 1 : 0);
  return xc > xp ? -ti : ti;
}

// y = x + c * 2 pi, each operation rounded on its own
__device__ __forceinline__ float unwrapped(float x, int c) {
  return __fadd_rn(x, __fmul_rn(static_cast<float>(c), kTwoPi));
}

// The phase of a cell of a Synsq row (interleaved re, im)
__device__ __forceinline__ float cell_phase(const float* row, int j) {
  return atan2f(row[2 * j], row[2 * j + 1]);
}

// The bin of a phase difference e (synsq's _bin_map, operation for
// operation): f = fre / samplate in shared memory (nf entries), c0 and c1
// the layout's constants (log: log2 f[0], log2 f[num-1] - log2 f[0];
// linear: f[0], f[num-1] - f[0]).  -1 out of range.
__device__ __forceinline__ int bin_of(float e, const float* f, int nf,
                                      int kind, int num, float c0, float c1) {
  const float vs = __fdiv_rn(e, kTwoPi);
  const float v = fabsf(vs);
  if (kind == kNearest) {
    // searchsorted(f, v, right=True) - 1, clamped to [0, num - 2]
    int lo = 0, hi = nf;
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (!(f[mid] > v)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int idx = min(max(lo - 1, 0), num - 2);
    if (!(v >= f[0] && v < f[num - 1])) return -1;
    return __fsub_rn(v, f[idx]) < __fsub_rn(f[idx + 1], v) ? idx : idx + 1;
  }
  const float nf32 = static_cast<float>(num);
  const float a = kind == kLog ? __fsub_rn(log2f(v), c0)
                               : fabsf(__fsub_rn(vs, c0));
  const float fi = floorf(__fadd_rn(__fdiv_rn(__fmul_rn(a, nf32), c1), 0.5f));
  // decided on the float: -inf, NaN and values past int32 never reach the
  // cast
  return fi >= 0.f && fi < nf32 ? static_cast<int>(fi) : -1;
}

// Index of word s of thread t's run in the staging buffer, V words a run:
// the words are XOR-swizzled so that a thread's V reads and a warp's
// 512-byte copies both meet the 32 banks without conflicts (a quarter warp
// of 16-byte accesses covers 8 distinct bank quads either way).
template <int V>
__device__ __forceinline__ int swz(int t, int s) {
  static_assert(V == 4 || V == 8, "runs of 4 or 8 words");
  return t * V + (s ^ ((t / (8 / V)) & (V - 1)));
}

// One block a row of T samples.  kBins: src holds complex cells and bins
// receives Synsq's bin of each; else src holds phases and e receives the
// difference.
template <bool kBins>
__global__ void __launch_bounds__(kThreads, 2)
unwrap_rows_kernel(const float* __restrict__ src, float* __restrict__ e_out,
                   int* __restrict__ bins, int T, BinMap bm) {
  constexpr int W = kBins ? 2 : 1;     // floats a sample
  constexpr int VI = kRun * W / 4;     // 16-byte words of a run, in
  constexpr int VO = kRun / 4;         // and out
  constexpr int kSpan = 32 * kRun;     // samples of a warp
  // the warps' totals, by the parity of the tile: one barrier a tile
  __shared__ int warp_tot[2][kWarps];
  // the bin map's constants (log: log2 f[0], log2 f[num-1] - log2 f[0];
  // linear: f[0], f[num-1] - f[0]; then thresh^2)
  __shared__ float consts[3];
  // the runs' words on their way in, on their way out, then fre / samplate
  extern __shared__ float4 stage[];
  float4* in_words = stage;
  float4* out_words = stage + kThreads * VI;
  float* f_s = reinterpret_cast<float*>(out_words + kThreads * VO);
  const float* row = src + static_cast<size_t>(blockIdx.x) * T * W;
  float* out = kBins ? reinterpret_cast<float*>(bins) : e_out;
  out += static_cast<size_t>(blockIdx.x) * T;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  if constexpr (kBins) {
    for (int i = tid; i < bm.nf; i += kThreads) {
      f_s[i] = __fdiv_rn(bm.fre[i], bm.samplate);
    }
    if (tid == 0) {
      const float fmin = __fdiv_rn(bm.fre[0], bm.samplate);
      const float fmax = __fdiv_rn(bm.fre[bm.num - 1], bm.samplate);
      const float c0 = bm.kind == kLog ? log2f(fmin) : fmin;
      consts[0] = c0;
      consts[1] =
          bm.kind == kLog ? __fsub_rn(log2f(fmax), c0) : __fsub_rn(fmax, fmin);
      consts[2] = __fmul_rn(bm.thresh, bm.thresh);
    }
    __syncthreads();
  }

  // A warp's span of a tile goes in as 16-byte words, copied while the
  // tile before it is computed, where it is whole and its address allows;
  // else (a row's ragged end, rows at unaligned addresses) one sample at a
  // time.
  auto staged = [&](int base) {
    const int w0 = base + warp * kSpan;
    return w0 + kSpan <= T &&
           (reinterpret_cast<uintptr_t>(row + W * w0) & 15) == 0;
  };
  auto fetch = [&](int base) {
    const float* wp = row + W * (base + warp * kSpan);
#pragma unroll
    for (int q = 0; q < VI; ++q) {
      const int i = lane + 32 * q;
      __pipeline_memcpy_async(in_words + swz<VI>(warp * 32 + i / VI, i % VI),
                              wp + 4 * i, 16);
    }
    __pipeline_commit();
  };
  if (staged(0)) fetch(0);

  int carry = 0;  // the count at the end of the previous tile
  for (int base = 0, parity = 0; base < T; base += kTile, parity ^= 1) {
    const int wj0 = base + warp * kSpan;
    const int j0 = wj0 + lane * kRun;
    const bool staged_in = staged(base);
    if (staged_in) {
      __pipeline_wait_prior(0);
      __syncwarp();
    }
    float x[kRun];
    unsigned loud = 0;  // bit i: cell j0 + i is above the threshold
    if constexpr (kBins) {
      // a cell's phase, and whether its power passes the threshold, as
      // soon as it is loaded (the cells themselves are not kept)
      auto take = [&](int i, float re, float im) {
        x[i] = atan2f(re, im);
        const float power = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
        loud |= (power > consts[2] ? 1u : 0u) << i;
      };
      if (staged_in) {
#pragma unroll
        for (int q = 0; q < VI; ++q) {
          const float4 w = in_words[swz<VI>(tid, q)];
          take(2 * q, w.x, w.y);
          take(2 * q + 1, w.z, w.w);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          const float2 z =
              j0 + i < T ? reinterpret_cast<const float2*>(row)[j0 + i]
                         : make_float2(0.f, 0.f);
          take(i, z.x, z.y);
        }
      }
    } else if (staged_in) {
#pragma unroll
      for (int q = 0; q < VI; ++q) {
        const float4 w = in_words[swz<VI>(tid, q)];
        x[4 * q] = w.x;
        x[4 * q + 1] = w.y;
        x[4 * q + 2] = w.z;
        x[4 * q + 3] = w.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kRun; ++i) x[i] = j0 + i < T ? row[j0 + i] : 0.f;
    }
    // the warp's words are read: the next tile's may come in
    if (base + kTile < T && staged(base + kTile)) {
      __syncwarp();
      fetch(base + kTile);
    }

    // the sample before the run: the last of lane - 1's run, or a load at
    // the warp's edge
    float xp = __shfl_up_sync(0xffffffffu, x[kRun - 1], 1);
    if (lane == 0 && j0 > 0 && j0 <= T) {
      xp = kBins ? cell_phase(row, j0 - 1) : row[j0 - 1];
    }
    // the run's wrap counts.  Synsq's phases come from atan2f, within
    // [-pi, pi], so a count is -1, 0 or 1: bit i of `ud` marks +1, bit
    // 16 + i marks -1; the bare entry's phases may be any finite values
    static_assert(kRun <= 16, "a run's counts in one word");
    int k[kBins ? 1 : kRun];
    unsigned ud = 0;
    int total = 0;
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const int j = j0 + i;
      const int ki = j > 0 && j < T ? wrap_count(x[i], i ? x[i - 1] : xp) : 0;
      if constexpr (kBins) {
        ud |= (ki > 0 ? 1u : ki < 0 ? 0x10000u : 0u) << i;
      } else {
        k[i] = ki;
      }
      total += ki;
    }

    // the block's scan of the runs' totals
    int c = total;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, c, o);
      if (lane >= o) c += v;
    }
    if (lane == 31) warp_tot[parity][warp] = c;
    __syncthreads();
    int before = carry, tile_total = carry;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int v = warp_tot[parity][w];
      tile_total += v;
      if (w < warp) before += v;
    }
    carry = tile_total;
    int cj = before + c - total;  // the count at sample j0 - 1

    // Synsq's last column repeats the one before it: prev holds e[j - 1],
    // which where the last column starts this run (T - 1 = j0 >= 16) is
    // recomputed from cells T-2 (xp) and T-3
    float prev = 0.f;
    if (kBins && j0 == T - 1 && j0 > 0) {
      const float xpp = cell_phase(row, j0 - 2);
      prev = __fsub_rn(unwrapped(xp, cj),
                       unwrapped(xpp, cj - wrap_count(xp, xpp)));
    }
    float yp = unwrapped(xp, cj);
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if constexpr (kBins) {
        cj += static_cast<int>(ud >> i & 1u) -
              static_cast<int>(ud >> (16 + i) & 1u);
      } else {
        cj += k[i];
      }
      const float y = unwrapped(x[i], cj);
      const float e = j0 + i > 0 ? __fsub_rn(y, yp) : 0.f;
      yp = y;
      if constexpr (kBins) {
        x[i] = j0 + i == T - 1 ? prev : e;  // Synsq's phase difference
        prev = e;
      } else {
        x[i] = e;
      }
    }
    // the run's outputs wait in the warp's buffer: e, or Synsq's bins (as
    // float bits), made there a word at a time
#pragma unroll
    for (int q = 0; q < VO; ++q) {
      out_words[swz<VO>(tid, q)] =
          make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
    }
    if constexpr (kBins) {
      __syncwarp();  // read back from the buffer: x is not kept live
      auto bin = [&](float e, int i) {
        const int fi =
            bin_of(e, f_s, bm.nf, bm.kind, bm.num, consts[0], consts[1]);
        return __int_as_float(
            !bm.has_thresh ? fi
            : fi >= 0 && fi < bm.num && (loud >> i & 1u) ? fi
                                                         : bm.num);
      };
#pragma unroll
      for (int q = 0; q < VO; ++q) {
        float4& w = out_words[swz<VO>(tid, q)];
        w = make_float4(bin(w.x, 4 * q), bin(w.y, 4 * q + 1),
                        bin(w.z, 4 * q + 2), bin(w.w, 4 * q + 3));
      }
    }
    __syncwarp();
    // out: the warp's span as 16-byte words, where it is whole and its
    // address allows, else one sample at a time
    if (wj0 + kSpan <= T &&
        (reinterpret_cast<uintptr_t>(out + wj0) & 15) == 0) {
#pragma unroll
      for (int q = 0; q < VO; ++q) {
        const int i = lane + 32 * q;
        reinterpret_cast<float4*>(out + wj0)[i] =
            out_words[swz<VO>(warp * 32 + i / VO, i % VO)];
      }
    } else {
#pragma unroll
      for (int q = 0; q < VO; ++q) {
        const float4 w = out_words[swz<VO>(tid, q)];
        const float v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (j0 + 4 * q + c < T) out[j0 + 4 * q + c] = v[c];
        }
      }
    }
    __syncwarp();  // the buffer is free for the next tile
  }
}

// Launch unwrap_rows_kernel, one block a row, with its dynamic shared
// memory: the runs' words in and out, and Synsq's nf band frequencies.
template <bool kBins>
cudaError_t launch_rows(const float* src, float* e, int* bins, long long rows,
                        long long T, const BinMap& bm, cudaStream_t st) {
  const size_t smem = sizeof(float) * (kThreads * kRun * (kBins ? 3 : 2) +
                                       (kBins ? bm.nf : 0));
  auto kernel = unwrap_rows_kernel<kBins>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(rows), kThreads, smem, st>>>(
      src, e, bins, static_cast<int>(T), bm);
  return cudaGetLastError();
}

}  // namespace

// x, e: (rows, T) fp32, contiguous.  Returns the CUDA error code.
extern "C" int af_unwrap_diff(const float* x, float* e, long long rows,
                              long long T, void* stream) {
  if (rows <= 0 || T <= 0) return 0;
  if (rows > INT32_MAX || T > kMaxT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_rows<false>(
      x, e, nullptr, rows, T, BinMap{}, static_cast<cudaStream_t>(stream)));
}

// D: (rows, T) complex64 cells (interleaved re, im), bins: (rows, T) int32.
// fre: nf ascending band frequencies (fp32); kind 0 log, 1 linear, 2 the
// nearest band; num bins (1 <= num <= nf); thresh is used when
// has_thresh.  Returns the CUDA error code.
extern "C" int af_synsq_bins(const float* D, int* bins, const float* fre,
                             int nf, long long rows, long long T, int kind,
                             int num, float samplate, float thresh,
                             int has_thresh, void* stream) {
  if (rows <= 0 || T <= 0) return 0;
  if (rows > INT32_MAX || T > kMaxT || kind < kLog || kind > kNearest ||
      num < 1 || num > nf || nf > kMaxFre) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BinMap bm{fre, nf, kind, num, samplate, thresh, has_thresh};
  return static_cast<int>(launch_rows<true>(
      D, nullptr, bins, rows, T, bm, static_cast<cudaStream_t>(stream)));
}
