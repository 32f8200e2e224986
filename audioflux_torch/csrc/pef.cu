// PEF, the pseudo-energy-filter pitch (PitchPEF), from the recordings to
// the pitch in two kernels, fp32.
//
// Neither replaces a TPU kernel: the JAX package's PEF is XLA code around
// fft4_fwd and fft4_inv (audioflux_tpu/mir/pitch.py), whose CUDA
// counterparts in fft_pow2.cu stay as they are for every other caller.
// Per frame PEF takes the power spectrum of the windowed frame at 2 N
// (N = fft_length = 4096), resamples it onto a log grid of G = 2 N points
// (a two-point interpolation from the linear bins), places that row at
// pad_num in a zero row of X = 32768 points, cross-correlates it with the
// comb filter (forward, times conj(Ff), inverse) and keeps the lag of the
// largest value in [min_index, max_index].  Done as separate transforms
// and PyTorch code, a frame's complex spectrum, its power, two gathered
// planes, the 16,385 bins of the cross-correlation's spectrum (twice, for
// the product) and its 32,768 lags all pass through device memory, and
// only one index a frame is kept.  Here nothing per bin or per lag leaves
// the chip:
//
//   * pef_log_power_kernel: the front.  The real-row route's forward at
//     n = 2 N (fft_real_reg.cuh, RealRoute<1>: N complex points, 64
//     threads a frame, persistent blocks), with each frame read straight
//     from its recording and the window applied in the load; the split of
//     real_fwd_kernel (X[k] = E + W^k O from Z[k] and Z[N - k]) evaluated
//     only for the pairs that hold a bin the grid reads; the power of
//     those bins in shared memory; and the G interpolated
//     values (p[pos] + w (p[pos + 1] - p[pos])) bw of the frame written
//     as one row.  The power and the interpolation round as PyTorch's
//     separate operations do (no contraction).  Bound by its store of G
//     floats a frame and the grid's three tables read through the cache.
//   * pef_xcorr_pitch_kernel: the back.  One row a block of 256 threads
//     (RealRoute<4>), persistent blocks that stage the next row with a
//     TMA bulk copy while this one is transformed.  The forward at X of
//     the row placed at pad_num (only its G live samples are read); then,
//     for each pair of bins (k, N - k) the threads hold after the forward,
//     one exchange through the transpose buffer (the bins of one half of
//     each thread's out, the partners' merged points back), in which the
//     thread of k forms the split to X[k] and X[N - k], the products with
//     conj(Ff[k]) and conj(Ff[N - k]) (the filter's half spectrum, the
//     same for every row, held in shared memory), and real_inv_kernel's
//     merge of the half spectrum at the inverse's packed points k and
//     N - k, in registers; the merged points back to the transform's
//     input layout through the buffer; the inverse as real_inv_kernel runs
//     it (the forward's passes on the conjugate); then the arg-max over
//     [min_index, max_index]: the lags to the buffer in their order, each
//     thread over every 256th, a warp shuffle, the warps' winners in warp
//     0, the first lag on ties as torch.argmax keeps it (and a NaN as the
//     largest value).  One float a frame is written: log_fre[lag].  Both
//     transforms run through one copy of the transform's code: the
//     kernel's instruction count a row is what bounds it (a copy each, as
//     the route's forward and back passes, doubled its time, PERF.md).
//
// The twiddle W_X^k of the split and the merge is the product of two
// exact fp32 factors, W_X^(g + 4096 kb + 64 (ka & 1)) from the table and
// W_256^(ka >> 1) as a literal, as the real-row route forms its own.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fft_real_reg.cuh"
#include "fft_reg.cuh"
#include "fft_smem.cuh"

using afx::bit_reverse;
using afx::cmul;

namespace {

constexpr int kSmemMax = 232448;  // a block's shared memory on sm_90

// ------------------------------------------------------------------ front

// What the front reads and writes: frame f of recording r is x[r, f
// slide ..][:N] times the window; its G grid values go to row r frames +
// f of out.  The kept bins are [b0, b1]: every pos lies in [b0, b1 - 1].
struct LogPowerArgs {
  const float* x;
  const float* window;
  const int* pos;
  const float* w;
  const float* bw;
  float* out;
  long long rows, samples;
  int frames, slide, grid, b0, b1;
  bool pairs;  // every frame 8-byte aligned: its points load as float2
};

__global__ void __launch_bounds__(64)
pef_log_power_kernel(LogPowerArgs a, const float2* __restrict__ tw) {
  using R = afx::RealRoute<1>;
  constexpr int N = R::kN, T = R::kB, n = 2 * N;
  constexpr int kPairs = N / 2 / T;  // pairs (k, N - k) a thread: 32
  constexpr int kLive = N / 2 / T;   // loads a thread: the frame's N samples
  extern __shared__ float4 smem4[];
  float2* buf = reinterpret_cast<float2*>(smem4);
  float* power = reinterpret_cast<float*>(buf + R::kBuf);  // bins b0 .. b1
  const int t = threadIdx.x;
  // a complex value of the pair buffer, as real_fwd_kernel lays it out
  auto slot = [](int k) { return k + (k >> 12) * R::kPad; };
  // whether pair i of any thread holds a kept bin: k = T i .. T i + T - 1
  // (bins k), bins N - k, and for k = 0 bins N / 2 and N
  auto needed = [&](int i) {
    const int lo = T * i, hi = T * i + T - 1;
    const bool low = lo <= a.b1 && a.b0 <= hi;
    const bool high = N - hi <= a.b1 && a.b0 <= N - lo;
    const bool k0 = i == 0 && ((a.b0 <= N / 2 && N / 2 <= a.b1) ||
                               a.b1 >= N);
    return low || high || k0;
  };
  auto put = [&](int b, float2 xv) {
    if (a.b0 <= b && b <= a.b1) {
      power[b - a.b0] = __fadd_rn(__fmul_rn(xv.x, xv.x), __fmul_rn(xv.y, xv.y));
    }
  };
  const float2* win = reinterpret_cast<const float2*>(a.window);

  for (long long row = blockIdx.x; row < a.rows; row += gridDim.x) {
    const long long rec = row / a.frames;
    const int f = static_cast<int>(row % a.frames);
    const float* src =
        a.x + rec * a.samples + static_cast<long long>(f) * a.slide;
    float2 v[64];
    // point j = j1 T + t: samples 2 j, 2 j + 1 of the frame, zero past N
#pragma unroll
    for (int j1 = 0; j1 < 64; ++j1) {
      if (j1 < kLive) {
        const int j = j1 * T + t;
        const float2 s =
            a.pairs ? __ldg(reinterpret_cast<const float2*>(src) + j)
                    : make_float2(__ldg(src + 2 * j), __ldg(src + 2 * j + 1));
        const float2 wv = __ldg(win + j);
        v[bit_reverse(j1, 6)] =
            make_float2(__fmul_rn(s.x, wv.x), __fmul_rn(s.y, wv.y));
        // keep the loads of a later point from being hoisted this far: the
        // point's registers are the transform's, and no more are free
        if ((j1 & 7) == 7) asm volatile("" ::: "memory");
      } else {
        v[bit_reverse(j1, 6)] = make_float2(0.f, 0.f);
      }
    }
    afx::real_route_transform<1, true>(
        v, buf, tw + n, t, true,
        [&](int ka, float2 z) { buf[slot(t + 64 * ka)] = z; });
    __syncthreads();  // Z stands in the buffer
    // real_fwd_kernel's split, pair by pair: X[k] = E + W^k O and X[N -
    // k] = conj(E - W^k O); the thread of k = 0 has X[0], X[N / 2] =
    // conj Z[N / 2] and X[N].  W_n^k = W_n^t W_128^i
    const float2 wt = __ldg(afx::per_row(tw) + t);
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      if (!needed(i)) continue;
      const int k = t + T * i;
      const float2 za = buf[slot(k)];
      const float2 zb = buf[slot(k == 0 ? N / 2 : N - k)];
      if (i == 0 && t == 0) {
        put(0, make_float2(za.x + za.y, 0.f));
        put(N / 2, make_float2(zb.x, -zb.y));
        put(N, make_float2(za.x - za.y, 0.f));
        continue;
      }
      const float2 e = make_float2(0.5f * (za.x + zb.x), 0.5f * (za.y - zb.y));
      const float2 o = make_float2(0.5f * (za.y + zb.y), 0.5f * (zb.x - za.x));
      const float2 wo = cmul(cmul(wt, afx::w256(2 * i)), o);
      put(k, make_float2(e.x + wo.x, e.y + wo.y));
      put(N - k, make_float2(e.x - wo.x, wo.y - e.y));
    }
    // the power stands, and the buffer is free for the next frame's
    // transform (the power is written again only after its barriers)
    __syncthreads();
    float* out = a.out + row * a.grid;
    for (int q = t; q < a.grid; q += T) {
      const int p = __ldg(a.pos + q) - a.b0;
      const float p1 = power[p], p2 = power[p + 1];
      out[q] = __fmul_rn(
          __fadd_rn(p1, __fmul_rn(__ldg(a.w + q), __fsub_rn(p2, p1))),
          __ldg(a.bw + q));
    }
  }
}

// ------------------------------------------------------------------- back

// What the back reads and writes: row r of lp is the G live samples of an
// X-point zero row at pad; ff: conj(Ff[k]) as (re, im), k = 0 .. N; the
// pitch log_fre[lag] of row r goes to out[r].
struct XcorrArgs {
  const float* lp;
  const float* ff;
  const float* log_fre;
  float* out;
  long long rows;
  int grid, pad, lo_lag, hi_lag;
};

constexpr int kBackWarps = 8;
// the points of a row that may be live: pad + G <= 2 * 256 * kBackLive
// (PEF's pad is at most N0 = 4096, its G = 2 N0 = 8192)
constexpr int kBackLive = 24;
// the transpose buffer's floats as the transforms use them: 64 rows of
// P = B + 4, the last row's four pad floats left out
constexpr int kBackBuf = 63 * afx::RealRoute<4>::kP + afx::RealRoute<4>::kB;

// Shared memory of the back: the staged row, the transpose buffer, the
// filter's spectrum (N float2, Re Ff[N] in the imaginary part of k = 0),
// the warps' winners and the mbarrier.
__host__ __device__ constexpr int back_smem(int grid) {
  return 4 * (grid + kBackBuf) +
         8 * (afx::RealRoute<4>::kN + kBackWarps + 1);
}
static_assert(back_smem(8192) <= kSmemMax, "a row of 8192 fits");

// Whether (a, la) beats (b, lb) as torch.argmax ranks them: the larger
// value, a NaN above every number, the lower lag among equals; a negative
// lag is no candidate.
__device__ __forceinline__ bool beats(float a, int la, float b, int lb) {
  if (la < 0) return false;
  if (lb < 0) return true;
  if (a != a) return b == b || la < lb;
  if (b != b) return false;
  return a > b || (a == b && la < lb);
}

// The half-spectrum work at one pair of bins (k, N - k), 0 < k < N, from
// Z[k] = za and Z[N - k] = zb, w = W_X^k, fa = conj Ff[k], fb = conj
// Ff[N - k]: real_fwd_kernel's split, X[k] = E + w O and X[N - k] = conj(E
// - w O); the products P = X conj(Ff); and real_inv_kernel's merge of the
// inverse's packed point k (A = P[k], B = conj P[N - k], E' = A + B, O' =
// (A - B) conj(w), the transform's input conj(E' + i O')) to own and, with
// W_X^(N - k) = -conj(w), of point N - k to other.
__device__ __forceinline__ void pair_merge(float2 za, float2 zb, float2 w,
                                           float2 fa, float2 fb, float2& own,
                                           float2* other) {
  const float2 e = make_float2(0.5f * (za.x + zb.x), 0.5f * (za.y - zb.y));
  const float2 o = make_float2(0.5f * (za.y + zb.y), 0.5f * (zb.x - za.x));
  const float2 wo = cmul(w, o);
  const float2 pa = cmul(make_float2(e.x + wo.x, e.y + wo.y), fa);
  const float2 pb = cmul(make_float2(e.x - wo.x, wo.y - e.y), fb);
  const float2 e2 = make_float2(pa.x + pb.x, pa.y - pb.y);
  const float2 o2 =
      cmul(make_float2(pa.x - pb.x, pa.y + pb.y), make_float2(w.x, -w.y));
  own = make_float2(e2.x - o2.y, -e2.y - o2.x);
  if (other != nullptr) {
    const float2 e3 = make_float2(pb.x + pa.x, pb.y - pa.y);
    const float2 o3 =
        cmul(make_float2(pb.x - pa.x, pb.y + pa.y), make_float2(-w.x, -w.y));
    *other = make_float2(e3.x - o3.y, -e3.y - o3.x);
  }
}

__global__ void __launch_bounds__(256)
pef_xcorr_pitch_kernel(XcorrArgs a, const float2* __restrict__ tw) {
  using R = afx::RealRoute<4>;
  constexpr int N = R::kN, T = R::kB, P = R::kP, n = 2 * N;
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);
  float* buf = stage + a.grid;
  float2* ffs = reinterpret_cast<float2*>(buf + kBackBuf);
  float2* red = ffs + N;
  uint64_t* bar = reinterpret_cast<uint64_t*>(red + kBackWarps);
  const int t = threadIdx.x;
  const float2* fac = tw + n;
  // the filter's slot of bin k: bits 2-3 of k swizzled by k >> 12, so that
  // a half-warp's reads of its bins (k and N - k) fall in distinct banks
  auto fslot = [](int k) { return k ^ ((k >> 12) << 2); };
  // word i of a flat row of N floats in the buffer: bits 3-4 of i swizzled
  // by bits 12-13 (transposition) or 13-14 (lags), so that a warp's writes
  // of its bins, 4096 or 8192 apart, fall in distinct banks; a warp's
  // reads of consecutive words stay in distinct banks
  auto nat = [](int i) { return i ^ (((i >> 12) & 3) << 3); };
  auto lagw = [](int i) { return i ^ (((i >> 13) & 3) << 3); };
  // one TMA bulk copy a row (rows 16-byte aligned, G % 4 == 0)
  auto fetch = [&](int r) {
    if (t == 0) {
      afx::bulk_fetch(stage, a.lp + static_cast<long long>(r) * a.grid,
                      4u * a.grid, bar);
    }
  };

  for (int k = t; k < N; k += T) {
    ffs[fslot(k)] = k == 0 ? make_float2(__ldg(a.ff), __ldg(a.ff + 2 * N))
                           : make_float2(__ldg(a.ff + 2 * k),
                                         __ldg(a.ff + 2 * k + 1));
  }
  if (t == 0) afx::mbar_init(bar);
  __syncthreads();
  const int rows = static_cast<int>(a.rows);
  int row = blockIdx.x;
  uint32_t phase = 0;
  if (row < rows) fetch(row);
  constexpr float s = 1.f / n;
  for (; row < rows; row += gridDim.x) {
    afx::mbar_wait(bar, phase);
    phase ^= 1u;
    __syncthreads();  // the row stands in the staging buffer
    const unsigned grid = static_cast<unsigned>(a.grid);
    float2 v[64];
    // point j = j1 T + t: samples 2 j, 2 j + 1 of the zero row, live where
    // pad <= p < pad + G; zero past j1 = kBackLive for every row, so that
    // the transform's first stages fold those zeros away
#pragma unroll
    for (int j1 = 0; j1 < 64; ++j1) {
      if (j1 >= kBackLive) {
        v[bit_reverse(j1, 6)] = make_float2(0.f, 0.f);
        continue;
      }
      const int rel = 2 * (j1 * T + t) - a.pad;
      const unsigned r0 = static_cast<unsigned>(rel);
      const unsigned r1 = static_cast<unsigned>(rel + 1);
      v[bit_reverse(j1, 6)] = make_float2(r0 < grid ? stage[rel] : 0.f,
                                          r1 < grid ? stage[rel + 1] : 0.f);
    }
    __syncthreads();  // the staging buffer is free: fetch the next row
    if (row + static_cast<int>(gridDim.x) < rows) fetch(row + gridDim.x);

    // the forward, then the inverse's transform (by conjugation, as
    // real_inv_kernel runs it): one copy of the transform's code, run
    // twice (the kernel's size costs it time)
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      // t, opaque where the row goes on (the lanes' literal selections are
      // made again each transform, not kept in registers across them)
      int tl = t;
      asm volatile("" : "+r"(tl));
      afx::real_route_transform<4, false>(v, buf, fac, tl, true,
                                          [](int, float2) {});
      if (pass == 1) break;
      // thread u = g C + jb holds Z[k], k = g + 64 ka + 4096 kb, at v[ka].
      // The partner of bin k is N - k: for g > 0 the bin (64 - g, 63 - ka,
      // 3 - kb) of thread 259 - u, for g = 0 (u < 4) and ka > 0 the bin
      // (0, 64 - ka, 3 - kb) of thread 3 - u; so the bins of ka < 32 pair
      // with those of ka >= 32, but for g = 0 at ka = 0 (bins 0, N / 2 and
      // the pair N / 4, 3 N / 4) and at ka = 32, whose partners are lanes
      // of the same warp.  The bins of ka >= 32 go to the buffer (slot
      // (ka - 32) T + u, as float2), the thread of each bin of ka < 32
      // reads its partner's there and writes back the partner's merged
      // point in its place, and each thread reads its merged points of
      // ka >= 32 back.
      const int g = tl / 4, kb = bit_reverse(tl % 4, 2);
      const int k0 = g + 4096 * kb;
      float2* xc = reinterpret_cast<float2*>(buf);
      // float2 slot i of the exchange, in the columns the transforms use
      auto xslot = [&](int i) { return xc + (i / 128) * (P / 2) + i % 128; };
      const float2* twr = afx::per_row(tw);
      const float2 base[2] = {__ldg(twr + k0), __ldg(twr + k0 + 64)};
      // W_X^k = W_X^(k0 + 64 (ka & 1)) W_256^(ka >> 1)
      auto twid = [&](int ka) {
        return cmul(base[ka & 1], afx::w256(ka >> 1));
      };
#pragma unroll
      for (int ka = 32; ka < 64; ++ka) *xslot((ka - 32) * T + tl) = v[ka];
      // the lanes' own pairs at ka = 0 (N / 4 with 3 N / 4) and ka = 32
      const float2 z0 = make_float2(__shfl_xor_sync(0xffffffffu, v[0].x, 1),
                                    __shfl_xor_sync(0xffffffffu, v[0].y, 1));
      __syncthreads();
      // four bins at a time: their operands are loaded before any of
      // their partners' points is stored (a store could alias a later
      // load, so the loads of later bins are not hoisted above it)
      constexpr int kBatch = 4;
#pragma unroll
      for (int k8 = 0; k8 < 32; k8 += kBatch) {
        float2 fa[kBatch], fb[kBatch], zb[kBatch];
        int other[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int ka = k8 + i, k = k0 + 64 * ka, kp = (N - k) & (N - 1);
          fa[i] = ffs[fslot(k)];
          fb[i] = ffs[fslot(kp)];
          other[i] = g ? (31 - ka) * T + (T + 3 - tl)
                       : ka ? (32 - ka) * T + (3 - tl) : 0;
          // g = 0 at ka = 0: bin 0, N / 2 (its own partner), N / 4 and
          // 3 N / 4
          zb[i] = ka == 0 && g == 0 ? (tl == 1 ? v[0] : z0)
                                    : *xslot(other[i]);
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int ka = k8 + i;
          if (ka == 0 && g == 0) {
            if (tl == 0) {  // X[0] and X[N], real; the inverse reads Re P
              const float p0 = (v[0].x + v[0].y) * fa[0].x;
              const float pn = (v[0].x - v[0].y) * fa[0].y;
              v[0] = make_float2(p0 + pn, pn - p0);
            } else {
              pair_merge(v[0], zb[0], twid(0), fa[0], fb[0], v[0], nullptr);
            }
            continue;
          }
          pair_merge(v[ka], zb[i], twid(ka), fa[i], fb[i], v[ka],
                     xslot(other[i]));
        }
      }
      __syncthreads();  // every point of ka >= 32 is merged in its slot
#pragma unroll
      for (int ka = 32; ka < 64; ++ka) v[ka] = *xslot((ka - 32) * T + tl);
      {  // g = 0 at ka = 32: the slot still holds the bin, and the partner
         // is lane u ^ 3
        const float2 zp =
            make_float2(__shfl_xor_sync(0xffffffffu, v[32].x, 3),
                        __shfl_xor_sync(0xffffffffu, v[32].y, 3));
        if (g == 0) {
          const int k = k0 + 64 * 32;
          pair_merge(v[32], zp, twid(32), ffs[fslot(k)], ffs[fslot(N - k)],
                     v[32], nullptr);
        }
      }
      // the merged points to the transform's input layout, point j = j1 T
      // + t at v[bit_reverse(j1)], through the buffer (real parts, then
      // imaginary parts, in place in the registers)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        __syncthreads();  // the buffer is free
#pragma unroll
        for (int ka = 0; ka < 64; ++ka) {
          buf[nat(k0 + 64 * ka)] = c ? v[ka].y : v[ka].x;
        }
        __syncthreads();
#pragma unroll
        for (int j1 = 0; j1 < 64; ++j1) {
          const float w = buf[nat(j1 * T + tl)];
          if (c) {
            v[bit_reverse(j1, 6)].y = w;
          } else {
            v[bit_reverse(j1, 6)].x = w;
          }
        }
      }
      __syncthreads();  // the buffer is free for the transform
    }
    // thread u holds F[m] at v[ka], m = g + 64 ka + 4096 kb: lag 2 m is
    // s Re F[m], lag 2 m + 1 is -s Im F[m].  The even lags, then the odd
    // ones, go to the buffer in the order of m (word m ^ (kb << 3)), and
    // each thread scans every B-th m of [lo, hi]; the warps' winners meet
    // in warp 0, which writes the pitch.  Ties go to the lower lag, a NaN
    // above every number (beats).
    int lo = a.lo_lag, hi = a.hi_lag;
    asm volatile("" : "+r"(lo), "+r"(hi));
    float best = 0.f;
    int lag = -1;
    {
      const int kb = bit_reverse(t % 4, 2);
      float* const w0 = buf + ((t / 4 + 4096 * kb) ^ (kb << 3));
#pragma unroll
      for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int ka = 0; ka < 64; ++ka) {
          w0[64 * ka] = c ? -s * v[ka].y : s * v[ka].x;
        }
        __syncthreads();
        for (int m = ((lo - c + 1) >> 1) + t; m <= (hi - c) >> 1; m += T) {
          const float val = buf[m ^ (((m >> 12) & 3) << 3)];
          if (beats(val, 2 * m + c, best, lag)) {
            best = val;
            lag = 2 * m + c;
          }
        }
        if (c == 0) __syncthreads();  // the odd lags take the words next
      }
    }
    auto meet = [&]() {
#pragma unroll
      for (int h = 16; h >= 1; h /= 2) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, h);
        const int ol = __shfl_xor_sync(0xffffffffu, lag, h);
        if (beats(ob, ol, best, lag)) {
          best = ob;
          lag = ol;
        }
      }
    };
    meet();
    if ((t & 31) == 0) red[t >> 5] = make_float2(best, __int_as_float(lag));
    __syncthreads();
    if (t < 32) {
      const float2 r = red[t < kBackWarps ? t : 0];
      best = r.x;
      lag = t < kBackWarps ? __float_as_int(r.y) : -1;
      meet();
      if (t == 0) a.out[row] = __ldg(a.log_fre + lag);
    }
  }
}

// ----------------------------------------------------------------- launch

// The blocks of `kernel` (threads, smem) the current card holds at once,
// asked once a (kernel, card) and remembered.
template <typename K>
cudaError_t resident_blocks(K kernel, int threads, int smem, int* out) {
  struct Seen {
    const void* kernel;
    int dev, smem, resident;
  };
  static Seen seen[16];
  static int n_seen = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const void* key = reinterpret_cast<const void*>(kernel);
  for (int i = 0; i < n_seen; ++i) {
    if (seen[i].kernel == key && seen[i].dev == dev && seen[i].smem == smem) {
      *out = seen[i].resident;
      return cudaSuccess;
    }
  }
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemMax);
  if (e != cudaSuccess) return e;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  *out = sms * per_sm;
  if (n_seen < 16) seen[n_seen++] = Seen{key, dev, smem, *out};
  return cudaSuccess;
}

unsigned grid_for(long long rows, int resident) {
  return static_cast<unsigned>(rows < resident ? rows : resident);
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

// x: (batch, samples) fp32 recordings; frame f of a recording at f * slide,
// `frames` of them (the frames that fit), N = 2^(log2n - 1) = 4096 samples
// each (log2n = 13, the transform's n = 2 N).  window: N floats, 8-byte
// aligned.  pos, w, bw: (grid,) the log grid's linear bins, weights and
// band widths, every pos in [b0, b1 - 1], 0 <= b0 < b1 <= N.  tw: the
// kernel table of n (n float2 exp(-2 pi i k / n), then the pass-1 factors
// of N points).  out: (batch * frames, grid).  Returns the CUDA error code
// of the launch (0 on success).
extern "C" int af_pef_log_power(const float* x, const float* window,
                                const int* pos, const float* w,
                                const float* bw, float* out, const void* tw,
                                long long batch, long long samples, int frames,
                                int slide, int grid, int b0, int b1, int log2n,
                                void* stream) {
  using R = afx::RealRoute<1>;
  constexpr int N = R::kN;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (log2n != 13 || batch <= 0 || frames <= 0 || slide <= 0 || grid <= 0 ||
      b0 < 0 || b1 <= b0 || b1 > N || !aligned(window, 8) ||
      static_cast<long long>(frames - 1) * slide + N > samples) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LogPowerArgs a{x,     window, pos,   w,    bw, out,
                       batch * frames, samples, frames, slide, grid, b0, b1,
                       aligned(x, 8) && samples % 2 == 0 && slide % 2 == 0};
  // the transpose buffer, then the kept bins' power
  const int smem = 8 * R::kBuf + 4 * ((b1 - b0 + 1 + 3) & ~3);
  int resident = 0;
  cudaError_t e =
      resident_blocks(pef_log_power_kernel, R::kB, smem, &resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  pef_log_power_kernel<<<grid_for(a.rows, resident), R::kB, smem, st>>>(
      a, static_cast<const float2*>(tw));
  return static_cast<int>(cudaGetLastError());
}

// lp: (rows, grid) fp32, 16-byte aligned, each row the live samples [pad,
// pad + grid) of an n-point zero row (log2n = 15, n = 32768), grid <= 8192
// and a multiple of 4, pad + grid <= 12288; hi_lag - lo_lag < n / 2.  ff: (n / 2 + 1,
// 2) fp32, conj of the filter's spectrum as (re, im).  log_fre: the grid's
// frequencies, at least hi_lag + 1 of them.  tw: the kernel table of n.
// out: (rows,), log_fre at the first lag of the largest cross-correlation
// value in [lo_lag, hi_lag].  Returns the CUDA error code of the launch (0
// on success).
extern "C" int af_pef_xcorr_pitch(const float* lp, const float* ff,
                                  const float* log_fre, float* out,
                                  const void* tw, long long rows, int grid,
                                  int pad, int lo_lag, int hi_lag, int log2n,
                                  void* stream) {
  using R = afx::RealRoute<4>;
  constexpr int n = 2 * R::kN;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const XcorrArgs a{lp, ff, log_fre, out, rows, grid, pad, lo_lag, hi_lag};
  const int smem = back_smem(grid);
  if (log2n != 15 || rows <= 0 || rows > INT32_MAX || grid <= 0 ||
      grid % 4 != 0 || !aligned(lp, 16) || pad < 0 ||
      pad + grid > 2 * R::kB * kBackLive || lo_lag < 0 || lo_lag > hi_lag ||
      hi_lag >= n || hi_lag - lo_lag >= R::kN || smem > kSmemMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int resident = 0;
  cudaError_t e =
      resident_blocks(pef_xcorr_pitch_kernel, R::kB, smem, &resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  pef_xcorr_pitch_kernel<<<grid_for(rows, resident), R::kB, smem, st>>>(
      a, static_cast<const float2*>(tw));
  return static_cast<int>(cudaGetLastError());
}
