// Exact sliding median along one axis of a contiguous fp32 tensor, odd
// order, order/2 zeros of padding per side.
//
// Replaces the TPU kernel
// audioflux_tpu/ops/pallas_median.py:median_filter_last_axis.  What carries
// over is the idea, not the tiling: the taps are held in registers and the
// median is selected by a network of fminf/fmaxf.
//
// What bounds it on the card: a cell is read once and written once (8
// bytes), and a network that selects each window's median on its own costs
// hundreds of min/max a cell (Batcher's merge sort pruned to the median
// wire: 149 compare-exchanges at order 21, 157 at order 31, two min/max
// each), which the card issues at half its FMA rate: the instructions
// bound, not the bytes.  So the design cuts instructions.
//
// A thread owns a run of M consecutive outputs at one inner position.
// Their windows share all but M - 1 of their taps, and one network, built
// by ops/median_network.py and included as the generated header
// median_networks.cuh, selects all M medians: the shared taps are sorted
// once, halves of the run merge in the taps they add, and every operation
// no median needs is pruned.  At M = afx::kMedianRun = 16 that is 23.25
// min/max an output at order 21 and 32.4 at order 31 (15.0 and 20.2
// compare-exchanges), against 298 and 314 (149 and 157 compare-exchanges)
// for one window a thread.  Every wire index is a constant of the
// generated code, so the taps never become an indexed array in local
// memory.  The outputs are taps themselves: equal value for value to a
// full sort.  Instances: orders 21 and 31 (HPSS's defaults); other orders
// count ranks over the window in shared memory, which is exact for every
// odd order and on no main path.
//
// Layouts.  The tensor is seen as (outer, len, inner), the median running
// over len.  inner > 1 (HPSS's time axis, inner = 1025): a block is 32
// inner cells x 8 runs; a thread reads its ORDER + M - 1 taps straight from
// device memory, a warp's reads are 128 neighbouring bytes, and the 8 runs
// of a block share their taps in L1.  inner == 1 (the last axis): a block
// takes 256 consecutive runs of the flattened rows, stages the rows'
// segments (zero halos included) in shared memory with a gap between rows
// (cp.async, so that every copy is in flight at once), reads its taps as
// 16-byte words, and writes its outputs back through
// shared memory so that the stores are coalesced.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "median_networks.cuh"

namespace {

constexpr int kThreads = 256;

// The median of `order` taps by rank counting: the tap with at most
// order / 2 taps below it and more than order / 2 taps below or equal.
__device__ __forceinline__ float median_rank(const float* s, int step,
                                             int order) {
  const int half = order / 2;
  for (int j = 0; j < order; ++j) {
    const float c = s[j * step];
    int less = 0, equal = 0;
    for (int k = 0; k < order; ++k) {
      const float t = s[k * step];
      less += t < c;
      equal += t == c;
    }
    if (less <= half && half < less + equal) return c;
  }
  return s[half * step];  // unreachable on input without NaN
}

// Rank counting for the orders without a network.  grid.x = outer *
// tiles_l * tiles_i; dynamic shared memory (tl + order - 1) * ti floats.
__global__ void __launch_bounds__(kThreads)
median_rank_kernel(const float* __restrict__ x, float* __restrict__ y,
                   long long len, long long inner, int order, int tl, int ti,
                   int tiles_l, int tiles_i) {
  extern __shared__ float s[];
  const int half = order / 2;
  long long b = blockIdx.x;
  const int bi = static_cast<int>(b % tiles_i);
  b /= tiles_i;
  const int bl = static_cast<int>(b % tiles_l);
  const long long o = b / tiles_l;
  const long long l0 = static_cast<long long>(bl) * tl;
  const long long i0 = static_cast<long long>(bi) * ti;
  const float* xo = x + o * len * inner;
  float* yo = y + o * len * inner;

  const int span = tl + order - 1;
  for (int idx = threadIdx.x; idx < span * ti; idx += blockDim.x) {
    const int lt = idx / ti, it = idx % ti;
    const long long l = l0 - half + lt, i = i0 + it;
    s[idx] = (l >= 0 && l < len && i < inner) ? xo[l * inner + i] : 0.f;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < tl * ti; idx += blockDim.x) {
    const int lt = idx / ti, it = idx % ti;
    const long long l = l0 + lt, i = i0 + it;
    if (l >= len || i >= inner) continue;
    yo[l * inner + i] = median_rank(s + lt * ti + it, ti, order);
  }
}

// The M medians of taps t (stages == 2), or (stages == 1, timing only) the
// centre taps: the kernel cut after its loads and stores.
template <int ORDER, int M>
__device__ __forceinline__ void select_medians(
    const float (&t)[ORDER + M - 1], float (&v)[M], int stages) {
  if (stages == 1) {
#pragma unroll
    for (int k = 0; k < M; ++k) v[k] = t[ORDER / 2 + k];
  } else {
    afx::MedianRun<ORDER, M>::run(t, v);
  }
}

// inner > 1.  blockDim = (32, 8): threadIdx.x an inner cell, threadIdx.y a
// run.  grid.x = outer * tiles_r * tiles_i.
template <int ORDER, int M>
__global__ void __launch_bounds__(kThreads)
median_run_strided(const float* __restrict__ x, float* __restrict__ y,
                   long long len, long long inner, long long runs,
                   int tiles_r, int tiles_i, int stages) {
  constexpr int H = ORDER / 2;
  constexpr int NT = ORDER + M - 1;
  long long b = blockIdx.x;
  const int bi = static_cast<int>(b % tiles_i);
  b /= tiles_i;
  const long long br = b % tiles_r;
  const long long o = b / tiles_r;
  const long long i = static_cast<long long>(bi) * 32 + threadIdx.x;
  const long long r = br * 8 + threadIdx.y;
  if (i >= inner || r >= runs) return;
  const long long l0 = r * M;
  const float* xo = x + o * len * inner + i;
  float t[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const long long l = l0 - H + j;
    t[j] = (l >= 0 && l < len) ? __ldg(xo + l * inner) : 0.f;
  }
  float v[M];
  select_medians<ORDER, M>(t, v, stages);
  float* yo = y + o * len * inner + i;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    if (l0 + k < len) yo[(l0 + k) * inner] = v[k];
  }
}

// Shared-memory floats between the staged segments of two rows: at least
// the two halos, a multiple of 4 so that every run starts 16-byte aligned.
template <int ORDER>
__host__ __device__ constexpr int row_gap() {
  return (2 * (ORDER / 2) + 3) & ~3;
}

// inner == 1.  The rows are `rpr` runs each; block b takes runs q0 = 256 b
// .. q0 + 255 of the flattened (row, run) order.  Row rho's sample l sits
// at s[(rho * rpr - q0) * M + (rho - rho0) * G + H + l], so run q's taps
// start at s[(q - q0) * M + (rho - rho0) * G].
template <int ORDER, int M>
__global__ void __launch_bounds__(kThreads)
median_run_rows(const float* __restrict__ x, float* __restrict__ y,
                long long len, long long rpr, long long total_runs,
                int stages) {
  static_assert(M % 4 == 0, "runs start on 16-byte words");
  constexpr int H = ORDER / 2;
  constexpr int NT = ORDER + M - 1;
  constexpr int NT4 = (NT + 3) / 4;
  constexpr int G = row_gap<ORDER>();
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const long long q0 = static_cast<long long>(blockIdx.x) * kThreads;
  const long long q1 =
      q0 + kThreads < total_runs ? q0 + kThreads : total_runs;
  const long long rho0 = q0 / rpr, rho1 = (q1 - 1) / rpr;
  const long long ra0 = q0 - rho0 * rpr, rb1 = q1 - rho1 * rpr;

  // the copies go out asynchronously, all at once: a load-then-store
  // loop would wait out the memory's latency once an iteration
  for (long long rho = rho0; rho <= rho1; ++rho) {
    const long long ra = rho == rho0 ? ra0 : 0;
    const long long rb = rho == rho1 ? rb1 : rpr;
    const long long base = (rho * rpr - q0) * M + (rho - rho0) * G + H;
    const float* xr = x + rho * len;
    for (long long l = ra * M - H + tid; l < rb * M + H; l += kThreads) {
      if (l >= 0 && l < len) {
        __pipeline_memcpy_async(s + base + l, xr + l, 4);
      } else {
        s[base + l] = 0.f;
      }
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const long long q = q0 + tid;
  float v[M];
  if (q < q1) {
    const long long rho = q / rpr;
    const float4* w4 = reinterpret_cast<const float4*>(
        s + (q - q0) * M + (rho - rho0) * G);
    float t[NT];
#pragma unroll
    for (int j4 = 0; j4 < NT4; ++j4) {
      const float4 f = w4[j4];
      const float e[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (4 * j4 + c < NT) t[4 * j4 + c] = e[c];
      }
    }
    select_medians<ORDER, M>(t, v, stages);
  }
  __syncthreads();  // every thread has its taps: the outputs take their place
  if (q < q1) {
    float4* o4 = reinterpret_cast<float4*>(s + (q - q0) * M);
#pragma unroll
    for (int k = 0; k < M / 4; ++k) {
      o4[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    }
  }
  __syncthreads();
  for (long long rho = rho0; rho <= rho1; ++rho) {
    const long long ra = rho == rho0 ? ra0 : 0;
    const long long rb = rho == rho1 ? rb1 : rpr;
    const long long hi = rb * M < len ? rb * M : len;
    const long long base = (rho * rpr - q0) * M;
    float* yr = y + rho * len;
    for (long long l = ra * M + tid; l < hi; l += kThreads) {
      yr[l] = s[base + l];
    }
  }
}

int launch_rank(const float* x, float* y, long long outer, long long len,
                long long inner, int order, int tl, int ti, cudaStream_t st) {
  const long long tiles_l = (len + tl - 1) / tl;
  const long long tiles_i = (inner + ti - 1) / ti;
  const long long blocks = outer * tiles_l * tiles_i;
  if (blocks > INT32_MAX || tiles_l > INT32_MAX || tiles_i > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * static_cast<size_t>(tl + order - 1) * ti;
  cudaError_t e = cudaFuncSetAttribute(
      median_rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  median_rank_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      x, y, len, inner, order, tl, ti, static_cast<int>(tiles_l),
      static_cast<int>(tiles_i));
  return static_cast<int>(cudaGetLastError());
}

template <int ORDER, int M>
int launch_run(const float* x, float* y, long long outer, long long len,
               long long inner, int stages, cudaStream_t st) {
  const long long runs = (len + M - 1) / M;
  if (inner > 1) {
    const long long tiles_r = (runs + 7) / 8;
    const long long tiles_i = (inner + 31) / 32;
    const long long blocks = outer * tiles_r * tiles_i;
    if (blocks > INT32_MAX || tiles_r > INT32_MAX || tiles_i > INT32_MAX) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    median_run_strided<ORDER, M><<<static_cast<unsigned>(blocks),
                                   dim3(32, 8), 0, st>>>(
        x, y, len, inner, runs, static_cast<int>(tiles_r),
        static_cast<int>(tiles_i), stages);
    return static_cast<int>(cudaGetLastError());
  }
  const long long total = outer * runs;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // rows a block touches, at most; the last row's halo and the 16-byte
  // reads past a run's last tap fit in the final gap
  const long long rows_max = (kThreads + runs - 1) / runs + 1;
  const size_t smem = sizeof(float) *
      static_cast<size_t>(kThreads * M + rows_max * row_gap<ORDER>() + 8);
  auto kernel = median_run_rows<ORDER, M>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      x, y, len, runs, total, stages);
  return static_cast<int>(cudaGetLastError());
}

// The min/max issue rate: each thread runs `iters` rounds of a 19
// compare-exchange sorting network over 8 values (38 min/max), rotating the
// wires between rounds so that no round repeats the last one's pairs.
__global__ void __launch_bounds__(kThreads)
minmax_probe_kernel(float* __restrict__ data, int iters) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float a[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = data[i * 8 + k];
  constexpr int kPairs[19][2] = {{0, 1}, {2, 3}, {4, 5}, {6, 7}, {0, 2},
                                 {1, 3}, {4, 6}, {5, 7}, {1, 2}, {5, 6},
                                 {0, 4}, {1, 5}, {2, 6}, {3, 7}, {2, 4},
                                 {3, 5}, {1, 2}, {3, 4}, {5, 6}};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int p = 0; p < 19; ++p) {
      const float lo = fminf(a[kPairs[p][0]], a[kPairs[p][1]]);
      const float hi = fmaxf(a[kPairs[p][0]], a[kPairs[p][1]]);
      a[kPairs[p][0]] = lo;
      a[kPairs[p][1]] = hi;
    }
    float b[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) b[k] = a[(k + 3) & 7];
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] = b[k];
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) data[i * 8 + k] = a[k];
}

}  // namespace

// x, y: contiguous (outer, len, inner) fp32; the median runs over `len`.
// order: odd, >= 3.  stages: 2 (the whole kernel) or, where the order has
// a network (21, 31), 1 (loads and stores only, for timing).  Other orders
// count ranks over a tl x ti tile of outputs ((tl + order - 1) * ti floats
// must fit a block's shared memory).  Returns the CUDA error code of the
// launch (0 on success).
extern "C" int af_median_filter(const float* x, float* y, long long outer,
                                long long len, long long inner, int order,
                                int stages, int tl, int ti, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (outer <= 0 || len <= 0 || inner <= 0) return 0;
  if (order < 3 || order % 2 == 0 || tl < 1 || ti < 1 || stages < 1 ||
      stages > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int M = afx::kMedianRun;
  if (order == 21) {
    return launch_run<21, M>(x, y, outer, len, inner, stages, st);
  }
  if (order == 31) {
    return launch_run<31, M>(x, y, outer, len, inner, stages, st);
  }
  if (stages != 2) return static_cast<int>(cudaErrorInvalidValue);
  return launch_rank(x, y, outer, len, inner, order, tl, ti, st);
}

// Runs the min/max probe over data (threads * 8 floats, threads a multiple
// of 256): threads * iters * 38 min/max.  Returns the CUDA error code.
extern "C" int af_minmax_probe(float* data, long long threads, int iters,
                               void* stream) {
  if (threads <= 0 || threads % kThreads || iters < 1 ||
      threads / kThreads > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  minmax_probe_kernel<<<static_cast<unsigned>(threads / kThreads), kThreads,
                        0, static_cast<cudaStream_t>(stream)>>>(data, iters);
  return static_cast<int>(cudaGetLastError());
}
