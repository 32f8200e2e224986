// Exact sliding median along one axis of a contiguous fp32 tensor, odd
// order, order/2 zeros of padding per side.
//
// Replaces the TPU kernel
// audioflux_tpu/ops/pallas_median.py:median_filter_last_axis.  What carries
// over is the idea, not the tiling: every output's window is held in
// registers and the median is selected by Batcher's odd-even merge sort of
// the window padded to a power of two with +inf, pruned backwards to the
// compare-exchanges that can reach the median wire (149 at order 21, 157 at
// order 31).  The network is computed at compile time and every wire index
// is a template argument, so the window never becomes an indexed array in
// local memory.  Orders without a template instance count ranks over the
// window in shared memory, which is exact for every odd order.  Both paths
// return the order/2-th order statistic itself, equal value for value to a
// full sort on finite input.
//
// What bounds it on the card: a cell is read once and written once (8
// bytes) but costs two min/max per compare-exchange (314 at order 31), so
// operations bind, not bytes.
//
// The tensor is seen as (outer, len, inner) with the filtered axis in the
// middle: inner = 1 filters the last axis; inner > 1 filters an inner axis
// in place of two transposes around the kernel.  A block stages a tile of
// (tl + order - 1) x ti cells in shared memory, ti fastest, so neighbouring
// threads read neighbouring addresses for either layout, in device memory
// and in shared memory alike.

#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

namespace {

constexpr int kMaxCe = 512;
constexpr int kThreads = 256;

struct Network {
  int pad_n;     // window padded to this power of two
  int count;     // compare-exchanges kept
  int a[kMaxCe];
  int b[kMaxCe];
};

// Batcher's odd-even merge sort over pad_n wires, pruned backwards from
// the median wire order / 2 (the +inf padding sorts to the top).
__host__ __device__ constexpr Network pruned_median_network(int order) {
  Network all{};
  int n = 1;
  while (n < order) n *= 2;
  all.pad_n = n;
  for (int p = 1; p < n; p *= 2) {
    for (int k = p; k >= 1; k /= 2) {
      for (int j = k % p; j < n - k; j += 2 * k) {
        const int lim = k < n - j - k ? k : n - j - k;
        for (int i = 0; i < lim; ++i) {
          if ((i + j) / (2 * p) == (i + j + k) / (2 * p)) {
            all.a[all.count] = i + j;
            all.b[all.count] = i + j + k;
            ++all.count;
          }
        }
      }
    }
  }
  bool needed[64] = {};
  bool keep[kMaxCe] = {};
  needed[order / 2] = true;
  for (int c = all.count - 1; c >= 0; --c) {
    if (needed[all.a[c]] || needed[all.b[c]]) {
      keep[c] = true;
      needed[all.a[c]] = true;
      needed[all.b[c]] = true;
    }
  }
  Network net{};
  net.pad_n = n;
  for (int c = 0; c < all.count; ++c) {
    if (keep[c]) {
      net.a[net.count] = all.a[c];
      net.b[net.count] = all.b[c];
      ++net.count;
    }
  }
  return net;
}

template <int ORDER>
struct Net {
  static constexpr Network value = pruned_median_network(ORDER);
  static constexpr int kPad = value.pad_n;
  static constexpr int kCount = value.count;
};

template <int A, int B>
__device__ __forceinline__ void compare_exchange(float* v) {
  const float lo = fminf(v[A], v[B]);
  const float hi = fmaxf(v[A], v[B]);
  v[A] = lo;
  v[B] = hi;
}

template <int ORDER, int... C>
__device__ __forceinline__ void run_network(float* v,
                                            std::integer_sequence<int, C...>) {
  (compare_exchange<Net<ORDER>::value.a[C], Net<ORDER>::value.b[C]>(v), ...);
}

// The median of the ORDER taps at s[0], s[step], ... by the pruned network.
template <int ORDER>
__device__ __forceinline__ float median_network(const float* s, int step) {
  float v[Net<ORDER>::kPad];
#pragma unroll
  for (int j = 0; j < Net<ORDER>::kPad; ++j) {
    v[j] = j < ORDER ? s[j * step] : __int_as_float(0x7f800000);
  }
  run_network<ORDER>(v, std::make_integer_sequence<int, Net<ORDER>::kCount>{});
  return v[ORDER / 2];
}

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

// ORDER > 0: the network instance; ORDER == 0: rank counting at `order`.
// grid.x = outer * tiles_l * tiles_i; blockDim.x = kThreads; dynamic
// shared memory (tl + order - 1) * ti floats.
template <int ORDER>
__global__ void __launch_bounds__(kThreads)
median_kernel(const float* __restrict__ x, float* __restrict__ y,
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
    const float* w = s + lt * ti + it;
    float m;
    if constexpr (ORDER > 0) {
      m = median_network<ORDER>(w, ti);
    } else {
      m = median_rank(w, ti, order);
    }
    yo[l * inner + i] = m;
  }
}

template <int ORDER>
int launch(const float* x, float* y, long long outer, long long len,
           long long inner, int order, int tl, int ti, cudaStream_t st) {
  const long long tiles_l = (len + tl - 1) / tl;
  const long long tiles_i = (inner + ti - 1) / ti;
  const long long blocks = outer * tiles_l * tiles_i;
  if (blocks > INT32_MAX || tiles_l > INT32_MAX || tiles_i > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * static_cast<size_t>(tl + order - 1) * ti;
  cudaError_t e = cudaFuncSetAttribute(
      median_kernel<ORDER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  median_kernel<ORDER><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      x, y, len, inner, order, tl, ti, static_cast<int>(tiles_l),
      static_cast<int>(tiles_i));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: contiguous (outer, len, inner) fp32; the median runs over `len`.
// order: odd, >= 3.  tl x ti: the block's tile of outputs along len and
// inner; (tl + order - 1) * ti floats must fit a block's shared memory.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int af_median_filter(const float* x, float* y, long long outer,
                                long long len, long long inner, int order,
                                int tl, int ti, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (outer <= 0 || len <= 0 || inner <= 0) return 0;
  if (order < 3 || order % 2 == 0 || tl < 1 || ti < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (order == 21) return launch<21>(x, y, outer, len, inner, order, tl, ti, st);
  if (order == 31) return launch<31>(x, y, outer, len, inner, order, tl, ti, st);
  return launch<0>(x, y, outer, len, inner, order, tl, ti, st);
}
