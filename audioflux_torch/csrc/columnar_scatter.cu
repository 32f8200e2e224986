// Per-column scatter-add of complex values, fp32 planes:
//   out[b, f, t] = sum over i, in ascending i, of v[b, i, t] where
//   fi[b, i, t] == f;  an index outside [0, out_size) drops its cell.
// The reassignment step of synchrosqueezing.
//
// Replaces the TPU kernel
// audioflux_tpu/ops/pallas_scatter.py:columnar_scatter_pallas (a compare of
// every input row against an iota of all output rows).  Here a cell goes
// straight to its bin.
//
// What bounds it on the card: 12 bytes read per input cell and 8 written
// per output cell against one complex add: device memory.  A thread owns
// one time column: it keeps the column's out_size complex sums in shared
// memory (word address 2 * (f * TPB + thread), so the threads of a warp
// hit distinct banks whatever their f), walks the input rows in order with
// the loads of eight rows in flight, and stores its sums.  Loads and stores
// are coalesced along t.  No thread touches another's sums, so there are
// no atomics and no barriers, the order of every sum is fixed, and the
// result equals the plain version's bit for bit.  The sums take
// 8 * out_size bytes per column, which sets the columns per block (64
// while two such blocks fit an SM's shared memory, out_size <= 221, else
// 32) and the largest out_size (512).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kUnroll = 8;

// grid: batch * tiles blocks, tiles = ceil(T / TPB); blockDim.x = TPB.
template <int TPB>
__global__ void __launch_bounds__(TPB)
columnar_scatter_kernel(const float2* __restrict__ v,
                        const int* __restrict__ fi, float2* __restrict__ out,
                        int R, int F, long long T, long long tiles) {
  extern __shared__ float2 acc[];  // [f][thread]
  const long long b = blockIdx.x / tiles;
  const long long t = (blockIdx.x % tiles) * TPB + threadIdx.x;
  if (t >= T) return;
  float2* mine = acc + threadIdx.x;
  for (int f = 0; f < F; ++f) mine[f * TPB] = make_float2(0.f, 0.f);
  const size_t in0 = static_cast<size_t>(b) * R * T + t;
  for (int i0 = 0; i0 < R; i0 += kUnroll) {
    int idx[kUnroll];
    float2 val[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      idx[u] = -1;
      val[u] = make_float2(0.f, 0.f);
      if (i0 + u < R) {
        const size_t g = in0 + static_cast<size_t>(i0 + u) * T;
        idx[u] = fi[g];
        val[u] = v[g];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (static_cast<unsigned>(idx[u]) < static_cast<unsigned>(F)) {
        float2* a = mine + idx[u] * TPB;
        *a = make_float2(a->x + val[u].x, a->y + val[u].y);
      }
    }
  }
  const size_t out0 = static_cast<size_t>(b) * F * T + t;
  for (int f = 0; f < F; ++f) {
    out[out0 + static_cast<size_t>(f) * T] = mine[f * TPB];
  }
}

template <int TPB>
int launch(const void* v, const int* fi, void* out, long long batch, int R,
           int F, long long T, cudaStream_t st) {
  const int smem = static_cast<int>(sizeof(float2)) * F * TPB;
  cudaError_t e = cudaFuncSetAttribute(
      columnar_scatter_kernel<TPB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = (T + TPB - 1) / TPB;
  if (batch * tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  columnar_scatter_kernel<TPB>
      <<<static_cast<unsigned>(batch * tiles), TPB, smem, st>>>(
          static_cast<const float2*>(v), fi, static_cast<float2*>(out), R, F,
          T, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// v: (batch, R, T) complex64.  fi: (batch, R, T) int32.  out: (batch,
// out_size, T) complex64, every cell written.  Returns the CUDA error code.
extern "C" int af_columnar_scatter(const void* v, const int* fi, void* out,
                                   long long batch, int R, int out_size,
                                   long long T, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || T <= 0 || out_size <= 0) return 0;
  if (R < 0 || out_size > 512) return static_cast<int>(cudaErrorInvalidValue);
  if (out_size <= 221) return launch<64>(v, fi, out, batch, R, out_size, T, st);
  return launch<32>(v, fi, out, batch, R, out_size, T, st);
}
