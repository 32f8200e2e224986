// The CWT/PWT filterbank convolution in the frequency domain, fp32:
//   out[b, j, m] = ifft(bank[j] * F[b])[pad + m],  0 <= m < length,
// 1/N included, times i when `det` (the derivative bank).  F is the (B, N)
// complex spectrum of the padded signal, bank the (num, N) real wavelet
// bank, N a power of two in [2^14, 2^17].
//
// Replaces the TPU kernel audioflux_tpu/ops/pallas_cwt.py:cwt_ifft_bank.
// That kernel contracts dense DFT matrices on the matrix unit; this one is
// a four-step FFT, and shares nothing with it but the contract.
//
// What bounds it on the card: a band-row reads little (its share of F and
// the nonzero part of its bank row) and writes 8 * length bytes, against
// 5 N log2 N flops: device memory is the bound, and the work must not add
// traffic of its own.  A band-row's N complex points (512 KB at N = 65536)
// do not fit one block's shared memory, but they fit the shared memory of a
// thread block cluster: C blocks on neighbouring SMs that read each other's
// shared memory (distributed shared memory).  So one launch does the whole
// transform and the intermediate never reaches device memory:
//   * N = n1 * n2 (n1 = 2^ceil(log2 N / 2)), input index k = t1 * n2 + t2.
//     Block c of the cluster owns the columns t2 in [c n2/C, (c+1) n2/C):
//     it loads bank * conj(F) there, a warp 256 neighbouring bytes of F
//     at a time (the product never exists in device memory), straight into
//     the registers of the first radix-16 pass, and runs the length-n1
//     transforms over t1 in its shared memory (pass 1).
//   * cluster.sync().  Block d then takes the rows k1 in [d n1/C,
//     (d+1) n1/C): each thread reads the 16 points of its item of pass 2's
//     first radix-16 pass straight from the owners' shared memory into
//     registers, 1/C of them its own, and multiplies by the four-step
//     twiddles W_N^(t2 k1).  A second cluster barrier, so that nobody
//     overwrites what a peer still reads (the 16-point DFTs run between
//     its arrive and its wait); then the points go to the block's own
//     shared memory in row layout.
//   * Pass 2: the other passes of the length-n2 transforms over t2.  Bin k2
//     of row k1 is sample
//     n = k1 + n1 * k2 of conj(ifft) * N; only pad <= n < pad + length is
//     stored, conjugated, scaled by the exact power of two 1/N and rotated
//     by i when det; a warp stores 32 neighbouring samples (256 bytes), at
//     n2 = 256 straight from the registers of the last radix-16 pass.
//   * No twiddle is gathered from the table of N entries while the
//     band-rows run.  The four-step twiddle W_N^(t2 k1) of a thread's point
//     is the product of one value it keeps in a register and one of 16 *
//     nrow values in shared memory (see cwt_cluster_kernel); the passes'
//     own twiddles (at most 15 a thread and pass, the same for every
//     sequence) stand in shared memory too, in the order the lanes read
//     them.  Both are loaded once a block from the float64-built table.
//     With the table of N entries a warp's 16 distinct pass twiddles lay
//     in 16 cache lines, and that gather was two thirds of a pass's time
//     (16.5 ms a call against 8.4 ms, NVIDIA H100 80GB HBM3, 700 W).
//   * A block of 8192 points (512 threads) needs 64 registers a thread and
//     78 KB, so two blocks share an SM and one band-row's barriers and
//     cluster syncs hide behind another's arithmetic.  N = 2^17 needs
//     blocks of 16384 points (1024 threads, one an SM) to stay within the
//     portable cluster size 8.
//   * Persistent clusters: the grid is as many clusters as the card holds
//     at once; cluster g takes the band-rows g, g + G, g + 2G, ...  The
//     transforms cost the same for every band (only the load depends on its
//     support rows), so the rows are interleaved, not handed out by a
//     counter; neighbouring clusters work on the bands of one clip at the
//     same time, which keeps that clip's F (8 N bytes) in the L2 cache.
//
// Support slicing: the banks are analytic, a band's nonzero bins are a
// leading run, so only the first rows_h[j] rows t1 of the (n1, n2) view
// hold a nonzero.  Pass 1 loads those rows only and takes the rest as the
// exact zeros they are; the result is the same value for value.
//
// The inverse is the forward transform between two conjugations,
// ifft(z) = conj(fft(conj(z))) / N, so the passes' arithmetic (Stockham,
// radix 16, dft_reg of fft_smem.cuh) and the float64-built twiddle table
// exp(-2 pi i k / N) are those of fft_pow2.cu.

#include <cooperative_groups.h>

#include <cstdint>

#include "fft_smem.cuh"

namespace cg = cooperative_groups;

using afx::cmul;
using afx::dft_reg;
using afx::pad;

namespace {

constexpr int kPts = 16;  // points a thread holds in a pass

// Sequence q of a transform of length L starts at float2 index q *
// row_stride(L), element e at pad(e) = e + e/16 within it.  The stride is
// odd, so that the same element of neighbouring sequences (the strided
// side of the load, the exchange and the store) falls on distinct banks.
__host__ __device__ constexpr int row_stride(int L) { return L + (L >> 4) + 1; }

// The number of twiddles that the passes after the first of a length-2^log2L
// transform read: radix 16 while it fits, then one pass of radix 2, 4 or 8,
// R << log2Ns values for a pass of radix R behind Ns points.
__host__ __device__ constexpr int pass_table_len(int log2L) {
  int len = 0;
  for (int log2Ns = 4; log2Ns < log2L;) {
    const int lr = log2L - log2Ns < 4 ? log2L - log2Ns : 4;
    len += 1 << (lr + log2Ns);
    log2Ns += lr;
  }
  return len;
}

// Fill those twiddles: for the pass behind Ns points, t[(r << log2Ns) + k]
// = exp(-2 pi i k r / (Ns R)), from the float64-built table of N entries
// (the values fft_smem.cuh's passes gather from it).
__device__ void build_pass_tables(float2* t, int log2L,
                                  const float2* __restrict__ tw, int log2n) {
  for (int log2Ns = 4; log2Ns < log2L;) {
    const int lr = log2L - log2Ns < 4 ? log2L - log2Ns : 4;
    const int cnt = 1 << (lr + log2Ns);
    for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
      const int r = e >> log2Ns, k = e & ((1 << log2Ns) - 1);
      t[e] = __ldg(&tw[(k * r) << (log2n - log2Ns - lr)]);
    }
    t += cnt;
    log2Ns += lr;
  }
}

// One in-place Stockham pass of radix R over all sequences, as
// fft_smem.cuh's, but with the pass's twiddles in shared memory: the
// table of N entries spreads a warp's 16 distinct twiddles over 16 cache
// lines, and that gather, 15 a thread and pass, was most of a pass's time.
// A thread's k = tid % Ns never changes, so its reads of t are 16
// neighbouring values, the two half-warps the same ones: no bank conflict.
template <int R>
__device__ __forceinline__ void cwt_pass(float2* z, int log2L, int log2Ns,
                                         const float2* t) {
  constexpr int kIt = 16 / R;
  constexpr int kLog2R = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : 4;
  const int log2per = log2L - kLog2R;  // work items per sequence: L / R
  const int per = 1 << log2per;
  const int stride = row_stride(1 << log2L);
  const int ns = 1 << log2Ns;
  constexpr int kRev16[16] = {0, 8, 4, 12, 2, 10, 6, 14,
                              1, 9, 5, 13, 3, 11, 7, 15};  // 4-bit reversal
  float2 v[16];
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int item = threadIdx.x + it * blockDim.x;
    const int q = item >> log2per, j = item & (per - 1);
    const int k = j & (ns - 1);
    const float2* zq = z + q * stride;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float2 a = zq[pad(j + (r << log2per))];
      if (r > 0 && log2Ns > 0) a = cmul(a, t[(r << log2Ns) + k]);
      v[it * R + (kRev16[r] >> (4 - kLog2R))] = a;
    }
    dft_reg<R>(v + it * R);
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int item = threadIdx.x + it * blockDim.x;
    const int q = item >> log2per, j = item & (per - 1);
    const int k = j & (ns - 1);
    const int dst = ((j - k) << kLog2R) + k;
    float2* zq = z + q * stride;
#pragma unroll
    for (int r = 0; r < R; ++r) zq[pad(dst + (r << log2Ns))] = v[it * R + r];
  }
  __syncthreads();
}

// The passes after the first of the transform of every sequence
// (blockDim.x * 16 points); t from build_pass_tables.  The first pass (radix
// 16, no twiddle) is the caller's: it takes its inputs from elsewhere than
// z (device memory, the peers' tiles), runs dft_reg<16> and writes point r
// of item j of sequence q to z[q * row_stride + pad(16 j + r)].  The caller
// synchronises first; the block is synchronised on return.
__device__ __forceinline__ void cwt_fft_tail(float2* z, int log2L,
                                             const float2* t) {
  int log2Ns = 4;
  for (; log2Ns + 4 <= log2L; log2Ns += 4) {
    cwt_pass<16>(z, log2L, log2Ns, t);
    t += 16 << log2Ns;
  }
  switch (log2L - log2Ns) {
    case 1: cwt_pass<2>(z, log2L, log2Ns, t); break;
    case 2: cwt_pass<4>(z, log2L, log2Ns, t); break;
    case 3: cwt_pass<8>(z, log2L, log2Ns, t); break;
    default: break;
  }
}

// A float2 at `local` (an address in this block's shared memory) of block
// `rank` of the cluster: distributed shared memory, by its own 32-bit
// address space, which costs fewer registers than a generic pointer.
__device__ __forceinline__ float2 ld_cluster(const float2* local,
                                             unsigned rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(local));
  unsigned r;
  float2 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y) : "r"(r) : "memory");
  return v;
}

// One cluster per band-row at a time.  blockDim.x = N / C / 16; gridDim.x =
// C * (number of clusters).  Each of the two transforms takes its first
// radix-16 pass's inputs straight from where they are, device memory or the
// peers' tiles, so the points are not laid down in shared memory first:
// thread (q, j) of pass 1 holds rows t1 = j + r n1/16 of column q, thread
// (q, j) of pass 2 columns t2 = j + r n2/16 of row k1 = r0 + q, q the
// fastest index over the lanes, so that a warp reads neighbouring addresses.
// The four-step twiddle of such a point is W_N^(k1 t2) = W_N^(k1 j), a
// register of the thread, times W_N^(k1 r n2/16), 16 * nrow table values in
// shared memory.  That is one more rounding (6e-8) than the table's own
// W_N^(k1 t2), for 60 KB less shared memory and no gather.  `stages` cuts
// the kernel to time its phases apart: 1 load and store only, 2 adds pass
// 1, 3 the exchange, 4 (the whole kernel) pass 2.
//
// The shape is the template's, so that every index of the exchange and the
// store is a base and a constant: with run-time shifts the compiler kept
// the 16 addresses beside the 16 points and spilled 180 bytes a thread
// (132 with constant shifts, none since the first passes take their inputs
// in registers), and a call took 8.2 ms where it now takes 5.1 (NVIDIA H100
// 80GB HBM3, 700 W).
template <int log2n1, int log2n2, int log2c>
__global__ void __launch_bounds__(
    (1 << (log2n1 + log2n2 - log2c)) / kPts,
    (1 << (log2n1 + log2n2 - log2c)) / kPts == 512 ? 2 : 1)
cwt_cluster_kernel(const float2* __restrict__ F, const float* __restrict__ bank,
                   const int* __restrict__ rows_h, float2* __restrict__ out,
                   const float2* __restrict__ tw, int num, long long total,
                   int pad_n, int length, int det, int stages) {
  extern __shared__ float2 z[];
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int log2n = log2n1 + log2n2;
  constexpr int n = 1 << log2n;
  constexpr int n1 = 1 << log2n1;
  constexpr int n2 = 1 << log2n2;
  constexpr int log2ncol = log2n2 - log2c, log2nrow = log2n1 - log2c;
  constexpr int ncol = 1 << log2ncol, nrow = 1 << log2nrow;
  constexpr int stride1 = row_stride(n1), stride2 = row_stride(n2);
  constexpr int kThreads = n / (1 << log2c) / kPts;
  const int rank = static_cast<int>(cluster.block_rank());
  const int c0 = rank << log2ncol;  // first column t2 of pass 1
  const int r0 = rank << log2nrow;  // first row k1 of pass 2
  const int tid = threadIdx.x;
  constexpr int nthr = kThreads;
  const long long n_clusters = gridDim.x >> log2c;
  const float scale = 1.f / static_cast<float>(n);

  constexpr int per1 = n1 / kPts, per2 = n2 / kPts;  // items a sequence
  static_assert(ncol * per1 == kThreads && nrow * per2 == kThreads,
                "a thread holds one item of 16 points in either pass");
  constexpr int kRev16[16] = {0, 8, 4, 12, 2, 10, 6, 14,
                              1, 9, 5, 13, 3, 11, 7, 15};  // 4-bit reversal
  float2* tws = z + (ncol * stride1 > nrow * stride2 ? ncol * stride1
                                                     : nrow * stride2);
  float2* pass1_tw = tws + kPts * nrow;
  float2* pass2_tw = pass1_tw + pass_table_len(log2n1);
  const int q1 = tid & (ncol - 1), j1 = tid >> log2ncol;  // pass 1's item
  const int q2 = tid & (nrow - 1), j2 = tid >> log2nrow;  // pass 2's item
  const int k1x = r0 + q2;
  const float2 tw_a = __ldg(&tw[(k1x * j2) & (n - 1)]);
  // tws[r * nrow + q] = W_N^((r0 + q) r n2/16)
  for (int e = tid; e < kPts * nrow; e += nthr) {
    const int k1 = r0 + (e & (nrow - 1)), r = e >> log2nrow;
    tws[e] = __ldg(&tw[(k1 * per2 * r) & (n - 1)]);
  }
  build_pass_tables(pass1_tw, log2n1, tw, log2n);
  build_pass_tables(pass2_tw, log2n2, tw, log2n);
  __syncthreads();

  for (long long r = blockIdx.x >> log2c; r < total; r += n_clusters) {
    const int j = static_cast<int>(r % num);
    const float2* Fb = F + ((r / num) << log2n) + c0 + q1;
    const float* bk = bank + (static_cast<size_t>(j) << log2n) + c0 + q1;
    const int h = rows_h ? min(rows_h[j], n1) : n1;

    // ---- pass 1, first radix: bank * conj(F) at column q1, rows t1 < h --
    // (the last reads of z, the previous band-row's store, are behind the
    // __syncthreads that ends this loop's body)
    {
      float2 v[kPts];
      if (j1 < h) {  // else all 16 rows are zero rows, and so is their DFT
#pragma unroll
        for (int i = 0; i < kPts; ++i) {
          const int t1 = j1 + i * per1;
          float2 a = make_float2(0.f, 0.f);
          if (t1 < h) {
            const float2 f = __ldg(&Fb[t1 << log2n2]);
            const float w = __ldg(&bk[t1 << log2n2]);
            a = make_float2(w * f.x, -(w * f.y));
          }
          v[kRev16[i]] = a;
        }
        if (stages >= 2) dft_reg<kPts>(v);
      } else {
#pragma unroll
        for (int i = 0; i < kPts; ++i) v[i] = make_float2(0.f, 0.f);
      }
      float2* zq = z + q1 * stride1;
#pragma unroll
      for (int i = 0; i < kPts; ++i) zq[pad((j1 << 4) + i)] = v[i];
    }
    __syncthreads();

    // ---- pass 1, the other passes: length-n1 transforms over t1 ---------
    if (stages >= 2) cwt_fft_tail(z, log2n1, pass1_tw);

    if (stages >= 3) {
      cluster.sync();
      // ---- exchange and pass 2, first radix: row k1x from every owner ---
      float2 v[kPts];
#pragma unroll
      for (int i = 0; i < kPts; ++i) {
        const int t2 = j2 + i * per2;
        v[kRev16[i]] = ld_cluster(
            &z[(t2 & (ncol - 1)) * stride1 + pad(k1x)], t2 >> log2ncol);
      }
      // the peers may overwrite what was read; the arithmetic fills the wait
      cluster.barrier_arrive();
#pragma unroll
      for (int i = 0; i < kPts; ++i) {
        v[kRev16[i]] = cmul(v[kRev16[i]], cmul(tw_a, tws[(i << log2nrow) + q2]));
      }
      if (stages >= 4) dft_reg<kPts>(v);
      cluster.barrier_wait();
      float2* zq = z + q2 * stride2;
#pragma unroll
      for (int i = 0; i < kPts; ++i) zq[pad((j2 << 4) + i)] = v[i];
      __syncthreads();
    }

    float2* o = out + static_cast<size_t>(r) * length;
    // sample n = k1 + n1 * k2 of conj(ifft) * N from bin k2 of row k1
    auto store = [&](int m, float2 a) {
      if (m < 0 || m >= length) return;
      const float2 ra = make_float2(scale * a.x, -scale * a.y);
      o[m] = det ? make_float2(-ra.y, ra.x) : ra;
    };
    if constexpr (log2n2 == 8) {
      // ---- pass 2, its second and last radix-16 pass, and the store -----
      // item (q2, j2) ends with the bins k2 = j2 + 16 i of row k1x: they go
      // straight to device memory, a warp's 32 rows as 256 neighbouring
      // bytes, and not through z once more
      float2 v[kPts];
      const float2* zq = z + q2 * stride2;
#pragma unroll
      for (int i = 0; i < kPts; ++i) {
        float2 a = zq[pad(j2 + (i << 4))];
        if (i > 0 && stages >= 4) a = cmul(a, pass2_tw[(i << 4) + j2]);
        v[kRev16[i]] = a;
      }
      if (stages >= 4) dft_reg<kPts>(v);
#pragma unroll
      for (int i = 0; i < kPts; ++i) {
        store(k1x + ((j2 + (i << 4)) << log2n1) - pad_n, v[i]);
      }
    } else {
      // ---- pass 2, the other passes: length-n2 transforms over t2 -------
      if (stages >= 4) cwt_fft_tail(z, log2n2, pass2_tw);
      // ---- store: a warp takes neighbouring rows k1 of one bin k2 -------
      for (int idx = tid; idx < nrow * n2; idx += nthr) {
        const int rl = idx & (nrow - 1), k2 = idx >> log2nrow;
        store(r0 + rl + (k2 << log2n1) - pad_n, z[rl * stride2 + pad(k2)]);
      }
    }
    __syncthreads();
  }
}

struct Shape {
  int log2n1, threads;
  size_t smem;
};

// The launch shape of N = 2^log2n over clusters of 2^log2c blocks, or
// threads = 0 when the kernel does not take it.
Shape shape_of(int log2n, int log2c) {
  Shape s{(log2n + 1) / 2, 0, 0};
  const int log2n2 = log2n - s.log2n1;
  if (log2c < 0 || log2c > 3 || log2c > log2n2 - 1) return s;
  const int pts = 1 << (log2n - log2c);
  if (pts != 8192 && pts != 16384) return s;
  const int nrow = 1 << (s.log2n1 - log2c);
  const size_t a = static_cast<size_t>(row_stride(1 << s.log2n1))
                   << (log2n2 - log2c);
  const size_t b = static_cast<size_t>(row_stride(1 << log2n2))
                   << (s.log2n1 - log2c);
  s.smem = sizeof(float2) * ((a > b ? a : b) + kPts * nrow +
                             pass_table_len(s.log2n1) + pass_table_len(log2n2));
  s.threads = pts / kPts;
  return s;
}

// The kernel of N = 2^log2n over clusters of 2^log2c blocks.
const void* kernel_of(int log2n, int log2c) {
  switch (log2n * 4 + log2c) {
    case 14 * 4 + 0: return reinterpret_cast<const void*>(cwt_cluster_kernel<7, 7, 0>);
    case 14 * 4 + 1: return reinterpret_cast<const void*>(cwt_cluster_kernel<7, 7, 1>);
    case 15 * 4 + 1: return reinterpret_cast<const void*>(cwt_cluster_kernel<8, 7, 1>);
    case 15 * 4 + 2: return reinterpret_cast<const void*>(cwt_cluster_kernel<8, 7, 2>);
    case 16 * 4 + 2: return reinterpret_cast<const void*>(cwt_cluster_kernel<8, 8, 2>);
    case 16 * 4 + 3: return reinterpret_cast<const void*>(cwt_cluster_kernel<8, 8, 3>);
    case 17 * 4 + 3: return reinterpret_cast<const void*>(cwt_cluster_kernel<9, 8, 3>);
    default: return nullptr;
  }
}

cudaError_t configure(int log2n, int log2c, cudaStream_t st,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                      const void** fn) {
  const Shape s = shape_of(log2n, log2c);
  *fn = s.threads ? kernel_of(log2n, log2c) : nullptr;
  if (*fn == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      *fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(s.smem));
  if (e != cudaSuccess) return e;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1u << log2c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(1u << log2c);
  cfg->blockDim = dim3(s.threads);
  cfg->dynamicSmemBytes = s.smem;
  cfg->stream = st;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// The number of clusters of 2^log2c blocks that the card holds at once for
// N = 2^log2n (0: it cannot hold one), or minus the CUDA error code.
extern "C" int af_cwt_max_clusters(int log2n, int log2c) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const void* fn;
  cudaError_t e = configure(log2n, log2c, nullptr, &cfg, &attr, &fn);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int n_clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&n_clusters, fn, &cfg);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return n_clusters;
}

// F: (batch, N) complex64.  bank: (num, N) fp32.  rows_h: num int32 leading
// row counts of the (n1, n2) view, or null for all n1.  out: (batch, num,
// length) complex64.  tw: N float2, exp(-2 pi i k / N).  Clusters of
// 2^log2c blocks, `n_clusters` of them (at most what af_cwt_max_clusters
// returns: more would still be right, but not resident together).  Returns
// the CUDA error code of the launch.
extern "C" int af_cwt_ifft_bank(const void* F, const float* bank,
                                const int* rows_h, void* out, const void* tw,
                                long long batch, int num, int log2n,
                                int pad_n, int length, int det, int log2c,
                                int n_clusters, int stages,
                                void* stream) {
  const long long total = batch * num;
  if (total <= 0 || length <= 0) return 0;
  if (log2n < 14 || log2n > 17 || pad_n < 0 || n_clusters < 1 || stages < 1 ||
      stages > 4 ||
      static_cast<long long>(pad_n) + length > (1LL << log2n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const void* fn;
  cudaError_t e = configure(log2n, log2c, static_cast<cudaStream_t>(stream),
                            &cfg, &attr, &fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_clusters > total) n_clusters = static_cast<int>(total);
  cfg.gridDim = dim3(static_cast<unsigned>(n_clusters) << log2c);
  const float2* Fp = static_cast<const float2*>(F);
  float2* op = static_cast<float2*>(out);
  const float2* twp = static_cast<const float2*>(tw);
  void* args[] = {&Fp, &bank, &rows_h, &op, &twp, &num,
                  const_cast<long long*>(&total), &pad_n, &length, &det,
                  &stages};
  e = cudaLaunchKernelExC(&cfg, fn, args);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
