// Three-direction DGSEM volume derivative for NVIDIA Hopper (sm_90a): the
// tiled instance, specialised on the node count n (2 <= n <= 8).
//
// Replaces `repro/kernels/dg_derivative.py:dg_derivative3` (a Pallas TPU
// kernel) and computes what its oracle `repro/kernels/ref.py:dg_derivative3`
// computes: for an element batch u (B, n, n, n, C) and the (n, n) Lagrange
// derivative matrix D,
//     du0[b,i,j,k,c] = sum_m D[i,m] u[b,m,j,k,c]
//     du1[b,i,j,k,c] = sum_m D[j,m] u[b,i,m,k,c]
//     du2[b,i,j,k,c] = sum_m D[k,m] u[b,i,j,m,c]
// in one pass over u.  u and the three outputs are float32 or bfloat16,
// contiguous; D is float32 or bfloat16 (read as stored, widened here); the
// sums are float32, m in increasing order, as in `dg_derivative.cu` (the
// generic instance, kept for n > 8).
//
// What bounds it: a value of u costs 3n multiply-adds against 4 bytes read
// and 12 written in float32 (n = 4: 0.75 operations a byte, far under the
// H100's 20), so bytes bound it.  At the channel's shape (576 elements of
// 4^3 x 4) one call moves 2.36 MB, 0.70 us at 3.35 TB/s: about what a launch
// costs, so the design has to reach the whole of its bytes in one round
// trip, with no per-value work in the way.  Against PR 12's generic kernel:
//   - n is a template argument, so every loop over a line unrolls, the
//     index arithmetic is multiplies and shifts by constants (no runtime
//     division), and D's three rows come from shared memory once per node;
//   - a thread computes V channels of one node together (V = 4 where
//     C % 4 == 0: a float32 node of the channel is one 16-byte piece) and
//     writes each output with one V-wide vector store;
//   - a block stages a tile of whole elements into shared memory with
//     16-byte cp.async copies, all in flight at once (value by value where
//     u's tile is not 16-byte aligned);
//   - a tile holds as many elements as give about 128 threads (2 at the
//     channel's shape, so its 576 elements take 288 blocks; tiles of 1 or
//     4 elements were slower there in scratch timings), and the grid
//     is one wave: as many blocks as the card holds at once, each walking
//     over tiles with a 2-stage ring, the next tile's copy in flight while
//     this one is computed (576 elements need one tile a block).
// A block is (X, G) threads: x over the tile's nodes, y over the C / V
// channel groups, so consecutive threads write consecutive nodes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kTargetThreads = 128;
constexpr int kMaxThreads = 512;  // at most 128 registers a thread
constexpr int kMaxC = 64;         // so that a block has >= 8 threads a group
constexpr int kSmemDefault = 48 * 1024;

// V values of T moved as one aligned piece (4, 8 or 16 bytes).
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float& d, float x) { d = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16& d, float x) {
  d = __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every committed group but the newest one has landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copy `count` values from `src` into the 16-byte aligned `dst`: 16-byte
// cp.async pieces where `src` is 16-byte aligned, the rest value by value.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int count, int tid, int nthreads) {
  constexpr int kPer = 16 / sizeof(T);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int pieces = count / kPer;
    for (int t = tid; t < pieces; t += nthreads)
      cp_async16(dst + t * kPer, src + t * kPer);
    done = pieces * kPer;
  }
  for (int t = done + tid; t < count; t += nthreads) dst[t] = src[t];
}

template <typename T, int N, int V>
__global__ void __launch_bounds__(kMaxThreads)
    dg_derivative3_tiled_kernel(const T* __restrict__ u,
                                const void* __restrict__ dmat, int d_is_bf16,
                                T* __restrict__ du0, T* __restrict__ du1,
                                T* __restrict__ du2, long long batch, int c,
                                int elems_per_tile, long long n_tiles,
                                int stages) {
  constexpr int N2 = N * N, N3 = N2 * N;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_values = elems_per_tile * N3 * c;
  // each buffer starts on a 16-byte boundary
  const int buf_values = (tile_values * (int)sizeof(T) + 15) / 16 * 16 /
                         (int)sizeof(T);
  T* bufs = reinterpret_cast<T*>(smem);
  float* s_d = reinterpret_cast<float*>(bufs + stages * buf_values);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  if (d_is_bf16) {
    const __nv_bfloat16* d = static_cast<const __nv_bfloat16*>(dmat);
    for (int t = tid; t < N2; t += nthreads) s_d[t] = __bfloat162float(d[t]);
  } else {
    const float* d = static_cast<const float*>(dmat);
    for (int t = tid; t < N2; t += nthreads) s_d[t] = d[t];
  }
  const long long per_tile = (long long)elems_per_tile * N3 * c;
  long long tile = blockIdx.x;
  auto tile_elems = [&](long long t) {
    const long long left = batch - t * elems_per_tile;
    return (int)(left < elems_per_tile ? left : elems_per_tile);
  };
  if (tile < n_tiles)
    stage(bufs, u + tile * per_tile, tile_elems(tile) * N3 * c, tid,
          nthreads);
  cp_async_commit();

  const int g = threadIdx.y;  // channel group: channels g V .. g V + V - 1
  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    if (next < n_tiles)  // only when stages == 2: the grid is short
      stage(bufs + ((it + 1) & 1) * buf_values, u + next * per_tile,
            tile_elems(next) * N3 * c, tid, nthreads);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();

    const T* cur = bufs + (it & 1) * buf_values;
    const int nodes = tile_elems(tile) * N3;
    const long long out0 = tile * per_tile + g * V;
    for (int nt = threadIdx.x; nt < nodes; nt += blockDim.x) {
      const int node = nt % N3;
      const int i = node / N2, j = (node / N) % N, k = node % N;
      const T* own = cur + nt * c + g * V;
      const T* line0 = own - i * (N2 * c);  // along i, step N^2 C
      const T* line1 = own - j * (N * c);   // along j, step N C
      const T* line2 = own - k * c;         // along k, step C
      float a0[V], a1[V], a2[V];
#pragma unroll
      for (int q = 0; q < V; ++q) a0[q] = a1[q] = a2[q] = 0.0f;
#pragma unroll
      for (int m = 0; m < N; ++m) {
        const float d0 = s_d[i * N + m], d1 = s_d[j * N + m],
                    d2 = s_d[k * N + m];
        const Pack<T, V> x0 =
            *reinterpret_cast<const Pack<T, V>*>(line0 + m * (N2 * c));
        const Pack<T, V> x1 =
            *reinterpret_cast<const Pack<T, V>*>(line1 + m * (N * c));
        const Pack<T, V> x2 =
            *reinterpret_cast<const Pack<T, V>*>(line2 + m * c);
#pragma unroll
        for (int q = 0; q < V; ++q) {
          a0[q] = fmaf(d0, widen(x0.v[q]), a0[q]);
          a1[q] = fmaf(d1, widen(x1.v[q]), a1[q]);
          a2[q] = fmaf(d2, widen(x2.v[q]), a2[q]);
        }
      }
      Pack<T, V> o0, o1, o2;
#pragma unroll
      for (int q = 0; q < V; ++q) {
        narrow(o0.v[q], a0[q]);
        narrow(o1.v[q], a1[q]);
        narrow(o2.v[q], a2[q]);
      }
      const long long at = out0 + (long long)nt * c;
      *reinterpret_cast<Pack<T, V>*>(du0 + at) = o0;
      *reinterpret_cast<Pack<T, V>*>(du1 + at) = o1;
      *reinterpret_cast<Pack<T, V>*>(du2 + at) = o2;
    }
    __syncthreads();  // the next round's copy reuses this buffer
  }
}

// Blocks of `threads` threads and `smem` bytes that the card holds at once,
// for one kernel; cached, since the host's dispatch is on the channel's
// critical path.
int resident_blocks(const void* kernel, int threads, size_t smem,
                    int* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int, size_t>, int> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto key = std::make_tuple(dev, kernel, threads, smem);
  std::lock_guard<std::mutex> lock(mu);
  auto hit = cache.find(key);
  if (hit != cache.end()) {
    *blocks = hit->second;
    return 0;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *blocks = cache[key] = per_sm * sms;
  return 0;
}

size_t smem_bytes(int stages, size_t tile_bytes, int n) {
  return stages * ((tile_bytes + 15) / 16 * 16) + sizeof(float) * n * n;
}

template <typename T, int N, int V>
int launch(const void* u, const void* dmat, int d_is_bf16, void* du0,
           void* du1, void* du2, long long batch, int c, cudaStream_t stream) {
  constexpr int N3 = N * N * N;
  auto kernel = dg_derivative3_tiled_kernel<T, N, V>;
  const int groups = c / V;
  const size_t elem_bytes = sizeof(T) * (size_t)N3 * c;
  int elems = kTargetThreads / (N3 * groups);
  if (elems < 1) elems = 1;
  while (elems > 1 && smem_bytes(2, elems * elem_bytes, N) > kSmemDefault)
    --elems;
  int x = elems * N3;
  if (x * groups > kMaxThreads) {
    x = kMaxThreads / groups;
    if (x >= 32) x -= x % 32;
  }
  const dim3 block(x, groups);
  const long long n_tiles = (batch + elems - 1) / elems;
  // one tile a block where the card holds them all at once; else a grid of
  // one wave, each block walking over tiles with two buffers
  int stages = 1;
  size_t smem = smem_bytes(1, elems * elem_bytes, N);
  for (;;) {
    if (smem > kSmemDefault) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    int resident = 0;
    const int rc = resident_blocks(reinterpret_cast<const void*>(kernel),
                                   x * groups, smem, &resident);
    if (rc != 0) return rc;
    if (n_tiles <= resident || stages == 2) {
      const long long grid = n_tiles < resident ? n_tiles : resident;
      kernel<<<dim3((unsigned)grid), block, smem, stream>>>(
          static_cast<const T*>(u), dmat, d_is_bf16, static_cast<T*>(du0),
          static_cast<T*>(du1), static_cast<T*>(du2), batch, c, elems,
          n_tiles, stages);
      return static_cast<int>(cudaGetLastError());
    }
    stages = 2;
    smem = smem_bytes(2, elems * elem_bytes, N);
  }
}

template <typename T, int N>
int launch_v(const void* u, const void* dmat, int d_is_bf16, void* du0,
             void* du1, void* du2, long long batch, int c,
             cudaStream_t stream) {
  if (c % 4 == 0)
    return launch<T, N, 4>(u, dmat, d_is_bf16, du0, du1, du2, batch, c,
                           stream);
  if (c % 2 == 0)
    return launch<T, N, 2>(u, dmat, d_is_bf16, du0, du1, du2, batch, c,
                           stream);
  return launch<T, N, 1>(u, dmat, d_is_bf16, du0, du1, du2, batch, c,
                         stream);
}

template <typename T>
int launch_n(const void* u, const void* dmat, int d_is_bf16, void* du0,
             void* du1, void* du2, long long batch, int n, int c,
             cudaStream_t s) {
#define DG_N(N)                                                          \
  case N: return launch_v<T, N>(u, dmat, d_is_bf16, du0, du1, du2, batch, \
                                c, s)
  switch (n) {
    DG_N(2); DG_N(3); DG_N(4); DG_N(5); DG_N(6); DG_N(7); DG_N(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DG_N
}

}  // namespace

extern "C" {

// (du0, du1, du2) for `batch` elements of n^3 nodes (2 <= n <= 8) and c
// channels on `stream`; returns the cudaError_t of the launch (0 on
// success).  D is (n, n), float32 or (d_is_bf16) bfloat16.
int dg_derivative3_tiled_launch(const void* u, const void* dmat, void* du0,
                                void* du1, void* du2, long long batch, int n,
                                int c, int is_bf16, int d_is_bf16,
                                void* stream) {
  if (batch < 1 || c < 1 || c > kMaxC)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_n<__nv_bfloat16>(u, dmat, d_is_bf16, du0, du1, du2, batch,
                                   n, c, s);
  return launch_n<float>(u, dmat, d_is_bf16, du0, du1, du2, batch, n, c, s);
}

const char* dg_derivative3_tiled_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
