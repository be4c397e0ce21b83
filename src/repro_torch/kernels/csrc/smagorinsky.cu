// Smagorinsky eddy viscosity for NVIDIA Hopper (sm_90a).
//
// Replaces `repro/kernels/smagorinsky.py:smagorinsky_nut` (a Pallas TPU
// kernel) and computes what its oracle `repro/kernels/ref.py:smagorinsky_nut`
// computes: with S = (g + g^T) / 2 the symmetric part of the velocity
// gradient g[i][j] = d v_i / d x_j,
//     nu_t = (C_s Delta)^2 sqrt(2 S:S + 1e-30).
// grad_v is any (P, 3, 3) view with strides (s_p, 3, 1), s_p >= 9: the
// velocity rows of the channel's (..., 4, 3) gradient (s_p = 12) are read in
// place.  cs is any (P,) view with stride s_c >= 0 (0: one C_s for all).
// Both are float32 or bfloat16; nu_t is (P,), contiguous, in their dtype;
// the math is float32, in the oracle's form (S first).
//
// What bounds it: per point 10 values are read and 1 written (44 bytes in
// float32) for about 26 operations, so bytes bound it.  At the channel's
// shape (P = 16 envs x 2,304 nodes) that is 1.6 MB, about 0.5 us at 3.35
// TB/s: as little as one launch costs, so the design has to have all of its
// bytes in flight at once.  Against PR 12's version (one thread per point,
// nine 4-byte loads at a 36-byte stride, contiguous operands only, so that
// the caller copied the gradient's rows first):
//   - a block of 128 threads stages its slab of 128 points (6 KB at
//     s_p = 12) into shared memory with one TMA bulk copy (cp.async.bulk)
//     onto an mbarrier, and reads C_s meanwhile; a thread computes one
//     point from shared memory;
//   - the block's nu_t go back through shared memory and out as 16-byte
//     stores (4 float32 or 8 bfloat16 points a thread);
//   - a block a slab: the channel's 288 slabs are one wave of blocks;
//   - a view whose slab is not 16-byte aligned, or whose point stride would
//     stage more than 48 values a point, is read value by value from device
//     memory instead.
// In scratch timings on the H100, 128-point slabs by one bulk copy were the
// fastest staged form at the channel's P, ahead of 64- and 256-point slabs
// and of 16-byte cp.async copies by every thread (at 6 x P, 256-point
// slabs were a little faster); 16-byte loads straight from device memory,
// four points a thread, were a little faster at the channel's P and lost
// by a third at 6 x P.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;        // points of a slab, threads of a block
constexpr int kMaxStagedStride = 48; // values a point at most, when staged

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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// `bytes` (a multiple of 16) from 16-byte aligned `src` to `dst` by the TMA
// unit, completing on `bar`, which expects them
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          int phase) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\tLAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\tbra LAB_WAIT;\n\tDONE:\n\t}" ::"r"(smem_u32(bar)),
      "r"(phase)
      : "memory");
}

// kStaged: grad_v's slabs are 16-byte aligned and s_p <= kMaxStagedStride.
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    smagorinsky_kernel(const T* __restrict__ grad_v, long long s_p,
                       const T* __restrict__ cs, long long s_c,
                       T* __restrict__ nu_t, long long p, float delta) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_nu[kThreads];
  __shared__ __align__(8) unsigned long long bar;
  T* s_g = reinterpret_cast<T*>(smem);
  constexpr int kVec = 16 / sizeof(T);  // points of one 16-byte store
  const int t = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * kThreads;
  const int np = (int)(p - p0 < kThreads ? p - p0 : kThreads);
  const T* slab = grad_v + p0 * s_p;
  if (kStaged) {  // the slab's values, from its first point's to its last's
    const int count = (np - 1) * (int)s_p + 9;
    const int pieces = count / kVec;  // 16-byte pieces
    if (t == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
          smem_u32(&bar)));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      bulk_copy(s_g, slab, pieces * 16u, &bar);
    }
    for (int x = pieces * kVec + t; x < count; x += kThreads)
      s_g[x] = slab[x];
  }
  const float c_s = t < np ? widen(cs[(p0 + t) * s_c]) : 0.0f;
  if (kStaged) {
    __syncthreads();  // the barrier is initialised before anyone waits
    mbar_wait(&bar, 0);
    __syncthreads();  // and the tail's values are stored
  }
  if (t < np) {
    const T* gp = kStaged ? s_g + t * s_p : slab + t * s_p;
    float g[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) g[k] = widen(gp[k]);
    float ss = 0.0f;  // S:S
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const float s_ab = 0.5f * (g[3 * a + b] + g[3 * b + a]);
        ss += s_ab * s_ab;
      }
    }
    const float s_mag = sqrtf(2.0f * ss + 1e-30f);
    const float cd = c_s * delta;
    s_nu[t] = cd * cd * s_mag;
  }
  __syncthreads();
  T* out = nu_t + p0;  // 16-byte aligned: p0 is a multiple of 128
  if (np == kThreads) {
    if (t < kThreads / kVec) {
      Pack<T, kVec> pk;
#pragma unroll
      for (int q = 0; q < kVec; ++q) narrow(pk.v[q], s_nu[t * kVec + q]);
      *reinterpret_cast<Pack<T, kVec>*>(out + t * kVec) = pk;
    }
  } else if (t < np) {
    narrow(out[t], s_nu[t]);
  }
}

// Dynamic shared memory of a staged block: its slab of kThreads points of
// s_p values, rounded up to 16 bytes.
size_t slab_bytes(long long s_p, size_t value_bytes) {
  return (kThreads * s_p * value_bytes + 15) / 16 * 16;
}

template <typename T>
int launch(const void* grad_v, long long s_p, const void* cs, long long s_c,
           void* nu_t, long long p, float delta, cudaStream_t stream) {
  // a slab spans 128 s_p values, a multiple of 16 bytes: where the first
  // slab is 16-byte aligned, every slab is
  const bool staged = s_p <= kMaxStagedStride &&
                      (reinterpret_cast<uintptr_t>(grad_v) & 15) == 0;
  auto kernel = staged ? smagorinsky_kernel<T, true>
                       : smagorinsky_kernel<T, false>;
  const size_t smem = staged ? slab_bytes(s_p, sizeof(T)) : 0;
  const long long blocks = (p + kThreads - 1) / kThreads;
  kernel<<<dim3((unsigned)blocks), dim3(kThreads), smem, stream>>>(
      static_cast<const T*>(grad_v), s_p, static_cast<const T*>(cs), s_c,
      static_cast<T*>(nu_t), p, delta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// nu_t for P points on `stream`, grad_v with point stride s_p (>= 9) and
// cs with stride s_c (>= 0), in values; returns the cudaError_t of the
// launch (0 on success).
int smagorinsky_launch(const void* grad_v, long long s_p, const void* cs,
                       long long s_c, void* nu_t, long long p, int is_bf16,
                       float delta, void* stream) {
  if (p < 1 || s_p < 9 || s_c < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(grad_v, s_p, cs, s_c, nu_t, p, delta, s);
  return launch<float>(grad_v, s_p, cs, s_c, nu_t, p, delta, s);
}

// Dynamic shared memory (bytes) of a staged launch for point stride s_p,
// the most a launch asks for (one value by value asks for none); -1 where
// s_p is below 9 or too long to be staged.
int smagorinsky_smem_bytes(int s_p, int is_bf16) {
  if (s_p < 9 || s_p > kMaxStagedStride) return -1;
  return static_cast<int>(slab_bytes(s_p, is_bf16 ? 2 : 4));
}

const char* smagorinsky_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
