// Smagorinsky eddy viscosity for NVIDIA Hopper (sm_90a).
//
// Replaces `repro/kernels/smagorinsky.py:smagorinsky_nut` (a Pallas TPU
// kernel) and computes what its oracle `repro/kernels/ref.py:smagorinsky_nut`
// computes: with S = (g + g^T) / 2 the symmetric part of the velocity
// gradient g[i][j] = d v_i / d x_j,
//     nu_t = (C_s Delta)^2 sqrt(2 S:S + 1e-30).
// grad_v is (P, 3, 3) and cs (P,), float32 or bfloat16, contiguous; nu_t is
// (P,) in their dtype; the math is float32, in the oracle's form (S first).
//
// What bounds it: per point 10 values are read and 1 written (44 bytes in
// float32) for about 40 operations, so bytes bound it on the card (about 3
// operations a byte against the H100's 20 float32 operations a byte).  At
// the channel's shapes (P = 16 envs x 2,304 nodes) that is 1.6 MB, about
// 0.5 us at 3.35 TB/s, well below what one launch costs.  The design is one
// thread per point: a warp's nine strided loads of its 32 gradients touch
// nine whole 128-byte lines between them, so every byte brought in is used
// through L1.  The ragged edge is masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void smagorinsky_kernel(const T* __restrict__ grad_v,
                                   const T* __restrict__ cs,
                                   T* __restrict__ nu_t, long long p,
                                   float delta) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  float g[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) g[k] = load_f32(grad_v + i * 9 + k);
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
  const float cd = load_f32(cs + i) * delta;
  store(nu_t + i, cd * cd * s_mag);
}

constexpr int kThreads = 256;

}  // namespace

extern "C" {

// nu_t for P points on `stream`; returns the cudaError_t of the launch
// (0 on success).
int smagorinsky_launch(const void* grad_v, const void* cs, void* nu_t,
                       long long p, int is_bf16, float delta, void* stream) {
  if (p < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)((p + kThreads - 1) / kThreads)), block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    smagorinsky_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(grad_v),
        static_cast<const __nv_bfloat16*>(cs),
        static_cast<__nv_bfloat16*>(nu_t), p, delta);
  else
    smagorinsky_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(grad_v), static_cast<const float*>(cs),
        static_cast<float*>(nu_t), p, delta);
  return static_cast<int>(cudaGetLastError());
}

const char* smagorinsky_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
