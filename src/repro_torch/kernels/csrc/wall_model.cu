// Reichardt law-of-the-wall inversion (equilibrium wall model) for NVIDIA
// Hopper (sm_90a).
//
// Replaces `repro/kernels/wall_model.py:wall_model_tau` (a Pallas TPU
// kernel) and computes what its oracle `repro/kernels/ref.py:wall_model_tau`
// computes, in the same order of operations: from the laminar guess
// u_tau = sqrt(nu u_par / y_m + 1e-12), `iters` damped fixed-point rounds
// u_tau <- sqrt(u_tau u_par / max(u+(y_m u_tau / nu), 1e-6) + 1e-14), then
// tau_w = rho_w u_tau^2.  u_par, rho_w and tau_w are float32 or bfloat16 and
// flat (P,); the math is float32.
//
// What bounds it: per point it reads 2 values and writes 1 (12 bytes in
// float32) and does `iters` rounds of about 20 operations, three of them
// transcendental (log1pf, 2 expf) and one sqrtf.  At the channel's shapes
// (P = 2 walls x 16 envs x 144 wall-face columns = 4,608; the channel calls
// it once per RHS for both walls) the whole call is 55,296 bytes: far below
// what one launch costs, so the launch and each thread's chain of `iters`
// dependent rounds bound it on the card, not bytes or operations.  The
// design is one thread per point with the ragged edge masked (the TPU
// kernel padded its last block with 1s instead); the rounds run in
// registers.  Blocks are 64 threads: the card then spreads 4,608 points over
// 72 SMs (blocks of 256 put them on 18), so each SM's schedulers interleave
// fewer of the dependent chains.
//
// Built without --use_fast_math, so sqrtf and the division are IEEE-rounded
// and log1pf / expf are CUDA's full-precision versions (within 2 ulp).  nvcc
// may contract a product and a sum into one FMA; the fixed point contracts,
// so these last-bit differences from the plain version do not grow.
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

// Reichardt's composite law u+(y+) (ref.reichardt_uplus, same op order).
__device__ __forceinline__ float reichardt_uplus(float y_plus, float kappa) {
  return log1pf(kappa * y_plus) / kappa +
         7.8f * (1.0f - expf(-y_plus / 11.0f) -
                 (y_plus / 11.0f) * expf(-y_plus / 3.0f));
}

template <typename T>
__global__ void wall_model_kernel(const T* __restrict__ u_par,
                                  const T* __restrict__ rho_w,
                                  T* __restrict__ tau, long long p, float y_m,
                                  float nu, float kappa, int iters) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const float up = load_f32(u_par + i);
  float u_tau = sqrtf(nu * up / y_m + 1e-12f);  // laminar initial guess
  for (int k = 0; k < iters; ++k) {
    const float y_plus = y_m * u_tau / nu;
    const float u_plus = fmaxf(reichardt_uplus(y_plus, kappa), 1e-6f);
    u_tau = sqrtf(u_tau * up / u_plus + 1e-14f);
  }
  store(tau + i, load_f32(rho_w + i) * (u_tau * u_tau));
}

constexpr int kThreads = 64;  // see the note at the top

}  // namespace

extern "C" {

// tau_w for P points on `stream`; returns the cudaError_t of the launch
// (0 on success).  All three arrays are contiguous, of one dtype.
int wall_model_launch(const void* u_par, const void* rho_w, void* tau,
                      long long p, int is_bf16, float y_m, float nu,
                      float kappa, int iters, void* stream) {
  if (p < 1 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)((p + kThreads - 1) / kThreads)), block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    wall_model_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(u_par),
        static_cast<const __nv_bfloat16*>(rho_w),
        static_cast<__nv_bfloat16*>(tau), p, y_m, nu, kappa, iters);
  else
    wall_model_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(u_par), static_cast<const float*>(rho_w),
        static_cast<float*>(tau), p, y_m, nu, kappa, iters);
  return static_cast<int>(cudaGetLastError());
}

const char* wall_model_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
