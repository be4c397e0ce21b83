// Three-direction DGSEM volume derivative for NVIDIA Hopper (sm_90a).
//
// Replaces `repro/kernels/dg_derivative.py:dg_derivative3` (a Pallas TPU
// kernel) and computes what its oracle `repro/kernels/ref.py:dg_derivative3`
// computes: for an element batch u (B, n, n, n, C) and the (n, n) Lagrange
// derivative matrix D,
//     du0[b,i,j,k,c] = sum_m D[i,m] u[b,m,j,k,c]
//     du1[b,i,j,k,c] = sum_m D[j,m] u[b,i,m,k,c]
//     du2[b,i,j,k,c] = sum_m D[k,m] u[b,i,j,m,c]
// in one pass over u.  u and the three outputs are float32 or bfloat16,
// contiguous; D is float32; the sums are float32, m in increasing order.
//
// What bounds it: each output value needs n multiply-adds, so a value of u
// costs 3n multiply-adds against 4 bytes read and 12 written in float32
// (n = 4: 0.75 operations a byte, far under the H100's 20 float32 operations
// a byte); bytes bound it.  The TPU kernel ran the three contractions as MXU
// matmuls over reshaped VMEM blocks; a line here is n <= 16 long, too short
// for the tensor cores without regrouping many lines into one tile, so this
// kernel uses the CUDA cores.  The design reads u once: a block stages D and
// whole elements (as many as fill about 256 values, at least one) in shared
// memory, each thread computes the three derivatives of one (node, channel)
// value and writes them to the same offset of the three outputs, so that
// neighbouring threads read and write neighbouring addresses.  Threads loop
// when an element holds more values than the block has threads.  An element
// of n^3 C values must fit in the 227 KB of shared memory a block can use
// (n = 16, C = 5: 80 KB); above 48 KB the launch raises the kernel's
// dynamic shared-memory limit first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemDefault = 48 * 1024;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void dg_derivative3_kernel(const T* __restrict__ u,
                                      const float* __restrict__ dmat,
                                      T* __restrict__ du0, T* __restrict__ du1,
                                      T* __restrict__ du2, long long total,
                                      int n, int c, int elems_per_block) {
  extern __shared__ float smem[];
  float* s_d = smem;          // D, (n, n)
  float* s_u = smem + n * n;  // elems_per_block elements, (n, n, n, C) each
  const int stride_k = c, stride_j = n * c, stride_i = n * n * c;
  const int per_elem = n * stride_i;
  const long long base = (long long)blockIdx.x * elems_per_block * per_elem;
  const long long left = total - base;
  const int count = (int)(left < (long long)elems_per_block * per_elem
                              ? left
                              : (long long)elems_per_block * per_elem);
  for (int t = threadIdx.x; t < n * n; t += blockDim.x) s_d[t] = dmat[t];
  for (int t = threadIdx.x; t < count; t += blockDim.x)
    s_u[t] = load_f32(u + base + t);
  __syncthreads();

  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const int e = t / per_elem;
    const int r = t - e * per_elem;
    const int i = r / stride_i;
    const int j = (r / stride_j) % n;
    const int k = (r / stride_k) % n;
    const int ch = r % c;
    const float* ue = s_u + e * per_elem + ch;
    const float* line0 = ue + j * stride_j + k * stride_k;  // along i
    const float* line1 = ue + i * stride_i + k * stride_k;  // along j
    const float* line2 = ue + i * stride_i + j * stride_j;  // along k
    float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
    for (int m = 0; m < n; ++m) {
      d0 += s_d[i * n + m] * line0[m * stride_i];
      d1 += s_d[j * n + m] * line1[m * stride_j];
      d2 += s_d[k * n + m] * line2[m * stride_k];
    }
    store(du0 + base + t, d0);
    store(du1 + base + t, d1);
    store(du2 + base + t, d2);
  }
}

template <typename T>
int launch(const void* u, const float* dmat, void* du0, void* du1, void* du2,
           long long batch, int n, int c, cudaStream_t stream) {
  const int per_elem = n * n * n * c;
  int elems_per_block = kThreads / per_elem;
  if (elems_per_block < 1) elems_per_block = 1;
  const size_t smem =
      sizeof(float) * ((size_t)n * n + (size_t)elems_per_block * per_elem);
  if (smem > kSmemDefault) {
    cudaError_t err = cudaFuncSetAttribute(
        dg_derivative3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (batch + elems_per_block - 1) / elems_per_block;
  dg_derivative3_kernel<T><<<dim3((unsigned)blocks), dim3(kThreads), smem,
                             stream>>>(
      static_cast<const T*>(u), dmat, static_cast<T*>(du0),
      static_cast<T*>(du1), static_cast<T*>(du2), batch * per_elem, n, c,
      elems_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// (du0, du1, du2) for `batch` elements on `stream`; returns the cudaError_t
// of the launch (0 on success).  D is (n, n) float32.
int dg_derivative3_launch(const void* u, const void* dmat, void* du0,
                          void* du1, void* du2, long long batch, int n, int c,
                          int is_bf16, void* stream) {
  if (batch < 1 || n < 1 || c < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dmat);
  if (is_bf16)
    return launch<__nv_bfloat16>(u, d, du0, du1, du2, batch, n, c, s);
  return launch<float>(u, d, du0, du1, du2, batch, n, c, s);
}

const char* dg_derivative3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
