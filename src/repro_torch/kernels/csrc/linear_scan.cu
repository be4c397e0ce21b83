// Gated linear recurrence for NVIDIA Hopper (sm_90a).
//
// Replaces `repro/kernels/linear_scan.py:linear_scan` (a Pallas TPU kernel)
// and computes what its oracle `repro/kernels/ref.py:linear_scan` computes,
// per row b with state S (dk, dv) starting at s0 (or 0):
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
//     o_t = q_t @ S_t                                  (decay_before_read)
//     o_t = q_t @ (S_{t-1} + diag(u) k_t v_t^T)        (RWKV6; u absent = 1)
// q, k, w are (B, T, dk) and v (B, T, dv), each float32 or bfloat16 on its
// own; u (dk,) and s0 (B, dk, dv) are float32; o is (B, T, dv) in q's dtype
// and S_final (B, dk, dv) float32.  All math is float32.
//
// What bounds it: per step and state entry a few operations (5 for the
// GLA read, 7 for RWKV's), against reading q, k, w, v and writing o once:
// at hymba-1.5b's prefill (B*H = 100 rows, T = 2048, dk = 16, dv = 64;
// q, v bf16, k, w f32) that is 1.0 GFLOP against 86 MB, so bytes bound it
// (~26 us at 3.35 TB/s); a decode step (T = 1) moves the state in and out.
//
// Design: the exact recurrence, step by step (the TPU kernel walks chunks
// of a chunk-parallel form instead).  The columns of S evolve independently,
// so a block owns one row and a tile of columns: thread (j, g) holds rows
// 16g .. 16g+15 of column j in registers, and the read q_t . S[:, j] is
// summed over the G = dk/16 lanes of a column with shuffles (none for
// dk <= 16, hymba's case: a column per thread).  A tile is one warp of
// compute (G x columns = 32), so a row's columns spread over several blocks
// and SMs; each block has 8 warps, the seven others only stage.  The steps
// are staged in shared memory in chunks (operands converted to float32,
// padding rows w = 1, k = q = v = 0): each thread loads its share of chunk
// c+1 (at most 8 values, so nothing spills) into registers before the
// compute warp walks chunk c, so the loads overlap the recurrence; o goes
// back one chunk at a time.  The step loop is unrolled by 4 so that a
// step's read overlaps the next step's update.  The sequential dependence
// over T bounds this design; the chunk-parallel form on the tensor cores is
// the redesign that would approach the byte bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;    // 8 warps: one computes, all stage
constexpr int kRows = 16;        // state rows a thread holds
constexpr int kPrefetch = 8;     // staged values per thread per chunk
constexpr int kMaxChunk = 64;

__device__ __forceinline__ float load_any(const void* p, long long i,
                                          int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* w;
  const float* u;   // (dk,) or null
  const float* s0;  // (B, dk, dv) or null
  void* o;
  float* s_fin;
  int t, dk, dv;
  int q_bf16, k_bf16, v_bf16, w_bf16;
  int groups, dkp, cols;   // G, padded dk = 16 G, columns per block
  int chunk;               // steps per chunk
  // log2 of dkp, cols and chunk * dkp (all powers of two)
  int dkp_log2, cols_log2, qkw_log2;
};

// Chunk element e of the staged layout [q | k | w] (chunk x dkp each), then
// v (chunk x cols, the block's columns from c0), read from global memory
// as float32 (padding beyond T, dk or dv: q = k = v = 0, w = 1).
__device__ __forceinline__ float staged_value(const Params& p, long long row,
                                              int c0, int t0, int e) {
  const int qkw = 1 << p.qkw_log2;
  if (e < 3 * qkw) {
    const int which = e >> p.qkw_log2, rem = e & (qkw - 1);
    const int t = t0 + (rem >> p.dkp_log2), i = rem & (p.dkp - 1);
    if (t >= p.t || i >= p.dk) return which == 2 ? 1.0f : 0.0f;
    const long long idx = (row * p.t + t) * p.dk + i;
    if (which == 0) return load_any(p.q, idx, p.q_bf16);
    if (which == 1) return load_any(p.k, idx, p.k_bf16);
    return load_any(p.w, idx, p.w_bf16);
  }
  const int rem = e - 3 * qkw;
  const int t = t0 + (rem >> p.cols_log2), j = c0 + (rem & (p.cols - 1));
  if (t >= p.t || j >= p.dv) return 0.0f;
  return load_any(p.v, (row * p.t + t) * p.dv + j, p.v_bf16);
}

template <bool kDecayBeforeRead, bool kOneLane>
__global__ void __launch_bounds__(kThreads)
linear_scan_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int staged = p.chunk * (3 * p.dkp + p.cols);
  float* q_s = smem;
  float* k_s = q_s + p.chunk * p.dkp;
  float* w_s = k_s + p.chunk * p.dkp;
  float* v_s = w_s + p.chunk * p.dkp;
  float* o_s = smem + staged;  // (chunk, cols)

  const long long row = blockIdx.x;
  const int c0 = blockIdx.y * p.cols;
  const int tid = threadIdx.x;
  const int jl = tid / p.groups, g = tid % p.groups, j = c0 + jl;
  const bool compute_warp = tid < 32;  // G * cols <= 32
  const bool live = compute_warp && jl < p.cols && j < p.dv;
  const int i0 = g * kRows;

  float st[kRows], uu[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r;
    const bool in = live && i < p.dk;
    st[r] = in && p.s0 ? p.s0[(row * p.dk + i) * p.dv + j] : 0.0f;
    uu[r] = (i < p.dk && p.u) ? p.u[i] : 1.0f;
  }

  float pre[kPrefetch];
#pragma unroll
  for (int n = 0; n < kPrefetch; ++n) {
    const int e = tid + n * kThreads;
    pre[n] = e < staged ? staged_value(p, row, c0, 0, e) : 0.0f;
  }

  for (int t0 = 0; t0 < p.t; t0 += p.chunk) {
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll
    for (int n = 0; n < kPrefetch; ++n) {
      const int e = tid + n * kThreads;
      if (e < staged) smem[e] = pre[n];
    }
    __syncthreads();
    const int t_next = t0 + p.chunk;
    if (t_next < p.t) {
#pragma unroll
      for (int n = 0; n < kPrefetch; ++n) {
        const int e = tid + n * kThreads;
        pre[n] = e < staged ? staged_value(p, row, c0, t_next, e) : 0.0f;
      }
    }

    const int steps = min(p.chunk, p.t - t0);
    if (compute_warp) {
#pragma unroll 4
      for (int s = 0; s < steps; ++s) {
        const float vj = v_s[s * p.cols + (jl & (p.cols - 1))];
        float qv[kRows], kv[kRows], wv[kRows];
#pragma unroll
        for (int r = 0; r < kRows; r += 4) {
          const int base = s * p.dkp + i0 + r;
          const float4 a = *reinterpret_cast<const float4*>(q_s + base);
          const float4 b = *reinterpret_cast<const float4*>(k_s + base);
          const float4 c = *reinterpret_cast<const float4*>(w_s + base);
          qv[r] = a.x; qv[r + 1] = a.y; qv[r + 2] = a.z; qv[r + 3] = a.w;
          kv[r] = b.x; kv[r + 1] = b.y; kv[r + 2] = b.z; kv[r + 3] = b.w;
          wv[r] = c.x; wv[r + 1] = c.y; wv[r + 2] = c.z; wv[r + 3] = c.w;
        }
        float acc = 0.0f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float kvj = kv[r] * vj;
          if (kDecayBeforeRead) {
            st[r] = wv[r] * st[r] + kvj;
            acc += qv[r] * st[r];
          } else {
            acc += qv[r] * (st[r] + uu[r] * kvj);
            st[r] = wv[r] * st[r] + kvj;
          }
        }
        if (!kOneLane)
          for (int lane = p.groups / 2; lane >= 1; lane >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, lane);
        if (live && g == 0) o_s[s * p.cols + jl] = acc;
      }
    }
    __syncthreads();
    for (int e = tid; e < steps * p.cols; e += kThreads) {
      const int jj = c0 + (e & (p.cols - 1));
      if (jj >= p.dv) continue;
      const long long idx = (row * p.t + t0 + (e >> p.cols_log2)) * p.dv + jj;
      if (p.q_bf16)
        static_cast<__nv_bfloat16*>(p.o)[idx] = __float2bfloat16(o_s[e]);
      else
        static_cast<float*>(p.o)[idx] = o_s[e];
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r;
    if (live && i < p.dk) p.s_fin[(row * p.dk + i) * p.dv + j] = st[r];
  }
}

int ceil_pow2(int x) {
  int y = 1;
  while (y < x) y <<= 1;
  return y;
}

int log2_of(int x) {  // x is a power of two
  int n = 0;
  while ((1 << n) < x) ++n;
  return n;
}

// The layout of p.t steps of (p.dk, p.dv): lanes a column, columns a
// block, and the largest chunk whose staged values fit the per-thread
// prefetch, no longer than the steps need.
void plan(Params* p) {
  p->groups = ceil_pow2((p->dk + kRows - 1) / kRows);  // <= 32
  p->dkp = p->groups * kRows;
  const int c = ceil_pow2(p->dv);
  p->cols = c < 32 / p->groups ? c : 32 / p->groups;
  int chunk = kMaxChunk;
  while (chunk > 1 && chunk * (3 * p->dkp + p->cols) > kPrefetch * kThreads)
    chunk >>= 1;
  while (chunk > 1 && chunk / 2 >= p->t) chunk >>= 1;
  p->chunk = chunk;
  p->dkp_log2 = log2_of(p->dkp);
  p->cols_log2 = log2_of(p->cols);
  p->qkw_log2 = log2_of(chunk * p->dkp);
}

// Dynamic shared memory of a planned launch: at most 2 x 8 x 256 floats
// (16 KB), so no opt-in above 48 KB is needed.
int smem_bytes(const Params& p) {
  return p.chunk * (3 * p.dkp + 2 * p.cols) * (int)sizeof(float);
}

}  // namespace

extern "C" {

// (o, s_final) of the recurrence on `stream`; u and s0 may be null.
// Returns the cudaError_t of the launch (0 on success).
int linear_scan_launch(const void* q, const void* k, const void* v,
                       const void* w, const float* u, const float* s0,
                       void* o, float* s_fin, int batch, int t, int dk,
                       int dv, int q_bf16, int k_bf16, int v_bf16,
                       int w_bf16, int decay_before_read, void* stream) {
  if (batch < 1 || t < 1 || dk < 1 || dv < 1 || dk > 512 || dv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,      k,      v,      w,      u, s0, o, s_fin, t, dk, dv,
           q_bf16, k_bf16, v_bf16, w_bf16, 0, 0,  0, 0,     0, 0,  0};
  plan(&p);
  const int bytes = smem_bytes(p);
  const bool one_lane = p.groups == 1;
  void (*kernel)(Params) =
      decay_before_read
          ? (one_lane ? &linear_scan_kernel<true, true>
                      : &linear_scan_kernel<true, false>)
          : (one_lane ? &linear_scan_kernel<false, true>
                      : &linear_scan_kernel<false, false>);
  const dim3 grid((unsigned)batch, (unsigned)((dv + p.cols - 1) / p.cols));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<grid, kThreads, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory (bytes) of a launch of t steps of (dk, dv); -1
// where the launch would refuse them.
int linear_scan_smem_bytes(int t, int dk, int dv) {
  if (t < 1 || dk < 1 || dv < 1 || dk > 512 || dv > 65535) return -1;
  Params p{};
  p.t = t;
  p.dk = dk;
  p.dv = dv;
  plan(&p);
  return smem_bytes(p);
}

const char* linear_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
