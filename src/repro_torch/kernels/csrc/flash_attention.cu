// Flash attention forward for NVIDIA Hopper (sm_90a): the float32 instance
// of the port's `flash_attention`, on the CUDA cores (the bfloat16 instance
// is the tensor-core kernel of flash_attention_tc.cu).
//
// Replaces `repro/kernels/flash_attention.py:flash_attention` (a Pallas TPU
// kernel) and computes what its oracle `repro/kernels/ref.py:mha_chunked`
// computes: for q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D),
//     o[b, h, i] = sum_j softmax_j(cap(scale * q_i . k_j)) v_j
// over the keys j visible from query i, where query head h reads kv head
// h / (Hq / Hkv) (GQA), query i sits at absolute position i + Skv - Sq (the
// decode convention), causal keeps j <= that position, a window keeps
// j > position - window, and cap(x) = softcap * tanh(x / softcap).  A row
// with no visible key is 0.  Inputs are float32 with any strides but a
// unit one along D; o is contiguous float32.  Exact float32 math, no TF32:
// the full-width float32 check of hymba-1.5b rests on it.
//
// What bounds it: at hymba-1.5b's prefill (B=4, Hq=25, Hkv=5, S=2048,
// D=64, window 1024) the band of visible (q, k) pairs is 1.57M per head,
// 4 D operations each for the two products: 40 GFLOP for ~13 MB of I/O, so
// operations bound it on the card.  This kernel does its products on the
// CUDA cores in float32 (67 TFLOP/s peak), not on the tensor cores: a
// simple first port, exact in float32.
//
// Design: one block of 256 threads per (64-row query tile, b, h).  It keeps
// the query tile in shared memory, walks the 64-key tiles that intersect
// the tile's visible band (tiles wholly outside the causal/window band are
// skipped: same result, less work) and for each: stages K (transposed) and
// V in shared memory; each thread computes a 4x4 block of the 64x64 logits
// from float4 shared-memory reads; the online-softmax statistics (m, l) of
// its 4 rows are reduced over the 16 lanes that share them with shuffles
// and kept in registers; P goes to shared memory (transposed) and each
// thread accumulates its 4 rows x D/16 columns of P V in registers.  The
// query tiles are launched last-first, so the longest (most keys under a
// causal mask) start first.  D is padded to 64, 128 or 256 (one template
// instance each); shared memory is 68, 117 or 217 KB.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 64;            // query rows and keys per tile
constexpr int kThreads = 256;        // 16 x 16 threads, 4 x 4 values each
constexpr int kLd = kTile + 4;       // row stride of the transposed tiles

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int hq, hkv, sq, skv, d;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int causal, window;  // window <= 0: none
  float softcap;       // <= 0: none
  float scale;
};

template <int DP>
constexpr int smem_floats() {
  return 2 * DP * kLd + kTile * DP + kTile * kLd;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Params p) {
  constexpr int kCols = DP / 64;       // float4 column groups per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* q_t = smem;                   // [DP][kLd]   Q^T
  float* k_t = q_t + DP * kLd;         // [DP][kLd]   K^T
  float* v_s = k_t + DP * kLd;         // [kTile][DP] V
  float* p_t = v_s + kTile * DP;       // [kTile][kLd] P^T

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x;
  const int b = bh / p.hq, h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int n_qt = (p.sq + kTile - 1) / kTile;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * kTile;
  const int off = p.skv - p.sq;        // absolute position of query row 0
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int i = tid; i < kTile * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    float x = 0.0f;
    if (q0 + r < p.sq && c < p.d) x = to_f32(qg[(q0 + r) * p.q_ss + c]);
    q_t[c * kLd + r] = x;
  }

  // the keys any row of this tile can see
  const int pos_lo = q0 + off;
  const int pos_hi = min(q0 + kTile, p.sq) - 1 + off;
  int k_begin = 0, k_end = p.skv;
  if (p.causal) k_end = min(k_end, pos_hi + 1);
  if (p.window > 0) k_begin = max(0, pos_lo - p.window + 1);

  float m[4], l[4], acc[4][4 * kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * kCols; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = (k_begin / kTile) * kTile; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kTile * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      float kx = 0.0f, vx = 0.0f;
      if (k0 + r < p.skv && c < p.d) {
        kx = to_f32(kg[(k0 + r) * p.k_ss + c]);
        vx = to_f32(vg[(k0 + r) * p.v_ss + c]);
      }
      k_t[c * kLd + r] = kx;
      v_s[r * DP + c] = vx;
    }
    __syncthreads();

    // logits of rows 4ty.., keys 4tx..
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(q_t + c * kLd + 4 * ty);
      const float4 bk =
          *reinterpret_cast<const float4*>(k_t + c * kLd + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // masked online softmax; the 16 lanes with the same ty share rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
      const int pos = qi + off;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + 4 * tx + j;
        const bool ok = qi < p.sq && kj < p.skv &&
                        (!p.causal || kj <= pos) &&
                        (p.window <= 0 || kj > pos - p.window);
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.0f) x = p.softcap * tanhf(x / p.softcap);
        s[i][j] = ok ? x : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int lane = 8; lane >= 1; lane >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, lane));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = m[i] == -INFINITY ? 1.0f : expf(m[i] - m_new);
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] == -INFINITY ? 0.0f : expf(s[i][j] - m_safe);
        sum += s[i][j];
      }
#pragma unroll
      for (int lane = 8; lane >= 1; lane >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, lane);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kCols; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(p_t + (4 * tx + j) * kLd + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += P V on rows 4ty.., columns 64 g + 4 tx ..
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(p_t + kk * kLd + 4 * ty);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int g = 0; g < kCols; ++g) {
        const float4 vb = *reinterpret_cast<const float4*>(
            v_s + kk * DP + 64 * g + 4 * tx);
        const float vv[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][4 * g + c] = fmaf(pv[i], vv[c], acc[i][4 * g + c]);
      }
    }
  }

  T* og = static_cast<T*>(p.o) + (long long)bh * p.sq * p.d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= p.sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < kCols; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 64 * g + 4 * tx + c;
        if (col < p.d) store(og + (long long)qi * p.d + col,
                             acc[i][4 * g + c] / denom);
      }
  }
}

template <typename T, int DP>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int bytes = smem_floats<DP>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(batch * p.hq),
                  (unsigned)((p.sq + kTile - 1) / kTile));
  flash_attention_kernel<T, DP><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int batch, cudaStream_t stream) {
  if (p.d <= 64) return launch<T, 64>(p, batch, stream);
  if (p.d <= 128) return launch<T, 128>(p, batch, stream);
  return launch<T, 256>(p, batch, stream);
}

}  // namespace

extern "C" {

// o = attention(q, k, v) on `stream` (strides in elements, for the b, h
// and s axes of each input); returns the cudaError_t of the launch.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int batch, int hq, int hkv, int sq,
                           int skv, int d, long long q_sb, long long q_sh,
                           long long q_ss, long long k_sb, long long k_sh,
                           long long k_ss, long long v_sb, long long v_sh,
                           long long v_ss, int causal, int window,
                           float softcap, float scale, void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv || sq < 1 || skv < 0 ||
      d < 1 || d > 256 || sq > 65535 * kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,    k,    v,    o,    hq,   hkv,    sq,      skv,
                 d,    q_sb, q_sh, q_ss, k_sb, k_sh,   k_ss,    v_sb,
                 v_sh, v_ss, causal, window, softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch<float>(p, batch, s));
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
