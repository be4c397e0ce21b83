// Gated linear recurrence, chunk-parallel over T, for NVIDIA Hopper (sm_90a).
//
// Replaces `repro/kernels/linear_scan.py:linear_scan` (a Pallas TPU kernel)
// for sequences of at least one chunk, beside the step kernel of
// `linear_scan.cu`, which keeps short T (decode).  It computes what the
// oracle `repro/kernels/ref.py:linear_scan` computes, per row b with state
// S (dk, dv) starting at s0 (or 0):
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
//     o_t = q_t @ S_t                                  (decay_before_read)
//     o_t = q_t @ (S_{t-1} + diag(u) k_t v_t^T)        (RWKV6; u absent = 1)
// q, k, w are (B, T, dk) and v (B, T, dv), each float32 or bfloat16 on its
// own; u (dk,) and s0 (B, dk, dv) are float32; o is (B, T, dv) in q's dtype
// and S_final (B, dk, dv) float32.  All math is float32.  dk <= 64.
//
// What bounds it: at hymba-1.5b's prefill (B*H = 100 rows, T = 2048,
// dk = 16, dv = 64; q, v bf16, k, w f32) 1.0 GFLOP against 86 MB, so bytes
// (~26 us at 3.35 TB/s).  The step kernel walks the 2,048 steps in order
// (~210 ns a step): the sequential dependence over T bounds it, not the
// card.  This instance cuts that dependence as the TPU kernel's own form
// does (a grid of rows x T/C chunks), in three launches on one stream:
//   A (row, chunk, column tile): the chunk's end state from zero,
//       S_loc = sum_s (k_s * prod_{s<r} w_r) v_s^T,
//     a dense product over the chunk's steps (no dependence between them),
//     with the decays prod_{s<r} w_r as running products of w taken
//     backwards over the chunk (no exp, log or division, so nothing
//     overflows that the recurrence would not), and the chunk's decay
//     product prod w;
//   B (row, state entry): each chunk's incoming state, in order over the
//     row's T/C chunk summaries: S_in(0) = s0 (or 0), S_in(c+1) =
//     diag(prod w_c) S_in(c) + S_loc(c), written over S_loc in place; the
//     last is S_final;
//   C (row, chunk, column tile): the chunk's outputs by the exact step
//     recurrence from S_in(c), as the step kernel walks it.
// The sequential depth is thus C steps (A, C) plus T/C (B) instead of T,
// and (row, chunk) blocks fill the card: 100 rows x 32 chunks = 3,200
// blocks at hymba's shape instead of the step kernel's 200 warps.  A and C
// read the operands twice (1.6x the bytes of one pass); C reruns the
// recurrence rather than keeping A's outputs, which would move more.
//
// In A and C a block owns one (row, chunk) and a tile of `cols` columns:
// thread (j, g) holds rows 16g .. 16g+15 of column j (G = dk/16 <= 4 lanes
// a column, C's read summed over them with shuffles; none for dk <= 16),
// G x cols threads (at least a warp, at most 256), every warp computing.
// A block brings its chunk's q, k, w (C x dkp) and its tile of v (C x cols)
// into shared memory with 16-byte cp.async copies, all in flight at once,
// and widens the bf16 ones of q, k, w to float32 there; v stays as stored.
// An operand whose rows are not a multiple of 16 bytes or whose base is
// not 16-byte aligned is read value by value instead.  C is the largest
// power of two <= 64 whose tiles fit 48 KB whatever the dtypes (64 at
// hymba's shape, 32 for RWKV6's 64 x 64 state).  The products run on the
// CUDA cores: at dk = 16 the arithmetic is below the byte bound, and
// S_final is held to float32, which TF32 or bf16 products would not give.
// Scratch (float32, from the wrapper): S_loc (B, T/C, dk, dv) and
// prod w (B, T/C, dk).
//
// Measured on an H100 at hymba's prefill (PERF.md): 0.12 ms against the
// step kernel's 0.43; phase C ~60%, A ~30%, B ~9% of it.  The three phases
// move about 190 MB (A reads k, w, v and writes S_loc; B reads and
// rewrites S_loc; C reads all four operands and S_in and writes o), ~57 us
// at the card's 3.35 TB/s: this design's own floor is 2.2x the byte bound
// of one pass.  The first version staged value by value through registers
// and was latency-bound on its loads (0.41 ms); the 16-byte copies fixed
// that.  Variants that did not help: two columns a thread, the copies in
// four groups overlapped with the recurrence, resident blocks with two
// buffers (fewer warps a SM), v read from global memory in the loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;               // state rows a thread holds
constexpr int kMaxDk = 64;              // G = dk / 16 <= 4 lanes a column
constexpr int kMaxThreads = 256;        // threads of a block
constexpr int kMaxChunk = 64;           // steps of a chunk
constexpr int kSmemBudget = 48 * 1024;  // dynamic shared memory, no opt-in
constexpr int kCarryThreads = 256;      // phase B block
constexpr int kCarryBatch = 8;          // summaries phase B loads at once

__device__ __forceinline__ float load_any(const void* p, long long i,
                                          int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float bf16_bits(unsigned bits) {
  return __uint_as_float(bits << 16);
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
  float* s_loc;  // (B, nc, dk, dv): S_loc, then S_in
  float* pw;     // (B, nc, dk): the chunks' decay products
  int t, dk, dv, nc;
  int q_bf16, k_bf16, v_bf16, w_bf16;
  // 1 where an operand's tiles are copied 16 bytes at a time (cp.async):
  // q, k, w need dk a multiple of 16 and a 16-byte aligned base, v dv a
  // multiple of cols and a 16-byte aligned base; else value by value
  int q_vec, k_vec, w_vec, v_vec;
  int chunk, dkp, cols;
  // log2 of G, dkp and cols (all powers of two)
  int groups_log2, dkp_log2, cols_log2;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Shared memory of one block: the chunk's q, k, w as float32 (chunk x dkp
// each, `f`), their raw bf16 copies where a 16-byte copy brought them
// (chunk x dkp each, `raw`), and the tile's v as it is stored (chunk x
// cols, float32 or bf16).
struct Tiles {
  float* f[3];
  unsigned short* raw[3];
  void* v;
};

// Carve `which` (q = 0, k = 1, w = 2; phase A takes k and w only) out of
// the dynamic shared memory, in the order of `tiles_bytes` on the host.
__device__ __forceinline__ Tiles carve(const Params& p, char* smem,
                                       bool with_q) {
  Tiles t{};
  const int f_bytes = p.chunk * p.dkp * 4, raw_bytes = p.chunk * p.dkp * 2;
  const int bf16[3] = {p.q_bf16 && p.q_vec, p.k_bf16 && p.k_vec,
                       p.w_bf16 && p.w_vec};
  for (int x = with_q ? 0 : 1; x < 3; ++x) {
    t.f[x] = reinterpret_cast<float*>(smem);
    smem += f_bytes;
  }
  for (int x = with_q ? 0 : 1; x < 3; ++x) {
    if (bf16[x]) {
      t.raw[x] = reinterpret_cast<unsigned short*>(smem);
      smem += raw_bytes;
    }
  }
  t.v = smem;
  return t;
}

// Start the copies of the chunk's `steps` steps of q/k/w operand `x`
// (B, T, dk) into its tile: 16-byte cp.async into f (float32) or raw (bf16)
// where the operand allows it, else value by value into f as float32
// (padding columns dk .. dkp with `pad`).  Steps from `steps` on are never
// read.
__device__ __forceinline__ void stage_qkw(const Params& p, const Tiles& t,
                                          int x, const void* src,
                                          int is_bf16, int vec,
                                          long long row, int t0, int steps,
                                          float pad) {
  const int es = is_bf16 ? 2 : 4;
  if (vec) {  // dk == dkp: the steps are one contiguous run of bytes
    const char* g =
        static_cast<const char*>(src) + (row * p.t + t0) * p.dk * es;
    char* d = is_bf16 ? reinterpret_cast<char*>(t.raw[x])
                      : reinterpret_cast<char*>(t.f[x]);
    const int n16 = steps * p.dk * es / 16;
    for (int e = threadIdx.x; e < n16; e += blockDim.x)
      cp_async16(d + 16 * e, g + 16 * e);
    return;
  }
  const int n = steps << p.dkp_log2;
#pragma unroll 4
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int s = e >> p.dkp_log2, i = e & (p.dkp - 1);
    t.f[x][e] = i < p.dk
                    ? load_any(src, (row * p.t + t0 + s) * p.dk + i, is_bf16)
                    : pad;
  }
}

// The same for the tile of v (columns c0 .. c0 + cols), kept as stored;
// columns beyond dv are 0.
__device__ __forceinline__ void stage_v(const Params& p, const Tiles& t,
                                        long long row, int t0, int steps,
                                        int c0) {
  const int es = p.v_bf16 ? 2 : 4;
  if (p.v_vec) {
    const int row_bytes = p.cols * es, per_row = row_bytes / 16;
    const char* g = static_cast<const char*>(p.v) +
                    ((row * p.t + t0) * p.dv + c0) * es;
    char* d = static_cast<char*>(t.v);
    const int n16 = steps * per_row;
    for (int e = threadIdx.x; e < n16; e += blockDim.x) {
      const int s = e / per_row, x = e - s * per_row;
      cp_async16(d + s * row_bytes + 16 * x,
                 g + (long long)s * p.dv * es + 16 * x);
    }
    return;
  }
  const int n = steps << p.cols_log2;
#pragma unroll 4
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int s = e >> p.cols_log2, j = c0 + (e & (p.cols - 1));
    const long long idx = (row * p.t + t0 + s) * p.dv + j;
    if (p.v_bf16)
      static_cast<unsigned short*>(t.v)[e] =
          j < p.dv ? static_cast<const unsigned short*>(p.v)[idx] : 0;
    else
      static_cast<float*>(t.v)[e] =
          j < p.dv ? static_cast<const float*>(p.v)[idx] : 0.0f;
  }
}

// After the copies landed: bf16 tiles copied raw become float32.
__device__ __forceinline__ void widen(const Params& p, const Tiles& t, int x,
                                      int steps) {
  if (t.raw[x] == nullptr) return;
  const int n8 = (steps << p.dkp_log2) / 8;
  const uint4* src = reinterpret_cast<const uint4*>(t.raw[x]);
  float4* dst = reinterpret_cast<float4*>(t.f[x]);
  for (int e = threadIdx.x; e < n8; e += blockDim.x) {
    const uint4 r = src[e];
    dst[2 * e] = make_float4(bf16_bits(r.x & 0xffffu), bf16_bits(r.x >> 16),
                             bf16_bits(r.y & 0xffffu), bf16_bits(r.y >> 16));
    dst[2 * e + 1] =
        make_float4(bf16_bits(r.z & 0xffffu), bf16_bits(r.z >> 16),
                    bf16_bits(r.w & 0xffffu), bf16_bits(r.w >> 16));
  }
}

// The chunk's tiles (phase A: k, w, v; phase C: q too), waited for: the
// 16-byte copies all in flight at once, then the bf16 ones widened.
template <bool kWithQ>
__device__ __forceinline__ void stage_chunk(const Params& p, const Tiles& t,
                                            long long row, int t0,
                                            int steps, int c0) {
  if (kWithQ)
    stage_qkw(p, t, 0, p.q, p.q_bf16, p.q_vec, row, t0, steps, 0.0f);
  stage_qkw(p, t, 1, p.k, p.k_bf16, p.k_vec, row, t0, steps, 0.0f);
  stage_qkw(p, t, 2, p.w, p.w_bf16, p.w_vec, row, t0, steps, 1.0f);
  stage_v(p, t, row, t0, steps, c0);
  cp_async_wait_all();
  __syncthreads();
  if (kWithQ) widen(p, t, 0, steps);
  widen(p, t, 1, steps);
  widen(p, t, 2, steps);
  __syncthreads();
}

// The tile's v at element e, as float32.
__device__ __forceinline__ float v_at(const Params& p, const Tiles& t,
                                      int e) {
  return p.v_bf16 ? bf16_bits(static_cast<const unsigned short*>(t.v)[e])
                  : static_cast<const float*>(t.v)[e];
}

// Phase A: S_loc and prod w of one (row, chunk), a tile of columns.
__global__ void __launch_bounds__(kMaxThreads)
chunk_state_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const Tiles tl = carve(p, reinterpret_cast<char*>(smem4), false);
  float* k_s = tl.f[1];  // k, then k * decay
  const float* w_s = tl.f[2];
  const long long item = blockIdx.x;  // row * nc + chunk
  const long long row = item / p.nc;
  const int t0 = (int)(item % p.nc) * p.chunk;
  const int steps = min(p.chunk, p.t - t0);
  const int c0 = blockIdx.y * p.cols;
  stage_chunk<false>(p, tl, row, t0, steps, c0);
  // k_s[s][i] *= prod_{s < r < steps} w[r][i]: a thread per state row walks
  // the chunk backwards
  for (int i = threadIdx.x; i < p.dkp; i += blockDim.x) {
    float d = 1.0f;
#pragma unroll 8
    for (int s = steps - 1; s >= 0; --s) {
      const int e = (s << p.dkp_log2) + i;
      const float ws = w_s[e];
      k_s[e] *= d;
      d *= ws;
    }
    if (blockIdx.y == 0 && i < p.dk) p.pw[item * p.dk + i] = d;
  }
  __syncthreads();

  const int tid = threadIdx.x;
  const int jl = tid >> p.groups_log2;
  const int i0 = (tid & ((1 << p.groups_log2) - 1)) * kRows;
  const int j = c0 + jl;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
#pragma unroll 4
  for (int s = 0; s < steps; ++s) {
    const float vj = v_at(p, tl, (s << p.cols_log2) + jl);
    const float* ks = k_s + (s << p.dkp_log2) + i0;
#pragma unroll
    for (int r = 0; r < kRows; r += 4) {
      const float4 a = *reinterpret_cast<const float4*>(ks + r);
      acc[r] = fmaf(a.x, vj, acc[r]);
      acc[r + 1] = fmaf(a.y, vj, acc[r + 1]);
      acc[r + 2] = fmaf(a.z, vj, acc[r + 2]);
      acc[r + 3] = fmaf(a.w, vj, acc[r + 3]);
    }
  }
  if (j < p.dv) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      if (i < p.dk) p.s_loc[(item * p.dk + i) * p.dv + j] = acc[r];
    }
  }
}

// Phase B: one thread per (row, state entry) carries the state over the
// row's chunks, loading kCarryBatch summaries ahead of the dependent chain.
__global__ void __launch_bounds__(kCarryThreads)
chunk_carry_kernel(const Params p, long long entries) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= entries) return;  // entries = B * dk * dv, e = (row dk + i) dv + j
  const long long ri = e / p.dv;
  const int i = (int)(ri % p.dk);
  const long long row = ri / p.dk;
  const long long stride = (long long)p.dk * p.dv;  // one chunk's S_loc
  float* loc = p.s_loc + row * p.nc * stride + (e - row * stride);
  const float* pw = p.pw + row * p.nc * p.dk + i;
  float s = p.s0 ? p.s0[e] : 0.0f;
  for (int c0 = 0; c0 < p.nc; c0 += kCarryBatch) {
    float l[kCarryBatch], d[kCarryBatch];
#pragma unroll
    for (int n = 0; n < kCarryBatch; ++n) {
      const bool in = c0 + n < p.nc;
      l[n] = in ? loc[(c0 + n) * stride] : 0.0f;
      d[n] = in ? pw[(long long)(c0 + n) * p.dk] : 1.0f;
    }
#pragma unroll
    for (int n = 0; n < kCarryBatch; ++n) {
      if (c0 + n < p.nc) {
        loc[(c0 + n) * stride] = s;  // S_in of chunk c0 + n
        s = d[n] * s + l[n];
      }
    }
  }
  p.s_fin[e] = s;
}

// Phase C: the outputs of one (row, chunk) by the step recurrence from
// S_in, a tile of columns.
template <bool kDecayBeforeRead, bool kOneLane>
__global__ void __launch_bounds__(kMaxThreads)
chunk_output_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const Tiles tl = carve(p, reinterpret_cast<char*>(smem4), true);
  const float* q_s = tl.f[0];
  const float* k_s = tl.f[1];
  const float* w_s = tl.f[2];
  const long long item = blockIdx.x;  // row * nc + chunk
  const long long row = item / p.nc;
  const int t0 = (int)(item % p.nc) * p.chunk;
  const int steps = min(p.chunk, p.t - t0);
  const int c0 = blockIdx.y * p.cols;
  const int tid = threadIdx.x;
  const int jl = tid >> p.groups_log2;
  const int g = tid & ((1 << p.groups_log2) - 1);
  const int i0 = g * kRows, j = c0 + jl;
  const bool live = j < p.dv;

  float st[kRows], uu[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r;
    st[r] = live && i < p.dk ? p.s_loc[(item * p.dk + i) * p.dv + j] : 0.0f;
    uu[r] = (i < p.dk && p.u) ? p.u[i] : 1.0f;
  }
  stage_chunk<true>(p, tl, row, t0, steps, c0);

  const long long o_base = (row * p.t + t0) * p.dv + j;
#pragma unroll 4
  for (int s = 0; s < steps; ++s) {
    const float vj = v_at(p, tl, (s << p.cols_log2) + jl);
    const int base = (s << p.dkp_log2) + i0;
    float qv[kRows], kv[kRows], wv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; r += 4) {
      const float4 a = *reinterpret_cast<const float4*>(q_s + base + r);
      const float4 b = *reinterpret_cast<const float4*>(k_s + base + r);
      const float4 c = *reinterpret_cast<const float4*>(w_s + base + r);
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
      for (int lane = (1 << p.groups_log2) / 2; lane >= 1; lane >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, lane);
    if (live && g == 0) {
      const long long idx = o_base + (long long)s * p.dv;
      if (p.q_bf16)
        static_cast<__nv_bfloat16*>(p.o)[idx] = __float2bfloat16(acc);
      else
        static_cast<float*>(p.o)[idx] = acc;
    }
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

struct Plan {
  int groups, dkp, cols, chunk;
};

// The layout for (dk, dv), as `chunked_plan` in kernels/linear_scan.py
// reckons it; false if dk or dv is out of range.  The chunk is the largest
// whose tiles fit kSmemBudget whatever the operands' dtypes: float32 q, k,
// w (4 dkp bytes a step each), their raw bf16 copies (2 dkp each) and v as
// float32 (4 cols).
bool make_plan(int dk, int dv, Plan* pl) {
  if (dk < 1 || dk > kMaxDk || dv < 1 || dv > 65535) return false;
  pl->groups = ceil_pow2((dk + kRows - 1) / kRows);
  pl->dkp = pl->groups * kRows;
  const int lo = 32 / pl->groups, hi = kMaxThreads / pl->groups;
  const int c = ceil_pow2(dv);
  pl->cols = c < lo ? lo : (c > hi ? hi : c);
  int chunk = kMaxChunk;
  while (chunk > 1 && chunk * (18 * pl->dkp + 4 * pl->cols) > kSmemBudget)
    chunk >>= 1;
  pl->chunk = chunk;
  return true;
}

// Bytes of the tiles `carve` lays out: float32 q (phase C only), k, w; the
// raw bf16 copies of those of them that are bf16 and copied 16 bytes at a
// time; v as stored.
int tiles_bytes(const Params& p, bool with_q) {
  int bytes = 0;
  const int bf16[3] = {p.q_bf16 && p.q_vec, p.k_bf16 && p.k_vec,
                       p.w_bf16 && p.w_vec};
  for (int x = with_q ? 0 : 1; x < 3; ++x)
    bytes += p.chunk * p.dkp * (4 + (bf16[x] ? 2 : 0));
  return bytes + p.chunk * p.cols * (p.v_bf16 ? 2 : 4);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<unsigned long long>(ptr) & 15u) == 0;
}

using OutputKernel = void (*)(Params);

OutputKernel output_kernel(int decay_before_read, bool one_lane) {
  return decay_before_read ? (one_lane ? &chunk_output_kernel<true, true>
                                       : &chunk_output_kernel<true, false>)
                           : (one_lane ? &chunk_output_kernel<false, true>
                                       : &chunk_output_kernel<false, false>);
}

// Params for (dk, dv) and the operands' dtypes, with the copy paths that
// the pointers allow.
Params make_params(const void* q, const void* k, const void* v,
                   const void* w, const float* u, const float* s0, void* o,
                   float* s_fin, float* s_loc, float* pw, int t, int dk,
                   int dv, int q_bf16, int k_bf16, int v_bf16, int w_bf16,
                   const Plan& pl) {
  const bool rows16 = dk == pl.dkp;  // then dk * 2 bytes is a multiple of 16
  Params p{q,      k,      v,      w,      u,      s0,     o,
           s_fin,  s_loc,  pw,     t,      dk,     dv,
           (t + pl.chunk - 1) / pl.chunk,
           q_bf16, k_bf16, v_bf16, w_bf16,
           rows16 && aligned16(q), rows16 && aligned16(k),
           rows16 && aligned16(w),
           dv % pl.cols == 0 && (dv * (v_bf16 ? 2 : 4)) % 16 == 0 &&
               aligned16(v),
           pl.chunk, pl.dkp, pl.cols, log2_of(pl.groups), log2_of(pl.dkp),
           log2_of(pl.cols)};
  return p;
}

}  // namespace

extern "C" {

// (o, s_final) of the recurrence on `stream`, in three launches; u and s0
// may be null.  (chunk, cols) must be the plan's for (dk, dv); s_loc and pw
// are float32 scratch of (B, ceil(T / chunk), dk, dv) and (B, ..., dk).
// Returns the cudaError_t of the launches (0 on success).
int linear_scan_chunked_launch(const void* q, const void* k, const void* v,
                               const void* w, const float* u,
                               const float* s0, void* o, float* s_fin,
                               float* s_loc, float* pw, int batch, int t,
                               int dk, int dv, int q_bf16, int k_bf16,
                               int v_bf16, int w_bf16, int decay_before_read,
                               int chunk, int cols, void* stream) {
  Plan pl;
  if (batch < 1 || t < 1 || !make_plan(dk, dv, &pl) || pl.chunk != chunk ||
      pl.cols != cols)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(q, k, v, w, u, s0, o, s_fin, s_loc, pw, t, dk,
                               dv, q_bf16, k_bf16, v_bf16, w_bf16, pl);
  if ((long long)batch * p.nc > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)(batch * p.nc),
                  (unsigned)((dv + cols - 1) / cols));
  const int threads = pl.groups * cols;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  chunk_state_kernel<<<grid, threads, tiles_bytes(p, false), s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long entries = (long long)batch * dk * dv;
  chunk_carry_kernel<<<(unsigned)((entries + kCarryThreads - 1) /
                                  kCarryThreads),
                       kCarryThreads, 0, s>>>(p, entries);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const OutputKernel outputs = output_kernel(decay_before_read,
                                             pl.groups == 1);
  outputs<<<grid, threads, tiles_bytes(p, true), s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of phase A (phase 0) or phase C (phase 1, the GLA read) that one
// SM holds at once for (dk, dv) and the operands' dtypes (16-byte copies
// assumed), from the occupancy API; -1 on an error.
int linear_scan_chunked_blocks_per_sm(int dk, int dv, int q_bf16,
                                      int k_bf16, int v_bf16, int w_bf16,
                                      int phase) {
  Plan pl;
  if (!make_plan(dk, dv, &pl)) return -1;
  // a 16-byte aligned stand-in pointer, never dereferenced
  const void* any = reinterpret_cast<const void*>(256);
  const Params p = make_params(any, any, any, any, nullptr, nullptr, nullptr,
                               nullptr, nullptr, nullptr, pl.chunk, dk, dv,
                               q_bf16, k_bf16, v_bf16, w_bf16, pl);
  int blocks = -1;
  const int threads = pl.groups * pl.cols;
  const cudaError_t err =
      phase == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &blocks, chunk_state_kernel, threads,
                       tiles_bytes(p, false))
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &blocks, output_kernel(1, pl.groups == 1), threads,
                       tiles_bytes(p, true));
  return err == cudaSuccess ? blocks : -1;
}

const char* linear_scan_chunked_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
