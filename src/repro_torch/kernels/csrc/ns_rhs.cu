// Fused periodic-HIT compressible Navier-Stokes RHS for NVIDIA Hopper (sm_90a).
//
// Replaces `repro/kernels/rhs.py:fused_navier_stokes_rhs` (a Pallas TPU
// kernel) and computes exactly what its oracle
// `repro/kernels/ref.py:navier_stokes_rhs_fused` computes: primitive decode ->
// BR1 gradient of (v, T) -> Smagorinsky nu_t -> per direction, Kennedy-Gruber
// split-form volume + local Lax-Friedrichs surface + BR1 viscous divergence ->
// Lundgren forcing from whole-box quadrature means.  Math is float32; u and
// the RHS are float32 or bfloat16.
//
// Layout: u (B, Kx, Ky, Kz, n, n, n, 5) contiguous, cs_nodes (B, Kx, Ky, Kz,
// n, n, n), D (n, n) and w (n,) float32, periodic in all three directions.
//
// What bounds it: at the paper's 24-DOF width (n = 6, 4^3 elements) the
// function needs about 820 float32 operations per node (chip_smoke.py
// counts them) against 44 bytes of input and output per node in float32,
// so it sits at the ridge of the H100 (67 TFLOP/s fp32 outside the tensor
// cores, 3.35 TB/s): the bytes set the bound, 7% above the operations'.
// This kernel does about 1.35e3 per node, because it recomputes each face's
// LLF flux on both sides, the neighbour's primitives and viscous flux at
// every face node, and the Kennedy-Gruber flux of each node pair twice.
// The TPU kernel kept a whole mesh resident in VMEM; a 24-DOF mesh is
// 276 KB and a 32-DOF mesh 655 KB in float32, more than the 227 KB of shared
// memory a Hopper block can use.  So the design tiles by element:
//
//   (A) grad_pass: one block per (env, element), one thread per node.  The
//       element's (v, T) sit in shared memory; neighbour face traces are read
//       from global memory (L2) with periodic wrap.  It writes the 12-wide
//       gradient and nu_t to a float32 scratch laid out (block, 13, n^3) so
//       that neighbouring threads touch neighbouring addresses, and the
//       element's quadrature partials of momentum and 1/2 rho |v|^2.
//   (B) div_pass: one block per (env, element).  Primitives and the current
//       direction's viscous flux sit in shared memory for the n-term line
//       contractions; the neighbours' face viscous flux comes from pass (A)'s
//       scratch.  Each block sums its env's K^3 partials in a fixed order, so
//       there are no atomics and the result does not change from run to run.
//
// Every intermediate except the gradient scratch stays on chip.  No wgmma or
// TMA yet: the line contractions are n <= 8 long, too short for the tensor
// cores without regrouping many lines into one tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kNMax = 8;
constexpr int kNodesMax = kNMax * kNMax * kNMax;
constexpr int kScratch = 13;  // 12 gradient entries + nu_t per node
// Gas constants rounded once from double, as the reference's Python floats are.
constexpr float kGamma = 1.4f;
constexpr float kGm1 = static_cast<float>(1.4 - 1.0);
constexpr float kRGas = 1.0f;
constexpr float kCp = static_cast<float>(1.4 * 1.0 / (1.4 - 1.0));

struct Params {
  int kx, ky, kz, n;
  float inv_w0, inv_wn, jac, delta, mu, prandtl, prandtl_turb, forcing_a0,
      k_tke;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__device__ __forceinline__ void load_state(const T* node, float s[5]) {
#pragma unroll
  for (int c = 0; c < 5; ++c) s[c] = load_f32(node + c);
}

// rho, v[3], p, T from a conservative state (ref._primitives, same op order).
__device__ __forceinline__ void primitives(const float s[5], float& rho,
                                           float v[3], float& p, float& temp) {
  rho = s[0];
  v[0] = s[1] / rho;
  v[1] = s[2] / rho;
  v[2] = s[3] / rho;
  const float kinetic = 0.5f * rho * (v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
  p = kGm1 * (s[4] - kinetic);
  temp = p / (rho * kRGas);
}

// Euler flux along d (ref._advective_flux).
__device__ __forceinline__ void advective_flux(const float s[5], int d,
                                               float f[5]) {
  float rho, v[3], p, temp;
  primitives(s, rho, v, p, temp);
  const float vn = v[d];
  f[0] = s[1 + d];
#pragma unroll
  for (int i = 0; i < 3; ++i) f[1 + i] = vn * s[1 + i];
  f[1 + d] += p;
  f[4] = (s[4] + p) * vn;
}

// Local Lax-Friedrichs flux between left and right states (ref._lax_friedrichs).
__device__ __forceinline__ void lax_friedrichs(const float sl[5],
                                               const float sr[5], int d,
                                               float f[5]) {
  float rl, vl[3], pl, tl, rr, vr[3], pr, tr;
  primitives(sl, rl, vl, pl, tl);
  primitives(sr, rr, vr, pr, tr);
  const float cl = sqrtf(kGamma * pl / rl);
  const float cr = sqrtf(kGamma * pr / rr);
  const float lam = fmaxf(fabsf(vl[d]) + cl, fabsf(vr[d]) + cr);
  float fl[5], fr[5];
  advective_flux(sl, d, fl);
  advective_flux(sr, d, fr);
#pragma unroll
  for (int c = 0; c < 5; ++c)
    f[c] = 0.5f * (fl[c] + fr[c]) - 0.5f * lam * (sr[c] - sl[c]);
}

// Channels 1..4 of the viscous + SGS flux along d (channel 0 is zero);
// g[3 * i + j] = d q_i / d x_j for q = (v1, v2, v3, T)  (ref._viscous_flux).
__device__ __forceinline__ void viscous_flux(float rho, const float v[3],
                                             const float g[12], float nu_t,
                                             int d, const Params& prm,
                                             float f[4]) {
  const float div_v = g[0] + g[4] + g[8];
  const float mu_eff = prm.mu + rho * nu_t;
  const float third = (2.0f / 3.0f) * mu_eff * div_v;
  float work = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float s_id = 0.5f * (g[3 * i + d] + g[3 * d + i]);
    float tau = 2.0f * mu_eff * s_id;
    if (i == d) tau = tau - third;
    f[i] = tau;
    work += tau * v[i];
  }
  const float k_eff =
      kCp * (prm.mu / prm.prandtl + rho * nu_t / prm.prandtl_turb);
  const float q_d = -k_eff * g[9 + d];
  f[3] = work - q_d;
}

__device__ __forceinline__ int wrap(int i, int k) {
  return i < 0 ? i + k : (i >= k ? i - k : i);
}

// Block index of the element one step along direction d (periodic).
__device__ __forceinline__ int neighbor_block(int blk, int ex, int ey, int ez,
                                              int d, int step,
                                              const Params& prm) {
  const int env = blk / (prm.kx * prm.ky * prm.kz);
  int c[3] = {ex, ey, ez};
  const int k[3] = {prm.kx, prm.ky, prm.kz};
  c[d] = wrap(c[d] + step, k[d]);
  return (env * prm.kx + c[0]) * prm.ky * prm.kz + c[1] * prm.kz + c[2];
}

struct Node {
  int t, idx[3], stride[3], blk, ex, ey, ez, n3;
};

__device__ __forceinline__ Node locate(const Params& prm) {
  Node nd;
  const int n = prm.n;
  nd.t = threadIdx.x;
  nd.n3 = n * n * n;
  nd.idx[0] = nd.t / (n * n);
  nd.idx[1] = (nd.t / n) % n;
  nd.idx[2] = nd.t % n;
  nd.stride[0] = n * n;
  nd.stride[1] = n;
  nd.stride[2] = 1;
  nd.blk = blockIdx.x;
  const int e = nd.blk % (prm.kx * prm.ky * prm.kz);
  nd.ex = e / (prm.ky * prm.kz);
  nd.ey = (e / prm.kz) % prm.ky;
  nd.ez = e % prm.kz;
  return nd;
}

// ---------------------------------------------------------------------------
// (A) gradient of (v, T), nu_t, quadrature partials
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kNodesMax)
    grad_pass(const T* __restrict__ u, const T* __restrict__ cs,
              const float* __restrict__ dmat, const float* __restrict__ wq,
              float* __restrict__ scratch, float* __restrict__ partials,
              Params prm) {
  __shared__ float s_d[kNMax * kNMax];
  __shared__ float s_q[4][kNodesMax];
  __shared__ float s_red[4][kNodesMax];
  const Node nd = locate(prm);
  const int n = prm.n, t = nd.t, n3 = nd.n3;
  if (t < n * n) s_d[t] = dmat[t];

  float s[5], rho, v[3], p, temp;
  load_state(u + ((size_t)nd.blk * n3 + t) * 5, s);
  primitives(s, rho, v, p, temp);
  s_q[0][t] = v[0];
  s_q[1][t] = v[1];
  s_q[2][t] = v[2];
  s_q[3][t] = temp;

  // quadrature partials with the reference-to-unit-mass weights w/2
  const float wt = (0.5f * wq[nd.idx[0]]) * (0.5f * wq[nd.idx[1]]) *
                   (0.5f * wq[nd.idx[2]]);
  const float ke = 0.5f * (s[1] * v[0] + s[2] * v[1] + s[3] * v[2]);
  s_red[0][t] = wt * s[1];
  s_red[1][t] = wt * s[2];
  s_red[2][t] = wt * s[3];
  s_red[3][t] = wt * ke;
  __syncthreads();
  int half = 1;
  while (half < n3) half <<= 1;
  for (half >>= 1; half > 0; half >>= 1) {  // fixed-order tree sum
    if (t < half && t + half < n3) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s_red[c][t] += s_red[c][t + half];
    }
    __syncthreads();
  }
  if (t < 4) partials[(size_t)nd.blk * 4 + t] = s_red[t][0];

  float g[12];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int id = nd.idx[d], st = nd.stride[d];
    const int t0 = t - id * st;
    float vol[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float acc = 0.0f;
      for (int m = 0; m < n; ++m) acc += s_d[id * n + m] * s_q[c][t0 + m * st];
      vol[c] = acc;
    }
    // BR1 central interface value on the element's two faces (n >= 2, so a
    // node lies on at most one face per direction)
    if (id == n - 1 || id == 0) {
      const bool right = id == n - 1;
      const int nb = neighbor_block(nd.blk, nd.ex, nd.ey, nd.ez, d,
                                    right ? 1 : -1, prm);
      const int tn = right ? t - (n - 1) * st : t + (n - 1) * st;
      float sn[5], rn, vn[3], pn, tnp;
      load_state(u + ((size_t)nb * n3 + tn) * 5, sn);
      primitives(sn, rn, vn, pn, tnp);
      const float qn[4] = {vn[0], vn[1], vn[2], tnp};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float own = s_q[c][t];
        if (right) {
          const float star = 0.5f * (own + qn[c]);
          vol[c] += prm.inv_wn * (star - own);
        } else {
          const float star = 0.5f * (qn[c] + own);
          vol[c] += -prm.inv_w0 * (star - own);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) g[3 * c + d] = vol[c] * prm.jac;
  }

  // Smagorinsky eddy viscosity (paper Eq. 3)
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float sij = 0.5f * (g[3 * i + j] + g[3 * j + i]);
      ss += sij * sij;
    }
  }
  const float cdelta = load_f32(cs + (size_t)nd.blk * n3 + t) * prm.delta;
  const float nu_t = cdelta * cdelta * sqrtf(2.0f * ss + 1e-30f);

  float* out = scratch + (size_t)nd.blk * kScratch * n3 + t;
#pragma unroll
  for (int c = 0; c < 12; ++c) out[(size_t)c * n3] = g[c];
  out[(size_t)12 * n3] = nu_t;
}

// ---------------------------------------------------------------------------
// (B) fluxes, divergence, forcing
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ void load_visc(const T* u, const float* scratch,
                                          int blk, int t, int n3, int d,
                                          const Params& prm, float s[5],
                                          float fv[4]) {
  load_state(u + ((size_t)blk * n3 + t) * 5, s);
  float rho, v[3], p, temp, g[12];
  primitives(s, rho, v, p, temp);
  const float* sc = scratch + (size_t)blk * kScratch * n3 + t;
#pragma unroll
  for (int c = 0; c < 12; ++c) g[c] = sc[(size_t)c * n3];
  viscous_flux(rho, v, g, sc[(size_t)12 * n3], d, prm, fv);
}

template <typename T>
__global__ void __launch_bounds__(kNodesMax)
    div_pass(const T* __restrict__ u, const float* __restrict__ dmat,
             const float* __restrict__ scratch,
             const float* __restrict__ partials, T* __restrict__ rhs_out,
             Params prm) {
  __shared__ float s_d[kNMax * kNMax];
  __shared__ float s_p[6][kNodesMax];  // rho, v1, v2, v3, p, E/rho
  __shared__ float s_fv[4][kNodesMax];
  __shared__ float s_mean[4];
  const Node nd = locate(prm);
  const int n = prm.n, t = nd.t, n3 = nd.n3;
  const int n_elem = prm.kx * prm.ky * prm.kz;
  if (t < n * n) s_d[t] = dmat[t];
  if (t < 4) {  // whole-box means of the env, summed in element order
    const float* part = partials + (size_t)(nd.blk / n_elem) * n_elem * 4 + t;
    float acc = 0.0f;
    for (int e = 0; e < n_elem; ++e) acc += part[(size_t)e * 4];
    s_mean[t] = acc / (float)n_elem;
  }

  float s[5], rho, v[3], p, temp, g[12];
  load_state(u + ((size_t)nd.blk * n3 + t) * 5, s);
  primitives(s, rho, v, p, temp);
  s_p[0][t] = rho;
  s_p[1][t] = v[0];
  s_p[2][t] = v[1];
  s_p[3][t] = v[2];
  s_p[4][t] = p;
  const float e_own = s[4] / rho;
  s_p[5][t] = e_own;
  const float* sc = scratch + (size_t)nd.blk * kScratch * n3 + t;
#pragma unroll
  for (int c = 0; c < 12; ++c) g[c] = sc[(size_t)c * n3];
  const float nu_t = sc[(size_t)12 * n3];

  float rhs[5];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float fv[4];
    viscous_flux(rho, v, g, nu_t, d, prm, fv);
#pragma unroll
    for (int c = 0; c < 4; ++c) s_fv[c][t] = fv[c];
    __syncthreads();

    const int id = nd.idx[d], st = nd.stride[d];
    const int t0 = t - id * st;
    // split-form volume integral with the Kennedy-Gruber two-point flux
    float va[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int m = 0; m < n; ++m) {
      const int tm = t0 + m * st;
      const float rho_m = 0.5f * (rho + s_p[0][tm]);
      const float vm[3] = {0.5f * (v[0] + s_p[1][tm]),
                           0.5f * (v[1] + s_p[2][tm]),
                           0.5f * (v[2] + s_p[3][tm])};
      const float p_m = 0.5f * (p + s_p[4][tm]);
      const float e_m = 0.5f * (e_own + s_p[5][tm]);
      const float vn = vm[d];
      const float f_rho = rho_m * vn;
      float fm[3] = {f_rho * vm[0], f_rho * vm[1], f_rho * vm[2]};
      fm[d] += p_m;
      const float f_e = f_rho * e_m + p_m * vn;
      const float dm = s_d[id * n + m];
      va[0] += dm * f_rho;
      va[1] += dm * fm[0];
      va[2] += dm * fm[1];
      va[3] += dm * fm[2];
      va[4] += dm * f_e;
    }
    float vol[5];
    vol[0] = 2.0f * va[0];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float acc = 0.0f;
      for (int m = 0; m < n; ++m) acc += s_d[id * n + m] * s_fv[c][t0 + m * st];
      vol[1 + c] = 2.0f * va[1 + c] - acc;
    }

    if (id == n - 1 || id == 0) {
      const bool right = id == n - 1;
      const int nb = neighbor_block(nd.blk, nd.ex, nd.ey, nd.ez, d,
                                    right ? 1 : -1, prm);
      const int tn = right ? t - (n - 1) * st : t + (n - 1) * st;
      float sn[5], fvn[4], f_adv[5], f_node[5];
      load_visc(u, scratch, nb, tn, n3, d, prm, sn, fvn);
      if (right) {
        lax_friedrichs(s, sn, d, f_adv);
      } else {
        lax_friedrichs(sn, s, d, f_adv);
      }
      advective_flux(s, d, f_node);
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        const float fv_own = c == 0 ? 0.0f : fv[c - 1];
        const float fv_nb = c == 0 ? 0.0f : fvn[c - 1];
        const float f_visc_star =
            right ? 0.5f * (fv_own + fv_nb) : 0.5f * (fv_nb + fv_own);
        const float f_star = f_adv[c] - f_visc_star;
        const float jump = f_star - (f_node[c] - fv_own);
        vol[c] += right ? prm.inv_wn * jump : -prm.inv_w0 * jump;
      }
    }
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float div_d = vol[c] * prm.jac;
      rhs[c] = d == 0 ? -div_d : rhs[c] - div_d;
    }
    __syncthreads();  // s_fv is rewritten for the next direction
  }

  // Lundgren linear forcing + proportional TKE controller
  const float k_now = s_mean[3];
  float ratio = prm.k_tke / fmaxf(k_now, 0.1f * prm.k_tke);
  ratio = fminf(fmaxf(ratio, 0.0f), 3.0f);
  const float a_eff = prm.forcing_a0 * ratio;
  float f_e = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float f_mom = a_eff * (s[1 + i] - s_mean[i]);
    f_e += f_mom * v[i];
    rhs[1 + i] += f_mom;
  }
  rhs[4] += f_e;

  T* out = rhs_out + ((size_t)nd.blk * n3 + t) * 5;
#pragma unroll
  for (int c = 0; c < 5; ++c) store(out + c, rhs[c]);
}

template <typename T>
int launch(const void* u, const void* cs, const float* dmat, const float* w,
           float* scratch, float* partials, void* rhs, int n_blocks,
           const Params& prm, cudaStream_t stream) {
  const dim3 grid(n_blocks), block(prm.n * prm.n * prm.n);
  grad_pass<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(cs), dmat, w, scratch,
      partials, prm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  div_pass<T><<<grid, block, 0, stream>>>(static_cast<const T*>(u), dmat,
                                          scratch, partials,
                                          static_cast<T*>(rhs), prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches both passes on `stream`; returns the cudaError_t of the launches
// (0 on success).  Scratch is (B*Kx*Ky*Kz, 13, n^3) and partials
// (B*Kx*Ky*Kz, 4), both float32, allocated by the caller.
int ns_rhs_launch(const void* u, const void* cs, const float* dmat,
                  const float* w, float* scratch, float* partials, void* rhs,
                  int batch, int kx, int ky, int kz, int n, int is_bf16,
                  float inv_w0, float inv_wn, float jac, float delta, float mu,
                  float prandtl, float prandtl_turb, float forcing_a0,
                  float k_tke, void* stream) {
  if (n < 2 || n > kNMax || batch < 1 || kx < 1 || ky < 1 || kz < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params prm{kx,    ky,  kz,      n,          inv_w0,
                   inv_wn, jac, delta,   mu,         prandtl,
                   prandtl_turb, forcing_a0, k_tke};
  const int n_blocks = batch * kx * ky * kz;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(u, cs, dmat, w, scratch, partials, rhs,
                                 n_blocks, prm, s);
  return launch<float>(u, cs, dmat, w, scratch, partials, rhs, n_blocks, prm,
                       s);
}

const char* ns_rhs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
