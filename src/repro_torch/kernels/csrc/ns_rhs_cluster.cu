// Fused periodic-HIT compressible Navier-Stokes RHS for NVIDIA Hopper
// (sm_90a): one launch per RHS call, one thread-block cluster per mesh.
//
// Replaces `repro/kernels/rhs.py:fused_navier_stokes_rhs` (a Pallas TPU
// kernel) and computes what its oracle `repro/kernels/ref.py:
// navier_stokes_rhs_fused` and the port's `navier_stokes_rhs_plain`
// compute: primitive decode -> BR1 gradient of (v, T) -> Smagorinsky nu_t
// -> per direction, Kennedy-Gruber split-form volume + local Lax-Friedrichs
// surface + BR1 viscous divergence -> Lundgren forcing from whole-box
// quadrature means.  Math is float32; u and the RHS are float32 or
// bfloat16 (converted once on load and once on store).
//
// Layout: u (B, Kx, Ky, Kz, n, n, n, 5) contiguous, cs_nodes (B, Kx, Ky, Kz,
// n, n, n), D (n, n) and w (n,) float32, periodic in all three directions.
//
// Why a cluster.  The TPU kernel kept a whole mesh in VMEM, so the face
// exchange and the box means stayed inside one kernel.  A 24-DOF mesh
// (276 KB in float32) exceeds the 227 KB of shared memory of one Hopper
// block, which is why ns_rhs.cu splits the RHS into two launches joined by
// a global scratch.  The CTAs of a thread-block cluster (up to 16 here, a
// non-portable size above 8) can read each other's shared memory
// (distributed shared memory): together they hold a whole mesh.  Each CTA
// owns a rectangular block of elements (`cluster_plan` in kernels/rhs.py
// picks the CTA grid, the threads and the shared memory: the most CTAs
// that divide the mesh, e.g. 16 CTAs of 2x2x1 elements at 24-DOF, two to
// an SM, and at 32-DOF, one to an SM), and a face between two blocks is
// read from the neighbour CTA through `cluster.map_shared_rank`.  One
// cluster per mesh, launched with cudaLaunchKernelEx; the grid is B
// clusters.
//
// Phases of the one launch, each CTA on its own nodes in shared memory:
//   0. per element of the CTA, its mesh index and the CTA and local index
//      of its six neighbours (periodic), so no later phase divides.
//   1. decode u into the primitives (rho, v, p, E/rho, T); the CTA's
//      quadrature partials of momentum and 1/2 m.v (a warp tree, then the
//      warps in order).
//   -- cluster.sync: primitives and partials visible to the cluster
//   2. the box means, each CTA summing the cluster's partials in rank
//      order: no atomics, so a call gives the same bits every time.  The
//      BR1 gradient of (v, T) line by line, the three directions at once
//      (a line's face nodes take the neighbour element's trace, from this
//      CTA or the neighbour CTA); then per node nu_t and the viscous flux
//      of the three directions, in place of its gradient.
//   -- cluster.sync: viscous fluxes visible
//   3. each face once, by the CTA of the element on its left: the LLF flux
//      and the central viscous flux, and from them the lift jumps of both
//      elements that share the face.
//   -- cluster.sync: jumps visible
//   4. per direction, one thread per line of n nodes: the split-form
//      volume term with each pair's two-point flux computed once and used
//      for both ends (D[i,m] and D[m,i]; the flux is symmetric), the
//      viscous volume term, the lifts of the line's two faces; summed into
//      the RHS in shared memory.
//   5. the Lundgren forcing from the means of the input state; the RHS is
//      stored in u's dtype.
//   -- cluster.sync: no CTA exits while another may read its memory.
//
// Neighbours come from mesh coordinates, never from "the CTA to the left":
// with one or two CTAs along an axis the neighbour across the periodic
// wrap is the CTA itself or the one on the other side, and the
// coordinates give both the right CTA and the right element.
//
// What bounds it: the function needs about 820 float32 operations per node
// at 24-DOF (chip_smoke.py's ns_rhs_operations) against 44 bytes of input
// and output per node in float32, so at the H100's 67 TFLOP/s and
// 3.35 TB/s the bytes bound it, just above the operations.  This kernel
// does about what the function needs (each pair flux once, each face
// once), reads u from device memory three times (decode, faces, forcing;
// the last two mostly from L2) and nothing else but its inputs; every
// intermediate stays in shared memory.  It is latency-bound: a CTA's
// phases are short loops over shared memory between barriers, with 8-16
// warps on an SM.  The card holds 14 clusters of 16 CTAs at once (7 at
// 32-DOF), so 16 meshes take two waves (three).  Tensor cores: the line
// contractions are n <= 8 long and the pair flux is a short nonlinear
// formula, so the CUDA cores are the right unit; no wgmma.  Registers: no
// thread holds a node's whole set of values across phases; a line of
// phase 4 keeps its n x 5 volume sums and n x 4 viscous fluxes (at most
// 72), under the 128 (n <= 6, two CTAs per SM) or 255 (n >= 7) a thread
// may use.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kNMin = 2;
constexpr int kNMax = 8;
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCtas = 16;
constexpr int kMaxSmemBytes = 232448;
// float32 values in shared memory per node and per face node
constexpr int kPrim = 7;   // rho, v1, v2, v3, p, E/rho, T
constexpr int kVisc = 12;  // viscous flux channels 1..4 of the 3 directions
constexpr int kRhs = 5;
constexpr int kJump = 10;  // lift jumps of the face's left and right element
constexpr int kTable = 10;  // ints per element: its index, 6 + 3 neighbours
// Gas constants rounded once from double, as the reference's Python floats are.
constexpr float kGamma = 1.4f;
constexpr float kGm1 = static_cast<float>(1.4 - 1.0);
constexpr float kRGas = 1.0f;
constexpr float kCp = static_cast<float>(1.4 * 1.0 / (1.4 - 1.0));

// CTAs per SM that the registers must allow at kMaxThreads threads: an
// n >= 7 mesh fills an SM's shared memory with one CTA, which may use up
// to 255 registers a thread; smaller n run 2 CTAs per SM (128 registers).
template <int N>
struct Bounds {
  static constexpr int ctas_per_sm = N >= 7 ? 1 : 2;
};

struct Params {
  int kx, ky, kz;  // elements of a mesh along x, y, z
  int px, py, pz;  // CTAs of a cluster along x, y, z
  int sx, sy, sz;  // elements of a CTA along x, y, z
  float inv_w0, inv_wn, jac, delta, mu, prandtl, prandtl_turb, forcing_a0,
      k_tke;
};

// Shared-memory floats of a CTA holding `ne` elements of n^3 nodes;
// kernels/rhs.py:cluster_plan computes the same.
__host__ __device__ constexpr int smem_floats(int n, int ne) {
  return (kPrim + kVisc + kRhs) * ne * n * n * n + 3 * kJump * ne * n * n +
         n * n + 4 * kMaxWarps + 8 + kTable * ne;
}

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

// Euler flux along d from a state and its velocity and pressure
// (ref._advective_flux).
__device__ __forceinline__ void advective_flux(const float s[5],
                                               const float v[3], float p,
                                               int d, float f[5]) {
  const float vn = v[d];
  f[0] = s[1 + d];
#pragma unroll
  for (int i = 0; i < 3; ++i) f[1 + i] = vn * s[1 + i];
  f[1 + d] += p;
  f[4] = (s[4] + p) * vn;
}

// Local Lax-Friedrichs flux between left and right states
// (ref._lax_friedrichs), and the two states' Euler fluxes.
__device__ __forceinline__ void lax_friedrichs(const float sl[5],
                                               const float sr[5], int d,
                                               float f[5], float fl[5],
                                               float fr[5]) {
  float rl, vl[3], pl, tl, rr, vr[3], pr, tr;
  primitives(sl, rl, vl, pl, tl);
  primitives(sr, rr, vr, pr, tr);
  const float cl = sqrtf(kGamma * pl / rl);
  const float cr = sqrtf(kGamma * pr / rr);
  const float lam = fmaxf(fabsf(vl[d]) + cl, fabsf(vr[d]) + cr);
  advective_flux(sl, vl, pl, d, fl);
  advective_flux(sr, vr, pr, d, fr);
#pragma unroll
  for (int c = 0; c < 5; ++c)
    f[c] = 0.5f * (fl[c] + fr[c]) - 0.5f * lam * (sr[c] - sl[c]);
}

// Channels 1..4 of the viscous + SGS flux along d (channel 0 is zero);
// g[3 * i + j] = d q_i / d x_j for q = (v1, v2, v3, T); mu_eff and k_eff
// as ref._viscous_flux computes them, once per node.
__device__ __forceinline__ void viscous_flux(const float v[3],
                                             const float g[12], float mu_eff,
                                             float k_eff, int d, float f[4]) {
  const float div_v = g[0] + g[4] + g[8];
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
  const float q_d = -k_eff * g[9 + d];
  f[3] = work - q_d;
}

// The primitives the two-point flux reads: rho, v, p, E/rho.
struct Prim {
  float rho, v[3], p, e;
};

__device__ __forceinline__ Prim load_prim(const float* s_prim, int nodes,
                                          int i) {
  Prim q;
  q.rho = s_prim[i];
  q.v[0] = s_prim[nodes + i];
  q.v[1] = s_prim[2 * nodes + i];
  q.v[2] = s_prim[3 * nodes + i];
  q.p = s_prim[4 * nodes + i];
  q.e = s_prim[5 * nodes + i];
  return q;
}

// Kennedy & Gruber kinetic-energy-preserving two-point flux along D
// (ref._kennedy_gruber); symmetric in its two states, bit for bit.
template <int D>
__device__ __forceinline__ void kennedy_gruber(const Prim& a, const Prim& b,
                                               float f[5]) {
  const float rho_m = 0.5f * (a.rho + b.rho);
  const float vm[3] = {0.5f * (a.v[0] + b.v[0]), 0.5f * (a.v[1] + b.v[1]),
                       0.5f * (a.v[2] + b.v[2])};
  const float p_m = 0.5f * (a.p + b.p);
  const float e_m = 0.5f * (a.e + b.e);
  const float vn = vm[D];
  const float f_rho = rho_m * vn;
  f[0] = f_rho;
#pragma unroll
  for (int i = 0; i < 3; ++i) f[1 + i] = f_rho * vm[i];
  f[1 + D] += p_m;
  f[4] = f_rho * e_m + p_m * vn;
}

// Where an element of the mesh lives: the cluster rank of the CTA that
// holds it, its index among that CTA's elements, its index in the mesh.
struct Owner {
  int rank, le, elem;
};

__device__ __forceinline__ Owner owner(const Params& p, const int c[3]) {
  const int ox = c[0] / p.sx, oy = c[1] / p.sy, oz = c[2] / p.sz;
  Owner w;
  w.rank = (ox * p.py + oy) * p.pz + oz;
  w.le = ((c[0] - ox * p.sx) * p.sy + (c[1] - oy * p.sy)) * p.sz +
         (c[2] - oz * p.sz);
  w.elem = (c[0] * p.ky + c[1]) * p.kz + c[2];
  return w;
}

// Per element of the CTA, looked up instead of divided out in every
// phase: its index in the mesh, the owner of each of its 6 neighbours
// packed as rank * 256 + local index (side 0: -1, side 1: +1 along d, at
// [(2 d + side) ne + le]), and the mesh index of its +1 neighbours.
struct Tables {
  const int* elem;
  const int* nb;
  const int* nb_elem;
  int ne;
  __device__ __forceinline__ int rank(int d, int side, int le) const {
    return nb[(2 * d + side) * ne + le] >> 8;
  }
  __device__ __forceinline__ int local(int d, int side, int le) const {
    return nb[(2 * d + side) * ne + le] & 255;
  }
};

// Fills the tables' entries of element `le` (mesh coordinates from the
// CTA's first element `o`), periodic wrap.
__device__ __forceinline__ void fill_tables(const Params& p, const int o[3],
                                            int le, int ne, int* elem,
                                            int* nb, int* nb_elem) {
  const int c[3] = {o[0] + le / (p.sy * p.sz), o[1] + (le / p.sz) % p.sy,
                    o[2] + le % p.sz};
  elem[le] = (c[0] * p.ky + c[1]) * p.kz + c[2];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int k = d == 0 ? p.kx : (d == 1 ? p.ky : p.kz);
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      int m[3] = {c[0], c[1], c[2]};
      m[d] = side ? (m[d] + 1 == k ? 0 : m[d] + 1)
                  : (m[d] == 0 ? k - 1 : m[d] - 1);
      const Owner w = owner(p, m);
      nb[(2 * d + side) * ne + le] = w.rank * 256 + w.le;
      if (side) nb_elem[d * ne + le] = w.elem;
    }
  }
}

// Node of an element at index `id` along D and (a, b) along the other two
// axes in their order.
template <int N, int D>
__device__ __forceinline__ int node_at(int id, int a, int b) {
  return D == 0 ? (id * N + a) * N + b
                : (D == 1 ? (a * N + id) * N + b : (a * N + b) * N + id);
}

template <int N, int D>
__host__ __device__ constexpr int stride() {
  return D == 0 ? N * N : (D == 1 ? N : 1);
}

// `p` in the shared memory of cluster rank r (this CTA's own when r == me).
__device__ __forceinline__ float* in_rank(cg::cluster_group& cl,
                                          float* p, int r, int me) {
  return r == me ? p : cl.map_shared_rank(p, r);
}

// Row of q = (v1, v2, v3, T) channel c among the primitives.
__host__ __device__ constexpr int q_row(int c) {
  return c < 3 ? 1 + c : 6;
}

// Phase 2a for direction D, line `l` of N nodes: column D of the BR1
// gradient of q = (v, T) at the line's nodes, times the jacobian, into
// rows 3 c + D of `s_g`.  The line's values are read once; its two face
// nodes take the central value with the neighbour element's trace (this
// CTA's or the neighbour CTA's, periodic).
template <int N, int D>
__device__ __forceinline__ void gradient_line(cg::cluster_group& cl,
                                              const Params& p,
                                              const Tables& tb, int me,
                                              float* s_prim, const float* s_d,
                                              float* s_g, int nodes, int l) {
  constexpr int N2 = N * N, N3 = N2 * N, st = stride<N, D>();
  const int le = l / N2, ab = l - le * N2;
  const int nd0 = node_at<N, D>(0, ab / N, ab % N);
  const int i0 = le * N3 + nd0;
  const float* q_lo = in_rank(cl, s_prim, tb.rank(D, 0, le), me);
  const float* q_hi = in_rank(cl, s_prim, tb.rank(D, 1, le), me);
  const int i_lo = tb.local(D, 0, le) * N3 + nd0 + (N - 1) * st;
  const int i_hi = tb.local(D, 1, le) * N3 + nd0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int row = q_row(c) * nodes;
    float q[N];
#pragma unroll
    for (int m = 0; m < N; ++m) q[m] = s_prim[row + i0 + m * st];
    const float qn_lo = q_lo[row + i_lo], qn_hi = q_hi[row + i_hi];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float vol = 0.0f;
#pragma unroll
      for (int m = 0; m < N; ++m) vol += s_d[i * N + m] * q[m];
      if (i == N - 1) vol += p.inv_wn * (0.5f * (q[i] + qn_hi) - q[i]);
      if (i == 0) vol += -p.inv_w0 * (0.5f * (qn_lo + q[i]) - q[i]);
      s_g[(3 * c + D) * nodes + i0 + i * st] = vol * p.jac;
    }
  }
}

// Phase 3 for direction D: every face on the right of this CTA's elements,
// once.  Jumps are stored (D, channel, face node) for the left element
// (rows 0-4) and the right element (rows 5-9).
template <int N, int D, typename T>
__device__ __forceinline__ void face_jumps(cg::cluster_group& cl,
                                           const Tables& tb, int me,
                                           const T* u,
                                           size_t env_node0, float* s_fv,
                                           float* s_jump, int nodes,
                                           int faces) {
  constexpr int N2 = N * N, N3 = N2 * N;
  for (int f = threadIdx.x; f < faces; f += blockDim.x) {
    const int le = f / N2, ab = f - le * N2;
    const int nd_l = node_at<N, D>(N - 1, ab / N, ab % N);
    const int nd_r = node_at<N, D>(0, ab / N, ab % N);
    const int nb_le = tb.local(D, 1, le);
    float sl[5], sr[5];
    load_state(u + (env_node0 + (size_t)tb.elem[le] * N3 + nd_l) * 5, sl);
    load_state(u + (env_node0 + (size_t)tb.nb_elem[D * tb.ne + le] * N3 +
                    nd_r) * 5,
               sr);
    const float* fv_nb = in_rank(cl, s_fv, tb.rank(D, 1, le), me);
    float fvl[5], fvr[5];
    fvl[0] = 0.0f;
    fvr[0] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      fvl[1 + c] = s_fv[(4 * D + c) * nodes + le * N3 + nd_l];
      fvr[1 + c] = fv_nb[(4 * D + c) * nodes + nb_le * N3 + nd_r];
    }
    float f_adv[5], fl[5], fr[5];
    lax_friedrichs(sl, sr, D, f_adv, fl, fr);
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float f_star = f_adv[c] - 0.5f * (fvl[c] + fvr[c]);
      s_jump[(kJump * D + c) * faces + f] = f_star - (fl[c] - fvl[c]);
      s_jump[(kJump * D + 5 + c) * faces + f] = f_star - (fr[c] - fvr[c]);
    }
  }
}

// Phase 4 for direction D: one thread per line of N nodes along D.
template <int N, int D>
__device__ __forceinline__ void divergence_along(
    cg::cluster_group& cl, const Params& p, const Tables& tb, int me,
    const float* s_prim, const float* s_fv, float* s_rhs, float* s_jump,
    const float* s_d, int nodes, int faces) {
  constexpr int N2 = N * N, N3 = N2 * N, st = stride<N, D>();
  for (int l = threadIdx.x; l < faces; l += blockDim.x) {
    const int le = l / N2, ab = l - le * N2;
    const int i0 = le * N3 + node_at<N, D>(0, ab / N, ab % N);
    // split form: acc[i] = sum_m D[i, m] F#(u_i, u_m), each pair once,
    // every node's terms summed in ascending m
    float acc[N][5];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int c = 0; c < 5; ++c) acc[i][c] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const Prim qi = load_prim(s_prim, nodes, i0 + i * st);
      float f[5];
      kennedy_gruber<D>(qi, qi, f);
      const float d_ii = s_d[i * N + i];
#pragma unroll
      for (int c = 0; c < 5; ++c) acc[i][c] += d_ii * f[c];
#pragma unroll
      for (int m = i + 1; m < N; ++m) {
        kennedy_gruber<D>(qi, load_prim(s_prim, nodes, i0 + m * st), f);
        const float d_im = s_d[i * N + m], d_mi = s_d[m * N + i];
#pragma unroll
        for (int c = 0; c < 5; ++c) {
          acc[i][c] += d_im * f[c];
          acc[m][c] += d_mi * f[c];
        }
      }
    }
    const float* jump_l = in_rank(cl, s_jump, tb.rank(D, 0, le), me) +
                          (kJump * D + 5) * faces + tb.local(D, 0, le) * N2 +
                          ab;
    const float* jump_r = s_jump + kJump * D * faces + l;
    float fv[4][N];  // the line's viscous fluxes along D
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int m = 0; m < N; ++m)
        fv[c][m] = s_fv[(4 * D + c) * nodes + i0 + m * st];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float d_row[N];
#pragma unroll
      for (int m = 0; m < N; ++m) d_row[m] = s_d[i * N + m];
      float vol[5];
      vol[0] = 2.0f * acc[i][0];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float visc = 0.0f;
#pragma unroll
        for (int m = 0; m < N; ++m) visc += d_row[m] * fv[c][m];
        vol[1 + c] = 2.0f * acc[i][1 + c] - visc;
      }
      if (i == N - 1) {
#pragma unroll
        for (int c = 0; c < 5; ++c) vol[c] += p.inv_wn * jump_r[c * faces];
      }
      if (i == 0) {
#pragma unroll
        for (int c = 0; c < 5; ++c) vol[c] += -p.inv_w0 * jump_l[c * faces];
      }
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        float* r = s_rhs + c * nodes + i0 + i * st;
        const float div_d = vol[c] * p.jac;
        *r = D == 0 ? -div_d : *r - div_d;
      }
    }
  }
}

template <int N, typename T>
__global__ void __launch_bounds__(kMaxThreads, Bounds<N>::ctas_per_sm)
    ns_rhs_cluster_kernel(const T* __restrict__ u, const T* __restrict__ cs,
                          const float* __restrict__ dmat,
                          const float* __restrict__ wq,
                          T* __restrict__ rhs_out, Params p) {
  constexpr int N2 = N * N, N3 = N2 * N;
  cg::cluster_group cl = cg::this_cluster();
  const int n_ctas = p.px * p.py * p.pz;
  const int me = static_cast<int>(cl.block_rank());
  const int env = blockIdx.x / n_ctas;
  const int o[3] = {(me / (p.py * p.pz)) * p.sx, ((me / p.pz) % p.py) * p.sy,
                    (me % p.pz) * p.sz};
  const int ne = p.sx * p.sy * p.sz;
  const int nodes = ne * N3, faces = ne * N2;
  const int n_elem = p.kx * p.ky * p.kz;
  const size_t env_node0 = (size_t)env * n_elem * N3;
  const int tid = threadIdx.x, nthr = blockDim.x;

  extern __shared__ float4 smem_f4[];
  float* s_prim = reinterpret_cast<float*>(smem_f4);  // [kPrim][nodes]
  float* s_fv = s_prim + kPrim * nodes;                // [3 x 4][nodes]
  float* s_rhs = s_fv + kVisc * nodes;                 // [5][nodes]
  float* s_jump = s_rhs + kRhs * nodes;                // [3 x kJump][faces]
  float* s_d = s_jump + 3 * kJump * faces;             // [N][N]
  float* s_red = s_d + N2;                             // [4][kMaxWarps]
  float* s_part = s_red + 4 * kMaxWarps;               // [4]
  float* s_mean = s_part + 4;                          // [4]
  int* s_elem = reinterpret_cast<int*>(s_mean + 4);    // [ne]
  int* s_nb = s_elem + ne;                             // [6][ne]
  int* s_nb_elem = s_nb + 6 * ne;                      // [3][ne]
  const Tables tb{s_elem, s_nb, s_nb_elem, ne};

  // --- 0. D; the element tables -----------------------------------------
  for (int i = tid; i < N2; i += nthr) s_d[i] = dmat[i];
  for (int le = tid; le < ne; le += nthr)
    fill_tables(p, o, le, ne, s_elem, s_nb, s_nb_elem);
  __syncthreads();

  // --- 1. primitives; quadrature partials with the weights w/2 ----------
  float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = tid; i < nodes; i += nthr) {
    const int le = i / N3, nd = i - le * N3;
    float s[5], rho, v[3], pr, temp;
    load_state(u + (env_node0 + (size_t)s_elem[le] * N3 + nd) * 5, s);
    primitives(s, rho, v, pr, temp);
    s_prim[i] = rho;
    s_prim[nodes + i] = v[0];
    s_prim[2 * nodes + i] = v[1];
    s_prim[3 * nodes + i] = v[2];
    s_prim[4 * nodes + i] = pr;
    s_prim[5 * nodes + i] = s[4] / rho;
    s_prim[6 * nodes + i] = temp;
    const float wt = (0.5f * wq[nd / N2]) * (0.5f * wq[(nd / N) % N]) *
                     (0.5f * wq[nd % N]);
    const float ke = 0.5f * (s[1] * v[0] + s[2] * v[1] + s[3] * v[2]);
    part[0] += wt * s[1];
    part[1] += wt * s[2];
    part[2] += wt * s[3];
    part[3] += wt * ke;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      part[c] += __shfl_down_sync(0xffffffffu, part[c], off);
  }
  if ((tid & 31) == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s_red[c * kMaxWarps + tid / 32] = part[c];
  }
  __syncthreads();
  if (tid < 4) {
    float acc = 0.0f;
    for (int w = 0; w < nthr / 32; ++w) acc += s_red[tid * kMaxWarps + w];
    s_part[tid] = acc;
  }
  cl.sync();

  // --- 2. box means; gradient, nu_t, viscous fluxes ---------------------
  if (tid < 4) {
    float acc = 0.0f;
    for (int r = 0; r < n_ctas; ++r) acc += *in_rank(cl, s_part + tid, r, me);
    s_mean[tid] = acc / static_cast<float>(n_elem);
  }
  // 2a. the gradient, line by line, the three directions at once; it
  // waits in the rows of the viscous fluxes
  for (int t = tid; t < 3 * faces; t += nthr) {
    if (t < faces)
      gradient_line<N, 0>(cl, p, tb, me, s_prim, s_d, s_fv, nodes, t);
    else if (t < 2 * faces)
      gradient_line<N, 1>(cl, p, tb, me, s_prim, s_d, s_fv, nodes, t - faces);
    else
      gradient_line<N, 2>(cl, p, tb, me, s_prim, s_d, s_fv, nodes,
                          t - 2 * faces);
  }
  __syncthreads();
  // 2b. per node: nu_t, then the viscous fluxes over its gradient
  for (int i = tid; i < nodes; i += nthr) {
    const int le = i / N3, nd = i - le * N3;
    float g[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) g[k] = s_fv[k * nodes + i];
    // Smagorinsky eddy viscosity (paper Eq. 3)
    float ss = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const float sab = 0.5f * (g[3 * a + b] + g[3 * b + a]);
        ss += sab * sab;
      }
    }
    const float cdelta =
        load_f32(cs + env_node0 + (size_t)s_elem[le] * N3 + nd) * p.delta;
    const float nu_t = cdelta * cdelta * sqrtf(2.0f * ss + 1e-30f);
    const float rho = s_prim[i];
    const float v[3] = {s_prim[nodes + i], s_prim[2 * nodes + i],
                        s_prim[3 * nodes + i]};
    const float mu_eff = p.mu + rho * nu_t;
    const float k_eff =
        kCp * (p.mu / p.prandtl + rho * nu_t / p.prandtl_turb);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float f[4];
      viscous_flux(v, g, mu_eff, k_eff, d, f);
#pragma unroll
      for (int c = 0; c < 4; ++c) s_fv[(4 * d + c) * nodes + i] = f[c];
    }
  }
  cl.sync();

  // --- 3. each face once --------------------------------------------------
  face_jumps<N, 0>(cl, tb, me, u, env_node0, s_fv, s_jump, nodes, faces);
  face_jumps<N, 1>(cl, tb, me, u, env_node0, s_fv, s_jump, nodes, faces);
  face_jumps<N, 2>(cl, tb, me, u, env_node0, s_fv, s_jump, nodes, faces);
  cl.sync();

  // --- 4. divergence, direction by direction ----------------------------
  divergence_along<N, 0>(cl, p, tb, me, s_prim, s_fv, s_rhs, s_jump, s_d,
                         nodes, faces);
  __syncthreads();  // lines of the next direction cross these nodes
  divergence_along<N, 1>(cl, p, tb, me, s_prim, s_fv, s_rhs, s_jump, s_d,
                         nodes, faces);
  __syncthreads();
  divergence_along<N, 2>(cl, p, tb, me, s_prim, s_fv, s_rhs, s_jump, s_d,
                         nodes, faces);
  __syncthreads();

  // --- 5. Lundgren linear forcing + proportional TKE controller ---------
  const float k_now = s_mean[3];
  float ratio = p.k_tke / fmaxf(k_now, 0.1f * p.k_tke);
  ratio = fminf(fmaxf(ratio, 0.0f), 3.0f);
  const float a_eff = p.forcing_a0 * ratio;
  for (int i = tid; i < nodes; i += nthr) {
    const int le = i / N3, nd = i - le * N3;
    const size_t g = env_node0 + (size_t)s_elem[le] * N3 + nd;
    float s[5], rhs[5];
    load_state(u + g * 5, s);
#pragma unroll
    for (int c = 0; c < 5; ++c) rhs[c] = s_rhs[c * nodes + i];
    float f_e = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float f_mom = a_eff * (s[1 + a] - s_mean[a]);
      f_e += f_mom * s_prim[(1 + a) * nodes + i];
      rhs[1 + a] += f_mom;
    }
    rhs[4] += f_e;
    T* out = rhs_out + g * 5;
#pragma unroll
    for (int c = 0; c < 5; ++c) store(out + c, rhs[c]);
  }
  cl.sync();  // the cluster's jumps were read from this CTA until here
}

template <typename T>
using Kernel = void (*)(const T*, const T*, const float*, const float*, T*,
                        Params);

template <typename T>
Kernel<T> kernel_for(int n) {
  switch (n) {
    case 2: return ns_rhs_cluster_kernel<2, T>;
    case 3: return ns_rhs_cluster_kernel<3, T>;
    case 4: return ns_rhs_cluster_kernel<4, T>;
    case 5: return ns_rhs_cluster_kernel<5, T>;
    case 6: return ns_rhs_cluster_kernel<6, T>;
    case 7: return ns_rhs_cluster_kernel<7, T>;
    case 8: return ns_rhs_cluster_kernel<8, T>;
    default: return nullptr;
  }
}

struct Shape {
  int batch, kx, ky, kz, n, px, py, pz, threads;
};

// Checks a plan, sets the kernel's attributes and fills its launch
// configuration (one cluster of px*py*pz CTAs per mesh); 0 or a cudaError_t.
int configure(const Shape& s, const void* kernel, cudaLaunchConfig_t& cfg,
              cudaLaunchAttribute& attr) {
  const int ctas = s.px * s.py * s.pz;
  if (kernel == nullptr || s.batch < 1 || s.kx < 1 || s.ky < 1 || s.kz < 1 ||
      s.px < 1 || s.py < 1 || s.pz < 1 || s.kx % s.px || s.ky % s.py ||
      s.kz % s.pz || ctas > kMaxCtas || s.threads < 32 ||
      s.threads > kMaxThreads || s.threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ne = (s.kx / s.px) * (s.ky / s.py) * (s.kz / s.pz);
  if (ne > 256) return static_cast<int>(cudaErrorInvalidValue);  // Tables
  const int bytes = 4 * smem_floats(s.n, ne);
  if (bytes > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(s.batch * ctas);
  cfg.blockDim = dim3(s.threads);
  cfg.dynamicSmemBytes = bytes;
  attr = cudaLaunchAttribute{};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ctas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return 0;
}

template <typename T>
int launch(const Shape& s, const Params& prm, const void* u, const void* cs,
           const float* dmat, const float* w, void* rhs,
           cudaStream_t stream) {
  const Kernel<T> kernel =
      s.n >= kNMin && s.n <= kNMax ? kernel_for<T>(s.n) : nullptr;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int rc =
      configure(s, reinterpret_cast<const void*>(kernel), cfg, attr);
  if (rc != 0) return rc;
  cfg.stream = stream;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(u), static_cast<const T*>(cs), dmat,
      w, static_cast<T*>(rhs), prm);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) of one CTA holding `ne` elements of n^3
// nodes.
int ns_rhs_cluster_smem_bytes(int n, int ne) {
  return 4 * smem_floats(n, ne);
}

// One launch on `stream`: B clusters of px*py*pz CTAs of `threads` threads;
// returns the cudaError_t of the configuration and the launch (0 on
// success).
int ns_rhs_cluster_launch(const void* u, const void* cs, const float* dmat,
                          const float* w, void* rhs, int batch, int kx,
                          int ky, int kz, int n, int px, int py, int pz,
                          int threads, int is_bf16, float inv_w0,
                          float inv_wn, float jac, float delta, float mu,
                          float prandtl, float prandtl_turb,
                          float forcing_a0, float k_tke, void* stream) {
  const Shape s{batch, kx, ky, kz, n, px, py, pz, threads};
  const Params prm{kx,
                   ky,
                   kz,
                   px,
                   py,
                   pz,
                   px > 0 ? kx / px : 0,
                   py > 0 ? ky / py : 0,
                   pz > 0 ? kz / pz : 0,
                   inv_w0,
                   inv_wn,
                   jac,
                   delta,
                   mu,
                   prandtl,
                   prandtl_turb,
                   forcing_a0,
                   k_tke};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(s, prm, u, cs, dmat, w, rhs, st);
  return launch<float>(s, prm, u, cs, dmat, w, rhs, st);
}

// How many clusters of this plan the device can hold at once
// (cudaOccupancyMaxActiveClusters) into *count; returns the cudaError_t.
int ns_rhs_cluster_max_active_clusters(int kx, int ky, int kz, int n, int px,
                                       int py, int pz, int threads,
                                       int is_bf16, int* count) {
  const Shape s{1, kx, ky, kz, n, px, py, pz, threads};
  const void* kernel = nullptr;
  if (n >= kNMin && n <= kNMax)
    kernel = is_bf16
                 ? reinterpret_cast<const void*>(kernel_for<__nv_bfloat16>(n))
                 : reinterpret_cast<const void*>(kernel_for<float>(n));
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int rc = configure(s, kernel, cfg, attr);
  if (rc != 0) return rc;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(count, kernel, &cfg));
}

const char* ns_rhs_cluster_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
