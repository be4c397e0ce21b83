// Flash attention forward on Hopper's tensor cores (sm_90a): the bfloat16
// instance of the port's `flash_attention`.
//
// Replaces `repro/kernels/flash_attention.py:flash_attention` (a Pallas TPU
// kernel) for bfloat16 inputs and computes what its oracle
// `repro/kernels/ref.py:mha_chunked` computes: for q (B, Hq, Sq, D), k and
// v (B, Hkv, Skv, D),
//     o[b, h, i] = sum_j softmax_j(cap(scale * q_i . k_j)) v_j
// over the keys j visible from query i, where query head h reads kv head
// h / (Hq / Hkv) (GQA), query i sits at absolute position i + Skv - Sq (the
// decode convention), causal keeps j <= that position, a window keeps
// j > position - window, and cap(x) = softcap * tanh(x / softcap).  A row
// with no visible key is 0.  o is contiguous bfloat16; the softmax
// statistics and both accumulators are float32.  The one rounding the
// plain version does not do: P is rounded to bfloat16 before P V.
//
// What bounds it: at hymba-1.5b's prefill (B=4, Hq=25, Hkv=5, S=2048,
// D=64, window 1024) the band holds 1.57M (q, k) pairs per head, 4 D
// operations each for the two products: 4.1e10 operations for 63 MB of
// I/O, so the bf16 tensor-core rate bounds it (0.041 ms at 989 TFLOP/s).
//
// Design (FlashAttention-3's shape): one block per (query tile, b, q head),
// with NC consumer warpgroups of 64 query rows each and one producer warp
// after them.  The producer's lane 0 loads the Q tile once and the K and V
// tiles of the tile's visible band into a ring of STAGES shared-memory
// stages by TMA, signalling `full_k`/`full_v` mbarriers (transaction bytes)
// and waiting on `empty` ones; TMA zero-fills rows past S and columns past
// D, which covers ragged S and the padded head dim.  Tiles are stored in
// 64-column blocks with the 128-byte swizzle that wgmma reads.  Each
// consumer warpgroup computes S = Q K^T by wgmma.m64nBNk16 (both operands
// K-major in shared memory); masks (only on tiles that cross the band's
// edge or S's end), applies scale and softcap and the online softmax on
// the float32 accumulator in registers (row statistics reduced over the 4
// lanes that share a row; the scale folded into the exponent's FMA);
// converts P to bf16 A fragments in registers; and accumulates O += P V by
// wgmma.m64nDPk16 with V from shared memory (MN-major, transposed by the
// instruction).  Both overlaps of FlashAttention-3: within a warpgroup, S
// of tile t and P V of tile t - 1 are issued together and the softmax of t
// runs while P V is in flight; between the two warpgroups, named barriers
// make them take turns at the tensor cores (ping-pong), so that one's
// softmax runs on the CUDA cores and special-function units while the
// other's products run.  The loops hold no branch around a wgmma or its
// wait: ptxas serializes every wgmma of a kernel where it cannot prove the
// accumulators untouched, which a conditional wait defeats.  Query tiles
// are launched longest first.  Instances (DP = D padded, BN = keys per tile):
//     DP  64: NC 2 (128 rows), BN 128, 3 stages, 112 KB shared memory
//     DP 128: NC 2 (128 rows), BN  64, 2 stages,  96 KB
//     DP 256: NC 1 ( 64 rows), BN  64, 2 stages, 160 KB
// The host encodes the three TMA descriptors per call with
// cuTensorMapEncodeTiled, obtained through cudaGetDriverEntryPoint (no
// -lcuda), from byte strides that the wrapper has checked (16-byte-aligned
// bases, strides multiples of 16 bytes).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
struct Tile;
template <>
struct Tile<64> {
  static constexpr int NC = 2, BN = 128, STAGES = 3;
};
template <>
struct Tile<128> {
  static constexpr int NC = 2, BN = 64, STAGES = 2;
};
template <>
struct Tile<256> {
  static constexpr int NC = 1, BN = 64, STAGES = 2;
};

template <int DP>
constexpr int smem_bytes() {
  using C = Tile<DP>;
  // 1 KB to align the base for the swizzle, the tiles, the barriers
  return 1024 + (64 * C::NC + 2 * C::STAGES * C::BN) * DP * 2 +
         8 * (1 + 3 * C::STAGES);
}

struct Params {
  void* o;
  int hq, hkv, sq, skv, d;
  int causal, window;  // window <= 0: none
  float softcap;       // <= 0: none
  float scale;
};

// --- PTX helpers ---------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.  A
// wait that never ends (a transaction count that cannot be met) traps after
// 2^35 cycles (~20 s), a launch failure instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 35)) __trap();
  }
}

// TMA: the (c0, c1, c2, c3) box of `map` into shared memory at `dst`,
// completing `bytes` of `bar`'s transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma reads or writes across the issue and the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// 2^x by the SFU (MUFU.EX2, results below 2^-126 flushed to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (64 x N, float32, the accumulator layout) += A B by one wgmma of depth
// 16.  wgmma_ss: A (64 x 16) and B (16 x N) both K-major in shared memory;
// the first call of a product passes accumulate = 0.  wgmma_rs: A from
// registers (bf16 pairs in the m16n8k16 fragment layout, one per warp's 16
// rows), B MN-major in shared memory (transpose flag 1).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// --- the steps of a consumer warpgroup ---------------------------------------
// S = Q K^T of one kv tile (K-major Q and K in 64-column blocks of 128 B
// rows; a depth-16 step is 32 B along a row), issued and committed
template <int DP, int BM, int BN>
__device__ __forceinline__ void issue_qk(float (&s)[BN / 2], uint32_t q_addr,
                                         uint32_t k_addr) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss(s,
             desc_sw128(q_addr + (kk / 4) * BM * 128 + (kk % 4) * 32, 16,
                        1024),
             desc_sw128(k_addr + (kk / 4) * BN * 128 + (kk % 4) * 32, 16,
                        1024),
             kk > 0);
  wgmma_commit();
}

// O += P V (V MN-major: 8 keys of 128 B per 1024 B, its 64-column blocks
// BN * 128 B apart), issued and committed
template <int DP, int BN>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2],
                                         uint32_t (&pa)[BN / 16][4],
                                         uint32_t v_addr) {
  fence_regs(o);
  fence_regs(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs(o, pa[kk], desc_sw128(v_addr + kk * 2048, BN * 128, 1024));
  wgmma_commit();
}

// What a warpgroup's thread needs to turn logits into probabilities: its
// two rows' query index and the tile-independent constants.
struct Rows {
  int row0;       // query index of the thread's first row (the second: +8)
  int c;          // lane % 4: columns 8 j + 2 c + {0, 1}
  int pos_lo;     // absolute position of the warpgroup's first row
  float mul;      // logit scale (softcap: scale / softcap)
  float cap;      // softcap * log2 e, or <= 0 for none
};

// Scale, softcap and mask one tile of logits (masking only where the tile
// crosses the band's edge or the end of the keys), then the online softmax
// in log2 units: s becomes P, m and l are updated, alpha is the factor O
// must be rescaled by.  Row maxima are reduced over the 4 lanes of a row;
// l is this lane's share, summed over the lanes at the end.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int k0, const Rows& w,
                                             const Params& p) {
  const int off = p.skv - p.sq;
  const bool edge = k0 + BN > p.skv ||
                    (p.causal && k0 + BN - 1 > w.pos_lo) ||
                    (p.window > 0 && k0 <= w.pos_lo + 63 - p.window);
  // each loop under a branch that is uniform across the warp, so that
  // neither tanh nor the mask is computed where it is not needed.  Without
  // softcap the scale is folded into the exponent's FMA: s stays raw and
  // `sc` takes it to log2 units
  float sc = w.mul;
  if (w.cap > 0.0f) {
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) s[j] = w.cap * tanhf(s[j] * w.mul);
    sc = 1.0f;
  } else if (w.mul <= 0.0f) {  // a scale <= 0 would turn the row max over
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) s[j] *= w.mul;
    sc = 1.0f;
  }
  if (edge) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * w.c + (e & 1);
        const int pos = w.row0 + 8 * (e >> 1) + off;
        if (key >= p.skv || (p.causal && key > pos) ||
            (p.window > 0 && key <= pos - p.window))
          s[4 * j + e] = -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * sc);
    // a row with no visible key yet keeps m = -inf and p = 0
    const float m_use = m_new == -INFINITY ? 0.0f : m_new;
    alpha[r] = exp2_approx(m[r] - m_use);
    neg_m[r] = -m_use;
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = exp2_approx(fmaf(s[4 * j + e], sc, neg_m[e >> 1]));
      s[4 * j + e] = pe;
      l[e >> 1] += pe;
    }
}

// P in bf16 as wgmma's A operand: keys 16 kk .. 16 kk + 15
template <int BN>
__device__ __forceinline__ void to_bf16(const float (&s)[BN / 2],
                                        uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

template <int DP>
__device__ __forceinline__ void rescale(float (&o)[DP / 2],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
}

// --- the kernel ------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(Tile<DP>::NC * 128 + 32, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const Params p) {
  constexpr int NC = Tile<DP>::NC, BN = Tile<DP>::BN;
  constexpr int STAGES = Tile<DP>::STAGES, BM = 64 * NC, NCB = DP / 64;
  constexpr uint32_t Q_BYTES = BM * DP * 2, KV_BYTES = BN * DP * 2;
  extern __shared__ uint8_t smem_raw[];
  // tiles at 1024-byte boundaries: the swizzle repeats every 8 rows of 128 B
  uint8_t* q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = q_s + Q_BYTES;                // [STAGES][NCB][BN][64]
  uint8_t* v_s = k_s + STAGES * KV_BYTES;      // [STAGES][NCB][BN][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + STAGES * KV_BYTES);
  uint64_t* full_k = q_full + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty = full_v + STAGES;

  const int bh = blockIdx.x, b = bh / p.hq, h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int n_qt = (p.sq + BM - 1) / BM;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * BM;  // longest tiles first
  const int off = p.skv - p.sq;  // absolute position of query row 0
  // the kv tiles that hold a key some row of this tile can see
  const int pos_lo = q0 + off, pos_hi = min(q0 + BM, p.sq) - 1 + off;
  int k_begin = 0, k_end = p.skv;
  if (p.causal) k_end = min(k_end, pos_hi + 1);
  if (p.window > 0) k_begin = max(0, pos_lo - p.window + 1);
  const int t_begin = k_begin / BN;
  const int t_end = k_end > k_begin ? (k_end + BN - 1) / BN : t_begin;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], NC * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == 4 * NC) {  // the producer warp: lane 0 issues every load
    if (threadIdx.x % 32 == 0) {
      mbar_expect_tx(q_full, Q_BYTES);
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
        tma_load(q_s + cb * BM * 128, &q_map, q_full, 64 * cb, q0, h, b);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[st], (i / STAGES - 1) & 1);
        uint8_t* k_dst = k_s + st * KV_BYTES;
        uint8_t* v_dst = v_s + st * KV_BYTES;
        mbar_expect_tx(&full_k[st], KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb)
          tma_load(k_dst + cb * BN * 128, &k_map, &full_k[st], 64 * cb,
                   t * BN, hk, b);
        mbar_expect_tx(&full_v[st], KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb)
          tma_load(v_dst + cb * BN * 128, &v_map, &full_v[st], 64 * cb,
                   t * BN, hk, b);
      }
    }
    return;
  }

  // a consumer warpgroup: query rows 64 wg .. 64 wg + 63 of the tile; this
  // thread holds rows r and r + 8 of them, and columns 8 j + 2 c + {0, 1}
  const int wg = warp / 4, tid = threadIdx.x % 128;
  Rows w;
  w.row0 = q0 + 64 * wg + 16 * (tid / 32) + (tid % 32) / 4;
  w.c = tid % 4;
  w.pos_lo = q0 + 64 * wg + off;
  // logits in log2 units: exp2(x log2 e - m) is exp(x - m / log2 e)
  w.mul = p.softcap > 0.0f ? p.scale / p.softcap : p.scale * kLog2e;
  w.cap = p.softcap > 0.0f ? p.softcap * kLog2e : 0.0f;
  const uint32_t q_addr = smem_u32(q_s) + wg * 64 * 128;
  const uint32_t k_base = smem_u32(k_s), v_base = smem_u32(v_s);

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  // Every warpgroup walks all n tiles of the block, in n + 1 turns: turn t
  // issues S of tile t and P V of tile t - 1.  With two warpgroups the
  // turns alternate (ping-pong, named barriers 1 and 2): one issues its
  // products while the other runs its softmax, so the tensor cores and the
  // special-function units work at once.  Within a warpgroup, the softmax
  // of tile t runs while P V of tile t - 1 is in flight.
  const int n = t_end - t_begin;
  auto turn_begin = [&]() {
    if constexpr (NC == 2)
      asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : "memory");
  };
  auto turn_end = [&](bool last) {
    if constexpr (NC == 2)
      if (!(last && wg == 1))  // nothing waits for the second's last turn
        asm volatile("bar.arrive %0, 256;" ::"r"(2 - wg) : "memory");
  };
  mbar_wait(q_full, 0);
  if (n > 0) {
    if constexpr (NC == 2)
      if (wg == 1) asm volatile("bar.arrive 1, 256;" ::: "memory");
    float s[BN / 2], alpha[2];
    uint32_t pa[BN / 16][4];
    turn_begin();
    mbar_wait(&full_k[0], 0);
    issue_qk<DP, BM, BN>(s, q_addr, k_base);
    turn_end(false);
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile<BN>(s, m, l, alpha, t_begin * BN, w, p);
    to_bf16<BN>(s, pa);
    for (int i = 1; i < n; ++i) {
      const int st = i % STAGES, sp = (i - 1) % STAGES;
      turn_begin();
      mbar_wait(&full_k[st], (i / STAGES) & 1);
      issue_qk<DP, BM, BN>(s, q_addr, k_base + st * KV_BYTES);
      mbar_wait(&full_v[sp], ((i - 1) / STAGES) & 1);
      issue_pv<DP, BN>(o, pa, v_base + sp * KV_BYTES);
      turn_end(false);
      wgmma_wait<1>();
      fence_regs(s);
      softmax_tile<BN>(s, m, l, alpha, (t_begin + i) * BN, w, p);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(&empty[sp]);
      rescale<DP>(o, alpha);
      to_bf16<BN>(s, pa);
    }
    const int sp = (n - 1) % STAGES;
    turn_begin();
    mbar_wait(&full_v[sp], ((n - 1) / STAGES) & 1);
    issue_pv<DP, BN>(o, pa, v_base + sp * KV_BYTES);
    turn_end(true);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive(&empty[sp]);
  }

  // o / max(l, 1e-30) in bf16, rows past Sq and columns past D dropped
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) +
                      (long long)bh * p.sq * p.d;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = w.row0 + 8 * r;
    if (row >= p.sq) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = og + (long long)row * p.d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * w.c;
      const float x0 = o[4 * j + 2 * r] * inv, x1 = o[4 * j + 2 * r + 1] * inv;
      if (col + 1 < p.d && p.d % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < p.d) orow[col] = __float2bfloat16(x0);
        if (col + 1 < p.d) orow[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// --- host side -------------------------------------------------------------
// cuTensorMapEncodeTiled's signature (CUDA 12.0), looked up at run time
// with cudaGetDriverEntryPoint so that the library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// error codes of this library beyond cudaError_t's
constexpr int kNoEncoder = 10000;      // no cuTensorMapEncodeTiled found
constexpr int kEncodeFailed = 10001;   // a descriptor was refused

// A bf16 (B, H, S, D) tensor with byte strides (sb, sh, ss) and a unit one
// along D, as a 4-d TMA map (D, S, H, B) with (64 x rows) boxes, 128-byte
// swizzle; reads past S or D give zeros.
int encode(CUtensorMap* map, const void* ptr, int batch, int heads, int seq,
           int d, long long sb, long long sh, long long ss, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)seq,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)ss, (cuuint64_t)sh,
                                 (cuuint64_t)sb};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeFailed;
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const Params& p,
           int batch, const long long* st, int block_m, int block_n,
           cudaStream_t stream) {
  constexpr int NC = Tile<DP>::NC, BN = Tile<DP>::BN, BM = 64 * NC;
  if (block_m != BM || block_n != BN || p.sq > 65535 * BM)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm;
  int rc = encode(&qm, q, batch, p.hq, p.sq, p.d, st[0], st[1], st[2], BM);
  if (rc == 0)
    rc = encode(&km, k, batch, p.hkv, p.skv > 0 ? p.skv : 1, p.d, st[3],
                st[4], st[5], BN);
  if (rc == 0)
    rc = encode(&vm, v, batch, p.hkv, p.skv > 0 ? p.skv : 1, p.d, st[6],
                st[7], st[8], BN);
  if (rc != 0) return rc;
  constexpr int bytes = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((unsigned)(batch * p.hq), (unsigned)((p.sq + BM - 1) / BM));
  flash_attention_tc_kernel<DP>
      <<<grid, NC * 128 + 32, bytes, stream>>>(qm, km, vm, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// o = attention(q, k, v) on `stream` for bf16 q, k, v with byte strides
// for the b, h and s axes of each (16-byte-aligned bases, strides multiples
// of 16 bytes, as the wrapper checks) and a contiguous bf16 o.  block_m and
// block_n must be the instance's tile (the wrapper's TC_TILES).  Returns a
// cudaError_t, or kNoEncoder / kEncodeFailed.
int flash_attention_tc_launch(const void* q, const void* k, const void* v,
                              void* o, int batch, int hq, int hkv, int sq,
                              int skv, int d, long long q_sb, long long q_sh,
                              long long q_ss, long long k_sb, long long k_sh,
                              long long k_ss, long long v_sb, long long v_sh,
                              long long v_ss, int causal, int window,
                              float softcap, float scale, int block_m,
                              int block_n, void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv || sq < 1 || skv < 0 ||
      d < 1 || d > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{o, hq, hkv, sq, skv, d, causal, window, softcap, scale};
  const long long st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh,
                           k_ss, v_sb, v_sh, v_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch<64>(q, k, v, p, batch, st, block_m, block_n, s);
  if (d <= 128) return launch<128>(q, k, v, p, batch, st, block_m, block_n, s);
  return launch<256>(q, k, v, p, batch, st, block_m, block_n, s);
}

// Dynamic shared memory of the instance that takes head dim d, in bytes
// (ptxas reports only static shared memory).
int flash_attention_tc_smem_bytes(int d) {
  if (d <= 64) return smem_bytes<64>();
  if (d <= 128) return smem_bytes<128>();
  return smem_bytes<256>();
}

const char* flash_attention_tc_error_string(int code) {
  if (code == kNoEncoder)
    return "cuTensorMapEncodeTiled not found (CUDA 12.0 or later needed)";
  if (code == kEncodeFailed)
    return "cuTensorMapEncodeTiled refused a TMA descriptor";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
