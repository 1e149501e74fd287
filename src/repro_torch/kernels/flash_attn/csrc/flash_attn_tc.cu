// Flash-attention forward (prefill), bf16, on Hopper's tensor cores (sm_90a): K4.
//
// Replaces the Pallas TPU kernel of the JAX reference,
// src/repro/kernels/flash_attn/flash_attn.py: _kernel (via
// flash_attention_pallas).  For batch row b, query head h (KV head h / G)
// and query position i:
//
//   s[i, j]   = q[b, i, h] . k[b, j, h/G]                      fp32 sums
//   s[i, j]   = -1e30 where j >= Sk, or j > i when causal
//   out[b, i, h] = sum_j softmax_j(scale * s[i, :])[j] * v[b, j, h/G]
//
// as an online softmax over tiles of BK keys (running max m, denominator l,
// numerator acc in fp32), finalised as acc / max(l, 1e-30) and stored in
// bf16, as the Pallas kernel does.  Differences, all far inside the bf16
// gate of 3e-2: scale * log2(e) is fused into exp2's argument on the fp32
// scores, p = exp2(fma(s, scale log2(e), -m)) (the Pallas kernel scales q
// first), exp2 flushes a result below 2^-126 to zero (ex2 below), and the
// probabilities P are rounded to bf16 before P.V (the JAX package's
// blocked path offers the same with ModelConfig.flash_p_dtype).  l sums
// the fp32 probabilities.
//
// What bounds it on an H100: operations.  At yi-9b's prefill (B = 1,
// S = 4096, 32 query heads, d = 128, causal) the work is 137 GFLOP, 0.139 ms
// at the bf16 tensor-core peak of 989 TFLOP/s.  Beside the products, every
// score takes an exp2 on the SM's MUFU units (16 a clock): at d = 128 a key
// tile's softmax costs a warpgroup about half the tensor-core time of its two
// products, so run in series with them it caps the kernel near two thirds of
// the peak before any wait.  The schedule below hides it under the products.
// What the design does:
//
// * Both products run on the tensor cores with wgmma (bf16 in, fp32
//   accumulated).  S = Q.K^T reads Q and the K tile from shared memory; K's
//   rows are contiguous in d, so it is the K-major B operand as it lies.
//   O += P.V takes P from registers: the S accumulator, exponentiated and
//   cast to bf16, already has the layout of wgmma's A fragment.  V is the B
//   operand with the transpose bit (its tile is MN-major).
// * Key tiles of BK = 128 for d <= 128: S is one m64n128k16 a 16 columns of
//   d, and P.V one m64n128k16 (d 80, 128) or m64n64k16 (d 32, 64) a 16 keys,
//   so each key costs half the mbarrier round trips and online-softmax
//   rescales of 64-key tiles.  d = 160 and 256 keep BK = 64 (P.V in chunks
//   of 64 columns): their O (80 and 128 registers a thread) leaves no room
//   for a 128-key S beside it.  Cfg<D, DV> sets both, the tile from v's
//   head dim DV (= D but below).
// * Q, K and V arrive by TMA (cp.async.bulk.tensor, 4-D maps over
//   (d, heads, positions, batch) encoded on the host each call), with the
//   128-byte swizzle that the wgmma descriptors name.  A box is 64 columns
//   wide, so a row of d > 64 is loaded as ceil(d / 64) boxes; columns past
//   d are zero-filled by TMA: they add nothing to Q.K^T, and those columns
//   of P.V are never stored.  This is how d = 32, 80 and 160 are handled.
// * Warp specialisation: one producer warp (its warpgroup drops to 24
//   registers with setmaxnreg) keeps two rings in flight, K tiles and V
//   tiles (3 each at d = 128), each slot with a full and an empty mbarrier,
//   so S can start before V lands and a K slot is refilled as soon as its
//   S has retired; two consumer warpgroups (240 registers) own 64 query
//   rows each, BQ = 128 rows a block.
// * The consumers' schedule, FlashAttention-3's (Shah et al. 2024,
//   arXiv:2407.08608, sections 3.1-3.2):
//   - Inside a warpgroup, tile t's S = Q.K_t^T and tile t-1's O += P.V_{t-1}
//     are issued back to back as two wgmma groups, O rescaled between them.
//     The warpgroup waits for the first group alone, releases K_t's slot,
//     runs tile t's mask, max and exp2 while P.V_{t-1} is in flight, and
//     waits for that group only before P's registers are rewritten; then
//     V_{t-1}'s slot is released.  No slot is released before the wgmma
//     group that read it has retired.
//   - Between the warpgroups (d <= 128), two named barriers (ids 1 and 2,
//     beside __syncthreads' 0) take turns: a warpgroup issues its products
//     between bar.sync on its own barrier and bar.arrive on the other's, so
//     the two warpgroups' products reach the tensor cores alternately and
//     one warpgroup's softmax runs under the other's products.  Warpgroup 1
//     arrives once at the start, so warpgroup 0 leads.  Each warpgroup takes
//     one turn a key tile of the block, also on a tile it skips, so the
//     turns pair up whatever each computes.  At d = 160 and 256 a 64-key
//     tile's softmax is small beside its products and the turns would only
//     delay the issue, so there the warpgroups issue freely (FA3's tile
//     table makes the same choice).
//   - O's rescale is left out where no row of a warp has a new max: alpha
//     is then exactly 1, so no bit changes.
//   The sums are the serial schedule's, in the same order, at the tile
//   Cfg<D, DV> sets.  What bounds the schedule: a warpgroup's softmax takes
//   about as long as the other warpgroup's products, so the overlap leaves
//   little slack; a q tile's first S and last P.V are not overlapped; and
//   every block reads its K and V tiles from L2 (with no loads the causal
//   call at S = 32768 ran ~12% faster).
// * GQA reads KV head h / G through the tensor map; nothing is copied.
// * Causal: the key loop ends at the q tile's diagonal, a warpgroup skips
//   the tiles wholly above its own rows, and only the diagonal tile and a
//   ragged last tile are masked.  The q tiles are launched longest first
//   (the grid's q-tile index counts down the diagonal), so the long blocks
//   do not finish last.  Skipping is exact: a skipped tile would give p = 0, alpha = 1.
// * Ragged edges: rows past Sq are zero-filled on load and not stored; keys
//   past Sk score -1e30.
// * Sliding window (window > 0, causal): query i keeps the keys
//   i - window < j <= i.  A q tile's key loop starts at the tile holding
//   key q0 - window + 1, in the producer and the consumers alike, a
//   warpgroup skips the tiles wholly below its rows' windows, and only the
//   tiles that cross a row's lower edge are masked there.  So a window of
//   128 reads 2 key tiles a q tile at d <= 128, whatever Sq.  The windowed
//   instances are kernels of their own, flash_attn_tc_window_kernel<D>, so
//   a device trace tells them apart; window == 0 launches
//   flash_attn_tc_kernel<D>, whose code is the body's with the window
//   compiled out.
// * A narrower V (DV < D): latent attention's heads (DeepSeek-V3's MLA)
//   attend at d = 192 (128 nope + 64 rope dims) and give a 128-wide V, as
//   FlashAttention-3's 192/128 instance does.  Cfg<D, DV> sizes Q, the K
//   ring and S by D, and the V ring, O and the P.V instructions by DV, so
//   P.V does DV's work and the output is DV wide: V is never padded to D.
//   The key tile follows O's registers (DV): 128 keys at 192/128, with two
//   stages a ring (Q 48 KB, a K tile 48 KB, a V tile 32 KB); the warpgroups
//   issue freely, as at d > 128.  Its heads share no K/V (latent attention
//   expands a K and a V per head), so the grid runs q tiles fastest: the
//   blocks resident together are one head's q tiles and read one head's K/V
//   out of L2, where head-fastest blocks would each stream another head's
//   from HBM.  On an H100 at S 32768 and 128 heads: 71.1 ms, 110.6
//   head-fastest, 81.8 with 64-key tiles in four stages; with the
//   warpgroups' turns 66.3, not yet checked at those sizes against the
//   plain version.  flash_attn_tc_dv_kernel<D, DV>, a name of its own in a
//   device trace, has no window.
// Left for later: persistent blocks (a q tile's epilogue under the next
// one's loads), clusters (one K/V load multicast to neighbouring q tiles),
// and a window design of its own (several q tiles sharing one K/V read).
//
// Layouts: q (B, Sq, Hq, d), k (B, Sk, Hkv, d), v (B, Sk, Hkv, dv), out
// (B, Sq, Hq, dv), contiguous, bf16, 16-byte aligned.  d = dv in {32, 64,
// 80, 128, 160, 256}, or d 192 with dv 128, one instantiation each.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int BQ = 128;       // query rows a block: two consumer warpgroups of 64
constexpr int CONSUMERS = 2;  // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int SMEM_LIMIT = 232448;
constexpr float NEG = -1e30f;

// error codes of this file, above cudaError_t's range
constexpr int ERR_NO_ENCODER = 10000;
constexpr int ERR_ENCODE = 10001;  // + the CUresult
constexpr int ERR_HEAD_DIM = 20001;
constexpr int ERR_WINDOW = 20002;  // a window without the causal mask
constexpr int ERR_DV_WINDOW = 20003;  // a window with a narrower v

template <int D, int DV = D>
struct Cfg {
  static constexpr int DC = (D + 63) / 64;           // 64-column chunks (boxes) of a q/k row
  static constexpr int DCV = (DV + 63) / 64;         // and of a v row
  static constexpr int BK = DV <= 128 ? 128 : 64;    // keys a tile
  static constexpr int ON = DCV <= 2 ? 64 * DCV : 64; // columns of O a P.V instruction
  static constexpr int OC = 64 * DCV / ON;           // P.V instructions a 16-key step
  static constexpr bool PINGPONG = D <= 128;         // the warpgroups take turns (see above)
  static constexpr bool Q_MAJOR = DV != D;           // the grid's q tiles fastest (see above)
  static constexpr int Q_BYTES = BQ * 128 * DC;      // chunk c: BQ rows of 128 bytes
  static constexpr int K_BYTES = BK * 128 * DC;      // a tile of K
  static constexpr int V_BYTES = BK * 128 * DCV;     // a tile of V
  static constexpr int FIT = (SMEM_LIMIT - 1024 - 256 - Q_BYTES) / (K_BYTES + V_BYTES);
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;   // tiles in each of the K and V rings
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * (K_BYTES + V_BYTES) + 256;
  static_assert(STAGES >= 2, "the K and V rings need two stages each");
  static_assert(DV <= D, "v is at most as wide as q and k");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// exp2 in its flush-to-zero form: one MUFU instruction, where exp2f adds
// three for a subnormal result.  A probability below 2^-126 of its row's
// max becomes 0: it could add nothing to l >= 1 anyway, and in P.V
// nothing beside the max's own term of at least 2^126 times its size.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.  K-major
// operands: sbo = the stride of 8-row groups (lbo unused).  MN-major (V): lbo =
// the stride of 64-column atoms along N, sbo = the stride of 8-key groups.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups are in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator or A-fragment reads or writes
// across the asynchronous wgmma boundary.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define WG_D32                                                                                  \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),           \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),   \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),             \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),             \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define WG_D64                                                                                  \
  WG_D32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),         \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),             \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),             \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),             \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),             \
      "+f"(d[62]), "+f"(d[63])

#define WG_REGS32                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

#define WG_REGS64                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 2R, fp32) (+)= A (64 x 16, shared, K-major) . B (16 x 2R, shared, K-major)
template <int R>
__device__ __forceinline__ void wgmma_ss(float (&d)[R], uint64_t da, uint64_t db, int accumulate) {
  static_assert(R == 32 || R == 64, "n64 or n128");
  if constexpr (R == 32) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
        ", %32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : WG_D32
        : "l"(da), "l"(db), "r"(accumulate));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS64
        ", %64, %65, p, 1, 1, 0, 0;\n"
        "}\n"
        : WG_D64
        : "l"(da), "l"(db), "r"(accumulate));
  }
}

// d (64 x 2R, fp32) += A (64 x 16, bf16 registers) . B (16 x 2R, shared, MN-major)
template <int R>
__device__ __forceinline__ void wgmma_rs(float (&d)[R], const uint32_t (&a)[4], uint64_t db) {
  static_assert(R == 32 || R == 64, "n64 or n128");
  if constexpr (R == 32) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
        "}\n"
        : WG_D32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
        "}\n"
        : WG_D64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One consumer warpgroup: its registers (O, S, P, the running max m, the
// sums l, O's pending rescale alpha) and its steps on a key tile.  Every
// member inlines, so the arrays stay in registers.
template <int D, int DV, bool WINDOW>
struct Consumer {
  using C = Cfg<D, DV>;
  static constexpr int BK = C::BK;
  float o[C::OC][C::ON / 2];
  float sc[BK / 2];         // S of one tile; wgmma's first step of a tile overwrites it
  uint32_t pa[BK / 16][4];  // P in bf16, as wgmma's A fragments: step kk holds keys 16 kk ..
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // m in log2 units; l this thread's part
  float a0 = 1.f, a1 = 1.f;  // O's rescale from the newest tile's softmax
  uint32_t q_s, ring, bars;
  int t_lo, wg, row_lo, r0, cl, Sk, causal, window;
  float scale_log2;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int c = 0; c < C::OC; ++c)
#pragma unroll
      for (int i = 0; i < C::ON / 2; ++i) o[c][i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
  }

  // tile t's slot in the K and V rings
  __device__ __forceinline__ int slot(int t) const { return (t - t_lo) % C::STAGES; }
  // mbarriers from bars: full_k, full_v, empty_k, empty_v, STAGES each
  __device__ __forceinline__ uint32_t bar(int which, int t) const {
    return bars + 8 * (which * C::STAGES + slot(t));
  }
  __device__ __forceinline__ uint32_t parity(int t) const {
    return ((t - t_lo) / C::STAGES) & 1;
  }
  __device__ __forceinline__ void wait_k(int t) const { mbar_wait(bar(0, t), parity(t)); }
  __device__ __forceinline__ void wait_v(int t) const { mbar_wait(bar(1, t), parity(t)); }
  __device__ __forceinline__ void release_k(int t) const { mbar_arrive(bar(2, t)); }
  __device__ __forceinline__ void release_v(int t) const { mbar_arrive(bar(3, t)); }

  // The warpgroups' turns at the tensor cores (d <= 128): warpgroup wg
  // issues between turn_wait (bar.sync on its own named barrier) and
  // turn_pass (bar.arrive on the other's); each barrier counts one
  // warpgroup's bar.sync and the other's bar.arrive.
  __device__ __forceinline__ void turn_wait() const {
    if constexpr (C::PINGPONG) asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
  }
  __device__ __forceinline__ void turn_pass() const {
    if constexpr (C::PINGPONG) asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
  }

  // a tile this warpgroup skips: its turn at the tensor cores, no products
  __device__ __forceinline__ void pass_tile(int t) const {
    wait_k(t);
    wait_v(t);
    turn_wait();
    turn_pass();
    release_k(t);
    release_v(t);
  }

  // S = Q . K_t^T over the DC chunks of d, 16 columns a step: one wgmma group
  __device__ __forceinline__ void issue_s(int t) {
    const uint32_t k_s = ring + slot(t) * C::K_BYTES;
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int c = 0; c < C::DC; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(sc, smem_desc(q_s + c * BQ * 128 + wg * 64 * 128 + kk * 32, 16, 1024),
                 smem_desc(k_s + c * BK * 128 + kk * 32, 16, 1024), (c | kk) != 0);
    wg_commit();
  }

  // O = alpha O + P . V_t: V's 8-key groups are 1024 bytes apart, 16 keys a
  // step, its 64-column chunks BK x 128 bytes apart.  One wgmma group.
  // Where no row of the warp has a new max, alpha is exactly 1 and the
  // rescale changes no bit: it is left out.
  __device__ __forceinline__ void issue_pv(int t) {
    const uint32_t v_s = ring + C::STAGES * C::K_BYTES + slot(t) * C::V_BYTES;
    const bool rescale = __any_sync(0xffffffffu, a0 != 1.f || a1 != 1.f);
#pragma unroll
    for (int c = 0; c < C::OC; ++c) {
      if (rescale) {
#pragma unroll
        for (int j = 0; j < C::ON / 8; ++j) {
          o[c][4 * j] *= a0;
          o[c][4 * j + 1] *= a0;
          o[c][4 * j + 2] *= a1;
          o[c][4 * j + 3] *= a1;
        }
      }
      fence_regs(o[c]);
    }
    fence_regs(pa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < C::OC; ++c)
        wgmma_rs(o[c], pa[kk], smem_desc(v_s + c * BK * 128 + kk * 2048, BK * 128, 1024));
    wg_commit();
  }

  // Tile t's softmax on its finished S: mask the diagonal tile, a ragged
  // last tile and (WINDOW) the tiles crossing a row's lower edge to -inf;
  // the new max in log2 units (the row's max score times scale log2(e)),
  // O's rescale, p = exp2(s scale log2(e) - m) with the scale fused into
  // the argument (one rounding), l.  A row with no key yet keeps m = NEG,
  // p = 0 and alpha = 1.
  __device__ __forceinline__ void softmax(int t) {
    fence_regs(sc);
    const int k0 = t * BK;
    const bool mask = k0 + BK > Sk || (causal && k0 + BK - 1 > row_lo) ||
                      (WINDOW && k0 < row_lo + 64 - window);
    if (mask) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + cl + e;
          if (col >= Sk || (causal && col > r0) || (WINDOW && col <= r0 - window))
            sc[4 * j + e] = -INFINITY;
          if (col >= Sk || (causal && col > r0 + 8) || (WINDOW && col <= r0 + 8 - window))
            sc[4 * j + 2 + e] = -INFINITY;
        }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0) * scale_log2);
    const float mn1 = fmaxf(m1, quad_max(mx1) * scale_log2);
    a0 = ex2(m0 - mn0);
    a1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2, -mn0));
      sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, -mn0));
      sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, -mn1));
      sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, -mn1));
      s0 += sc[4 * j] + sc[4 * j + 1];
      s1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * a0 + s0;
    l1 = l1 * a1 + s1;
  }

  // P in bf16, once the P.V group that read the last P has retired
  __device__ __forceinline__ void to_p() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  }

  // after wait_group 0: O and P are the thread's again
  __device__ __forceinline__ void retired() {
#pragma unroll
    for (int c = 0; c < C::OC; ++c) fence_regs(o[c]);
    fence_regs(pa);
  }

  // The tiles [ta, tb) of the block's [t_lo, n_tiles), FlashAttention-3's
  // schedule: S_t and P.V_{t-1} issued in one turn, tile t's softmax under
  // P.V_{t-1} and the other warpgroup's products.  One turn a tile.  K_t is
  // released once S_t has retired, V_t once P.V_t has.
  __device__ __forceinline__ void run(int ta, int tb, int n_tiles) {
    if (C::PINGPONG && wg == 1) turn_pass();  // warpgroup 0 takes the first turn
    for (int t = t_lo; t < ta; ++t) pass_tile(t);
    if (ta < tb) {
      wait_k(ta);
      turn_wait();
      issue_s(ta);
      turn_pass();
      wg_wait<0>();
      release_k(ta);
      softmax(ta);
      to_p();
      for (int t = ta + 1; t < tb; ++t) {
        wait_k(t);
        wait_v(t - 1);
        turn_wait();
        issue_s(t);
        issue_pv(t - 1);
        turn_pass();
        wg_wait<1>();  // S_t is done; P.V_{t-1} may still run
        release_k(t);
        softmax(t);
        wg_wait<0>();
        retired();
        release_v(t - 1);
        to_p();
      }
      wait_v(tb - 1);
      issue_pv(tb - 1);
      wg_wait<0>();
      retired();
      release_v(tb - 1);
    }
    for (int t = tb; t < n_tiles; ++t) pass_tile(t);
  }
};

// Shared memory, from a 1024-byte aligned base: Q (DC chunks of BQ x 128 B)
// | the K ring, STAGES x (DC chunks of BK x 128 B) | the V ring, STAGES x
// (DCV chunks of BK x 128 B) | mbarriers full_k[STAGES], full_v[STAGES],
// empty_k[STAGES], empty_v[STAGES], q.
// The kernels' body; WINDOW compiles the sliding window in (window > 0).
template <int D, int DV, bool WINDOW>
__device__ __forceinline__ void attend(const CUtensorMap* qmap, const CUtensorMap* kmap,
                                       const CUtensorMap* vmap, __nv_bfloat16* __restrict__ out,
                                       int Sq, int Sk, int Hq, int G, int causal, int window,
                                       float scale_log2, int n_qtiles) {
  using C = Cfg<D, DV>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t ring = base + C::Q_BYTES;
  const uint32_t bars = ring + C::STAGES * (C::K_BYTES + C::V_BYTES);
  const uint32_t q_bar = bars + 32 * C::STAGES;

  const int hq = C::Q_MAJOR ? blockIdx.z : blockIdx.x, b = blockIdx.y;
  const int zq = C::Q_MAJOR ? blockIdx.x : blockIdx.z;
  const int qt = causal ? n_qtiles - 1 - zq : zq;
  const int q0 = qt * BQ;
  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int n_tiles = (kv_end + BK - 1) / BK;
  const int t_lo = WINDOW ? max(0, q0 - window + 1) / BK : 0;  // the first key tile
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * C::STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);  // full_k, full_v: the producer's arrival
      mbar_init(bars + 8 * (2 * C::STAGES + s), CONSUMERS * 128);  // empty: every consumer thread
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread keeps the K/V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      const int hk = hq / G;
      mbar_expect_tx(q_bar, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::DC; ++c)
        tma_load_4d(q_s + c * BQ * 128, qmap, q_bar, 64 * c, hq, q0, b);
      for (int t = t_lo; t < n_tiles; ++t) {
        const int s = (t - t_lo) % C::STAGES;
        const uint32_t lap = (t - t_lo) / C::STAGES;
        const uint32_t full_k = bars + 8 * s, full_v = bars + 8 * (C::STAGES + s);
        const uint32_t k_s = ring + s * C::K_BYTES;
        const uint32_t v_s = ring + C::STAGES * C::K_BYTES + s * C::V_BYTES;
        if (lap > 0) mbar_wait(bars + 8 * (2 * C::STAGES + s), (lap - 1) & 1);
        mbar_expect_tx(full_k, C::K_BYTES);
#pragma unroll
        for (int c = 0; c < C::DC; ++c)
          tma_load_4d(k_s + c * BK * 128, kmap, full_k, 64 * c, hk, t * BK, b);
        if (lap > 0) mbar_wait(bars + 8 * (3 * C::STAGES + s), (lap - 1) & 1);
        mbar_expect_tx(full_v, C::V_BYTES);
#pragma unroll
        for (int c = 0; c < C::DCV; ++c)
          tma_load_4d(v_s + c * BK * 128, vmap, full_v, 64 * c, hk, t * BK, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    Consumer<D, DV, WINDOW> w;
    w.init();
    w.q_s = q_s;
    w.ring = ring;
    w.bars = bars;
    w.t_lo = t_lo;
    w.wg = wg;
    w.row_lo = q0 + wg * 64;
    w.r0 = w.row_lo + warp * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
    w.cl = 2 * (lane % 4);                   // and columns cl, cl + 1 of each 8
    w.Sk = Sk;
    w.causal = causal;
    w.window = window;
    w.scale_log2 = scale_log2;
    // the tiles this warpgroup computes: the others lie wholly above its
    // rows' diagonal or below their windows
    const int tb = causal ? min(n_tiles, (w.row_lo + 63) / BK + 1) : n_tiles;
    const int ta = min(WINDOW ? max(t_lo, max(0, w.row_lo - window + 1) / BK) : t_lo, tb);

    mbar_wait(q_bar, 0);
    w.run(ta, tb, n_tiles);

    const float den0 = fmaxf(quad_sum(w.l0), 1e-30f), den1 = fmaxf(quad_sum(w.l1), 1e-30f);
    const int64_t row_stride = (int64_t)Hq * DV;
    __nv_bfloat16* ob = out + ((int64_t)b * Sq) * row_stride + (int64_t)hq * DV;
    const int r0 = w.r0;
#pragma unroll
    for (int c = 0; c < C::OC; ++c)
#pragma unroll
      for (int j = 0; j < C::ON / 8; ++j) {
        const int col = C::ON * c + 8 * j + w.cl;  // DV is even, so col < DV covers col + 1
        if (col < DV) {
          if (r0 < Sq)
            *reinterpret_cast<__nv_bfloat162*>(ob + r0 * row_stride + col) =
                __floats2bfloat162_rn(w.o[c][4 * j] / den0, w.o[c][4 * j + 1] / den0);
          if (r0 + 8 < Sq)
            *reinterpret_cast<__nv_bfloat162*>(ob + (r0 + 8) * row_stride + col) =
                __floats2bfloat162_rn(w.o[c][4 * j + 2] / den1, w.o[c][4 * j + 3] / den1);
        }
      }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                     int Sq, int Sk, int Hq, int G, int causal, float scale_log2, int n_qtiles) {
  attend<D, D, false>(&qmap, &kmap, &vmap, out, Sq, Sk, Hq, G, causal, 0, scale_log2, n_qtiles);
}

// causal attention through a sliding window of ``window`` keys
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_tc_window_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            __nv_bfloat16* __restrict__ out, int Sq, int Sk, int Hq, int G,
                            int window, float scale_log2, int n_qtiles) {
  attend<D, D, true>(&qmap, &kmap, &vmap, out, Sq, Sk, Hq, G, 1, window, scale_log2, n_qtiles);
}

// a V narrower than Q and K (DV < D), no window
template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_tc_dv_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                        int Sq, int Sk, int Hq, int G, int causal, float scale_log2,
                        int n_qtiles) {
  attend<D, DV, false>(&qmap, &kmap, &vmap, out, Sq, Sk, Hq, G, causal, 0, scale_log2, n_qtiles);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A 4-D map over a contiguous (n, s, h, d) bf16 tensor, innermost first, with
// boxes of 64 columns x 1 head x ``rows`` positions x 1 batch row.
int make_map(CUtensorMap* map, const void* ptr, int n, int s, int h, int d, int rows) {
  EncodeTiled enc = encoder();
  if (!enc) return ERR_NO_ENCODER;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)s, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)h * d * 2,
                                 (cuuint64_t)s * h * d * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                   strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

template <int D, int DV = D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
           int Hq, int Hkv, int causal, int window, float scale, cudaStream_t stream) {
  using C = Cfg<D, DV>;
  if (window > 0 && !causal) return ERR_WINDOW;
  if (DV != D && window > 0) return ERR_DV_WINDOW;
  CUtensorMap qm, km, vm;
  int err = make_map(&qm, q, B, Sq, Hq, D, BQ);
  if (!err) err = make_map(&km, k, B, Sk, Hkv, D, C::BK);
  if (!err) err = make_map(&vm, v, B, Sk, Hkv, DV, C::BK);
  if (err) return err;
  const void* fn;  // only the kernels of this (D, DV) are instantiated
  if constexpr (DV != D)
    fn = (const void*)flash_attn_tc_dv_kernel<D, DV>;
  else
    fn = window > 0 ? (const void*)flash_attn_tc_window_kernel<D>
                    : (const void*)flash_attn_tc_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int n_qtiles = (Sq + BQ - 1) / BQ;
  const dim3 grid = C::Q_MAJOR ? dim3(n_qtiles, B, Hq) : dim3(Hq, B, n_qtiles);
  const float scale_log2 = scale * 1.4426950408889634f;
  if constexpr (DV != D)
    flash_attn_tc_dv_kernel<D, DV><<<grid, THREADS, C::SMEM, stream>>>(
        qm, km, vm, (__nv_bfloat16*)out, Sq, Sk, Hq, Hq / Hkv, causal, scale_log2, n_qtiles);
  else if (window > 0)
    flash_attn_tc_window_kernel<D><<<grid, THREADS, C::SMEM, stream>>>(
        qm, km, vm, (__nv_bfloat16*)out, Sq, Sk, Hq, Hq / Hkv, window, scale_log2, n_qtiles);
  else
    flash_attn_tc_kernel<D><<<grid, THREADS, C::SMEM, stream>>>(
        qm, km, vm, (__nv_bfloat16*)out, Sq, Sk, Hq, Hq / Hkv, causal, scale_log2, n_qtiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block takes at head dims d (q, k) and dv (v; = d but for
// a narrower v), 0 for dims not instantiated.
size_t flash_attn_tc_shared_bytes(int d, int dv) {
  if (dv != d) return d == 192 && dv == 128 ? Cfg<192, 128>::SMEM : 0;
  switch (d) {
    case 32: return Cfg<32>::SMEM;
    case 64: return Cfg<64>::SMEM;
    case 80: return Cfg<80>::SMEM;
    case 128: return Cfg<128>::SMEM;
    case 160: return Cfg<160>::SMEM;
    case 256: return Cfg<256>::SMEM;
    default: return 0;
  }
}

// q, k at head dim d, v and out at dv: dv = d, or a narrower v at the pairs
// instantiated, (192, 128), without a window.  window > 0 (causal only):
// query i keeps the keys i - window < j <= i.
int flash_attn_tc(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
                  int Hq, int Hkv, int d, int dv, int causal, int window, float scale,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dv != d) {
    if (d == 192 && dv == 128)
      return launch<192, 128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window, scale, st);
    return ERR_HEAD_DIM;
  }
  switch (d) {
    case 32: return launch<32>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window, scale, st);
    case 64: return launch<64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window, scale, st);
    case 80: return launch<80>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window, scale, st);
    case 128: return launch<128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window, scale, st);
    case 160: return launch<160>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window, scale, st);
    case 256: return launch<256>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window, scale, st);
    default: return ERR_HEAD_DIM;
  }
}

const char* flash_attn_tc_error_string(int err) {
  static char msg[96];
  if (err == ERR_NO_ENCODER) return "cuTensorMapEncodeTiled not found through the runtime";
  if (err == ERR_HEAD_DIM) return "head dim not instantiated";
  if (err == ERR_WINDOW) return "a sliding window needs the causal mask";
  if (err == ERR_DV_WINDOW) return "the narrower-v instance has no sliding window";
  if (err > ERR_ENCODE && err < ERR_HEAD_DIM) {
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed: CUresult %d", err - ERR_ENCODE);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
