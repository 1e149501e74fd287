// Flash-decode GQA attention for one new token, split across the cache, for
// Hopper (sm_90a): K5.
//
// Replaces the Pallas TPU kernel of the JAX reference,
// src/repro/kernels/decode_attn/decode_attn.py: _kernel (via
// decode_attention_pallas).  For batch row b and KV head h, with the G query
// heads of h's group (query head h*G + g) and L = kv_len[b]:
//
//   s[g, t] = (q[b, hG+g] . k[b, t, h]) * scale        t < L, scale = d^-1/2
//   out[b, hG+g] = sum_t softmax_t(s[g, :])[t] * v[b, t, h]
//
// What bounds it on an H100: the K/V bytes up to kv_len.  At yi-9b's decode
// shape (B = 4, Hkv = 4, d = 128, bf16, kv_len up to 4096) that is up to
// 33.6 MB a layer, 0.010 ms at 3.35 TB/s; the products are 4 * G * d FLOP a
// position, far below the compute roofline.  To reach the byte rate the
// card needs many loads in flight on every SM, so the cache is split:
//
// * One launch, grid (n_split, Hkv, B): block (s, h, b) reads positions
//   [s * chunk, (s + 1) * chunk) clipped to kv_len[b].  n_split and chunk
//   come from the shapes alone (ops.split_plan: about two blocks an SM, a
//   chunk a multiple of 64 positions), never from kv_len, so a launch needs
//   no host read.  At yi-9b's decode shape that is 256 blocks on 132 SMs,
//   where one block per (b, kv head) gave 16.  A block whose chunk starts at
//   or past kv_len[b] writes an empty partial (m = -1e30, l = 0, acc = 0)
//   and goes straight to the merge below (where n_split is 1, a row with
//   no position writes NaN: see the last point).
// * The G query heads of the group share every K/V tile.  Tiles are
//   double-buffered in shared memory by cp.async, 16 bytes a thread,
//   neighbouring threads on neighbouring addresses in d, so the next tile
//   loads while the current one is used.  Positions past kv_len are
//   zero-filled on load and get p = 0, as in the Pallas kernel.
// * Two kernels, picked by dtype, each the whole call: bf16 takes
//   decode_attn_split_mma_kernel, whose scores are mma.sync products on
//   the tensor cores (q^T as an n8 B fragment, heads past G zero), each warp
//   keeping an online softmax over its 16 positions of a tile, merged over
//   the four warps at the end.  It takes G <= 8 and d a multiple of 16,
//   which every served model has; the wrapper raises for other bf16 shapes.
//   fp32 takes decode_attn_split_kernel, whose score is a dot product spread
//   over the lanes that hold its d slice (16 bytes each) and reduced by
//   shuffles, with one online softmax a block.  Both run the softmax in log2 units
//   (scale * log2(e) folded into exp2f), P.V in fp32 on the CUDA cores, and
//   leave the partial (m, l, acc[G, d]) in fp32 in a workspace the wrapper
//   keeps for the stream.
// * The merge: each block counts itself done in a per-(b, KV head) counter
//   (an atomic add after a fence); the last of the n_split blocks merges
//   the group's partials in split order, M = max m_s, L = sum 2^(m_s - M)
//   l_s, out = sum 2^(m_s - M) acc_s / L, cast to q's dtype,
//   and resets the counter to 0 for the next call on the stream.  The merge
//   reads every partial, its own too, from the workspace in split order, so
//   the same inputs give the same bits every run, whichever block is last.
//   Where n_split is 1 the block finalises directly.  One kernel a call: a
//   decode step's 48 calls each save a launch and a workspace allocation on
//   the host, where the step spends its time.
// * kv_len >= 1 on the serving path (position + 1).  A row with kv_len <= 0
//   has no position: its partials are all empty, so L = 0 and acc = 0, and
//   every merge divides 0 by 0: NaN, as the reference's plain version gives
//   (its Pallas kernel gives a mean of V).  A row with a position has L >= 1
//   (the largest score's own weight is 1), so no clamp of L is needed.
//
// Layouts: q (B, Hq, d) and out (B, Hq, d) contiguous; k/v with unit stride
// in d and element strides (sb, ss, sh) for (B, S, Hkv), all multiples of
// 16 bytes, as are the base pointers and d; kv_len (B,) int32.  Types: fp32
// or bf16 for q/k/v/out (all one type), fp32 arithmetic.  d <= 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void to_f(const float* p, float (&x)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The end of every block when n_split > 1: this block's partial is in the
// workspace (acc[row][split][d], then ml[row][split][2] for the G rows
// from head0); count the block done, and if it is the group's last, merge
// the group's partials in split order (see the note at the top).  smem
// holds 1 + 2 G words; every thread of the block calls this.
template <typename T>
__device__ void merge_if_last(const float* ws_acc, const float* ws_ml, unsigned* cnt, T* out,
                              int64_t head0, int G, int d, int n_split, float* smem) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __threadfence();  // this block's partial reaches the device before its count
  __syncthreads();
  int* last = reinterpret_cast<int*>(smem);
  if (tid == 0) {
    *last = atomicAdd(cnt, 1u) == (unsigned)n_split - 1;
    if (*last) *cnt = 0u;  // every block of the group has counted: ready for the next call
  }
  __syncthreads();
  if (!*last) return;
  __threadfence();
  float* M = smem + 1;
  float* L = M + G;
  for (int g = warp; g < G; g += WARPS) {  // M and L of head g: one read, a fixed order
    const float* ml = ws_ml + (head0 + g) * n_split * 2;
    float m = NEG, l = 0.f;
    for (int s = lane; s < n_split; s += 32) {  // an empty partial adds 0
      const float2 x = __ldcg(reinterpret_cast<const float2*>(ml + 2 * s));
      const float mn = fmaxf(m, x.x);
      l = l * exp2f(m - mn) + x.y * exp2f(x.x - mn);
      m = mn;
    }
    for (int o = 16; o > 0; o >>= 1) {  // both lanes of a pair get the same bits
      const float mo = __shfl_xor_sync(0xffffffffu, m, o);
      const float lo = __shfl_xor_sync(0xffffffffu, l, o);
      const float mn = fmaxf(m, mo);
      l = l * exp2f(m - mn) + lo * exp2f(mo - mn);
      m = mn;
    }
    if (lane == 0) {
      M[g] = m;
      L[g] = l;  // 0 only for a row with no position: out = 0 / 0 = NaN
    }
  }
  __syncthreads();
  const int nv = d / 4;  // a thread sums 4 columns of one head over the splits
  for (int i = tid; i < G * nv; i += THREADS) {
    const int g = i / nv, j = (i - g * nv) * 4;
    const float* ml = ws_ml + (head0 + g) * n_split * 2;
    const float* acc = ws_acc + (head0 + g) * n_split * d + j;
    const float m = M[g];
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 16
    for (int s = 0; s < n_split; ++s) {  // the loads of 16 splits in flight
      const float w = exp2f(__ldcg(ml + 2 * s) - m);
      const float4 a = __ldcg(reinterpret_cast<const float4*>(acc + (int64_t)s * d));
      o[0] = fmaf(w, a.x, o[0]);
      o[1] = fmaf(w, a.y, o[1]);
      o[2] = fmaf(w, a.z, o[2]);
      o[3] = fmaf(w, a.w, o[3]);
    }
    T* dst = out + (head0 + g) * d + j;
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[e] = from_f<T>(o[e] / L[g]);
  }
}

// A block whose chunk holds no position.  With n_split > 1 it leaves an
// empty partial (m = -1e30, l = 0, acc = 0) and joins the merge.  With
// n_split == 1 the chunk is the whole cache, so the row has no position at
// all (kv_len <= 0): its outputs are NaN, what the merge gives such a row.
template <typename T>
__device__ void empty_chunk(float* ws_acc, float* ws_ml, unsigned* cnt, T* out, int64_t head0,
                            int G, int d, int split, int n_split, float* smem) {
  const int tid = threadIdx.x;
  if (n_split == 1) {
    for (int i = tid; i < G * d; i += THREADS) out[head0 * d + i] = from_f<T>(CUDART_NAN_F);
    return;
  }
  for (int g = tid; g < G; g += THREADS) {
    ws_ml[((head0 + g) * n_split + split) * 2] = NEG;
    ws_ml[((head0 + g) * n_split + split) * 2 + 1] = 0.f;
  }
  for (int i = tid; i < G * d; i += THREADS)
    ws_acc[((head0 + i / d) * n_split + split) * d + i % d] = 0.f;
  merge_if_last(ws_acc, ws_ml, cnt, out, head0, G, d, n_split, smem);
}

// Shared memory of the fp32 kernel: k[2][TS*d] | v[2][TS*d] | q[G*d] |
// acc[G*d] | p[G*TS] | m[G] | l[G] | alpha[G].
constexpr int FP32_TS = 32;  // positions a tile of the fp32 kernel

size_t smem_bytes(int G, int d) {
  constexpr size_t TS = FP32_TS;
  return sizeof(float) * (4 * TS * d + (size_t)2 * G * d + (size_t)G * TS + 3 * (size_t)G);
}

// The fp32 kernel: one block per (split, KV head, batch row).  VPL =
// 16-byte vectors of a row a lane holds (1, or 2 for rows of more than 128).
constexpr int HEADS = 8;  // query heads held in registers at once while scoring

template <int VPL>
__global__ void __launch_bounds__(THREADS)
decode_attn_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int* __restrict__ kv_len,
                         float* __restrict__ out, float* __restrict__ ws_acc,
                         float* __restrict__ ws_ml, unsigned* __restrict__ counters,
                         int S, int Hkv, int G, int d, int chunk,
                         int n_split, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                         int64_t v_ss, int64_t v_sh, float scale_log2) {
  constexpr int TS = FP32_TS, VEC = 4;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int GD = G * d, nvec = d / VEC;
  const int L = min(kv_len[b], S);
  const int c0 = split * chunk, c1 = min(c0 + chunk, L);
  const int64_t head0 = (int64_t)b * Hkv * G + (int64_t)h * G;  // the group's first query head

  extern __shared__ __align__(16) uint8_t smem_raw[];
  unsigned* cnt = counters + (int64_t)b * Hkv + h;
  if (c0 >= c1) {
    empty_chunk(ws_acc, ws_ml, cnt, out, head0, G, d, split, n_split,
                reinterpret_cast<float*>(smem_raw));
    return;
  }

  float* k_s = reinterpret_cast<float*>(smem_raw);
  float* v_s = k_s + 2 * TS * d;
  float* q_s = v_s + 2 * TS * d;
  float* acc_s = q_s + GD;
  float* p_s = acc_s + GD;
  float* m_s = p_s + G * TS;
  float* l_s = m_s + G;
  float* a_s = l_s + G;

  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  auto load_tile = [&](int tile, int buf) {
    const int t0 = c0 + tile * TS;
    float* kd = k_s + buf * TS * d;
    float* vd = v_s + buf * TS * d;
    for (int i = tid; i < TS * nvec; i += THREADS) {
      const int t = i / nvec, j = (i - t * nvec) * VEC;
      const bool in = t0 + t < c1;
      const int64_t pos = in ? t0 + t : c0;  // a valid address even where nothing is read
      cp_async16(kd + t * d + j, kb + pos * k_ss + j, in ? 16 : 0);
      cp_async16(vd + t * d + j, vb + pos * v_ss + j, in ? 16 : 0);
    }
    cp_async_commit();
  };
  const int n_tiles = (c1 - c0 + TS - 1) / TS;
  load_tile(0, 0);

  for (int i = tid; i < GD; i += THREADS) {
    q_s[i] = q[head0 * d + i];
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG;
    l_s[g] = 0.f;
  }

  // lanes per cache row: a power of two, at most 32; rows per warp pass
  int lpr = 1;
  while (lpr < nvec && lpr < 32) lpr <<= 1;
  const int ppw = 32 / lpr, sub = lane % lpr;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      load_tile(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = k_s + buf * TS * d;
    const float* vt = v_s + buf * TS * d;
    const int nvalid = min(TS, c1 - (c0 + it * TS));

    // scores: the lanes of a row group hold its d slice; shuffles reduce it
    for (int g0 = 0; g0 < G; g0 += HEADS) {
      float qr[HEADS][VPL][VEC];
#pragma unroll
      for (int g = 0; g < HEADS; ++g)
#pragma unroll
        for (int u = 0; u < VPL; ++u) {
          const int vi = sub + u * lpr;
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            qr[g][u][e] = (g0 + g < G && vi < nvec) ? q_s[(g0 + g) * d + vi * VEC + e] : 0.f;
        }
      for (int t = warp * ppw + lane / lpr; t < TS; t += WARPS * ppw) {
        float dot[HEADS];
#pragma unroll
        for (int g = 0; g < HEADS; ++g) dot[g] = 0.f;
#pragma unroll
        for (int u = 0; u < VPL; ++u) {
          const int vi = sub + u * lpr;
          if (vi < nvec) {
            float x[VEC];
            to_f(kt + t * d + vi * VEC, x);
#pragma unroll
            for (int g = 0; g < HEADS; ++g)
#pragma unroll
              for (int e = 0; e < VEC; ++e) dot[g] = fmaf(qr[g][u][e], x[e], dot[g]);
          }
        }
        for (int o = lpr / 2; o > 0; o >>= 1) {  // the HEADS chains interleave
#pragma unroll
          for (int g = 0; g < HEADS; ++g) dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
        }
        if (sub == 0) {
#pragma unroll
          for (int g = 0; g < HEADS; ++g)
            if (g0 + g < G) p_s[(g0 + g) * TS + t] = t < nvalid ? dot[g] * scale_log2 : NEG;
        }
      }
    }
    __syncthreads();

    // online softmax in log2 units, one warp per query head of the group
    for (int g = warp; g < G; g += WARPS) {
      float* pg = p_s + g * TS;
      float mx = NEG;
      for (int t = lane; t < TS; t += 32) mx = fmaxf(mx, pg[t]);
      mx = warp_max(mx);
      const float m_old = m_s[g], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < TS; t += 32) {
        const float p = exp2f(pg[t] - m_new);
        pg[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha * acc + p . v; a thread owns (head, 16-byte slice of d)
    for (int e = tid; e < G * nvec; e += THREADS) {
      const int g = e / nvec, j = (e - g * nvec) * VEC;
      const float* pg = p_s + g * TS;
      float a[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) a[i] = 0.f;
#pragma unroll 8
      for (int t = 0; t < nvalid; ++t) {
        float x[VEC];
        to_f(vt + t * d + j, x);
        const float p = pg[t];
#pragma unroll
        for (int i = 0; i < VEC; ++i) a[i] = fmaf(p, x[i], a[i]);
      }
      float* ac = acc_s + g * d + j;
      const float alpha = a_s[g];
#pragma unroll
      for (int i = 0; i < VEC; ++i) ac[i] = alpha * ac[i] + a[i];
    }
    __syncthreads();  // the buffer is free for the load two tiles on
  }

  if (n_split == 1) {
    for (int i = tid; i < GD; i += THREADS)
      out[head0 * d + i] = acc_s[i] / l_s[i / d];
    return;
  }
  for (int i = tid; i < GD; i += THREADS) {
    const int g = i / d, j = i - g * d;
    ws_acc[((head0 + g) * n_split + split) * d + j] = acc_s[i];
  }
  for (int g = tid; g < G; g += THREADS) {
    ws_ml[((head0 + g) * n_split + split) * 2] = m_s[g];
    ws_ml[((head0 + g) * n_split + split) * 2 + 1] = l_s[g];
  }
  merge_if_last(ws_acc, ws_ml, cnt, out, head0, G, d, n_split, reinterpret_cast<float*>(smem_raw));
}

// The bf16 kernel, for G <= 8 and d a multiple of 16: the scores on the
// tensor cores.  Warp w of the block owns positions 16 w .. 16 w + 15 of each
// tile of MMA_TS = 64 and keeps its own online softmax over them; the four
// warps merge once, at the end.  S^T (16 positions x 8 heads) = K_tile . q^T
// is mma.sync m16n8k16 (bf16 in, fp32 sums): K's rows come from shared
// memory by ldmatrix (rows padded by 16 bytes, so the 8 rows a matrix reads
// fall in distinct banks), q^T is the B fragment, held in registers for the
// whole block, heads past G zero.  P.V stays in fp32 on the CUDA cores: lane
// j owns columns 64 i + 2 j, + 1, for GB heads.
constexpr int MMA_TS = 64;
constexpr int MMA_KSTEPS = 16;  // d / 16 <= 16

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
      " {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Shared memory: k[2][MMA_TS][d + 8] | v[2][MMA_TS][d + 8] (bf16) | p[WARPS][16][8]
// | alpha[WARPS][8] | m[WARPS][8] | l[WARPS][8] (fp32).  After the last tile
// the K/V ring holds the warps' acc[WARPS][8][d] for the final merge.
size_t mma_smem_bytes(int d) {
  return 4 * (size_t)MMA_TS * (d + 8) * 2 + sizeof(float) * WARPS * (16 * 8 + 3 * 8);
}

template <int GB>
__global__ void __launch_bounds__(THREADS)
decode_attn_split_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const int* __restrict__ kv_len, __nv_bfloat16* __restrict__ out,
                             float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                             unsigned* __restrict__ counters, int S,
                             int Hkv, int G, int d, int chunk, int n_split, int64_t k_sb,
                             int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                             int64_t v_sh, float scale_log2) {
  constexpr int TS = MMA_TS, VEC = 8;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int GD = G * d, nvec = d / VEC, DP = d + 8;
  const int L = min(kv_len[b], S);
  const int c0 = split * chunk, c1 = min(c0 + chunk, L);
  const int64_t head0 = (int64_t)b * Hkv * G + (int64_t)h * G;

  extern __shared__ __align__(16) uint8_t smem_raw[];
  unsigned* cnt = counters + (int64_t)b * Hkv + h;
  if (c0 >= c1) {
    empty_chunk(ws_acc, ws_ml, cnt, out, head0, G, d, split, n_split,
                reinterpret_cast<float*>(smem_raw));
    return;
  }

  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + 2 * TS * DP;
  float* p_all = reinterpret_cast<float*>(v_s + 2 * TS * DP);
  float* pw = p_all + warp * 16 * 8;                  // this warp's p[16][8]
  float* alpha_all = p_all + WARPS * 16 * 8;
  float* aw = alpha_all + warp * 8;
  float* m_all = alpha_all + WARPS * 8;
  float* l_all = m_all + WARPS * 8;

  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  auto load_tile = [&](int tile, int buf) {
    const int t0 = c0 + tile * TS;
    __nv_bfloat16* kd = k_s + buf * TS * DP;
    __nv_bfloat16* vd = v_s + buf * TS * DP;
    for (int i = tid; i < TS * nvec; i += THREADS) {
      const int t = i / nvec, j = (i - t * nvec) * VEC;
      const bool in = t0 + t < c1;
      const int64_t pos = in ? t0 + t : c0;
      cp_async16(kd + t * DP + j, kb + pos * k_ss + j, in ? 16 : 0);
      cp_async16(vd + t * DP + j, vb + pos * v_ss + j, in ? 16 : 0);
    }
    cp_async_commit();
  };
  const int n_tiles = (c1 - c0 + TS - 1) / TS;
  load_tile(0, 0);

  // q^T as mma B fragments: head n = lane / 4, d pairs from 2 (lane % 4)
  const int gn = lane >> 2, gc = lane & 3, nks = d / 16;
  uint32_t qb[MMA_KSTEPS][2];
  const uint32_t* qrow = reinterpret_cast<const uint32_t*>(q + (head0 + gn) * d);
#pragma unroll
  for (int kk = 0; kk < MMA_KSTEPS; ++kk) {
    const bool in = kk < nks && gn < G;
    qb[kk][0] = in ? qrow[8 * kk + gc] : 0u;
    qb[kk][1] = in ? qrow[8 * kk + 4 + gc] : 0u;
  }

  // softmax state of heads 2 gc, 2 gc + 1 over this warp's positions
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};
  float acc[GB][4][2];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[g][i][0] = acc[g][i][1] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      load_tile(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = k_s + (buf * TS + 16 * warp) * DP;
    const __nv_bfloat16* vt = v_s + (buf * TS + 16 * warp) * DP;
    const int nvalid = min(TS, c1 - (c0 + it * TS)) - 16 * warp;  // may be <= 0

    float sc[4] = {0.f, 0.f, 0.f, 0.f};  // (position gn | gn + 8, head 2 gc | 2 gc + 1)
#pragma unroll
    for (int kk = 0; kk < MMA_KSTEPS; ++kk)
      if (kk < nks) {
        uint32_t a[4];
        ldmatrix_x4(a, kt + (lane & 15) * DP + 16 * kk + (lane >> 4) * 8);
        mma_bf16(sc, a, qb[kk]);
      }
    const bool v0 = gn < nvalid, v1 = gn + 8 < nvalid;
    float pr[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float x0 = sc[e] * scale_log2, x1 = sc[2 + e] * scale_log2;
      float mx = fmaxf(v0 ? x0 : NEG, v1 ? x1 : NEG);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float m_new = fmaxf(m_r[e], mx);
      const float alpha = exp2f(m_r[e] - m_new);
      pr[e] = v0 ? exp2f(x0 - m_new) : 0.f;  // masked: exactly 0, whatever m is
      pr[2 + e] = v1 ? exp2f(x1 - m_new) : 0.f;
      l_r[e] = l_r[e] * alpha + pr[e] + pr[2 + e];
      m_r[e] = m_new;
      pw[gn * 8 + 2 * gc + e] = pr[e];
      pw[(gn + 8) * 8 + 2 * gc + e] = pr[2 + e];
      if (gn == 0) aw[2 * gc + e] = alpha;
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float a = aw[g];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[g][i][0] *= a;
        acc[g][i][1] *= a;
      }
    }
    const int np = min(16, nvalid);
#pragma unroll 4
    for (int t = 0; t < np; ++t) {
      float p[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) p[g] = pw[t * 8 + g];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 64 * i + 2 * lane;
        if (col < d) {
          const float2 x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(vt + t * DP + col));
#pragma unroll
          for (int g = 0; g < GB; ++g) {
            acc[g][i][0] = fmaf(p[g], x.x, acc[g][i][0]);
            acc[g][i][1] = fmaf(p[g], x.y, acc[g][i][1]);
          }
        }
      }
    }
    __syncthreads();  // the tile's buffer, p and alpha are free again
  }

  // this warp's l over its lanes; then (m, l, acc) of the four warps merged
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float l = l_r[e];
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    l += __shfl_xor_sync(0xffffffffu, l, 8);
    l += __shfl_xor_sync(0xffffffffu, l, 16);
    if (gn == 0) {
      m_all[warp * 8 + 2 * gc + e] = m_r[e];
      l_all[warp * 8 + 2 * gc + e] = l;
    }
  }
  float* acc_all = reinterpret_cast<float*>(smem_raw);  // the K/V ring is free
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = 64 * i + 2 * lane;
      if (col < d) {
        acc_all[(warp * 8 + g) * d + col] = acc[g][i][0];
        acc_all[(warp * 8 + g) * d + col + 1] = acc[g][i][1];
      }
    }
  __syncthreads();
  for (int i = tid; i < GD; i += THREADS) {
    const int g = i / d, j = i - g * d;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, m_all[w * 8 + g]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = exp2f(m_all[w * 8 + g] - M);  // 0 for a warp with no position
      l += wt * l_all[w * 8 + g];
      a += wt * acc_all[(w * 8 + g) * d + j];
    }
    if (n_split == 1) {
      out[head0 * d + i] = __float2bfloat16_rn(a / l);
    } else {
      ws_acc[((head0 + g) * n_split + split) * d + j] = a;
      if (j == 0) {
        ws_ml[((head0 + g) * n_split + split) * 2] = M;
        ws_ml[((head0 + g) * n_split + split) * 2 + 1] = l;
      }
    }
  }
  if (n_split > 1)
    merge_if_last(ws_acc, ws_ml, cnt, out, head0, G, d, n_split,
                  reinterpret_cast<float*>(smem_raw));
}

// The workspace: acc[rows][n_split][d] (float4-aligned, d a multiple of 4),
// then ml[rows][n_split][2], rows = B * Hkv * G; counters: B * Hkv, zero
// between calls (the last block of each group resets its own).
template <int GB>
int launch_mma(const void* q, const void* k, const void* v, const int* kv_len, void* out,
               float* ws, unsigned* counters, int B, int S, int Hkv, int G, int d, int chunk,
               int n_split, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
               int64_t v_ss, int64_t v_sh, float scale, cudaStream_t stream) {
  const size_t bytes = mma_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(decode_attn_split_mma_kernel<GB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  float* ws_ml = ws + (size_t)B * Hkv * G * n_split * d;
  dim3 grid(n_split, Hkv, B);
  decode_attn_split_mma_kernel<GB><<<grid, THREADS, bytes, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, kv_len,
      (__nv_bfloat16*)out, ws, ws_ml, counters, S, Hkv, G, d, chunk, n_split, k_sb, k_ss, k_sh,
      v_sb, v_ss, v_sh, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int VPL>
int launch_fp32(const void* q, const void* k, const void* v, const int* kv_len, void* out,
                float* ws, unsigned* counters, int B, int S, int Hkv, int G, int d, int chunk,
                int n_split, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                int64_t v_ss, int64_t v_sh, float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes(G, d);
  cudaError_t err = cudaFuncSetAttribute(decode_attn_split_kernel<VPL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  float* ws_ml = ws + (size_t)B * Hkv * G * n_split * d;
  dim3 grid(n_split, Hkv, B);
  decode_attn_split_kernel<VPL><<<grid, THREADS, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, kv_len, (float*)out, ws, ws_ml,
      counters, S, Hkv, G, d, chunk, n_split, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs, for the wrapper's checks.
size_t decode_attn_shared_bytes(int G, int d, int dtype) {
  return dtype == 1 ? mma_smem_bytes(d) : smem_bytes(G, d);
}

// dtype: 0 = float32, 1 = bfloat16 (G <= 8, d a multiple of 16).  Strides
// of k and v in elements, for (B, S, Hkv).  ws: B * Hkv * G * n_split *
// (d + 2) floats, 16-byte aligned; counters: B * Hkv, zero (both unused
// when n_split is 1).  One kernel launch.
int decode_attn(const void* q, const void* k, const void* v, const int* kv_len, void* out,
                float* ws, unsigned* counters, int B, int S, int Hkv, int G, int d, int chunk,
                int n_split, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                int64_t v_ss, int64_t v_sh, float scale, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define ARGS q, k, v, kv_len, out, ws, counters, B, S, Hkv, G, d, chunk, n_split, k_sb, k_ss, \
             k_sh, v_sb, v_ss, v_sh, scale, st
  if (dtype == 1) {
    if (G > 8 || d % 16) return (int)cudaErrorInvalidValue;
    if (G == 1) return launch_mma<1>(ARGS);
    if (G == 2) return launch_mma<2>(ARGS);
    if (G <= 4) return launch_mma<4>(ARGS);
    return launch_mma<8>(ARGS);
  }
  if (d <= 128) return launch_fp32<1>(ARGS);
  return launch_fp32<2>(ARGS);
#undef ARGS
}

const char* decode_attn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
