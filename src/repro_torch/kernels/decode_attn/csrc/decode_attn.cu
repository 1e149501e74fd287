// Flash-decode GQA attention for one new token, for Hopper (sm_90a): K5.
//
// Replaces the Pallas TPU kernel of the JAX reference,
// src/repro/kernels/decode_attn/decode_attn.py: _kernel (via
// decode_attention_pallas).  For batch row b and KV head h, with the G query
// heads of h's group (query head h*G + g) and L = kv_len[b]:
//
//   s[g, t] = (q[b, hG+g] . k[b, t, h]) * scale        t < L, scale = d^-1/2
//   out[b, hG+g] = sum_t softmax_t(s[g, :])[t] * v[b, t, h]
//
// as an online softmax over tiles of TS cache positions (running max m,
// denominator l, numerator acc, all fp32), finalised as acc / max(l, 1e-30)
// and stored in q's dtype, as the Pallas kernel does.
//
// Design:
// * Grid (B, Hkv): one block per (b, kv head).  The G query heads of the
//   group share every K/V tile the block stages in shared memory (the
//   Pallas kernel's (G, d) x (d, Sb) product).
// * The cache is read in the model's (B, S, Hkv, d) layout through its
//   strides.  The JAX wrapper transposes it to (B, Hkv, S, d) first, which
//   at 4096 positions copies the whole cache per layer per step; this kernel
//   copies nothing.
// * The tile loop stops at kv_len[b].  A tile past kv_len contributes
//   exactly nothing to the online softmax of the Pallas kernel's full sweep
//   (every score is -1e30, so p = 0 and alpha = exp(0) = 1), so stopping
//   there changes no value.  Inside the last tile, positions >= kv_len get
//   the score -1e30 as in the Pallas kernel (p = 0).
// * kv_len >= 1 on the serving path (position + 1); the wrapper rejects 0,
//   where the reference gives NaN and the Pallas kernel a mean of V.
//
// What bounds it on an H100: the K/V bytes up to kv_len.  At yi-9b's decode
// shape (B = 4, Hkv = 4, d = 128, bf16) and kv_len = 4096 that is 33.6 MB a
// layer, 0.010 ms at 3.35 TB/s; the products are 2 * 2 * 32 * 128 FLOP a
// position, far below the compute roofline.  At the short caches of the
// serving run it is bound by its launch.  Occupancy is low: 16 (b, kv head)
// blocks on 132 SMs.  Splitting S across blocks (with a second pass that
// merges the partial (m, l, acc) triples) would fill the card; that is later
// work, as are 16-byte vector loads and tensor-core products.
//
// Layouts: q (B, Hq, d) and out (B, Hq, d) contiguous; k/v with unit stride
// in d and element strides (sb, ss, sh) for (B, S, Hkv); kv_len (B,) int32.
// Types: fp32 or bf16 for q/k/v/out (all one type), fp32 arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1e30f)

namespace {

constexpr int THREADS = 256;
constexpr int TS = 64;  // cache positions per tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
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

// Shared memory (floats): q[G*d] | k[TS*(d+1)] | v[TS*d] | p[G*TS] | acc[G*d]
// | m[G] | l[G] | alpha[G].  The k rows are padded by one float so that
// neighbouring threads (neighbouring positions) read distinct banks.
size_t smem_floats(int G, int d) {
  return (size_t)G * d * 2 + (size_t)TS * (d + 1) + (size_t)TS * d + (size_t)G * TS +
         3 * (size_t)G;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ kv_len,
                   T* __restrict__ out, int S, int Hkv, int G, int d, int64_t k_sb,
                   int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                   float scale) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int dp = d + 1, GD = G * d;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + GD;
  float* v_s = k_s + TS * dp;
  float* p_s = v_s + TS * d;
  float* acc_s = p_s + G * TS;
  float* m_s = acc_s + GD;
  float* l_s = m_s + G;
  float* a_s = l_s + G;

  // the group's query heads h*G .. h*G+G-1 are contiguous rows of q
  const int64_t q_off = ((int64_t)b * Hkv * G + (int64_t)h * G) * d;
  for (int i = threadIdx.x; i < GD; i += THREADS) {
    q_s[i] = to_f(q[q_off + i]);
    acc_s[i] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const int limit = min(kv_len[b], S);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int t0 = 0; t0 < limit; t0 += TS) {
    const int n = min(TS, limit - t0);
    __syncthreads();  // the previous tile's readers are done
#pragma unroll 8
    for (int i = threadIdx.x; i < n * d; i += THREADS) {
      const int t = i / d, j = i - t * d;
      k_s[t * dp + j] = to_f(kb[(t0 + t) * k_ss + j]);
      v_s[t * d + j] = to_f(vb[(t0 + t) * v_ss + j]);
    }
    __syncthreads();
    // scores; positions past kv_len in this tile get -1e30 (p = 0)
    for (int i = threadIdx.x; i < G * TS; i += THREADS) {
      const int g = i / TS, t = i - g * TS;
      float s = NEG_INF;
      if (t < n) {
        const float* qg = q_s + g * d;
        const float* kt = k_s + t * dp;
        float dot = 0.f;
        for (int j = 0; j < d; ++j) dot = fmaf(qg[j], kt[j], dot);
        s = dot * scale;
      }
      p_s[i] = s;
    }
    __syncthreads();
    // online softmax, one warp per query head of the group
    for (int g = warp; g < G; g += THREADS / 32) {
      float* pg = p_s + g * TS;
      float mx = NEG_INF;
      for (int t = lane; t < TS; t += 32) mx = fmaxf(mx, pg[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < TS; t += 32) {
        const float p = expf(pg[t] - m_new);
        pg[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc = alpha * acc + p . v; each thread owns the same entries every tile
    for (int i = threadIdx.x; i < GD; i += THREADS) {
      const int g = i / d, j = i - g * d;
      const float* pg = p_s + g * TS;
      float a = 0.f;
      for (int t = 0; t < n; ++t) a = fmaf(pg[t], v_s[t * d + j], a);
      acc_s[i] = a_s[g] * acc_s[i] + a;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < GD; i += THREADS) {
    out[q_off + i] = from_f<T>(acc_s[i] / fmaxf(l_s[i / d], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* kv_len, void* out, int B,
           int S, int Hkv, int G, int d, int64_t k_sb, int64_t k_ss, int64_t k_sh,
           int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale, cudaStream_t stream) {
  const size_t bytes = smem_floats(G, d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, Hkv);
  decode_attn_kernel<T><<<grid, THREADS, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, kv_len, (T*)out, S, Hkv, G, d, k_sb, k_ss, k_sh,
      v_sb, v_ss, v_sh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs, for the wrapper's checks.
size_t decode_attn_shared_bytes(int G, int d) { return smem_floats(G, d) * sizeof(float); }

// dtype: 0 = float32, 1 = bfloat16.  Strides of k and v in elements, for (B, S, Hkv).
int decode_attn(const void* q, const void* k, const void* v, const int* kv_len, void* out,
                int B, int S, int Hkv, int G, int d, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale, int dtype,
                void* stream) {
  if (dtype == 0)
    return launch<float>(q, k, v, kv_len, out, B, S, Hkv, G, d, k_sb, k_ss, k_sh, v_sb, v_ss,
                         v_sh, scale, (cudaStream_t)stream);
  return launch<__nv_bfloat16>(q, k, v, kv_len, out, B, S, Hkv, G, d, k_sb, k_ss, k_sh, v_sb,
                               v_ss, v_sh, scale, (cudaStream_t)stream);
}

const char* decode_attn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
