// Flash-attention forward (prefill), causal or not, fp32, for Hopper (sm_90a):
// the fp32 variant of K4.  bf16 inputs take the tensor-core kernel in
// flash_attn_tc.cu; the wrapper picks one of the two by dtype.
//
// Replaces the Pallas TPU kernel of the JAX reference,
// src/repro/kernels/flash_attn/flash_attn.py: _kernel (via
// flash_attention_pallas).  For batch row b, query head h (KV head h / G)
// and query position i:
//
//   s[i, j]   = (q[b, i, h] * scale) . k[b, j, h/G]        scale = d^-1/2, fp32
//   s[i, j]   = -1e30 where j >= Sk, or j > i when causal
//   out[b, i, h] = sum_j softmax_j(s[i, :])[j] * v[b, j, h/G]
//
// as an online softmax over tiles of BK keys (running max m, denominator l,
// numerator acc in fp32), finalised as acc / max(l, 1e-30), as the Pallas
// kernel does (q is scaled before the product, as there).
//
// Design:
// * Grid (ceil(Sq / BQ), Hq, B): one block per (q tile, query head, batch
//   row).  The block reads KV head h / G directly; no repeated K/V is
//   materialised (the JAX wrapper repeats K/V to flat heads first).
// * The block stages its q tile once and one K and one V tile at a time in
//   shared memory; the scores and probabilities of a tile never leave the
//   SM, as they stay in VMEM on the TPU.  128 threads in a 16 x 8 layout:
//   each thread holds an 8-row x 4-column block of the 64 x 64 score tile
//   and an 8-row x ceil(d/16)-column block of the accumulator in registers.
//   Rows are reduced with warp shuffles across the 16 threads that share
//   them.
// * Causal skip: the key loop ends at the diagonal of the q tile.  A
//   skipped tile is wholly above the diagonal: every score is -1e30, so
//   p = 0 and alpha = 1, and each query row has already met key 0 in the
//   first tile, so its running max is finite.  Skipping changes no value.
// * Ragged edges (Sq, Sk not multiples of the tiles) are masked here: rows
//   past Sq load zeros and are not stored; keys past Sk score -1e30.
//
// What bounds it on an H100: operations on the fp32 CUDA cores (67 TFLOP/s):
// 2.05 ms at yi-9b's prefill shape.  The tensor cores cannot give fp32
// attention within the fp32 gate of 3e-5, so this variant keeps them idle;
// it serves the fp32 runs (the card-vs-CPU parity checks), not the bf16
// serving path.
//
// Layouts: q/out (B, Sq, Hq, d), k/v (B, Sk, Hkv, d), all contiguous, fp32.
// d <= 256.

#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1e30f)

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int THREADS = 128;
constexpr int RI = 8;    // rows per thread (BQ / 8 row groups)
constexpr int CJ = 4;    // score columns per thread (BK / 16)
constexpr int MAX_NC = 16;  // d <= 16 * MAX_NC

__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

// max / sum over the 16 lanes of a half warp (the threads sharing a row)
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory (floats): q[BQ*(d+1)] | k[BK*(d+1)] | v[BK*d] | p[BQ*(BK+1)].
// The q, k and p rows are padded by one float so the rows read together by
// one warp fall in distinct banks.
size_t smem_floats(int d) {
  return (size_t)BQ * (d + 1) + (size_t)BK * (d + 1) + (size_t)BK * d +
         (size_t)BQ * (BK + 1);
}

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ out, int Sq, int Sk, int Hq, int Hkv, int d, int causal,
                  float scale) {
  const int q0 = blockIdx.x * BQ, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int dp = d + 1, pp = BK + 1;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BQ * dp;
  float* v_s = k_s + BK * dp;
  float* p_s = v_s + BK * d;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const int64_t q_row = (int64_t)Hq * d, kv_row = (int64_t)Hkv * d;
  const T* qb = q + (int64_t)b * Sq * q_row + (int64_t)hq * d;
  const T* kb = k + (int64_t)b * Sk * kv_row + (int64_t)hk * d;
  const T* vb = v + (int64_t)b * Sk * kv_row + (int64_t)hk * d;
  T* ob = out + (int64_t)b * Sq * q_row + (int64_t)hq * d;

  for (int i = threadIdx.x; i < BQ * d; i += THREADS) {
    const int r = i / d, j = i - r * d;
    q_s[r * dp + j] = (q0 + r < Sq) ? to_f(qb[(q0 + r) * q_row + j]) * scale : 0.f;
  }

  float m[RI], l[RI], acc[RI][NC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // causal: keys past the q tile's last row are masked for every row
  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
#pragma unroll 4
    for (int i = threadIdx.x; i < BK * d; i += THREADS) {
      const int t = i / d, j = i - t * d;
      const bool in = k0 + t < Sk;
      k_s[t * dp + j] = in ? to_f(kb[(k0 + t) * kv_row + j]) : 0.f;
      v_s[t * d + j] = in ? to_f(vb[(k0 + t) * kv_row + j]) : 0.f;
    }
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
    for (int e = 0; e < d; ++e) {
      float kv[CJ];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = k_s[(tx + 16 * j) * dp + e];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float qv = q_s[(ty + 8 * i) * dp + e];
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv, kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 8 * i, qpos = q0 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool valid = qpos < Sq && kpos < Sk && (!causal || qpos >= kpos);
        if (!valid) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[r * pp + tx + 16 * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int t = 0; t < BK; ++t) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int j = tx + 16 * c;
        vv[c] = j < d ? v_s[t * d + j] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = p_s[(ty + 8 * i) * pp + t];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qpos = q0 + ty + 8 * i;
    if (qpos >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = tx + 16 * c;
      if (j < d) ob[qpos * q_row + j] = from_f<T>(acc[i][c] / den);
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
           int Hq, int Hkv, int d, int causal, float scale, cudaStream_t stream) {
  const size_t bytes = smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_attn_kernel<T, NC><<<grid, THREADS, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Sk, Hq, Hkv, d, causal, scale);
  return (int)cudaGetLastError();
}

// NC = ceil(d / 16) accumulator columns per thread, a compile-time count so
// the accumulator stays in registers.
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
             int Hq, int Hkv, int d, int causal, float scale, cudaStream_t stream) {
  switch ((d + 15) / 16) {
#define CASE(N) \
  case N:       \
    return launch<T, N>(q, k, v, out, B, Sq, Sk, Hq, Hkv, d, causal, scale, stream);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs, and the largest head dim, for the wrapper.
size_t flash_attn_shared_bytes(int d) { return smem_floats(d) * sizeof(float); }
int flash_attn_max_head_dim(void) { return 16 * MAX_NC; }

int flash_attn(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
               int Hq, int Hkv, int d, int causal, float scale, void* stream) {
  return dispatch<float>(q, k, v, out, B, Sq, Sk, Hq, Hkv, d, causal, scale,
                         (cudaStream_t)stream);
}

const char* flash_attn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
