// RMSNorm over the last dim for Hopper (sm_90a), with the post-norm residual
// add folded into its epilogue.
//
// Replaces no TPU kernel: the JAX package has none for the norm (its
// rms_norm is plain code, src/repro/models/layers.py: rms_norm).  It takes
// the place of the port's plain chain, models/layers.py: rms_norm, on the
// serving path of models/transformer.py, with the chain's rounding points:
//
//   var = float(x)^2 summed in fp32, times 1/d      (torch.mean's factor)
//   inv = T(rsqrtf(var + eps))                      rounded to x's dtype T
//   y   = T(T(x * inv) * scale)                     each product rounded to T
//   out = T(residual + y)                           where a residual is given
//
// Only the order of the fp32 sum differs from the chain (ref.py's
// rms_norm_emulation writes this kernel's order out).  Products and sums go
// through __fmul_rn / __fadd_rn, so nothing is contracted into an FMA and
// the fp32 instance rounds where the chain does too.
//
// What bounds it on an H100: bytes.  The chain makes six passes over a
// (rows, d) tensor, about 26 bytes an element in bf16 (the fp32 copy, its
// square, the mean's read, x * inv, * scale), and a post-norm site adds the
// residual add's 6.  This kernel reads x once and writes the result once:
// 4 bytes an element, 6 with the residual.  At K-EXAONE's 32768-token
// prefill (d 6144) that is 0.805 GB, 0.240 ms at 3.35 TB/s (0.361 ms with
// the residual).  On an NVIDIA H100 80GB HBM3 at 700 W it takes 0.318 ms
// there (0.399 ms with the residual: 76% and 90% of the bound) where the
// chain takes 2.44 ms (2.84).
//
// Design:
// * One read, one write.  A thread loads its VPT 16-byte vectors of a row
//   (and the residual's) into registers, sums their squares, and after the
//   row's reduction normalises the same registers and stores them: x is
//   never read twice, and nothing but the output is written.
// * Threads a row from the width alone (ops.launch_plan): tpr = 2^k threads
//   a row, VPT = ceil(vectors / tpr) <= 8.  A wide row (d 6144 in bf16: 768
//   vectors) takes 256 threads of 3 vectors, a block a row; a head of 128
//   (16 vectors) takes 4 threads of 4 vectors, 64 rows a 256-thread block,
//   so q's 2M rows at 32768 tokens do not each take a block.
// * The row's sum in a fixed order: each thread adds its vectors' squares
//   in order (vector j, then element), the row's lanes by an xor butterfly
//   of shuffles (offsets min(tpr, 32) / 2 down to 1; a pair adds the same
//   two values, so every lane ends with the same bits), and, where tpr > 32,
//   the warps' sums through shared memory in warp order.  The same input
//   gives the same bits every call.
// * Bytes in flight: 16 x VPT bytes a thread, twice that with the residual;
//   at d 6144 (60 registers a thread, 4 blocks an SM) 48-96 KB an SM.
//
// Layouts: x, residual and out (rows, d) contiguous, scale (d,) contiguous,
// each 16-byte aligned; d x sizeof(T) a multiple of 16.  The wrapper raises
// on anything else and this entry point refuses it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_VPT = 8;        // ops.MAX_VPT
constexpr int MAX_THREADS = 512;  // ops.MAX_THREADS_PER_ROW: one row's threads at most

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int VPT>
__global__ void __launch_bounds__(MAX_THREADS)
rms_norm_kernel(const uint4* __restrict__ x, const uint4* __restrict__ scale,
                const uint4* __restrict__ res, uint4* __restrict__ out, int64_t rows,
                int nvec, int lg_tpr, float eps, float inv_n) {
  constexpr int N = 16 / sizeof(T);  // elements a vector
  __shared__ float warp_sum[MAX_THREADS / 32];
  const int tpr = 1 << lg_tpr;
  const int lane = threadIdx.x & (tpr - 1);
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x >> lg_tpr) + (threadIdx.x >> lg_tpr);
  const bool live = row < rows;
  const int64_t base = row * nvec;

  uint4 v[VPT], r[VPT];
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = lane + j * tpr;
    if (live && i < nvec) {
      v[j] = x[base + i];
      if (res) r[j] = res[base + i];
      const T* e = reinterpret_cast<const T*>(&v[j]);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float f = to_f(e[k]);
        ss = __fadd_rn(ss, __fmul_rn(f, f));
      }
    }
  }
  // the row's lanes: every lane of the warp shuffles, a dead row adds zeros
  const int width = tpr < 32 ? tpr : 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (o < width) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  }
  if (tpr > 32) {  // the row's warps, in warp order
    if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = ss;
    __syncthreads();
    const int first = (threadIdx.x >> lg_tpr) << (lg_tpr - 5);
    ss = warp_sum[first];
    for (int w = 1; w < (tpr >> 5); ++w) ss = __fadd_rn(ss, warp_sum[first + w]);
  }
  if (!live) return;

  const float inv = to_f(from_f<T>(rsqrtf(__fadd_rn(__fmul_rn(ss, inv_n), eps))));
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = lane + j * tpr;
    if (i < nvec) {
      const uint4 s = __ldg(scale + i);
      const T* e = reinterpret_cast<const T*>(&v[j]);
      const T* se = reinterpret_cast<const T*>(&s);
      const T* re = reinterpret_cast<const T*>(&r[j]);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const T xn = from_f<T>(__fmul_rn(to_f(e[k]), inv));
        T y = from_f<T>(__fmul_rn(to_f(xn), to_f(se[k])));
        if (res) y = from_f<T>(__fadd_rn(to_f(re[k]), to_f(y)));
        oe[k] = y;
      }
      out[base + i] = o;
    }
  }
}

template <typename T>
cudaError_t dispatch(const uint4* x, const uint4* scale, const uint4* res, uint4* out,
                     int64_t rows, int nvec, int vpt, int lg_tpr, int block, int grid,
                     float eps, float inv_n, cudaStream_t s) {
#define RMS_NORM_CASE(V)                                                                   \
  case V:                                                                                  \
    rms_norm_kernel<T, V><<<grid, block, 0, s>>>(x, scale, res, out, rows, nvec, lg_tpr,  \
                                                 eps, inv_n);                             \
    break;
  switch (vpt) {
    RMS_NORM_CASE(1)
    RMS_NORM_CASE(2)
    RMS_NORM_CASE(3)
    RMS_NORM_CASE(4)
    RMS_NORM_CASE(5)
    RMS_NORM_CASE(6)
    RMS_NORM_CASE(7)
    RMS_NORM_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef RMS_NORM_CASE
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (rows, d), scale (d,), residual (rows, d) or null -> out (rows, d), all
// of one dtype (bf16 = 1, fp32 = 0), on `stream`, on the grid that
// ops.launch_plan planned: 2^lg_tpr threads a row, `vpt` vectors a thread,
// `rows_per_block` rows a block, `grid` blocks.  A plan that misses a row or
// a vector, or a layout the kernel cannot take, is refused.
int rms_norm(const void* x, const void* scale, const void* res, void* out, int64_t rows,
             int d, int bf16, int vpt, int lg_tpr, int rows_per_block, int grid, float eps,
             void* stream) {
  const int n = bf16 ? 8 : 4;
  const int64_t tpr = int64_t(1) << (lg_tpr < 0 ? 0 : lg_tpr);
  const int64_t block = tpr * rows_per_block;
  const bool aligned = (uintptr_t)x % 16 == 0 && (uintptr_t)scale % 16 == 0 &&
                       (uintptr_t)res % 16 == 0 && (uintptr_t)out % 16 == 0;
  if (rows < 1 || d < n || d % n != 0 || !aligned || lg_tpr < 0 || tpr > MAX_THREADS ||
      vpt < 1 || vpt > MAX_VPT || rows_per_block < 1 || block > MAX_THREADS || grid < 1 ||
      tpr * vpt < d / n || (int64_t)grid * rows_per_block < rows) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const float inv_n = 1.0f / (float)d;  // torch.mean's factor: rows / (rows * d) in fp32
  const uint4* xv = (const uint4*)x;
  const uint4* sv = (const uint4*)scale;
  const uint4* rv = (const uint4*)res;
  uint4* ov = (uint4*)out;
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(xv, sv, rv, ov, rows, d / n, vpt, lg_tpr, (int)block,
                                     grid, eps, inv_n, s)
           : dispatch<float>(xv, sv, rv, ov, rows, d / n, vpt, lg_tpr, (int)block, grid, eps,
                             inv_n, s);
  return (int)err;
}

const char* rms_norm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
