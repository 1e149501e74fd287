// Fused pruned-ADC QAT first layer for Hopper (sm_90a): forward (K2) and
// backward (K3).
//
// Replaces the Pallas TPU kernels of the JAX reference,
// src/repro/kernels/fused_qat/fused_qat.py: _fwd_kernel (with
// _dequant_ste_value) and _bwd_kernel.  Per population row p and sample b:
//
//   level[b,c] = max_t ids[c,t] * (x[b,c] >= thr[c,t])     comparator bank + encoder
//   h[b,c]     = x + (level * scale - x)                    dequant, STE forward value
//   out[b,f]   = sum_c h[b,c] * w[c,f] + bias[f]            first-layer matmul
//
// and in the backward, with g = d out:
//
//   dx[b,c] = sum_f g[b,f] * w[c,f]      (the STE passes the gradient through)
//   dw[c,f] = sum_b h[b,c] * g[b,f]
//
// What bounds it on an H100: at the co-design shapes (C <= 21 inputs,
// F <= 5 hidden units, T = 15 thresholds, 128 samples a step) one call
// moves some 0.4 MB and does ~2 MFLOP, well under a microsecond at
// 3.35 TB/s or 67 TFLOP/s fp32; a call is bound by its launch.  The design
// therefore keeps everything in one launch per pass (two for the
// backward's fixed-order tile sum): each block stages its row's tables and
// weights in shared memory once, loads its x tile with coalesced reads, and
// keeps the dequantized tile out of device memory, as the Pallas kernel
// keeps it in VMEM.  The matmuls are far below one tensor-core tile and run
// on the fp32 pipes.
//
// Rounding: the dequant uses __fmul_rn / __fsub_rn / __fadd_rn so the
// compiler cannot contract `level*scale - x` into an FMA; that keeps h
// bit-identical to quantize_pruned_ste's `x + (v - x)`.
//
// Determinism: the reference sums dw over batch tiles through a sequential
// TPU grid.  Blocks here run in parallel in no fixed order, so each block
// writes its tile's partial dw (summed over its samples in index order) to
// scratch and a second kernel adds the tiles in tile order.  No atomics:
// the same inputs give the same bits on every run, which the genome memo
// relies on.
//
// Layouts (all contiguous, row-major, fp32 unless noted):
//   x (P, B, C), thr (P, C, T), ids (P, C, T) int32, w (P, C, F), bias (P, F),
//   out (P, B, F), g (P, B, F), dx (P, B, C), dw_part (P, n_tiles, C, F),
//   dw (P, C, F).
// Grid: (ceil(B / TILE_B), P); one thread per sample of the tile.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TILE_B 128

// Dynamic shared memory carve-up shared by both kernels:
//   thr[C*T] f32 | ids[C*T] i32 | w[C*F] f32 | tile[TILE_B*C] f32 | extra
static __device__ __forceinline__ float dequant_ste(float xv, const float* thr_s,
                                                    const int* ids_s, int T,
                                                    float scale) {
  int lv = 0;
  for (int t = 0; t < T; ++t) {
    // +inf at pruned slots never fires; x >= thr fires at equality
    if (xv >= thr_s[t]) lv = max(lv, ids_s[t]);
  }
  float v = __fmul_rn((float)lv, scale);
  return __fadd_rn(xv, __fsub_rn(v, xv));
}

static __device__ __forceinline__ void stage_row(const float* thr, const int* ids,
                                                 const float* w, int p, int C, int T,
                                                 int F, float* thr_s, int* ids_s,
                                                 float* w_s) {
  const int64_t ct = (int64_t)C * T, cf = (int64_t)C * F;
  for (int i = threadIdx.x; i < ct; i += blockDim.x) {
    thr_s[i] = thr[p * ct + i];
    ids_s[i] = ids[p * ct + i];
  }
  for (int i = threadIdx.x; i < cf; i += blockDim.x) w_s[i] = w[p * cf + i];
}

// Load the tile's x rows (contiguous in memory) with coalesced reads, then
// replace each thread's own row by its dequantized STE value h.  Rows past
// the ragged end of the batch are zero (they feed no output and add
// nothing to dw).
static __device__ __forceinline__ void stage_h(const float* x, int p, int b0, int rows,
                                               int B, int C, int T, float scale,
                                               const float* thr_s, const int* ids_s,
                                               float* h_s) {
  const float* xt = x + ((int64_t)p * B + b0) * C;
  const int n = rows * C;
  for (int i = threadIdx.x; i < TILE_B * C; i += blockDim.x) h_s[i] = i < n ? xt[i] : 0.0f;
  __syncthreads();
  const int r = threadIdx.x;
  if (r < rows) {
    for (int c = 0; c < C; ++c) {
      h_s[r * C + c] = dequant_ste(h_s[r * C + c], thr_s + c * T, ids_s + c * T, T, scale);
    }
  }
  __syncthreads();
}

__global__ void fused_qat_fwd_kernel(const float* __restrict__ x,
                                     const float* __restrict__ thr,
                                     const int* __restrict__ ids,
                                     const float* __restrict__ w,
                                     const float* __restrict__ bias,
                                     float* __restrict__ out, int B, int C, int T,
                                     int F, float scale) {
  extern __shared__ float smem[];
  float* thr_s = smem;
  int* ids_s = (int*)(thr_s + C * T);
  float* w_s = (float*)(ids_s + C * T);
  float* h_s = w_s + C * F;
  const int p = blockIdx.y;
  const int b0 = blockIdx.x * TILE_B;
  const int rows = min(TILE_B, B - b0);
  stage_row(thr, ids, w, p, C, T, F, thr_s, ids_s, w_s);
  __syncthreads();
  stage_h(x, p, b0, rows, B, C, T, scale, thr_s, ids_s, h_s);
  const int r = threadIdx.x;
  if (r >= rows) return;
  float* o = out + ((int64_t)p * B + b0 + r) * F;
  for (int f = 0; f < F; ++f) {
    float acc = 0.0f;
    for (int c = 0; c < C; ++c) acc = fmaf(h_s[r * C + c], w_s[c * F + f], acc);
    o[f] = acc + bias[(int64_t)p * F + f];
  }
}

__global__ void fused_qat_bwd_kernel(const float* __restrict__ x,
                                     const float* __restrict__ thr,
                                     const int* __restrict__ ids,
                                     const float* __restrict__ w,
                                     const float* __restrict__ g,
                                     float* __restrict__ dx,
                                     float* __restrict__ dw_part, int B, int C,
                                     int T, int F, float scale) {
  extern __shared__ float smem[];
  float* thr_s = smem;
  int* ids_s = (int*)(thr_s + C * T);
  float* w_s = (float*)(ids_s + C * T);
  float* h_s = w_s + C * F;
  float* g_s = h_s + TILE_B * C;
  const int p = blockIdx.y;
  const int tile = blockIdx.x;
  const int b0 = tile * TILE_B;
  const int rows = min(TILE_B, B - b0);
  stage_row(thr, ids, w, p, C, T, F, thr_s, ids_s, w_s);
  const float* gt = g + ((int64_t)p * B + b0) * F;
  for (int i = threadIdx.x; i < TILE_B * F; i += blockDim.x) {
    g_s[i] = i < rows * F ? gt[i] : 0.0f;
  }
  __syncthreads();
  stage_h(x, p, b0, rows, B, C, T, scale, thr_s, ids_s, h_s);

  const int r = threadIdx.x;
  if (dx != nullptr && r < rows) {
    float* d = dx + ((int64_t)p * B + b0 + r) * C;
    for (int c = 0; c < C; ++c) {
      float acc = 0.0f;
      for (int f = 0; f < F; ++f) acc = fmaf(g_s[r * F + f], w_s[c * F + f], acc);
      d[c] = acc;
    }
  }
  // this tile's dw, one (c, f) output per thread, summed in sample order
  float* part = dw_part + ((int64_t)p * gridDim.x + tile) * C * F;
  for (int o = threadIdx.x; o < C * F; o += blockDim.x) {
    const int c = o / F, f = o % F;
    float acc = 0.0f;
    for (int s = 0; s < rows; ++s) acc = fmaf(h_s[s * C + c], g_s[s * F + f], acc);
    part[o] = acc;
  }
}

// dw[p, o] = sum over tiles, in tile order, of dw_part[p, tile, o]
__global__ void dw_tile_sum_kernel(const float* __restrict__ dw_part,
                                   float* __restrict__ dw, int P, int n_tiles, int CF) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)P * CF) return;
  const int64_t p = i / CF, o = i % CF;
  const float* src = dw_part + p * n_tiles * CF + o;
  float acc = 0.0f;
  for (int t = 0; t < n_tiles; ++t) acc = __fadd_rn(acc, src[(int64_t)t * CF]);
  dw[i] = acc;
}

static size_t shared_bytes(int C, int T, int F, bool backward) {
  size_t n = (size_t)C * T * 2 + (size_t)C * F + (size_t)TILE_B * C;
  if (backward) n += (size_t)TILE_B * F;
  return n * 4;
}

extern "C" {

// Shared memory one block of each kernel needs, for the wrapper's checks.
size_t fused_qat_shared_bytes(int C, int T, int F, int backward) {
  return shared_bytes(C, T, F, backward != 0);
}

int fused_qat_forward(const float* x, const float* thr, const int* ids, const float* w,
                      const float* bias, float* out, int P, int B, int C, int T, int F,
                      float scale, void* stream) {
  dim3 grid((B + TILE_B - 1) / TILE_B, P);
  fused_qat_fwd_kernel<<<grid, TILE_B, shared_bytes(C, T, F, false),
                         (cudaStream_t)stream>>>(x, thr, ids, w, bias, out, B, C, T, F,
                                                 scale);
  return (int)cudaGetLastError();
}

int fused_qat_backward(const float* x, const float* thr, const int* ids, const float* w,
                       const float* g, float* dx, float* dw_part, float* dw, int P, int B,
                       int C, int T, int F, float scale, void* stream) {
  const int n_tiles = (B + TILE_B - 1) / TILE_B;
  dim3 grid(n_tiles, P);
  fused_qat_bwd_kernel<<<grid, TILE_B, shared_bytes(C, T, F, true),
                         (cudaStream_t)stream>>>(x, thr, ids, w, g, dx, dw_part, B, C, T,
                                                 F, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int CF = C * F;
  const int64_t n = (int64_t)P * CF;
  dw_tile_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      dw_part, dw, P, n_tiles, CF);
  return (int)cudaGetLastError();
}

const char* fused_qat_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
