// Pruned flash-ADC comparator bank and priority encoder for Hopper (sm_90a): K1.
//
// Replaces the Pallas TPU kernel of the JAX reference,
// src/repro/kernels/pruned_quant/pruned_quant.py: _kernel (via
// pruned_quantize_pallas).  For row b and channel c:
//
//   level(b, c) = max_t  ids[c, t] * (x[b, c] >= thr[c, t])
//
// with pruned comparators carrying thr = +inf and ids = 0.  The compare is
// IEEE fp32 >=, so NaN fires no comparator (level 0), +inf fires every kept
// one, and an input equal to a threshold fires it, as the TPU kernel does.
//
// Design:
// * Grid (ceil(C / CB), row groups): one block per CB = 128 consecutive
//   channels and RB = 16 consecutive rows, one thread per channel walking
//   the rows.  Neighbouring threads read and write neighbouring channels of
//   a row, so every access to x and to the levels is coalesced along C.
// * The block's slice of the (C, T) tables (T = 2^N - 1) is staged once in
//   shared memory, transposed to [t][channel] so that the 32 threads of a
//   warp read 32 banks at each t; every row of the block reuses it, as the
//   TPU kernel pins the tables in VMEM while the batch axis streams.
// * Ragged rows and channels (B, C not multiples of RB, CB) are masked
//   here, not padded: a thread past C does nothing, the row loop stops at B.
//
// What bounds it on an H100: bytes.  It reads x (4 B) and writes the level
// (4 B) of each element once, and reads the tables once: at internvl2-26b's
// patch shape (1024 rows, C = 6144, N = 4) that is 51.07 MB, 0.0152 ms at
// 3.35 TB/s; its T compares and selects an element are 2.8 us at the fp32
// peak.  The kernel is a single streaming pass with nothing re-read from
// device memory but the small tables.  This first version is simple, not
// fast: each thread walks its rows one load at a time and reads its T
// comparators from shared memory for every element (PERF.md has its time
// against the bound and against torch.searchsorted).
//
// Layouts: x (B, C) fp32 and levels (B, C) int32, contiguous; thr (C, T)
// fp32 and ids (C, T) int32, contiguous.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CB = 128;  // channels a block (= threads)
constexpr int RB = 16;   // rows a block walks
constexpr int MAX_GRID_Y = 65535;

__global__ void __launch_bounds__(CB)
pruned_quant_kernel(const float* __restrict__ x, const float* __restrict__ thr,
                    const int* __restrict__ ids, int* __restrict__ out, int B, int C,
                    int T) {
  extern __shared__ unsigned char smem[];
  float* thr_s = reinterpret_cast<float*>(smem);
  int* ids_s = reinterpret_cast<int*>(thr_s + CB * T);

  const int c0 = blockIdx.x * CB;
  const int nc = min(CB, C - c0);
  // the slice thr[c0 : c0 + nc, :] is contiguous; stage it as [t][lc]
  const int64_t base = (int64_t)c0 * T;
  for (int i = threadIdx.x; i < nc * T; i += CB) {
    const int lc = i / T, t = i - lc * T;
    thr_s[t * CB + lc] = thr[base + i];
    ids_s[t * CB + lc] = ids[base + i];
  }
  __syncthreads();
  const int lc = threadIdx.x;
  if (lc >= nc) return;
  const int c = c0 + lc;
  for (int64_t r0 = (int64_t)blockIdx.y * RB; r0 < B; r0 += (int64_t)gridDim.y * RB) {
    const int64_t r1 = r0 + RB < B ? r0 + RB : B;
    for (int64_t r = r0; r < r1; ++r) {
      const float v = x[r * C + c];
      int level = 0;
      for (int t = 0; t < T; ++t) {
        // comparator t fires; the encoder keeps the largest id that fired
        if (v >= thr_s[t * CB + lc]) level = max(level, ids_s[t * CB + lc]);
      }
      out[r * C + c] = level;
    }
  }
}

size_t smem_bytes(int T) { return (size_t)CB * T * (sizeof(float) + sizeof(int)); }

}  // namespace

extern "C" {

// Shared memory one block needs for T comparators a channel, for the wrapper's checks.
size_t pruned_quant_shared_bytes(int T) { return smem_bytes(T); }

// x (B, C) fp32, thr (C, T) fp32, ids (C, T) int32 -> out (B, C) int32, on `stream`.
int pruned_quant(const void* x, const void* thr, const void* ids, void* out, int B, int C,
                 int T, void* stream) {
  const size_t bytes = smem_bytes(T);
  cudaError_t err = cudaFuncSetAttribute(
      pruned_quant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t row_groups = ((int64_t)B + RB - 1) / RB;
  dim3 grid((C + CB - 1) / CB, (unsigned)(row_groups < MAX_GRID_Y ? row_groups : MAX_GRID_Y));
  pruned_quant_kernel<<<grid, CB, bytes, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)thr, (const int*)ids, (int*)out, B, C, T);
  return (int)cudaGetLastError();
}

const char* pruned_quant_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
