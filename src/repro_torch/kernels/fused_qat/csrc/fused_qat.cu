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
// F <= 5 hidden units, T = 15 thresholds, 128 samples a step, P = 24 rows)
// one call moves some 0.4 MB and does ~2 MFLOP, well under a microsecond
// at 3.35 TB/s or 67 TFLOP/s fp32; a call is bound by its launch and by
// the latency of its longest chain of dependent steps.
//
// K2 (forward): a block per (tile of `tile` samples, row p), tile * max(C, F)
// threads rounded up to a warp, in two stages in one launch (the plan, from
// shapes alone, is ops.forward_plan; tile = 16 at the co-design shape, 192
// blocks of 352 threads):
// * comparator stage: thread i of the block owns element i of the tile's x
//   rows (sample i / C, channel i % C; the rows are contiguous, so a warp's
//   loads are one coalesced run).  The block first stages its row's tables
//   and weights in shared memory with coalesced loads; each thread copies
//   its channel's T thresholds and ids into registers (RegBank<15>, N = 4,
//   every co-design config; other T read them from shared memory, SmemBank)
//   and runs its T compares, a PTX compare and a predicated max each, as
//   K1 does.  The dependent chain of a thread is T = 15 steps, where one
//   thread a sample ran C x T = 315.  It writes h to a shared tile, which
//   stays out of device memory, as the Pallas kernel keeps it in VMEM.
// * matmul stage, after one __syncthreads: thread j < rows * F computes
//   out[s, f], (s, f) = divmod(j, F), as the fmaf chain over c = 0..C-1 from
//   0 of h[s, c] * w[c, f] (h from the shared tile, w staged), plus bias[f];
//   the tile's rows * F outputs are contiguous, so the stores coalesce.
//   These matmuls are far below one tensor-core tile and run on the fp32
//   pipes.
// Bits: h is the same value the first design computed (the level is a
// max over the fired ids, whatever the order; the dequant below), and each
// output is the same fmaf chain in channel order plus the bias, so the
// output equals the first design's bit for bit, for any tile: no sum depends
// on the tiling, on P or on the run, and there are no atomics.
//
// K3 (backward): a block per (channel c, row p), P x C blocks (504 at the
// co-design shape), one thread per sample.
// A thread recomputes h[b,c] (T compares, its tables read through L1, one
// address for the whole block), forms its F products h * g[b,f] for dw and,
// when dx is asked for, dx[b,c] by a 5-term chain; the block then sums the
// products over samples in a fixed tree.  One launch a call, no shared
// staging of tiles, no scratch and no second kernel: the block that owns
// channel c of row p sees all of that row's samples, so it writes dw[p,c,:]
// whole.  With need_dx false (training: x needs no gradient) nothing of dx
// is computed or written.
//
// Rounding: the dequant uses __fmul_rn / __fsub_rn / __fadd_rn so the
// compiler cannot contract `level*scale - x` into an FMA; that keeps h
// bit-identical to quantize_pruned_ste's `x + (v - x)`.  dx[b,c] is
// fmaf(g[b,f], w[c,f], acc) over f in order from 0, as the first version
// computed it.
//
// Order of dw's sums (K3), fixed by the shapes of one row only, so the same
// inputs give the same bits on every run and a row's result does not depend
// on P (the genome memo and the placement check rely on both); no atomics:
// * thread t (of BWD_THREADS = 128) takes samples t, t + 128, ... in index
//   order and adds each product __fmul_rn(h, g) to its own sum with
//   __fadd_rn, from 0 (at B <= 128 its sum is its one product, or 0);
// * each warp folds its 32 sums in halves by shuffles (lane i adds lane
//   i + 16, then i + 8, ..., 1);
// * the 4 warp sums are added as (w0 + w2) + (w1 + w3).
// fused_qat.ref.fused_backward_emulation repeats this order in plain
// PyTorch, for the CPU tests and to check the kernel's bits on the card.
//
// Layouts (all contiguous, row-major, fp32 unless noted):
//   x (P, B, C), thr (P, C, T), ids (P, C, T) int32, w (P, C, F), bias (P, F),
//   out (P, B, F), g (P, B, F), dx (P, B, C), dw (P, C, F).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The STE forward value x + (level * scale - x), rounded step by step.
static __device__ __forceinline__ float dequant_value(float xv, int lv, float scale) {
  float v = __fmul_rn((float)lv, scale);
  return __fadd_rn(xv, __fsub_rn(v, xv));
}

// Comparator bank, encoder and dequant of one input, the channel's tables
// read through L1 (K3).
static __device__ __forceinline__ float dequant_ste(float xv, const float* thr_s,
                                                    const int* ids_s, int T,
                                                    float scale) {
  int lv = 0;
  for (int t = 0; t < T; ++t) {
    // +inf at pruned slots never fires; x >= thr fires at equality
    if (xv >= thr_s[t]) lv = max(lv, ids_s[t]);
  }
  return dequant_value(xv, lv, scale);
}

namespace {

constexpr int FWD_MAX_THREADS = 1024;  // threads of a forward block at most (ops.MAX_THREADS)

// K2's comparator bank of one channel, T known at compile time: the tables
// copied from shared memory into registers, then a compare and a predicated
// max a comparator, written in PTX (the lines of K1's RegBank::level).
template <int T>
struct RegBank {
  float th[T];
  int id[T];
  __device__ __forceinline__ RegBank(const float* thr_s, const int* ids_s, int) {
#pragma unroll
    for (int t = 0; t < T; ++t) {
      th[t] = thr_s[t];
      id[t] = ids_s[t];
    }
  }
  __device__ __forceinline__ int level(float v) const {
    int lv = 0;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      // comparator t fires; the encoder keeps the largest id that fired: a
      // compare and a predicated max (the compiler's own lowering of the
      // same C++ takes a third instruction)
      asm("{\n\t.reg .pred p;\n\tsetp.ge.f32 p, %1, %2;\n\t@p max.s32 %0, %0, %3;\n\t}"
          : "+r"(lv)
          : "f"(v), "f"(th[t]), "r"(id[t]));
    }
    return lv;
  }
};

// Any T: the channel's tables read from shared memory for each compare.
struct SmemBank {
  const float* th;
  const int* id;
  int T;
  __device__ __forceinline__ SmemBank(const float* thr_s, const int* ids_s, int T_)
      : th(thr_s), id(ids_s), T(T_) {}
  __device__ __forceinline__ int level(float v) const {
    int lv = 0;
    for (int t = 0; t < T; ++t) {
      if (v >= th[t]) lv = max(lv, id[t]);
    }
    return lv;
  }
};

}  // namespace

// K2's dynamic shared memory: thr[C*T] f32 | ids[C*T] i32 | w[C*F] f32 |
// h[tile*C] f32 (ops.forward_plan counts the same bytes).
template <class Bank>
__global__ void __launch_bounds__(FWD_MAX_THREADS)
fused_qat_fwd_kernel(const float* __restrict__ x, const float* __restrict__ thr,
                     const int* __restrict__ ids, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ out, int B, int C,
                     int T, int F, float scale, int tile) {
  extern __shared__ float smem[];
  float* thr_s = smem;
  int* ids_s = (int*)(thr_s + C * T);
  float* w_s = (float*)(ids_s + C * T);
  float* h_s = w_s + C * F;
  const int p = blockIdx.y, tid = threadIdx.x;
  const int b0 = blockIdx.x * tile;
  const int rows = min(tile, B - b0);
  const int ct = C * T, cf = C * F;
  for (int i = tid; i < ct; i += blockDim.x) {  // the row's tables and weights
    thr_s[i] = thr[(int64_t)p * ct + i];
    ids_s[i] = ids[(int64_t)p * ct + i];
  }
  for (int i = tid; i < cf; i += blockDim.x) w_s[i] = w[(int64_t)p * cf + i];
  const int64_t e0 = (int64_t)p * B + b0;  // the tile's first sample in (P, B)
  float xv = 0.0f;
  if (tid < rows * C) xv = x[e0 * C + tid];  // issued before the barrier
  __syncthreads();
  // comparator stage: element tid = (sample tid / C, channel tid % C)
  if (tid < rows * C) {
    const int c = tid % C;
    const Bank bank(thr_s + c * T, ids_s + c * T, T);
    h_s[tid] = dequant_value(xv, bank.level(xv), scale);
  }
  __syncthreads();
  // matmul stage: output tid = (sample tid / F, unit tid % F), channels in order
  if (tid < rows * F) {
    const int s = tid / F, f = tid - s * F;
    const float* hs = h_s + s * C;
    float acc = 0.0f;
    for (int c = 0; c < C; ++c) acc = fmaf(hs[c], w_s[c * F + f], acc);
    out[e0 * F + tid] = __fadd_rn(acc, bias[(int64_t)p * F + f]);
  }
}

#define BWD_THREADS 128  // threads of a backward block (ref.BWD_THREADS)
#define BWD_WARPS (BWD_THREADS / 32)
#define BWD_FCHUNK 8     // dw outputs a thread sums at once; more F takes more passes

static_assert(BWD_WARPS == 4, "the cross-warp sum below is written for 4 warps");

__global__ void __launch_bounds__(BWD_THREADS)
fused_qat_bwd_kernel(const float* __restrict__ x, const float* __restrict__ thr,
                     const int* __restrict__ ids, const float* __restrict__ w,
                     const float* __restrict__ g, float* __restrict__ dx,
                     float* __restrict__ dw, int B, int C, int T, int F, float scale) {
  __shared__ float warp_sum[BWD_FCHUNK][BWD_WARPS];
  const int c = blockIdx.x, p = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t pc = (int64_t)p * C + c;
  const float* thr_c = thr + pc * T;
  const int* ids_c = ids + pc * T;
  const float* w_c = w + pc * F;
  const float* xp = x + (int64_t)p * B * C + c;  // x[p, b, c] = xp[b * C]
  const float* gp = g + (int64_t)p * B * F;      // g[p, b, :] = gp[b * F :]
  for (int f0 = 0; f0 < F; f0 += BWD_FCHUNK) {
    float acc[BWD_FCHUNK];
#pragma unroll
    for (int j = 0; j < BWD_FCHUNK; ++j) acc[j] = 0.0f;
    for (int b = tid; b < B; b += BWD_THREADS) {
      const float h = dequant_ste(xp[(int64_t)b * C], thr_c, ids_c, T, scale);
      const float* gb = gp + (int64_t)b * F;
#pragma unroll
      for (int j = 0; j < BWD_FCHUNK; ++j) {
        if (f0 + j < F) acc[j] = __fadd_rn(acc[j], __fmul_rn(h, gb[f0 + j]));
      }
      if (dx != nullptr && f0 == 0) {
        float d = 0.0f;
        for (int f = 0; f < F; ++f) d = fmaf(gb[f], w_c[f], d);
        dx[((int64_t)p * B + b) * C + c] = d;
      }
    }
#pragma unroll
    for (int j = 0; j < BWD_FCHUNK; ++j) {
      if (f0 + j < F) {  // the same for every thread of the block
        float v = acc[j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
        }
        if (lane == 0) warp_sum[j][warp] = v;
      }
    }
    __syncthreads();
    if (tid < BWD_FCHUNK && f0 + tid < F) {
      const float* s = warp_sum[tid];
      dw[pc * F + f0 + tid] = __fadd_rn(__fadd_rn(s[0], s[2]), __fadd_rn(s[1], s[3]));
    }
    __syncthreads();
  }
}

extern "C" {

// The plan (tile, threads, grid_x, shared_bytes) comes from ops.forward_plan;
// grid.y is the population.  One launch.
int fused_qat_forward(const float* x, const float* thr, const int* ids, const float* w,
                      const float* bias, float* out, int P, int B, int C, int T, int F,
                      float scale, int tile, int threads, int grid_x, int shared_bytes,
                      void* stream) {
  dim3 grid(grid_x, P);
  cudaStream_t st = (cudaStream_t)stream;
  if (T == 15) {  // N = 4: the tables in registers
    fused_qat_fwd_kernel<RegBank<15>><<<grid, threads, shared_bytes, st>>>(
        x, thr, ids, w, bias, out, B, C, T, F, scale, tile);
  } else {
    fused_qat_fwd_kernel<SmemBank><<<grid, threads, shared_bytes, st>>>(
        x, thr, ids, w, bias, out, B, C, T, F, scale, tile);
  }
  return (int)cudaGetLastError();
}

// dx may be null: then nothing of dx is computed.  One launch.
int fused_qat_backward(const float* x, const float* thr, const int* ids, const float* w,
                       const float* g, float* dx, float* dw, int P, int B, int C, int T,
                       int F, float scale, void* stream) {
  dim3 grid(C, P);
  fused_qat_bwd_kernel<<<grid, BWD_THREADS, 0, (cudaStream_t)stream>>>(
      x, thr, ids, w, g, dx, dw, B, C, T, F, scale);
  return (int)cudaGetLastError();
}

const char* fused_qat_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
