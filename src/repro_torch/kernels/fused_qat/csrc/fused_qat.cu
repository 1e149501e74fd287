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

// ---------------------------------------------------------------------------
// The QAT training step around K2/K3: qat_step_prep, qat_step_head and
// qat_step_update.
//
// They replace no TPU kernel (the reference runs the step as one XLA
// program).  They replace the chain of plain PyTorch ops the population step
// ran around K2 and K3, ~166 kernels a step at the co-design shape:
// core.qat.mlp_forward's po2 weight quantizer and hidden layers,
// cross_entropy, their autograd backward and the momentum update (the
// chain is core.trainer._chain_step).  A step of every row becomes five
// launches:
//
//   qat_step_prep    the step's samples X[idx[:, j]] gathered into (P, B, C),
//                    and every layer's po2-quantized weight (the STE's forward
//                    value w + (q - w))
//   K2               the first layer's pre-activations z1 (unchanged)
//   qat_step_head    a block a row: the hidden activations (relu, clip01,
//                    quantize_uniform), the dense layers, the cross-entropy and
//                    the backward down to g0 = dL/dz1, with every dw and db but
//                    dw0
//   K3               dw0 from g0, no dx (unchanged)
//   qat_step_update  v = momentum * v - lr * g, p += on * v on every parameter
//
// What bounds them: at P = 24 rows of the 21-5-3 MLP a step moves ~0.3 MB
// and does ~4 MFLOP, under a microsecond at 3.35 TB/s; each launch is bound
// by its latency, the head by its chain of dependent stages (a block a row,
// 24 of the card's 132 SMs busy at P = 24).
//
// Bits: each value is the op the chain ran, rounded as the torch kernel
// rounds it: fp32 throughout, products and sums through __fmul_rn /
// __fadd_rn / __fsub_rn (nvcc may not contract them into an FMA), quotients
// through __fdiv_rn, and the same log2f / exp2f / rintf / expf as torch's
// kernels.  Every sum keeps fixed_sum's pairwise tree (core/sums.py).  The
// backward is the one autograd runs for the chain: the STEs pass the
// gradient through, clip01's minimum and maximum pass half of it at a tie,
// relu passes nothing at 0, the cross-entropy's max is held constant.
// ref.qat_step writes the same step out in plain PyTorch ops.
// A block reads and writes one row only, so a row's result does not depend on
// the other rows of its call.

#define QS_MAX_LAYERS 4  // layers of the MLP (ops.MAX_LAYERS)
#define QS_MAX_WIDTH 32  // units of a hidden or output layer (ops.MAX_WIDTH)

// The MLP's parameters and the step's buffers, (P, ...) row-major, each
// contiguous: layer l's weight w[l] (P, sizes[l], sizes[l+1]) and bias b[l]
// (P, sizes[l+1]), their velocities vw, vb, the quantized weights wq, the
// gradients gw, gb.  Passed by value: a graph keeps the pointers.
struct QatNet {
  int n_layers;
  int sizes[QS_MAX_LAYERS + 1];
  float* w[QS_MAX_LAYERS];
  float* b[QS_MAX_LAYERS];
  float* vw[QS_MAX_LAYERS];
  float* vb[QS_MAX_LAYERS];
  float* wq[QS_MAX_LAYERS];
  float* gw[QS_MAX_LAYERS];
  float* gb[QS_MAX_LAYERS];
};

// torch.maximum / torch.minimum (and clamp, relu): NaN propagates
static __device__ __forceinline__ float t_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
static __device__ __forceinline__ float t_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// core.qat.quantize_pow2's forward value at per-row width `bits`
static __device__ __forceinline__ float quantize_pow2(float w, float bits) {
  const float e_lo = __fadd_rn(-exp2f(__fsub_rn(bits, 1.0f)), 1.0f);
  const float mag = fabsf(w);
  float e = rintf(log2f(t_max(mag, 1e-12f)));  // torch.round: half to even
  e = t_min(t_max(e, e_lo), 0.0f);
  const float sgn = (float)((0.0f < w) - (w < 0.0f));  // torch.sign
  float q = __fmul_rn(sgn, exp2f(e));
  if (mag < exp2f(__fsub_rn(e_lo, 1.0f))) q = 0.0f;
  return __fadd_rn(w, __fsub_rn(q, w));  // the STE: w + (q - w)
}

// A hidden activation's forward value: relu, clip01 = minimum(maximum(., 0),
// 1), then quantize_uniform at scale s = 2^act_bits - 1 with its STE.
static __device__ __forceinline__ float act_forward(float u, float s) {
  const float c = t_min(t_max(t_max(u, 0.0f), 0.0f), 1.0f);
  const float q = __fdiv_rn(t_min(t_max(rintf(__fmul_rn(c, s)), 0.0f), s), s);
  return __fadd_rn(c, __fsub_rn(q, c));
}

// Its gradient at pre-activation u from the gradient ga of its output, as
// autograd composes it: quantize_uniform's STE passes ga; minimum(c1, 1)
// halves it at c1 == 1 and drops it above; maximum(r, 0) halves it at r == 0
// and drops it below; relu drops it where its result is <= 0.
static __device__ __forceinline__ float act_backward(float u, float ga) {
  const float r = t_max(u, 0.0f), c1 = t_max(r, 0.0f);
  float d = ga;
  if (c1 == 1.0f) d = __fmul_rn(d, 0.5f); else if (c1 > 1.0f) d = 0.0f;
  if (r == 0.0f) d = __fmul_rn(d, 0.5f); else if (r < 0.0f) d = 0.0f;
  return r <= 0.0f ? 0.0f : d;
}

// fixed_sum's tree over v[0 .. n): v[i] += v[i + n/2] for i < n/2, an odd
// last element carried, until one is left.
static __device__ __forceinline__ float tree_local(float* v, int n) {
  while (n > 1) {
    const int h = n >> 1;
    for (int i = 0; i < h; ++i) v[i] = __fadd_rn(v[i], v[i + h]);
    if (n & 1) v[h] = v[2 * h];
    n = h + (n & 1);
  }
  return v[0];
}

// The same tree with n = N known at compile time: every index is a
// constant, so v stays in registers.
template <int N>
static __device__ __forceinline__ float tree_fixed(float* v) {
  if constexpr (N == 1) {
    return v[0];
  } else {
    constexpr int h = N / 2;
#pragma unroll
    for (int i = 0; i < h; ++i) v[i] = __fadd_rn(v[i], v[i + h]);
    if constexpr (N % 2 == 1) v[h] = v[2 * h];
    return tree_fixed<h + N % 2>(v);
  }
}

// W > 0: n == W, known at compile time
template <int W>
static __device__ __forceinline__ float tree(float* v, int n) {
  if constexpr (W > 0) {
    return tree_fixed<W>(v);
  } else {
    return tree_local(v, n);
  }
}

// fixed_sum's tree over the n rows of t (n x R, row-major), every column at
// once, by the whole block; the sums land in row 0.  Synchronises first (the
// caller's fill) and last.
static __device__ void tree_rows(float* t, int n, int R) {
  __syncthreads();
  while (n > 1) {
    const int h = n >> 1;
    for (int e = threadIdx.x; e < h * R; e += blockDim.x) t[e] = __fadd_rn(t[e], t[e + h * R]);
    __syncthreads();
    if (n & 1) {
      for (int r = threadIdx.x; r < R; r += blockDim.x) t[h * R + r] = t[2 * h * R + r];
      __syncthreads();
    }
    n = h + (n & 1);
  }
}

// qat_step_prep: a thread an element of row p (blockIdx.y): first the B x C
// gathered inputs (the thread of channel 0 also gathers the sample's label),
// then every layer's weights in order.
__global__ void qat_step_prep_kernel(const float* __restrict__ X, const int64_t* __restrict__ idx,
                                     int S, int j, int N, const int64_t* __restrict__ y,
                                     const float* __restrict__ wb, QatNet net,
                                     float* __restrict__ xg, int* __restrict__ yg, int B, int C) {
  const int p = blockIdx.y;
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < B * C) {
    const int b = e / C, c = e - b * C;
    const int64_t i = idx[((int64_t)p * S + j) * B + b];
    if (i < 0 || i >= N) __trap();  // torch's indexing asserts the same
    xg[(int64_t)p * B * C + e] = X[i * C + c];
    if (c == 0) {
      const int64_t label = y[i];
      if (label < 0 || label >= net.sizes[net.n_layers]) __trap();  // as torch.gather
      yg[(int64_t)p * B + b] = (int)label;
    }
    return;
  }
  e -= B * C;
  for (int l = 0; l < net.n_layers; ++l) {
    const int n = net.sizes[l] * net.sizes[l + 1];
    if (e < n) {
      const int64_t o = (int64_t)p * n + e;
      net.wq[l][o] = quantize_pow2(net.w[l][o], wb[p]);
      return;
    }
    e -= n;
  }
}

// One batch sum of the head: value(b) = sm[x + b * xs] * sm[y + b * ys]
// (sm[y + b * ys] alone where x < 0), offsets into the head's shared memory
// sm, summed over the batch into *out.
struct HeadSum {
  int x, y, xs, ys;
  float* out;
};

// The head's batch sums in order: each layer l >= 1's dw (J x K: a_l[:, i] *
// d_{l+1}[:, k]) then db (K: d_{l+1}[:, k]); last db0 (H: d_1[:, j]).  HW, KW
// as the head's: with them known, no layer is looked up at run time.
// a_o[l], d_o[l]: the offsets of a_l and d_l in sm.
template <int HW, int KW>
static __device__ __forceinline__ HeadSum head_sum(int r, const QatNet& net, int p,
                                                   const int* a_o, const int* d_o) {
  if constexpr (HW > 0) {
    if (r < HW * KW) {
      const int i = r / KW, k = r - i * KW;
      return {a_o[1] + i, d_o[2] + k, HW, KW, net.gw[1] + (int64_t)p * HW * KW + r};
    }
    r -= HW * KW;
    if (r < KW) return {-1, d_o[2] + r, 0, KW, net.gb[1] + (int64_t)p * KW + r};
    r -= KW;
    return {-1, d_o[1] + r, 0, HW, net.gb[0] + (int64_t)p * HW + r};
  }
  for (int l = 1; l < net.n_layers; ++l) {
    const int J = net.sizes[l], K = net.sizes[l + 1];
    if (r < J * K) {
      const int i = r / K, k = r - i * K;
      return {a_o[l] + i, d_o[l + 1] + k, J, K, net.gw[l] + (int64_t)p * J * K + r};
    }
    r -= J * K;
    if (r < K) return {-1, d_o[l + 1] + r, 0, K, net.gb[l] + (int64_t)p * K + r};
    r -= K;
  }
  const int H = net.sizes[1];
  return {-1, d_o[1] + r, 0, H, net.gb[0] + (int64_t)p * H + r};
}

static __device__ __forceinline__ float sum_value(const float* sm, const HeadSum& c, int b) {
  return c.x >= 0 ? __fmul_rn(sm[c.x + b * c.xs], sm[c.y + b * c.ys]) : sm[c.y + b * c.ys];
}

// A lane's part of the warp tree of one batch sum, M = B / 32 values a lane:
// lane t holds samples t, t + 32, ...; the levels of fixed_sum's tree above 32
// samples add register q + h to register q, in registers.
template <int M>
static __device__ __forceinline__ float lane_tree(const float* sm, const HeadSum& c, int lane) {
  float v[M];
#pragma unroll
  for (int q = 0; q < M; ++q) v[q] = sum_value(sm, c, lane + 32 * q);
#pragma unroll
  for (int h = M / 2; h >= 1; h >>= 1) {
#pragma unroll
    for (int q = 0; q < h; ++q) v[q] = __fadd_rn(v[q], v[q + h]);
  }
  return v[0];
}

#define QS_HEAD_THREADS 768  // a warp a batch sum: 23 of them at the co-design shape

// qat_step_head: a block a row, in four stages.
// * load: the row's weights and biases after the first layer, z1 (K2's
//   output), each sample's label (gathered by prep) and loss-term gradient
//   dce = (1 / denom) * w.
// * forward: each hidden layer's activation, then the dense layer after it
//   (a thread an output: its products in fixed_sum's tree over the inputs,
//   plus the bias); the last layer's output, the logits, lands in d_L.
// * backward, a thread a sample (nothing in it sums over the batch): the
//   cross-entropy's gradient in place over the logits, (dce / total) *
//   exp(l_k - m) less dce at the label, then each layer's dh (a tree over
//   its outputs) through the activation's gradient into d_l; g0 = d_1 out to
//   K3.
// * batch sums: every dw, db and db0 at once, each in fixed_sum's tree over
//   the batch.  Where B is 32 * 2^k (<= 1024; red_cols == 0) a warp takes a
//   sum: lane t holds samples t, t + 32, ...; the tree's levels above 32
//   are adds in registers (lane_tree), the last five shuffles.  Otherwise the sums go
//   through a (B x red_cols) table in shared memory, red_cols at a time.
// HW, KW > 0: an MLP of one hidden layer of HW units and KW classes, its
// widths known at compile time, so a thread's products, trees and class
// values stay in registers (the six datasets' topologies: ops.HEAD_WIDTHS);
// HW = KW = 0 reads every width at run time.  Either computes the same ops.
// Dynamic shared memory (ops.head_plan counts the same): wq_l, b_l for l >= 1
// | z_l, a_l for 1 <= l < L | d_l for 1 <= l <= L (B x sizes[l] each) | dce,
// labels (B each) | the table (B x red_cols).
template <int HW, int KW>
__global__ void __launch_bounds__(QS_HEAD_THREADS)
qat_step_head_kernel(const float* __restrict__ z1, const int* __restrict__ labels,
                     const float* __restrict__ wloss, const float* __restrict__ denom,
                     const float* __restrict__ ab, QatNet net, float* __restrict__ g0, int B,
                     int red_cols) {
  constexpr int VW = HW > 0 ? (HW > KW ? HW : KW) : QS_MAX_WIDTH;  // a thread's small arrays
  extern __shared__ float sm[];
  const int p = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int L = HW > 0 ? 2 : net.n_layers;
  // the width of layer l >= 1 (its units; l = L: the classes), known at
  // compile time in a fixed instance, where every l below is too
  auto n = [&](int l) { return HW > 0 ? (l == 1 ? HW : KW) : net.sizes[l]; };
  float* cur = sm;
  float* wq_s[QS_MAX_LAYERS];
  float* b_s[QS_MAX_LAYERS];
  float* z_s[QS_MAX_LAYERS];
  float* a_s[QS_MAX_LAYERS];
  float* d_s[QS_MAX_LAYERS + 1];
  int a_o[QS_MAX_LAYERS], d_o[QS_MAX_LAYERS + 1];  // offsets in sm, for the batch sums
  for (int l = 1; l < L; ++l) {
    wq_s[l] = cur;
    cur += n(l) * n(l + 1);
    b_s[l] = cur;
    cur += n(l + 1);
  }
  for (int l = 1; l < L; ++l) {
    z_s[l] = cur;
    cur += B * n(l);
    a_s[l] = cur;
    a_o[l] = (int)(cur - sm);
    cur += B * n(l);
  }
  for (int l = 1; l <= L; ++l) {
    d_s[l] = cur;
    d_o[l] = (int)(cur - sm);
    cur += B * n(l);
  }
  float* dce_s = cur;
  int* label_s = (int*)(cur + B);
  float* red = cur + 2 * B;

  const float inv = __fdiv_rn(1.0f, denom[p]);
  for (int b = tid; b < B; b += nt) {
    label_s[b] = labels[(int64_t)p * B + b];
    dce_s[b] = __fmul_rn(inv, wloss[(int64_t)p * B + b]);
  }
  for (int l = 1; l < L; ++l) {
    const int nw = n(l) * n(l + 1);
    for (int e = tid; e < nw; e += nt) wq_s[l][e] = net.wq[l][(int64_t)p * nw + e];
    for (int e = tid; e < n(l + 1); e += nt) b_s[l][e] = net.b[l][(int64_t)p * n(l + 1) + e];
  }
  float* first = L > 1 ? z_s[1] : d_s[1];  // z1 is the logits of a one-layer MLP
#pragma unroll 4
  for (int e = tid; e < B * n(1); e += nt) first[e] = z1[(int64_t)p * B * n(1) + e];
  __syncthreads();

  const float scale = __fsub_rn(exp2f(ab[p]), 1.0f);
  for (int l = 1; l < L; ++l) {
    const int J = n(l), K = n(l + 1);
    for (int e = tid; e < B * J; e += nt) a_s[l][e] = act_forward(z_s[l][e], scale);
    __syncthreads();
    float* out = l + 1 < L ? z_s[l + 1] : d_s[L];
    for (int e = tid; e < B * K; e += nt) {
      const int b = e / K, k = e - b * K;
      float v[VW];
#pragma unroll
      for (int i = 0; i < J; ++i) v[i] = __fmul_rn(a_s[l][b * J + i], wq_s[l][i * K + k]);
      out[e] = __fadd_rn(tree<HW>(v, J), b_s[l][k]);
    }
    __syncthreads();
  }

  for (int b = tid; b < B; b += nt) {
    const int K = n(L);
    float* lg = d_s[L] + b * K;
    float ex[VW];
#pragma unroll
    for (int k = 0; k < K; ++k) ex[k] = lg[k];
    float m = ex[0];
#pragma unroll
    for (int k = 1; k < K; ++k) m = t_max(m, ex[k]);
#pragma unroll
    for (int k = 0; k < K; ++k) ex[k] = expf(__fsub_rn(ex[k], m));
    float total = ex[0];
#pragma unroll
    for (int k = 1; k < K; ++k) total = __fadd_rn(total, ex[k]);
    const float dce = dce_s[b];
    const float dt = __fdiv_rn(dce, total);
    const int label = label_s[b];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float d = __fmul_rn(dt, ex[k]);
      if (k == label) d = __fadd_rn(d, -dce);
      lg[k] = d;
    }
    for (int l = L - 1; l >= 1; --l) {
      const int J = n(l), K1 = n(l + 1);
      const float* dz = d_s[l + 1] + b * K1;
#pragma unroll
      for (int i = 0; i < J; ++i) {
        float v[VW];
#pragma unroll
        for (int k = 0; k < K1; ++k) v[k] = __fmul_rn(dz[k], wq_s[l][i * K1 + k]);
        d_s[l][b * J + i] = act_backward(z_s[l][b * J + i], tree<KW>(v, K1));
      }
    }
    const int H = n(1);
#pragma unroll
    for (int i = 0; i < H; ++i) g0[((int64_t)p * B + b) * H + i] = d_s[1][b * H + i];
  }
  __syncthreads();

  int R = n(1);
  for (int l = 1; l < L; ++l) R += n(l) * n(l + 1) + n(l + 1);
  if (red_cols == 0) {
    const int lane = tid & 31, m = B >> 5;
    for (int r = tid >> 5; r < R; r += nt >> 5) {  // the same r across a warp
      const HeadSum c = head_sum<HW, KW>(r, net, p, a_o, d_o);
      float t;
      switch (m) {  // ops.head_plan: B = 32 * m, m a power of two <= 32
        case 1: t = lane_tree<1>(sm, c, lane); break;
        case 2: t = lane_tree<2>(sm, c, lane); break;
        case 4: t = lane_tree<4>(sm, c, lane); break;
        case 8: t = lane_tree<8>(sm, c, lane); break;
        case 16: t = lane_tree<16>(sm, c, lane); break;
        default: t = lane_tree<32>(sm, c, lane); break;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        t = __fadd_rn(t, __shfl_down_sync(0xffffffffu, t, off));
      }
      if (lane == 0) *c.out = t;
    }
  } else {
    for (int c0 = 0; c0 < R; c0 += red_cols) {
      const int rc = min(red_cols, R - c0);
      for (int e = tid; e < B * rc; e += nt) {
        const int b = e / rc;
        red[e] = sum_value(sm, head_sum<HW, KW>(c0 + e - b * rc, net, p, a_o, d_o), b);
      }
      tree_rows(red, B, rc);
      for (int r = tid; r < rc; r += nt) *head_sum<HW, KW>(c0 + r, net, p, a_o, d_o).out = red[r];
      __syncthreads();  // row 0 is read before the next pass fills the table
    }
  }
}

// qat_step_update: a thread an element of row p's parameters, every layer's
// weight then bias in order.  The velocity updates whatever the gate.
__global__ void qat_step_update_kernel(QatNet net, const float* __restrict__ lr,
                                       const float* __restrict__ gate, int S, int j,
                                       float momentum) {
  const int p = blockIdx.y;
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  const float lr_t = lr[(int64_t)p * S + j], on = gate[(int64_t)p * S + j];
  for (int l = 0; l < net.n_layers; ++l) {
    for (int part = 0; part < 2; ++part) {
      const int n = part ? net.sizes[l + 1] : net.sizes[l] * net.sizes[l + 1];
      if (e < n) {
        const int64_t o = (int64_t)p * n + e;
        float* prm = part ? net.b[l] : net.w[l];
        float* vel = part ? net.vb[l] : net.vw[l];
        const float g = (part ? net.gb[l] : net.gw[l])[o];
        const float v = __fsub_rn(__fmul_rn(momentum, vel[o]), __fmul_rn(lr_t, g));
        vel[o] = v;
        prm[o] = __fadd_rn(prm[o], __fmul_rn(on, v));
        return;
      }
      e -= n;
    }
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

// The step's three launches (plans: ops.prep_plan, head_plan, update_plan;
// grid.y or grid.x is the population).  One launch each.
int qat_step_prep(const float* X, const int64_t* idx, int S, int j, int N, const int64_t* y,
                  const float* wb, const QatNet* net, float* xg, int* yg, int P, int B, int C,
                  int threads, int grid_x, void* stream) {
  qat_step_prep_kernel<<<dim3(grid_x, P), threads, 0, (cudaStream_t)stream>>>(
      X, idx, S, j, N, y, wb, *net, xg, yg, B, C);
  return (int)cudaGetLastError();
}

// An instance with the widths known at compile time where the MLP has one
// hidden layer of the widths of ops.HEAD_WIDTHS, the generic one otherwise.
int qat_step_head(const float* z1, const int* labels, const float* wloss, const float* denom,
                  const float* ab, const QatNet* net, float* g0, int P, int B, int red_cols,
                  int threads, int shared_bytes, void* stream) {
  const int H = net->sizes[1], K = net->n_layers == 2 ? net->sizes[2] : 0;
  cudaStream_t st = (cudaStream_t)stream;
#define QS_HEAD(HW, KW)                                                         \
  qat_step_head_kernel<HW, KW><<<P, threads, shared_bytes, st>>>(z1, labels, wloss, denom, \
                                                                 ab, *net, g0, B, red_cols)
  if (H == 5 && K == 3) {
    QS_HEAD(5, 3);
  } else if (H == 3 && K == 3) {
    QS_HEAD(3, 3);
  } else if (H == 3 && K == 2) {
    QS_HEAD(3, 2);
  } else {
    QS_HEAD(0, 0);
  }
#undef QS_HEAD
  return (int)cudaGetLastError();
}

int qat_step_update(const QatNet* net, const float* lr, const float* gate, int S, int j,
                    float momentum, int P, int threads, int grid_x, void* stream) {
  qat_step_update_kernel<<<dim3(grid_x, P), threads, 0, (cudaStream_t)stream>>>(
      *net, lr, gate, S, j, momentum);
  return (int)cudaGetLastError();
}

const char* fused_qat_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
