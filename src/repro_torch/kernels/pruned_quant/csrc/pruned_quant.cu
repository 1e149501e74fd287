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
// Levels are integers: the result equals the plain version bit for bit.
//
// What bounds it on an H100: bytes.  It reads x (4 B) and writes the level
// (4 B) of each element once; at internvl2-26b's patch shape (1024 rows,
// C = 6144, N = 4) that is 51.07 MB, 0.0152 ms at 3.35 TB/s.  Close behind
// is instruction issue: the compiler lowers `if (v >= th) lv = max(lv, id)`
// to three instructions (FSETP, ISETP, SEL), 45 an element at T = 15, some
// 10 us of issue over the card's 132 SMs at 1.755 GHz; a compare and a
// predicated max written in PTX are two (FSETP, VIMNMX), about 6.4 us, and
// made the kernel a fifth faster on an NVIDIA H100 80GB HBM3 at 700 W.
//
// Design:
// * Tables in registers.  A thread owns W consecutive channels (W = 2 when C
//   is even and x is 8-byte aligned, else 1) and reads their T thresholds
//   and ids once into registers (RegBank<15, W>: N = 4, what every served
//   model and the co-design path use).  Every other width (N = 1..3, 5..8)
//   reads its tables through the L1 cache for every element (MemBank), a
//   generic loop no served path takes.  No shared memory, no __syncthreads.
// * Many rows a block.  A block of THREADS threads covers THREADS * W
//   channels and rows_per_block consecutive rows; the host plans the grid
//   (ops.launch_plan) so that about 4 blocks run on each SM, and every block
//   reads its tables once, so the tables cross L2 grid.y times in all (22 at
//   internvl2's shape).
// * Bytes in flight.  A thread loads U = 8 rows of its W channels (8-byte
//   accesses at W = 2, streaming cache hints) before it encodes any: 32 KB
//   of loads outstanding an SM at 4 blocks, 4.2 MB over the card, above the
//   ~2.5 MB that HBM's rate times its latency asks for.
//   Neighbouring threads read and write neighbouring channels of a row, so
//   every warp access is one contiguous 256-byte (W = 2) or 128-byte run.
// * Ragged shapes are masked, not padded: a thread past C returns, the row
//   loop ends at B with a one-row tail.
//
// Layouts: x (B, C) fp32 and levels (B, C) int32, contiguous; thr (C, T)
// fp32 and ids (C, T) int32, contiguous.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // threads a block (ops.THREADS)
constexpr int U = 8;          // rows a thread loads before it encodes (ops.ROWS_IN_FLIGHT)

// T comparators of W channels, held in registers.
template <int T, int W>
struct RegBank {
  float th[W][T];
  int id[W][T];
  __device__ __forceinline__ RegBank(const float* thr, const int* ids, int c0, int) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
#pragma unroll
      for (int t = 0; t < T; ++t) {
        th[w][t] = __ldg(thr + (int64_t)(c0 + w) * T + t);
        id[w][t] = __ldg(ids + (int64_t)(c0 + w) * T + t);
      }
    }
  }
  __device__ __forceinline__ int level(int w, float v) const {
    int lv = 0;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      // comparator t fires; the encoder keeps the largest id that fired: a
      // compare and a predicated max (the compiler's own lowering of the
      // same C++ takes a third instruction)
      asm("{\n\t.reg .pred p;\n\tsetp.ge.f32 p, %1, %2;\n\t@p max.s32 %0, %0, %3;\n\t}"
          : "+r"(lv)
          : "f"(v), "f"(th[w][t]), "r"(id[w][t]));
    }
    return lv;
  }
};

// Any T: the W channels' rows of the tables, read through L1 for each element.
template <int W>
struct MemBank {
  const float* th;
  const int* id;
  int T;
  __device__ __forceinline__ MemBank(const float* thr, const int* ids, int c0, int T_)
      : th(thr + (int64_t)c0 * T_), id(ids + (int64_t)c0 * T_), T(T_) {}
  __device__ __forceinline__ int level(int w, float v) const {
    int lv = 0;
    for (int t = 0; t < T; ++t) {
      if (v >= __ldg(th + w * T + t)) lv = max(lv, __ldg(id + w * T + t));
    }
    return lv;
  }
};

template <int W>
__device__ __forceinline__ void load_x(const float* p, float (&v)[W]);
template <>
__device__ __forceinline__ void load_x<1>(const float* p, float (&v)[1]) {
  v[0] = __ldcs(p);
}
template <>
__device__ __forceinline__ void load_x<2>(const float* p, float (&v)[2]) {
  const float2 t = __ldcs(reinterpret_cast<const float2*>(p));
  v[0] = t.x;
  v[1] = t.y;
}

template <int W>
__device__ __forceinline__ void store_levels(int* p, const int (&lv)[W]);
template <>
__device__ __forceinline__ void store_levels<1>(int* p, const int (&lv)[1]) {
  __stcs(p, lv[0]);
}
template <>
__device__ __forceinline__ void store_levels<2>(int* p, const int (&lv)[2]) {
  __stcs(reinterpret_cast<int2*>(p), make_int2(lv[0], lv[1]));
}

template <class Bank, int W>
__device__ __forceinline__ void encode_row(const Bank& bank, const float* xp, int* op) {
  float v[W];
  load_x<W>(xp, v);
  int lv[W];
#pragma unroll
  for (int w = 0; w < W; ++w) lv[w] = bank.level(w, v[w]);
  store_levels<W>(op, lv);
}

template <class Bank, int W>
__global__ void __launch_bounds__(THREADS)
pruned_quant_kernel(const float* __restrict__ x, const float* __restrict__ thr,
                    const int* __restrict__ ids, int* __restrict__ out, int B, int C,
                    int T, int rows_per_block) {
  const int c0 = (blockIdx.x * THREADS + threadIdx.x) * W;
  if (c0 >= C) return;  // W = 2 only for even C, so c0 + 1 < C too
  const Bank bank(thr, ids, c0, T);
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < B ? r0 + rows_per_block : (int64_t)B;
  const int64_t stride = C;
  const float* xp = x + r0 * stride + c0;
  int* op = out + r0 * stride + c0;
  int64_t r = r0;
  for (; r + U <= r1; r += U, xp += U * stride, op += U * stride) {
    float v[U][W];
#pragma unroll
    for (int i = 0; i < U; ++i) load_x<W>(xp + i * stride, v[i]);
#pragma unroll
    for (int i = 0; i < U; ++i) {
      int lv[W];
#pragma unroll
      for (int w = 0; w < W; ++w) lv[w] = bank.level(w, v[i][w]);
      store_levels<W>(op + i * stride, lv);
    }
  }
  for (; r < r1; ++r, xp += stride, op += stride) encode_row<Bank, W>(bank, xp, op);
}

template <class Bank, int W>
cudaError_t launch(const float* x, const float* thr, const int* ids, int* out, int B, int C,
                   int T, int rows_per_block, dim3 grid, cudaStream_t stream) {
  pruned_quant_kernel<Bank, W><<<grid, THREADS, 0, stream>>>(x, thr, ids, out, B, C, T,
                                                              rows_per_block);
  return cudaGetLastError();
}

template <int W>
cudaError_t dispatch(const float* x, const float* thr, const int* ids, int* out, int B, int C,
                     int T, int rows_per_block, dim3 grid, cudaStream_t stream) {
  return T == 15
      ? launch<RegBank<15, W>, W>(x, thr, ids, out, B, C, T, rows_per_block, grid, stream)
      : launch<MemBank<W>, W>(x, thr, ids, out, B, C, T, rows_per_block, grid, stream);
}

}  // namespace

extern "C" {

// x (B, C) fp32, thr (C, T) fp32, ids (C, T) int32 -> out (B, C) int32, on `stream`,
// on the grid that ops.launch_plan planned: `width` channels a thread,
// `rows_per_block` rows a block, grid (grid_x, grid_y).  A plan that misses a
// channel or a row, or a width the layout cannot take, is refused.
int pruned_quant(const void* x, const void* thr, const void* ids, void* out, int B, int C,
                 int T, int width, int rows_per_block, int grid_x, int grid_y, void* stream) {
  const bool aligned = ((uintptr_t)x % 8 == 0) && ((uintptr_t)out % 8 == 0);
  if (T < 1 || rows_per_block < 1 || grid_x < 1 || grid_y < 1 || grid_y > 65535 ||
      (width != 1 && width != 2) || (width == 2 && (C % 2 != 0 || !aligned)) ||
      (int64_t)grid_x * THREADS * width < C || (int64_t)grid_y * rows_per_block < B) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(grid_x, grid_y);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* tf = (const float*)thr;
  const int* ip = (const int*)ids;
  int* op = (int*)out;
  const cudaError_t err = width == 2
      ? dispatch<2>(xf, tf, ip, op, B, C, T, rows_per_block, grid, s)
      : dispatch<1>(xf, tf, ip, op, B, C, T, rows_per_block, grid, s);
  return (int)err;
}

const char* pruned_quant_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
