// Grouped GEMM over tokens sorted by expert — the MoE expert projection:
//   y[t] = x[t] · w[e(t)],   x (T, D), w (E, D, F) → y (T, F),
// where e(t) = block_expert_ids[t / block_t]: one expert id per run of
// block_t rows (every expert's token run is padded to a multiple of
// block_t upstream, by the MoE layer's capacity buffer).
//
// Replaces the TPU kernel repro/kernels/moe_gemm.py::moe_gemm, the
// pallas_call behind repro/kernels/ops.py::moe_gemm (forward only: JAX
// defines no VJP for it).  x, w and y all f32 (moe_gemm_f32) or all bf16
// (moe_gemm_bf16); the sum over D runs in f32 in both, and y is rounded to
// x's dtype once.  D and F are any sizes: the kernels mask the ragged
// edges (deepseek-moe-16b's F = 1408 is no multiple of the TPU's 512), so
// nothing is padded in memory.  block_t is a multiple of 8.  An expert id
// outside [0, E) gives NaN rows, and its tile is not read.
//
// The TPU kernel's grid is (T/block_t, F/block_f, D/block_d) with D
// innermost, an f32 VMEM accumulator carried across it, and the tile's
// expert id scalar-prefetched into the W BlockSpec's index map.  Here one
// CTA owns one output tile, reads its expert id from the int32 id tensor
// on the device, and loops over D itself.  Two designs, chosen by shape,
// the same rule as grouped_gemm.kernel_path:
//
// * bf16 with D % 8 == 0, F % 8 == 0 and block_t % 64 == 0 (every LM
//   configuration of the JAX package): the tensor cores.  A CTA owns a
//   (TM × 128) tile, TM = 128 where block_t % 128 == 0 and 64 otherwise, so
//   the tile lies inside one expert's run.  One producer warpgroup (one
//   thread) streams x's (TM × 64) K-major tile and w[e]'s (64 × 128)
//   MN-major tile, as two 64-column boxes, by TMA (a 2-D map over x, a 3-D
//   map over w, 128-byte swizzle; out-of-bounds D and F read as zeros)
//   through a ring of STAGES buffers, one full and one empty mbarrier
//   each.  TM / 64 consumer warpgroups each issue wgmma.m64n128k16 (B
//   through the transpose bit) over their 64 rows, four per 64-deep chunk,
//   keeping one chunk's group in flight while the next chunk's loads land;
//   the sums stay in the f32 accumulators and y is rounded to bf16 once and
//   stored masked at F.  CTAs walk groups of 512 rows (one expert's
//   capacity run at deepseek-moe-16b) with the row tile fastest, so w[e]'s
//   columns are read from HBM about once and from L2 by the group's other
//   row tiles.  TMA needs 16-byte row strides (D, F multiples of 8) and
//   wgmma 64-row tiles inside one expert, hence the rule.
// * every other shape, and f32: the FMA units, in f32.  Where block_t is a
//   multiple of 64, a register-tiled, software-pipelined SIMT GEMM
//   (moe_gemm_simt_kernel).  A CTA of 256 threads owns a (TM × 128) tile
//   inside one expert's run, TM = 128 where block_t % 128 == 0 and 64
//   otherwise, and walks its groups of 512 rows with the row tile fastest
//   (as the tensor-core kernel does, so a column tile of w[e] comes from
//   HBM about once and from L2 for the run's other row tiles).  Each thread
//   holds a (TM / 16 × 8) accumulator tile in registers: 8 warps in 2 × 4,
//   a warp's 8 × 4 threads each owning rows at a stride of 32 and columns
//   at a stride of 16 in groups of 4, so that every fragment is one float4
//   from shared memory and a warp's float4 reads touch distinct banks or
//   the same address: 64 FMAs for 4 shared loads a k-step at TM = 128.
//   D is walked in chunks of 16 through two shared-memory stages: while
//   chunk k's FMAs run, chunk k + 1's loads are in flight (w's rows,
//   contiguous in F, by 16-byte cp.async straight into the next stage; x's
//   rows by 16-byte loads into registers, stored K-major after the FMAs
//   with the 8-float groups XOR-swizzled by the k row, so that the
//   transposing stores and the float4 reads are both free of bank
//   conflicts); one __syncthreads a chunk.  16-byte loads need D and F
//   multiples of 4 and x, w, y 16-byte aligned (grouped_gemm.fma_instance
//   holds the same rule); otherwise the scalar instance of the same code
//   loads element by element, masked at the D and F edges.  bf16 operands
//   are converted to f32 as they are staged (no cp.async there).
//   Where block_t is not a multiple of 64, an 8-row tiling
//   (moe_gemm_kernel): a CTA owns (8 × 64) outputs, stages x's (8 × 16)
//   and w's (16 × 64) tiles per chunk of 16, 1 × 2 outputs a thread.
//   Either way the sum over D has one order inside one CTA: no atomics.
//
// What bounds it: operations, and in bf16 only just.  At deepseek-moe-16b's
// widths (64 experts, a capacity buffer of 512 rows each, T = 32,768, D
// 2048, F 1408) one projection is 2·T·D·F = 189 GFLOP: 0.191 ms at bf16's
// dense tensor-core 989 TFLOP/s, against 0.60 GB of bf16 bytes (x 134 MB,
// w 369 MB, y 92 MB) in 0.18 ms at 3.35 TB/s; in f32, 2.82 ms at
// 67 TFLOP/s for 1.19 GB (0.36 ms).
#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TN = 64;    // output columns per CTA
constexpr int KD = 16;    // reduction chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

// The 8-row tiling (block_t not a multiple of 64): TM rows per CTA, RM rows
// × CN columns per thread
template <typename T, int TM, int RM, int CN>
__global__ void __launch_bounds__(THREADS)
moe_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const int* __restrict__ eid, T* __restrict__ y, int D, int F,
                int E, int block_t) {
  constexpr int NX = TN / CN;          // threads along the columns
  constexpr int NY = TM / RM;          // threads along the rows
  static_assert(NX * NY == THREADS, "thread layout");
  constexpr int LA = TM + 4;           // row stride of the transposed x tile
  __shared__ float As[KD][LA];
  __shared__ float Bs[KD][TN];

  const int t0 = blockIdx.x * TM;
  const int f0 = blockIdx.y * TN;
  const int e = eid[t0 / block_t];     // TM divides block_t: one expert
  const int tx = threadIdx.x % NX, ty = threadIdx.x / NX;

  if (e < 0 || e >= E) {
    for (int idx = threadIdx.x; idx < TM * TN; idx += THREADS) {
      const int r = idx / TN, c = f0 + idx % TN;
      if (c < F) from_f32(NAN, y + (size_t)(t0 + r) * F + c);
    }
    return;
  }
  const T* xg = x + (size_t)t0 * D;
  const T* wg = w + (size_t)e * D * F;

  float acc[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += KD) {
    for (int idx = threadIdx.x; idx < TM * KD; idx += THREADS) {
      const int r = idx / KD, kk = idx % KD;
      As[kk][r] = k0 + kk < D ? to_f32(xg[(size_t)r * D + k0 + kk]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < KD * TN; idx += THREADS) {
      const int kk = idx / TN, c = idx % TN;
      Bs[kk][c] = (k0 + kk < D && f0 + c < F)
                      ? to_f32(wg[(size_t)(k0 + kk) * F + f0 + c])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      float a[RM], b[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = As[kk][ty * RM + i];
#pragma unroll
      for (int j = 0; j < CN; ++j) b[j] = Bs[kk][tx + NX * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    T* yr = y + (size_t)(t0 + ty * RM + i) * F;
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int c = f0 + tx + NX * j;
      if (c < F) from_f32(acc[i][j], yr + c);
    }
  }
}

// ---- the FMA path at block_t % 64 == 0: a register-tiled SIMT GEMM ----

namespace simt {

constexpr int TN = 128;          // output columns per CTA
constexpr int KC = 16;           // D per chunk
constexpr int GROUP_ROWS = 512;  // rows a CTA group walks, row tile fastest

using hopper::cp_async16;
using hopper::cp_async_wait_all;

// four consecutive elements, 16 (f32) or 8 (bf16) bytes, as f32
__device__ __forceinline__ void load4(float (&v)[4], const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(float (&v)[4], const __nv_bfloat16* p) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<const uint32_t*>(&lo);
  t.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = t;
}

// TM rows per CTA (128 or 64); VEC: 16-byte loads (the vec4 instance)
template <typename T, int TM, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
moe_gemm_simt_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const int* __restrict__ eid, T* __restrict__ y, int D,
                     int F, int E, int block_t, int n_t, int n_f) {
  constexpr int RM = TM / 16;                 // rows a thread: 8 or 4
  constexpr int WR = TM / 2;                  // rows a warp (2 × 4 warps)
  constexpr int KQ = KC / 4;                  // 4-groups of a row's chunk
  constexpr int GA = TM * KQ / THREADS;       // x's 4-groups a thread
  constexpr int GB = KC * TN / 4 / THREADS;   // w's 4-groups a thread
  constexpr bool ASYNC_W = VEC && std::is_same<T, float>::value;
  static_assert(RM % 4 == 0 && TM * KQ % THREADS == 0 &&
                KC * TN % (4 * THREADS) == 0 && 32 % KQ == 0, "tile shape");
  // x K-major, [stage][k][row ^ swizzle(k)]; w [stage][k][column]
  __shared__ __align__(16) float As[2][KC][TM];
  __shared__ __align__(16) float Bs[2][KC][TN];

  // this CTA's tile: groups of G row tiles × every column tile, the row
  // tile fastest inside a group
  constexpr int G = GROUP_ROWS / TM;
  const int group = blockIdx.x / (G * n_f);
  const int first = group * G;
  const int rows_g = min(G, n_t - first);
  const int r = blockIdx.x - group * G * n_f;
  const int t0 = (first + r % rows_g) * TM;
  const int f0 = (r / rows_g) * TN;
  const int e = eid[t0 / block_t];  // TM divides block_t: one expert
  const int tid = threadIdx.x;

  if (e < 0 || e >= E) {
    for (int idx = tid; idx < TM * TN; idx += THREADS) {
      const int c = f0 + idx % TN;
      if (c < F) from_f32(NAN, y + (size_t)(t0 + idx / TN) * F + c);
    }
    return;
  }
  const T* xg = x + (size_t)t0 * D;
  const T* wg = w + (size_t)e * D * F;

  // x's 4-group f of a chunk: row f / KQ, k's 4-group kq = f % KQ (a
  // warp reads 32 / KQ rows × 16·KQ contiguous bytes); stored at
  // As[k][row ^ (kq · 32 / KQ)], so a warp's 32 transposing stores hit 32
  // banks
  float ra[GA][4];
  auto load_x = [&](int k0) {
#pragma unroll
    for (int g = 0; g < GA; ++g) {
      const int f = g * THREADS + tid, m = f / KQ, k = k0 + (f % KQ) * 4;
      const T* p = xg + (size_t)m * D + k;
      if constexpr (VEC) {
        if (k < D) {
          load4(ra[g], p);
        } else {
#pragma unroll
          for (int v = 0; v < 4; ++v) ra[g][v] = 0.f;
        }
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v) ra[g][v] = k + v < D ? to_f32(p[v]) : 0.f;
      }
    }
  };
  auto store_x = [&](int s) {
#pragma unroll
    for (int g = 0; g < GA; ++g) {
      const int f = g * THREADS + tid, m = f / KQ, kq = f % KQ;
#pragma unroll
      for (int v = 0; v < 4; ++v)
        As[s][kq * 4 + v][m ^ (kq * 32 / KQ)] = ra[g][v];
    }
  };
  // w's 4-group g of a chunk: k row f / 32, columns (f % 32) · 4 (a warp
  // reads one row's 512 contiguous bytes); rows past D, columns past F
  // read as zeros
  float rb[ASYNC_W ? 1 : GB][4];
  auto load_w = [&](int k0, int s) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const int f = g * THREADS + tid, kk = f / 32, c = (f % 32) * 4;
      const int k = k0 + kk, col = f0 + c;
      const T* p = wg + (size_t)k * F + col;
      if constexpr (ASYNC_W) {
        const bool in = k < D && col < F;
        cp_async16(&Bs[s][kk][c], in ? p : wg, in);
      } else if constexpr (VEC) {
        if (k < D && col < F) {
          load4(rb[g], p);
        } else {
#pragma unroll
          for (int v = 0; v < 4; ++v) rb[g][v] = 0.f;
        }
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          rb[g][v] = k < D && col + v < F ? to_f32(p[v]) : 0.f;
      }
    }
  };
  auto store_w = [&](int s) {
    if constexpr (!ASYNC_W) {
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const int f = g * THREADS + tid;
        store4(&Bs[s][f / 32][(f % 32) * 4], rb[g]);
      }
    }
  };

  // the thread's outputs: rows row0 + 32·gi + i, columns col0 + 16·h + j
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = (warp / 4) * WR + (lane / 4) * 4;
  const int col0 = (warp % 4) * 32 + (lane % 4) * 4;
  float acc[RM][8];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (D + KC - 1) / KC;
  load_x(0);
  load_w(0, 0);
  store_x(0);
  store_w(0);
  cp_async_wait_all();
  __syncthreads();
  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc & 1;
    const bool more = kc + 1 < nk;
    if (more) {  // the next chunk's loads, in flight during the FMAs
      load_x((kc + 1) * KC);
      load_w((kc + 1) * KC, s ^ 1);
    }
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const int sw = (kk / 4) * (32 / KQ);
      float a[RM], b[8];
#pragma unroll
      for (int gi = 0; gi < RM / 4; ++gi) {
        const float4 t =
            *reinterpret_cast<const float4*>(&As[s][kk][(row0 + 32 * gi) ^ sw]);
        a[4 * gi] = t.x; a[4 * gi + 1] = t.y;
        a[4 * gi + 2] = t.z; a[4 * gi + 3] = t.w;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 t =
            *reinterpret_cast<const float4*>(&Bs[s][kk][col0 + 16 * h]);
        b[4 * h] = t.x; b[4 * h + 1] = t.y;
        b[4 * h + 2] = t.z; b[4 * h + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {  // the next stage, read by no thread since the last barrier
      store_x(s ^ 1);
      store_w(s ^ 1);
      cp_async_wait_all();
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    T* yr = y + (size_t)(t0 + row0 + 32 * (i / 4) + i % 4) * F;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = f0 + col0 + 16 * h;
      if constexpr (VEC) {
        if (c < F) store4(yr + c, &acc[i][4 * h]);  // F % 4 == 0
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < F) from_f32(acc[i][4 * h + j], yr + c + j);
      }
    }
  }
}

template <typename T, int TM, bool VEC>
int launch_at(const T* x, const T* w, const int* eid, T* y, long long Tn,
              int D, int F, int E, int block_t, cudaStream_t stream) {
  const long long n_t = Tn / TM, n_f = (F + TN - 1) / TN;
  if (n_t * n_f > INT_MAX) return (int)cudaErrorInvalidValue;
  moe_gemm_simt_kernel<T, TM, VEC><<<(unsigned)(n_t * n_f), THREADS, 0,
                                     stream>>>(x, w, eid, y, D, F, E, block_t,
                                               (int)n_t, (int)n_f);
  return (int)cudaGetLastError();
}

// grouped_gemm.fma_instance: 16-byte loads need D and F multiples of 4 and
// x, w, y 16-byte aligned
bool takes_vec4(int D, int F, const void* x, const void* w, const void* y) {
  const auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return D % 4 == 0 && F % 4 == 0 && al(x) && al(w) && al(y);
}

// block_t % 64 == 0: 128-row tiles where block_t % 128 == 0, else 64
template <typename T>
int launch(const T* x, const T* w, const int* eid, T* y, long long Tn, int D,
           int F, int E, int block_t, cudaStream_t s) {
  const bool vec = takes_vec4(D, F, x, w, y);
  if (block_t % 128 == 0)
    return vec ? launch_at<T, 128, true>(x, w, eid, y, Tn, D, F, E, block_t, s)
               : launch_at<T, 128, false>(x, w, eid, y, Tn, D, F, E, block_t,
                                          s);
  return vec ? launch_at<T, 64, true>(x, w, eid, y, Tn, D, F, E, block_t, s)
             : launch_at<T, 64, false>(x, w, eid, y, Tn, D, F, E, block_t, s);
}

}  // namespace simt

// The FMA path: the SIMT GEMM where block_t is a multiple of 64, else the
// 8-row tiling.
template <typename T>
int launch(const T* x, const T* w, const int* eid, T* y, long long Tn, int D,
           int F, int E, int block_t, void* stream) {
  if (Tn < 0 || D <= 0 || F <= 0 || E <= 0 || block_t <= 0 || block_t % 8 ||
      Tn % block_t)
    return (int)cudaErrorInvalidValue;
  if (Tn == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_t % 64 == 0)
    return simt::launch(x, w, eid, y, Tn, D, F, E, block_t, s);
  const long long n_t = Tn / 8;
  const long long n_f = (F + TN - 1) / TN;
  if (n_t > 0x7fffffffLL || n_f > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)n_t, (unsigned)n_f);
  moe_gemm_kernel<T, 8, 1, 2><<<grid, THREADS, 0, s>>>(x, w, eid, y, D, F, E,
                                                       block_t);
  return (int)cudaGetLastError();
}


// ---- bf16 on the tensor cores -------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int TN = 128;          // output columns per CTA
constexpr int KC = 64;           // D per chunk: one 128-byte swizzle span
constexpr int STAGES = 5;        // chunks in the ring
constexpr int GROUP_ROWS = 512;  // rows a CTA group walks, row tile fastest
constexpr int B_HALF = KC * 64 * 2;  // one 64-column box of w's tile

__host__ __device__ constexpr int stage_bytes(int nc) {
  return nc * 64 * KC * 2 + 2 * B_HALF;
}
__host__ __device__ constexpr size_t smem_bytes(int nc) {
  return 1024 + (size_t)STAGES * stage_bytes(nc) + 2 * STAGES * 8;
}

// NC consumer warpgroups, TM = 64·NC rows; one producer warpgroup after them
template <int NC>
__global__ void __launch_bounds__((NC + 1) * 128, 1)
moe_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const int* __restrict__ eid, bf16* __restrict__ y,
                      int D, int F, int E, int block_t, int n_t, int n_f) {
  using namespace hopper;
  constexpr int TM = 64 * NC;
  constexpr int A_BYTES = TM * KC * 2;
  constexpr int STAGE = stage_bytes(NC);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;

  // this CTA's tile: groups of G row tiles × every column tile, the row
  // tile fastest inside a group
  constexpr int G = GROUP_ROWS / TM;
  const int group = blockIdx.x / (G * n_f);
  const int first = group * G;
  const int rows_g = min(G, n_t - first);
  const int r = blockIdx.x - group * G * n_f;
  const int t0 = (first + r % rows_g) * TM;
  const int f0 = (r / rows_g) * TN;
  const int e = eid[t0 / block_t];  // TM divides block_t: one expert
  const bool valid = e >= 0 && e < E;
  const int nk = (D + KC - 1) / KC;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * 4);  // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == NC) {  // the producer: one thread issues every load
    if (threadIdx.x == NC * 128 && valid) {
      const bool second = f0 + 64 < F;  // a box wholly past F is not loaded
      const uint32_t bytes = A_BYTES + (second ? 2 : 1) * B_HALF;
      for (int kc = 0; kc < nk; ++kc) {
        const int s = kc % STAGES;
        mbar_wait(&empty[s], ((kc / STAGES) & 1) ^ 1);
        uint8_t* st = smem + s * STAGE;
        mbar_arrive_expect_tx(&full[s], bytes);
        tma_load_2d(st, &xmap, &full[s], kc * KC, t0);
        tma_load_3d(st + A_BYTES, &wmap, &full[s], f0, kc * KC, e);
        if (second)
          tma_load_3d(st + A_BYTES + B_HALF, &wmap, &full[s], f0 + 64,
                      kc * KC, e);
      }
    }
    return;
  }

  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int row0 = t0 + wg * 64 + (tid / 32) * 16 + lane / 4;
  if (!valid) {
    for (int idx = tid; idx < 64 * TN; idx += 128) {
      const int c = f0 + idx % TN;
      if (c < F)
        y[(size_t)(t0 + wg * 64 + idx / TN) * F + c] = __float2bfloat16(NAN);
    }
    return;
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc % STAGES;
    mbar_wait(&full[s], (kc / STAGES) & 1);
    const uint8_t* st = smem + s * STAGE;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      // A: this warpgroup's 64 rows, 16 deep (32 bytes further per step);
      // B: 16 rows of w (2048 bytes per step), the second box LBO away
      const uint64_t da = desc_sw128(st + wg * 64 * 128 + ks * 32, 16, 1024);
      const uint64_t db = desc_sw128(st + A_BYTES + ks * 2048, B_HALF, 1024);
      wgmma_m64n128_ss<1>(acc, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous chunk's products are done: free it
    if (kc > 0 && lane == 0) mbar_arrive(&empty[(kc - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    const int c = f0 + 8 * j + 2 * (lane % 4);
    if (c < F) {  // F % 8 == 0: a pair is wholly inside or outside
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)(row0 + 8 * i) * F +
                                           c) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

template <int NC>
int launch_nc(const bf16* x, const bf16* w, const int* eid, bf16* y,
              long long Tn, int D, int F, int E, int block_t,
              cudaStream_t stream) {
  constexpr int TM = 64 * NC;
  const long long n_t = Tn / TM, n_f = (F + TN - 1) / TN;
  if (n_t * n_f > INT_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap xm, wm;
  const cuuint64_t xdims[2] = {(cuuint64_t)D, (cuuint64_t)Tn};
  const cuuint64_t xstr[1] = {(cuuint64_t)D * 2};
  const cuuint32_t xbox[2] = {KC, TM};
  const cuuint64_t wdims[3] = {(cuuint64_t)F, (cuuint64_t)D, (cuuint64_t)E};
  const cuuint64_t wstr[2] = {(cuuint64_t)F * 2, (cuuint64_t)D * F * 2};
  const cuuint32_t wbox[3] = {64, KC, 1};
  int rc = hopper::make_map_bf16(&xm, x, 2, xdims, xstr, xbox);
  if (rc) return rc;
  rc = hopper::make_map_bf16(&wm, w, 3, wdims, wstr, wbox);
  if (rc) return rc;
  const size_t smem = smem_bytes(NC);
  const cudaError_t err = cudaFuncSetAttribute(
      moe_gemm_wgmma_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  moe_gemm_wgmma_kernel<NC><<<(unsigned)(n_t * n_f), (NC + 1) * 128, smem,
                              stream>>>(xm, wm, eid, y, D, F, E, block_t,
                                        (int)n_t, (int)n_f);
  return (int)cudaGetLastError();
}

// the shape rule (grouped_gemm.kernel_path): the tensor cores take it
bool takes(int D, int F, int block_t) {
  return D % 8 == 0 && F % 8 == 0 && block_t % 64 == 0;
}

// a shape that takes() holds
int launch(const bf16* x, const bf16* w, const int* eid, bf16* y,
           long long Tn, int D, int F, int E, int block_t, void* stream) {
  if (Tn < 0 || D <= 0 || F <= 0 || E <= 0 || block_t <= 0 || Tn % block_t)
    return (int)cudaErrorInvalidValue;
  if (Tn == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return block_t % 128 == 0
             ? launch_nc<2>(x, w, eid, y, Tn, D, F, E, block_t, s)
             : launch_nc<1>(x, w, eid, y, Tn, D, F, E, block_t, s);
}

}  // namespace tc

}  // namespace

// x (T, D), w (E, D, F), eid (T / block_t,) int32 → y (T, F), f32.
extern "C" int moe_gemm_f32(const float* x, const float* w, const int* eid,
                            float* y, long long T, int D, int F, int E,
                            int block_t, void* stream) {
  return launch(x, w, eid, y, T, D, F, E, block_t, stream);
}

// The same over bf16 x, w → y bf16 (f32 sums): on the tensor cores where
// D % 8 == 0, F % 8 == 0 and block_t % 64 == 0, else the FMA tiling.
extern "C" int moe_gemm_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                             const int* eid, __nv_bfloat16* y, long long T,
                             int D, int F, int E, int block_t, void* stream) {
  if (tc::takes(D, F, block_t))
    return tc::launch(x, w, eid, y, T, D, F, E, block_t, stream);
  return launch(x, w, eid, y, T, D, F, E, block_t, stream);
}
