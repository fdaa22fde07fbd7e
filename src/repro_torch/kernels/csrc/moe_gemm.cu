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
// x's dtype once.  D and F are any sizes: the kernel masks the ragged edges
// (deepseek-moe-16b's F = 1408 is no multiple of the TPU's 512), so nothing
// is padded in memory.  block_t is a multiple of 8.
//
// The TPU kernel's grid is (T/block_t, F/block_f, D/block_d) with D
// innermost, an f32 VMEM accumulator carried across it, and the tile's
// expert id scalar-prefetched into the W BlockSpec's index map.  Here one
// CTA owns one (TM-row, 64-column) output tile, reads its expert id from
// the int32 id tensor on the device, and loops over D itself in chunks of
// 16: each chunk stages x's (TM × 16) and w's (16 × 64) tiles in shared
// memory as f32, and 256 threads accumulate RM × CN outputs each in
// registers (TM = 64 with 4 × 4 per thread when block_t is a multiple of
// 64, as the MoE layer's 128; else TM = 8 with 1 × 2).  The sum over D has
// one order inside one CTA: no atomics.  An expert id outside [0, E) gives
// NaN rows (the tile is not read out of bounds).
//
// What bounds it: operations.  At deepseek-moe-16b's widths (64 experts, a
// capacity buffer of 512 rows each, T = 32,768, D 2048, F 1408) one
// projection is 2·T·D·F = 189 GFLOP (2.82 ms at the f32 rate of
// 67 TFLOP/s, 0.191 ms at bf16's dense tensor-core 989) for 1.19 GB of
// f32 bytes (0.36 ms at 3.35 TB/s).  This first kernel is an FMA tiling
// for both dtypes; tensor cores (wgmma over TMA-fed bf16 tiles) and larger
// register tiles are left for later.
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// TM rows per CTA, RM rows × CN columns per thread
template <typename T, int TM, int RM, int CN>
__global__ void __launch_bounds__(THREADS)
moe_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const int* __restrict__ eid, T* __restrict__ y, int D, int F,
                int E, int block_t) {
  constexpr int NX = TN / CN;          // threads along the columns
  constexpr int NY = TM / RM;          // threads along the rows
  static_assert(NX * NY == THREADS, "thread layout");
  constexpr int LA = TM + 4;           // row stride of the transposed x tile
  __shared__ __align__(16) float As[KD][LA];
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
      if constexpr (RM == 4) {
        const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        a[0] = a4.x; a[1] = a4.y; a[2] = a4.z; a[3] = a4.w;
      } else {
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = As[kk][ty * RM + i];
      }
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

template <typename T>
int launch(const T* x, const T* w, const int* eid, T* y, long long Tn, int D,
           int F, int E, int block_t, void* stream) {
  if (Tn < 0 || D <= 0 || F <= 0 || E <= 0 || block_t <= 0 || block_t % 8 ||
      Tn % block_t)
    return (int)cudaErrorInvalidValue;
  if (Tn == 0) return 0;
  const bool wide = block_t % 64 == 0;
  const long long n_t = Tn / (wide ? 64 : 8);
  const long long n_f = (F + TN - 1) / TN;
  if (n_t > 0x7fffffffLL || n_f > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)n_t, (unsigned)n_f);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide)
    moe_gemm_kernel<T, 64, 4, 4><<<grid, THREADS, 0, s>>>(x, w, eid, y, D, F,
                                                          E, block_t);
  else
    moe_gemm_kernel<T, 8, 1, 2><<<grid, THREADS, 0, s>>>(x, w, eid, y, D, F,
                                                         E, block_t);
  return (int)cudaGetLastError();
}

}  // namespace

// x (T, D), w (E, D, F), eid (T / block_t,) int32 → y (T, F), f32.
extern "C" int moe_gemm_f32(const float* x, const float* w, const int* eid,
                            float* y, long long T, int D, int F, int E,
                            int block_t, void* stream) {
  return launch(x, w, eid, y, T, D, F, E, block_t, stream);
}

// The same over bf16 x, w → y bf16 (f32 sums).
extern "C" int moe_gemm_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                             const int* eid, __nv_bfloat16* y, long long T,
                             int D, int F, int E, int block_t, void* stream) {
  return launch(x, w, eid, y, T, D, F, E, block_t, stream);
}
