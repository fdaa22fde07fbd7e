// Segmented activation, forward and backward: a different activation per
// hidden block in one pass over the tensor, the padding mask fused in.
//   forward:   y[b, c]  = act_{ids[c / blk]}(h[b, c]) · mask[c]
//   backward:  dh[b, c] = (dy[b, c] · mask[c]) · act'_{ids[c / blk]}(h[b, c])
//
// Replaces the TPU kernels repro/kernels/seg_act.py::seg_act (seg_act_f32
// here) and ::seg_act_bwd (seg_act_bwd_f32 here), the two halves of
// repro/kernels/ops.py::seg_act's custom VJP.  The backward forms
// (dy·mask) first and then routes it through the activation's derivative,
// in the order JAX's _bwd_kernel does.  h, dy (B, H) f32 row-major, ids
// (H / blk,) int32, mask (H,) f32 → (B, H) f32.
//
// The bf16 instances (seg_act_bf16, seg_act_bwd_bf16; JAX's kernels take
// bf16 h and dy beside the f32 mask and return h's dtype) widen h and dy
// to f32 with bf16.cuh's loads, compute the activation or its derivative
// and the mask product in f32 on the same epilogue functions, and round
// each output once to nearest even.  Their kernels are named apart
// (seg_act_bf16_fwd_kernel, seg_act_bf16_bwd_kernel); the f32 kernels are
// the same code as before them.
//
// The activations and their derivatives are the fused kernels' epilogue
// functions (activations.cuh), so this route computes the same expressions,
// kinks included: relu'(0) = 0, leaky_relu'(0) = 1, elu'(0) = 1,
// selu'(0) = scale·alpha, hardshrink'(±0.5) = 0.
//
// The TPU kernel walks (batch tile, hidden block) tiles with the block's
// activation id scalar-prefetched.  Here each thread owns VEC consecutive
// columns: it reads their ids and mask values once, then walks ROWS batch
// rows of them (CTA = THREADS·VEC columns × ROWS rows), with 16-byte loads
// and stores when H and the pointers allow (else VEC = 1).
//
// What bounds it: bytes.  Each element is read once and written once
// (forward 8 B, backward 12 B; bf16 4 B and 6 B) and costs at most a few dozen f32
// operations, far below the card's f32 ridge (20 FLOP per byte); the mask
// and ids are re-read once per group of ROWS rows, from L2.
#include <cstdint>
#include <cuda_runtime.h>

#include "activations.cuh"
#include "bf16.cuh"

namespace {

using bf16x::bf16;

constexpr int THREADS = 256;
constexpr int ROWS = 8;   // batch rows per CTA (grid.y covers the rest)

// VEC consecutive values as f32: one 16-byte load of f32, or one 8-byte
// load of bf16 widened (VEC 4)
template <int VEC>
__device__ __forceinline__ void load_vec(float (&v)[VEC],
                                         const float* __restrict__ p) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = p[0];
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(float (&v)[VEC],
                                         const bf16* __restrict__ p) {
  if constexpr (VEC == 4) {
    const float4 t = bf16x::load4(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* __restrict__ p,
                                          const float (&r)[VEC]) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  else
    p[0] = r[0];
}

// each value rounded once to bf16, to nearest even
template <int VEC>
__device__ __forceinline__ void store_vec(bf16* __restrict__ p,
                                          const float (&r)[VEC]) {
  if constexpr (VEC == 4)
    bf16x::store4(p, r[0], r[1], r[2], r[3]);
  else
    bf16x::store1(p, r[0]);
}

// T: the dtype of h, dy and the output (float or bf16); mask f32
template <typename T, int VEC, bool BWD>
__device__ __forceinline__ void seg_act_body(
    const T* __restrict__ h, const T* __restrict__ dy,
    const int* __restrict__ ids, const float* __restrict__ mask,
    T* __restrict__ out, int B, long long H, int blk) {
  const long long c0 =
      ((long long)blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (c0 >= H) return;
  int act[VEC];
  float m[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    act[v] = ids[(c0 + v) / blk];
    m[v] = mask[c0 + v];
  }
  const int b_end = min(B, (int)(blockIdx.y + 1) * ROWS);
#pragma unroll 4
  for (int b = blockIdx.y * ROWS; b < b_end; ++b) {
    const size_t at = (size_t)b * H + c0;
    float hv[VEC], r[VEC];
    load_vec<VEC>(hv, h + at);
    if constexpr (BWD) {
      float g[VEC];
      load_vec<VEC>(g, dy + at);
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        r[v] = (g[v] * m[v]) * apply_act_deriv(act[v], hv[v]);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) r[v] = apply_act(act[v], hv[v]) * m[v];
    }
    store_vec<VEC>(out + at, r);
  }
}

// two kernels a dtype, so that a profiler tells the directions and the
// instances apart
template <int VEC>
__global__ void __launch_bounds__(THREADS)
seg_act_fwd_kernel(const float* __restrict__ h, const int* __restrict__ ids,
                   const float* __restrict__ mask, float* __restrict__ y,
                   int B, long long H, int blk) {
  seg_act_body<float, VEC, false>(h, nullptr, ids, mask, y, B, H, blk);
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
seg_act_bwd_kernel(const float* __restrict__ h, const float* __restrict__ dy,
                   const int* __restrict__ ids,
                   const float* __restrict__ mask, float* __restrict__ dh,
                   int B, long long H, int blk) {
  seg_act_body<float, VEC, true>(h, dy, ids, mask, dh, B, H, blk);
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
seg_act_bf16_fwd_kernel(const bf16* __restrict__ h,
                        const int* __restrict__ ids,
                        const float* __restrict__ mask,
                        bf16* __restrict__ y, int B, long long H, int blk) {
  seg_act_body<bf16, VEC, false>(h, nullptr, ids, mask, y, B, H, blk);
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
seg_act_bf16_bwd_kernel(const bf16* __restrict__ h,
                        const bf16* __restrict__ dy,
                        const int* __restrict__ ids,
                        const float* __restrict__ mask,
                        bf16* __restrict__ dh, int B, long long H, int blk) {
  seg_act_body<bf16, VEC, true>(h, dy, ids, mask, dh, B, H, blk);
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool aligned8(const void* p) {
  return p == nullptr || bf16x::aligned8(p);
}

template <bool BWD>
int launch(const float* h, const float* dy, const int* ids, const float* mask,
           float* out, int B, long long H, int blk, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (blk <= 0 || H % blk) return (int)cudaErrorInvalidValue;
  const bool vec = H % 4 == 0 && aligned16(h) && aligned16(dy) &&
                   aligned16(out);
  const int v = vec ? 4 : 1;
  const long long gx = (H / v + THREADS - 1) / THREADS;
  const long long gy = (B + ROWS - 1) / ROWS;
  if (gx > 0x7fffffffLL || gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (BWD) {
    if (vec)
      seg_act_bwd_kernel<4><<<grid, THREADS, 0, s>>>(h, dy, ids, mask, out, B,
                                                     H, blk);
    else
      seg_act_bwd_kernel<1><<<grid, THREADS, 0, s>>>(h, dy, ids, mask, out, B,
                                                     H, blk);
  } else {
    if (vec)
      seg_act_fwd_kernel<4><<<grid, THREADS, 0, s>>>(h, ids, mask, out, B, H,
                                                     blk);
    else
      seg_act_fwd_kernel<1><<<grid, THREADS, 0, s>>>(h, ids, mask, out, B, H,
                                                     blk);
  }
  return (int)cudaGetLastError();
}

// the bf16 instances: VEC 4 where H % 4 == 0 and every bf16 pointer is
// 8-byte aligned (one 8-byte load or store of 4 values), else VEC 1
template <bool BWD>
int launch_bf16(const bf16* h, const bf16* dy, const int* ids,
                const float* mask, bf16* out, int B, long long H, int blk,
                void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (blk <= 0 || H % blk) return (int)cudaErrorInvalidValue;
  const bool vec = H % 4 == 0 && aligned8(h) && aligned8(dy) &&
                   aligned8(out);
  const int v = vec ? 4 : 1;
  const long long gx = (H / v + THREADS - 1) / THREADS;
  const long long gy = (B + ROWS - 1) / ROWS;
  if (gx > 0x7fffffffLL || gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (BWD) {
    if (vec)
      seg_act_bf16_bwd_kernel<4><<<grid, THREADS, 0, s>>>(h, dy, ids, mask,
                                                          out, B, H, blk);
    else
      seg_act_bf16_bwd_kernel<1><<<grid, THREADS, 0, s>>>(h, dy, ids, mask,
                                                          out, B, H, blk);
  } else {
    if (vec)
      seg_act_bf16_fwd_kernel<4><<<grid, THREADS, 0, s>>>(h, ids, mask, out,
                                                          B, H, blk);
    else
      seg_act_bf16_fwd_kernel<1><<<grid, THREADS, 0, s>>>(h, ids, mask, out,
                                                          B, H, blk);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int seg_act_f32(const float* h, const int* ids, const float* mask,
                           float* y, int B, long long H, int blk,
                           void* stream) {
  return launch<false>(h, nullptr, ids, mask, y, B, H, blk, stream);
}

extern "C" int seg_act_bwd_f32(const float* h, const float* dy,
                               const int* ids, const float* mask, float* dh,
                               int B, long long H, int blk, void* stream) {
  return launch<true>(h, dy, ids, mask, dh, B, H, blk, stream);
}

extern "C" int seg_act_bf16(const bf16* h, const int* ids, const float* mask,
                            bf16* y, int B, long long H, int blk,
                            void* stream) {
  return launch_bf16<false>(h, nullptr, ids, mask, y, B, H, blk, stream);
}

extern "C" int seg_act_bwd_bf16(const bf16* h, const bf16* dy,
                                const int* ids, const float* mask, bf16* dh,
                                int B, long long H, int blk, void* stream) {
  return launch_bf16<true>(h, dy, ids, mask, dh, B, H, blk, stream);
}
