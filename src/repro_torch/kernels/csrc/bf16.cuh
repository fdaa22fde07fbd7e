// bf16 operands under the compute policy (DESIGN.md §7): the kernels'
// bf16 instances read activations and weights as bf16, widen each value to
// f32 (exact), multiply and sum in f32, and round each bf16 output once
// from its f32 value, to nearest even — the bits torch.Tensor.to(
// torch.bfloat16) gives the same f32 value.  Conversions through the
// intrinsics only (__bfloat162float, __bfloat1622float2,
// __float2bfloat16_rn, __floats2bfloat162_rn).
//
// The helpers are overloads of the f32 ones the cores already call (a
// pointer's type picks the instance), so an f32 instance compiles to what
// it was.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bf16x {

using bf16 = __nv_bfloat16;

// v rounded to bf16 and widened back: the value a bf16 store of v holds
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// one value as f32: widened from bf16, as it is from f32
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// 2 values from one 4-byte load (p 4-byte aligned)
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// 4 values from one 8-byte load (p 8-byte aligned)
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// the same through the read-only path
__device__ __forceinline__ float4 ldg4(const bf16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// 8 values from one 16-byte load (p 16-byte aligned)
__device__ __forceinline__ void load8(float (&v)[8], const bf16* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = t.x;
    v[2 * i + 1] = t.y;
  }
}

// a pair packed into one 4-byte word, each rounded to nearest even
__device__ __forceinline__ unsigned pack2(float a, float b) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&t);
}

// 4 values in one 8-byte store (p 8-byte aligned); CS: evict-first
template <bool CS = false>
__device__ __forceinline__ void store4(bf16* p, float a, float b, float c,
                                       float d) {
  const uint2 raw = make_uint2(pack2(a, b), pack2(c, d));
  if constexpr (CS)
    __stcs(reinterpret_cast<uint2*>(p), raw);
  else
    *reinterpret_cast<uint2*>(p) = raw;
}

// one value in a 2-byte store
template <bool CS = false>
__device__ __forceinline__ void store1(bf16* p, float v) {
  const bf16 t = __float2bfloat16_rn(v);
  if constexpr (CS)
    __stcs(reinterpret_cast<unsigned short*>(p),
           *reinterpret_cast<const unsigned short*>(&t));
  else
    *p = t;
}

inline bool aligned8(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 8 == 0;
}

}  // namespace bf16x
