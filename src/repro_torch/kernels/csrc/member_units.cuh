// The member-owned work of the mid layer's weight gradient, shared by the
// fused backward (fused_layer_dx_dw.cu: dx and dW in one pass) and the
// unfused one's dW (block_diag.cu):
//   * the units table (n_units, UNIT_INTS) of block_diag.py::member_units —
//     (in0, nc, out0, no, q, ld, warp, 0): input tiles [in0, in0 + nc) of
//     output tiles [out0, out0 + no), tile (r, c) the parameter tile
//     q + r·ld + c (q < 0: fused_layer_dx_dw's pass-through runs);
//   * its jobs (job_ptr, block_diag.py::pack_jobs): a CTA of THREADS
//     threads takes a team job (one unit, wider than a warp stage, on the
//     whole CTA) or a warp job (up to WARPS units, one a warp);
//   * the stage shapes of the two kinds and the staging and 4 × 4
//     register-tile helpers.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "bf16.cuh"

namespace munits {

using bf16x::bf16;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BLK = 128;
constexpr int UNIT_INTS = 8;  // in0, nc, out0, no, q, ld, warp, 0

// a stage: x [BCH][CWM], W [OCH][CWM], du [BCH][OCH], duᵀ [OCH][BCH + 4]
// (fused_layer_dx_dw); the dW-only pass uses x, then dy [BCH][OCH] at DY
template <int BCH_, int OCH_, int CWM_>
struct Stage {
  static constexpr int BCH = BCH_, OCH = OCH_, CWM = CWM_;
  static constexpr int DUT_LD = BCH + 4;  // 16-byte rows, 4-way staging
  static constexpr int X = 0;
  static constexpr int W = X + BCH * CWM;
  static constexpr int DU = W + OCH * CWM;
  static constexpr int DUT = DU + BCH * OCH;
  static constexpr int FLOATS = DUT + OCH * DUT_LD;
  static constexpr int DY = X + BCH * CWM;
  static constexpr int DW_FLOATS = DY + BCH * OCH;
  // the 4-row register tiles must cover BCH batch rows and OCH output units
  // with ≥ 8 thread rows: at most NT / 8 column groups of 4
  static_assert(BCH <= 32 && OCH <= 32 && CWM % 4 == 0 && OCH % 4 == 0,
                "stage shape");
};
using TeamStage = Stage<32, 32, 64>;  // the whole CTA on one unit
using WarpStage = Stage<32, 8, 16>;   // one warp on one unit
static_assert(TeamStage::CWM <= THREADS / 2 && WarpStage::CWM <= 32 / 2,
              "a column group of 4 per thread, at least 8 thread rows");

template <int NT>
__device__ __forceinline__ void team_sync() {
  if constexpr (NT == THREADS)
    __syncthreads();
  else
    __syncwarp();
}

template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    p[0] = v[0];
}

// bf16 (the compute policy): V values widened from one 8-byte load (V =
// 4), and stored rounded to nearest even, 4 packed in an 8-byte store
template <int V>
__device__ __forceinline__ void load(const bf16* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = bf16x::ldg4(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int V>
__device__ __forceinline__ void store(bf16* p, const float (&v)[V]) {
  if constexpr (V == 4)
    bf16x::store4(p, v[0], v[1], v[2], v[3]);
  else
    bf16x::store1(p, v[0]);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 a,
                                       const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// rows × cols values of a row-major global array (rows `gld` apart; f32,
// or bf16 widened) into f32 shared memory (rows `sld` apart), V at a time,
// over NT threads (thread l's piece i = l + k·NT at row i / nv, piece i
// mod nv, both stepped by NT's quotient and remainder rather than divided
// anew)
template <int NT, int V, typename T>
__device__ __forceinline__ void stage_rows(float* dst, int sld,
                                           const T* src, int gld,
                                           int rows, int cols, int l) {
  const int nv = cols / V;
  const int dr = NT / nv, dj = NT - dr * nv;
  int r = l / nv, j = l - r * nv;
  while (r < rows) {
    float v[V];
    load<V>(src + (size_t)r * gld + j * V, v);
#pragma unroll
    for (int e = 0; e < V; ++e) dst[r * sld + j * V + e] = v[e];
    r += dr;
    j += dj;
    if (j >= nv) j -= nv, ++r;
  }
}

// CTA blockIdx.x's job: a team job's units one after the other on the
// whole CTA, a warp job's one a warp.  Body::run<NT, S>(unit, args, stage,
// lane) does one unit on NT threads over the stage at `stage`; a warp's
// stage is `warp_floats` floats.
template <class Body, class A>
__device__ __forceinline__ void run_job(const A& a, const int* units,
                                        const int* job_ptr, float* smem,
                                        int warp_floats) {
  const int u_lo = job_ptr[blockIdx.x], u_hi = job_ptr[blockIdx.x + 1];
  if (u_lo >= u_hi) return;
  if (units[(size_t)u_lo * UNIT_INTS + 6] == 0) {  // team job
    for (int k = u_lo; k < u_hi; ++k)
      Body::template run<THREADS, TeamStage>(units + (size_t)k * UNIT_INTS,
                                             a, smem, threadIdx.x);
  } else {  // warp job: a unit a warp
    const int w = threadIdx.x >> 5;
    for (int k = u_lo + w; k < u_hi; k += WARPS)
      Body::template run<32, WarpStage>(units + (size_t)k * UNIT_INTS, a,
                                        smem + w * warp_floats,
                                        threadIdx.x & 31);
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace munits
