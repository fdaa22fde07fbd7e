// Fused block-diagonal mid layer, backward, one member-owned pass:
//   du   = dy ⊙ g'
//   dx_m = du_m · W_m        (B × ib·blk: the member's input columns)
//   dW_m = du_mᵀ · x_m       (every parameter tile of the member)
//   pass-through members: dx = du on their tiles, no dW.
//
// Replaces the TPU kernel repro/kernels/fused_layer.py::fused_layer_dx_dw,
// the backward of repro/kernels/ops.py::fused_layer's custom VJP.  dy, g'
// (B, n_out_tiles·blk), x (B, n_in_tiles·blk), the parameter tiles wb
// (n_param_blocks, blk, blk) member-major as the forward reads them (tile
// (r, c) of a member is its output tile r, input tile c: wb[q + r·ld + c],
// each tile [output unit][input unit]), and the work units and jobs of
// fused_layer.py::dx_dw_units → dx (B, n_in_tiles·blk) and dWB
// (n_param_blocks, blk, blk) f32.  The bias cotangent Σ_b du stays a plain
// tensor op outside, as in the JAX package.
//
// The TPU kernel walks the transposed steps on a sequential grid, carrying
// dx run sums and each dW tile across batch tiles in VMEM.  Here the
// layout's member-major rectangles do the work: a unit is one member, or
// one chunk [c0, c1) of its input-tile columns, and owns dx[:, c0:c1] and
// dW[all rows, c0:c1] — every output has one owner, no atomics, one fixed
// summation order: a step is bitwise reproducible.  A unit stages du (formed
// once from dy and g'), its x columns and its weight columns in shared
// memory, then forms dx from du and W and dW from du and x, each thread a
// 4 × 4 register tile fed by two 16-byte shared-memory reads per 16 FMA.
// Members wider than a stage are walked in chunks: 64 columns, 32 output
// units, 32 batch rows at a time, dx summed in registers over the output
// chunks, dW added into its own slice in global memory, in order, over the
// batch chunks.
//
// Packing (member_units.cuh, shared with block_diag.cu's dW): a job is one
// CTA of 128 threads.  A unit of more than 8 output or 16 input units takes
// the whole CTA (team job); smaller ones and pass-through runs go a warp
// each, four to a CTA (warp job), so a block-8 member no longer costs a CTA
// for 256 outputs.  The warp jobs come first,
// so that these short, latency-bound jobs run beside the first wave of
// team jobs (heaviest first) and not in a tail of their own.  Any block 1–128,
// any B (16-byte global accesses where blk % 4 == 0 and the pointers
// allow; else a scalar instance).
//
// bf16 (the compute policy; fused_layer_dx_dw_bf16, kernel
// fused_layer_dx_dw_bf16_kernel): the same units over bf16 dy, g', x and
// tiles (8-byte loads, widened), du rounded to bf16 as the TPU kernel
// forms it from two bf16 tiles, dx and dWB stored in bf16, each rounded
// once (dWB's chunk sums in an f32 scratch past one 32-row batch chunk).
//
// What bounds it: bytes.  dy, g', x, the tiles, dx and dWB each cross
// memory once (a member wider than 64 columns re-reads its du per column
// chunk, from L2); at B = 32 the 4·B·blk² FLOP per tile are 32 FLOP per
// weight byte, under the card's f32 ridge once the FMAs are register-tiled.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "member_units.cuh"

namespace {

using namespace munits;

constexpr int SMEM = TeamStage::FLOATS > WARPS * WarpStage::FLOATS
                         ? TeamStage::FLOATS
                         : WARPS * WarpStage::FLOATS;

// T float, or bf16 under the compute policy: dy, g', x and the tiles bf16,
// du = dy · g' rounded to bf16 (repro/kernels/fused_layer.py:261), dx and
// dWB rounded once from their f32 sums; dws is dWB's f32 scratch where B
// spans more than one batch chunk (the chunks' sums added there, in
// order, as the f32 instance adds them in dWB), else null.
template <typename T>
struct Args {
  const T* dy;  // read through the read-only path (__ldg)
  const T* g;
  const T* x;
  const T* wb;
  T* dx;
  T* dwb;
  int B, in_w, out_w, blk;
  float* dws = nullptr;
};

// du = dy · g' as the replaced kernel forms it
template <typename T>
__device__ __forceinline__ float du_of(float d, float g) {
  if constexpr (std::is_same<T, bf16>::value)
    return bf16x::round_bf16(d * g);
  else
    return d * g;
}

// dx = du on a run of pass-through tiles
template <int NT, int V, typename T>
__device__ void pass_through(const int* u, const Args<T>& a, int l) {
  const int in0 = u[0], nc = u[1], out0 = u[2];
  const int nv = nc * a.blk / V;
  const long long n = (long long)a.B * nv;
  for (long long i = l; i < n; i += NT) {
    const int b = (int)(i / nv);
    const int c = (int)(i - (long long)b * nv) * V;
    const size_t at = (size_t)b * a.out_w + (size_t)out0 * a.blk + c;
    float d[V], gv[V];
    load<V>(a.dy + at, d);
    load<V>(a.g + at, gv);
#pragma unroll
    for (int e = 0; e < V; ++e) d[e] = du_of<T>(d[e], gv[e]);
    store<V>(a.dx + (size_t)b * a.in_w + (size_t)in0 * a.blk + c, d);
  }
}

// one unit on NT threads (lane l) over the stage at `s`
template <int NT, class S, int V, typename T>
__device__ void run_unit(const int* u, const Args<T>& a, float* s, int l) {
  constexpr bool BF = std::is_same<T, bf16>::value;
  if (u[4] < 0) {
    pass_through<NT, V>(u, a, l);
    return;
  }
  const int in0 = u[0], nc = u[1], out0 = u[2], no = u[3], q = u[4],
            ld = u[5];
  const int blk = a.blk;
  const int ncols = nc * blk, nouts = no * blk;
  const size_t xcol = (size_t)in0 * blk, ycol = (size_t)out0 * blk;
  float* xs = s + S::X;
  float* ws = s + S::W;
  float* dus = s + S::DU;
  float* dut = s + S::DUT;
  for (int cc0 = 0; cc0 < ncols; cc0 += S::CWM) {
    const int cw = min(S::CWM, ncols - cc0);
    const int txn = (cw + 3) >> 2;  // column groups of 4
    const int tx = l % txn, ty = l / txn;
    const int j0 = tx * 4, r0 = ty * 4;  // a 4 × 4 tile of each product
    for (int b0 = 0; b0 < a.B; b0 += S::BCH) {
      const int bc = min(S::BCH, a.B - b0);
      float adx[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) adx[i][j] = 0.f;
      for (int u0 = 0; u0 < nouts; u0 += S::OCH) {
        const int oc = min(S::OCH, nouts - u0);
        team_sync<NT>();  // the previous stage's readers are done
        if (u0 == 0) {    // x: bc rows × cw columns (this kernel's own
          // loop: with a shared staging helper here nvcc 12.8 gave the
          // vec4 instance 96 registers and a 16-byte spill, against 87
          // and none)
          const int nv = cw / V;
          for (int i = l; i < bc * nv; i += NT) {
            const int r = i / nv, j = (i - r * nv) * V;
            float v[V];
            load<V>(a.x + (size_t)(b0 + r) * a.in_w + xcol + cc0 + j, v);
#pragma unroll
            for (int e = 0; e < V; ++e) xs[r * S::CWM + j + e] = v[e];
          }
        }
        {  // du = dy · g': bc rows × oc units, in both layouts
          const int nv = oc / V;
          for (int i = l; i < bc * nv; i += NT) {
            const int r = i / nv, c = (i - r * nv) * V;
            const size_t at = (size_t)(b0 + r) * a.out_w + ycol + u0 + c;
            float d[V], gv[V];
            load<V>(a.dy + at, d);
            load<V>(a.g + at, gv);
#pragma unroll
            for (int e = 0; e < V; ++e) {
              const float v = du_of<T>(d[e], gv[e]);
              dus[r * S::OCH + c + e] = v;
              dut[(c + e) * S::DUT_LD + r] = v;
            }
          }
        }
        {  // W: oc output units × cw input units, from the member's tiles
          const int nv = cw / V;
          for (int i = l; i < oc * nv; i += NT) {
            const int r = i / nv, j = (i - r * nv) * V;
            const int ua = u0 + r, ja = cc0 + j;
            const size_t tile = (size_t)q + (size_t)(ua / blk) * ld + ja / blk;
            float v[V];
            load<V>(a.wb + (tile * blk + ua % blk) * blk + ja % blk, v);
#pragma unroll
            for (int e = 0; e < V; ++e) ws[r * S::CWM + j + e] = v[e];
          }
        }
        team_sync<NT>();
        if (r0 < bc) {  // dx rows r0.., columns j0..: Σ over this chunk's units
          for (int k = 0; k < oc; ++k)
            fma4x4(adx, lds4(dut + k * S::DUT_LD + r0),
                   lds4(ws + k * S::CWM + j0));
        }
        if (r0 < oc) {  // dW rows (units) r0.., columns j0..: Σ over bc rows
          float adw[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) adw[i][j] = 0.f;
          for (int k = 0; k < bc; ++k)
            fma4x4(adw, lds4(dus + k * S::OCH + r0), lds4(xs + k * S::CWM + j0));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int ua = u0 + r0 + i;
            if (r0 + i >= oc) break;
            const size_t row = (size_t)q + (size_t)(ua / blk) * ld;
            const int au = ua % blk;
            if constexpr (BF) {
              // the chunks' sums in the f32 scratch, the last one's total
              // rounded into dWB
              const bool last = b0 + S::BCH >= a.B;
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if (j0 + j < cw) {
                  const int ja = cc0 + j0 + j;
                  const size_t at =
                      ((row + ja / blk) * blk + au) * blk + ja % blk;
                  float v = adw[i][j];
                  if (b0 > 0) v = a.dws[at] + v;
                  if (last)
                    a.dwb[at] = __float2bfloat16_rn(v);
                  else
                    a.dws[at] = v;
                }
              }
            } else if constexpr (V == 4) {
              if (j0 < cw) {  // 4 columns of one tile (blk % 4 == 0)
                const int ja = cc0 + j0;
                float* p = a.dwb + ((row + ja / blk) * blk + au) * blk + ja % blk;
                float4 o = make_float4(adw[i][0], adw[i][1], adw[i][2],
                                       adw[i][3]);
                if (b0 > 0) {  // this unit's own slice, chunks in order
                  const float4 was = *reinterpret_cast<const float4*>(p);
                  o.x += was.x; o.y += was.y; o.z += was.z; o.w += was.w;
                }
                *reinterpret_cast<float4*>(p) = o;
              }
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if (j0 + j < cw) {
                  const int ja = cc0 + j0 + j;
                  float* p =
                      a.dwb + ((row + ja / blk) * blk + au) * blk + ja % blk;
                  *p = b0 > 0 ? *p + adw[i][j] : adw[i][j];
                }
              }
            }
          }
        }
      }
      if (r0 < bc) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (r0 + i >= bc) break;
          T* p = a.dx + (size_t)(b0 + r0 + i) * a.in_w + xcol + cc0 + j0;
          if constexpr (BF) {
            if constexpr (V == 4) {
              if (j0 < cw)
                bf16x::store4(p, adx[i][0], adx[i][1], adx[i][2], adx[i][3]);
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (j0 + j < cw) p[j] = __float2bfloat16_rn(adx[i][j]);
            }
          } else if constexpr (V == 4) {
            if (j0 < cw)
              *reinterpret_cast<float4*>(p) =
                  make_float4(adx[i][0], adx[i][1], adx[i][2], adx[i][3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (j0 + j < cw) p[j] = adx[i][j];
          }
        }
      }
    }
  }
}

template <int V>
struct DxDw {
  template <int NT, class S, typename T>
  __device__ __forceinline__ static void run(const int* u, const Args<T>& a,
                                             float* s, int l) {
    run_unit<NT, S, V>(u, a, s, l);
  }
};

template <int V>
__global__ void __launch_bounds__(THREADS)
fused_layer_dx_dw_kernel(Args<float> a, const int* __restrict__ units,
                         const int* __restrict__ job_ptr) {
  __shared__ __align__(16) float smem[SMEM];
  run_job<DxDw<V>>(a, units, job_ptr, smem, WarpStage::FLOATS);
}

template <int V>
__global__ void __launch_bounds__(THREADS)
fused_layer_dx_dw_bf16_kernel(Args<bf16> a, const int* __restrict__ units,
                              const int* __restrict__ job_ptr) {
  __shared__ __align__(16) float smem[SMEM];
  run_job<DxDw<V>>(a, units, job_ptr, smem, WarpStage::FLOATS);
}

}  // namespace

// The packing's shapes (member_units.cuh), which block_diag.py restates
// for member_units and pack_jobs: a team stage's columns, a warp stage's
// output units and columns, and the warps of a CTA (the units of a warp
// job).
extern "C" int fused_layer_dx_dw_stages(int* out) {
  out[0] = TeamStage::CWM;
  out[1] = WarpStage::OCH;
  out[2] = WarpStage::CWM;
  out[3] = WARPS;
  return 0;
}

// dy, g (B, n_out_tiles·blk), x (B, n_in_tiles·blk), wb (n_param, blk, blk),
// units (n_units, 8) and job_ptr (n_jobs + 1,) int32 → dx, dwb.
extern "C" int fused_layer_dx_dw_f32(const float* dy, const float* g,
                                     const float* x, const float* wb,
                                     const int* units, const int* job_ptr,
                                     float* dx, float* dwb, int B,
                                     int n_in_tiles, int n_out_tiles, int blk,
                                     int n_jobs, void* stream) {
  if (blk <= 0 || blk > MAX_BLK || B < 0 || n_jobs < 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)n_in_tiles * blk > INT_MAX ||
      (long long)n_out_tiles * blk > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || n_jobs == 0) return 0;
  const Args<float> a{dy, g, x, wb, dx, dwb, B, n_in_tiles * blk,
                      n_out_tiles * blk, blk};
  const bool v4 = blk % 4 == 0 && aligned16(dy) && aligned16(g) &&
                  aligned16(x) && aligned16(wb) && aligned16(dx) &&
                  aligned16(dwb);
  auto* kernel = v4 ? fused_layer_dx_dw_kernel<4> : fused_layer_dx_dw_kernel<1>;
  kernel<<<(unsigned)n_jobs, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, units, job_ptr);
  return (int)cudaGetLastError();
}

// The bf16 compute policy: dy, g, x, wb bf16 → dx, dwb bf16; dws
// (n_param, blk, blk) floats where B > 32 (dWB's f32 sums), else may be
// null.  The vec4 instance where blk % 4 == 0 and the bf16 tensors are
// 8-byte aligned (4 values a load).
extern "C" int fused_layer_dx_dw_bf16(const bf16* dy, const bf16* g,
                                      const bf16* x, const bf16* wb,
                                      const int* units, const int* job_ptr,
                                      bf16* dx, bf16* dwb, float* dws, int B,
                                      int n_in_tiles, int n_out_tiles,
                                      int blk, int n_jobs, void* stream) {
  if (blk <= 0 || blk > MAX_BLK || B < 0 || n_jobs < 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)n_in_tiles * blk > INT_MAX ||
      (long long)n_out_tiles * blk > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || n_jobs == 0) return 0;
  if (B > TeamStage::BCH && dws == nullptr) return (int)cudaErrorInvalidValue;
  Args<bf16> a{dy, g, x, wb, dx, dwb, B, n_in_tiles * blk,
               n_out_tiles * blk, blk};
  a.dws = dws;
  using bf16x::aligned8;
  const bool v4 = blk % 4 == 0 && aligned8(dy) && aligned8(g) &&
                  aligned8(x) && aligned8(wb) && aligned8(dx) &&
                  aligned8(dwb);
  auto* kernel = v4 ? fused_layer_dx_dw_bf16_kernel<4>
                    : fused_layer_dx_dw_bf16_kernel<1>;
  kernel<<<(unsigned)n_jobs, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, units, job_ptr);
  return (int)cudaGetLastError();
}
