// Fused block-diagonal mid layer, forward:
//   y[:, o] = act(u[:, o]) · mask[o],
//   u[:, o] = Σ_{steps s of output tile o} x[:, s_in[s]] · wb[s_w[s]]ᵀ
//             + b_eff[o]
// and, for training, g'[:, o] = act'(u[:, o]) · mask[o] as a second output.
//
// Replaces the TPU kernel repro/kernels/fused_layer.py::fused_layer_fwd,
// with_deriv=False (serving, repro/kernels/ops.py::fused_layer_infer:
// fused_layer_infer_f32 here) and with_deriv=True (training, the forward of
// ops.py::fused_layer's custom VJP: fused_layer_train_f32 here), and
// ::fused_layer_int8_fwd (the int8 serve copy, ops.py::fused_layer_infer_i8:
// fused_layer_infer_i8 here).
//
// x (B, n_in_tiles·blk), wb (n_param_blocks + 1, blk, blk) f32 with the
// shared identity tile appended (pass-through members), b_eff and mask
// (n_out_tiles·blk,) f32, one activation id per output tile (int32), and the
// layout's steps in CSR form (one CSR row per output tile) → y [and g']
// (B, n_out_tiles·blk) f32.
//
// The TPU kernel walks the flat ragged step list on a sequential grid axis
// and opens/closes a VMEM accumulator on s_first/s_last.  A GPU grid has no
// order, so every output has one owner that loops privately over its run of
// steps, in CSR order.
//
// f32: the product is block_diag_core.cuh, block_diag.cu's forward: one
// warp owning each group of rows of block_diag.py::fwd_groups (a member's output tiles over its input tiles,
// or a run of pass-through tiles through the identity tile), x and the
// tiles staged once a group with cp.async in two stages, a 4 × 8 register
// tile a lane.  This file's epilogue adds the gated bias, applies the
// tile's activation (and its derivative) and the mask: the warp stages u in
// shared memory and shares its outputs out over all 32 lanes (a group of
// one 8-unit tile would leave 24 idle), each lane 4 columns of one output
// tile, so it looks the activation up once and runs that one activation's
// code in a loop over its rows (a member's tiles share one, so a warp on
// one member does not diverge); y (and g') leave 16 bytes at a time,
// evict-first, where the vec4 instance runs.
//
// int8 (wb_q the packer's (n_param_blocks + 1, blk, blk) int8 array,
// identity tile appended, one f32 scale per tile, 1.0 for the identity):
// the same core and epilogue under the core's I8W weight policy — the
// tiles cross memory as bytes, a quarter of the f32 traffic, and each
// weight is formed as (float)q · scale before the FMA chain, as the
// replaced kernel forms it (so its bits are the f32 instance's on tiles
// dequantized the same way).
//
// int8 under the bf16 compute policy (fused_layer_infer_i8_bf16, kernel
// fused_layer_i8_bf16_group_kernel; JAX's fused_layer_int8_fwd on bf16
// x, repro/kernels/fused_layer.py:171-180, out dtype x's at :222): the core
// under its I8BW policy (I8W's tiles, scales and landing pass; x bf16,
// widened into the f32 stage as BF16W stages it) and this epilogue storing
// y in bf16, rounded once.
//
// bf16 (the compute policy; fused_layer_infer_bf16 / fused_layer_train_bf16,
// kernel fused_layer_bf16_group_kernel): the same core under its BF16W
// policy (x and the tiles bf16, widened into the f32 stage as a chunk is
// issued) and this epilogue storing y and g' in bf16, each rounded once
// from its f32 value, 4 values an 8-byte store (a lane's 4 columns).
//
// What bounds it: bytes at serving batch sizes.  Each step reads one
// blk × blk weight tile and one (32 × blk) input tile and does 2·32·blk²
// FLOP: 16 FLOP per weight byte at B = 32 (64 over int8 tiles), below the
// card's f32 ridge (67 TFLOP/s over 3.35 TB/s = 20) for f32 tiles.  Works
// for any blk ≤ 128 (block 8, the LayeredPopulation default, included).
#include <cstdint>
#include <cuda_runtime.h>

#include "activations.cuh"
#include "block_diag_core.cuh"

namespace {

// the forward's epilogue: y = act(u + b_eff)·mask (and g' =
// act'(u + b_eff)·mask), the replaced kernel's expressions; with BF (the
// bf16 compute policy) y and g' go to a.yh and a.gh, each rounded once to
// bf16, 4 values packed in an 8-byte store where the vec4 instance runs.  The lanes
// stage u (B rows × the group's ≤ 32 columns) in the stage just
// multiplied, then share the outputs out: a lane takes V consecutive
// columns of one output tile (one activation) and every (32 / quads)-th
// row, so a group of one 8-unit tile keeps all 32 lanes busy, and runs
// that activation's code in a loop over its rows.
template <bool DERIV, bool BF = false>
struct ActOut {
  static constexpr int ZLD = 36;  // a staged row: ≤ 32 columns, 4 (mod 8)

  template <int V>
  __device__ __forceinline__ static void store(float* p, const float* v) {
    if constexpr (V == 4)
      __stcs(reinterpret_cast<float4*>(p),
             make_float4(v[0], v[1], v[2], v[3]));
    else
      __stcs(p, v[0]);
  }
  template <int V>
  __device__ __forceinline__ static void store(bdcore::bf16* p,
                                               const float* v) {
    if constexpr (V == 4)
      bf16x::store4<true>(p, v[0], v[1], v[2], v[3]);
    else
      bf16x::store1<true>(p, v[0]);
  }

  template <int V, int ACT>
  __device__ static void rows(const bdcore::Args& a, const float* z,
                              size_t at, int row, int nb, int step,
                              const float (&bias)[V], const float (&m)[V]) {
#pragma unroll 1
    for (int b = row; b < nb; b += step) {
      float yv[V], gv[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float u = z[b * ZLD + e] + bias[e];
        yv[e] = apply_act(ACT, u) * m[e];
        if constexpr (DERIV) gv[e] = apply_act_deriv(ACT, u) * m[e];
      }
      const size_t o = at + (size_t)b * a.out_w;
      if constexpr (BF) {
        store<V>(a.yh + o, yv);
        if constexpr (DERIV) store<V>(a.gh + o, gv);
      } else {
        store<V>(a.y + o, yv);
        if constexpr (DERIV) store<V>(a.g + o, gv);
      }
    }
  }

  template <int V>
  __device__ __forceinline__ void run(const bdcore::Args& a,
                                      const bdcore::Rec& q, int lane,
                                      const float (&acc)[bdcore::RPL]
                                                        [bdcore::CG],
                                      float* z) const {
    const int nr = bdcore::nr_of(q.bits), nu = bdcore::nu_of(q.bits);
    const int b0 = q.bt * bdcore::BT, nb = min(bdcore::BT, a.B - b0);
    __syncwarp();  // every lane is done reading the stage
    int ub;
    const int r = bdcore::col_row(nu, lane >> 3, ub);
    if (r < nr) {
#pragma unroll
      for (int i = 0; i < bdcore::RPL; ++i) {
        const int b = (lane & 7) + 8 * i;
        if (b >= nb) break;
#pragma unroll
        for (int c = 0; c < bdcore::CG; ++c)
          if (ub + c < nu) z[b * ZLD + r * nu + ub + c] = acc[i][c];
      }
    }
    __syncwarp();
    const int quads = nr * nu / V, step = 32 / quads;
    if (lane >= step * quads) return;
    const int c = (lane % quads) * V, rr = c / nu;
    const int tile = q.row0 + rr;
    const size_t col = (size_t)tile * a.blk + bdcore::u0_of(q.bits) + c -
                       rr * nu;
    float bias[V], m[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      bias[e] = __ldg(a.b_eff + col + e);
      m[e] = __ldg(a.mask + col + e);
    }
    const float* zc = z + c;
    const size_t at = (size_t)b0 * a.out_w + col;
    const int row = lane / quads;
    switch (__ldg(a.tile_act + tile)) {
#define FL_ACT(id)                                         \
  case id:                                                 \
    rows<V, id>(a, zc, at, row, nb, step, bias, m);        \
    break;
      FL_ACT(0) FL_ACT(1) FL_ACT(2) FL_ACT(3) FL_ACT(4)
      FL_ACT(5) FL_ACT(6) FL_ACT(7) FL_ACT(8) FL_ACT(9)
#undef FL_ACT
      default:  // an unknown id: apply_act's poison
        rows<V, -1>(a, zc, at, row, nb, step, bias, m);
    }
  }
};

static_assert(bdcore::BT * ActOut<false>::ZLD <= bdcore::STAGE_FLOATS,
              "u of a group fits the stage");

template <int V, bool DERIV>
__global__ void __launch_bounds__(bdcore::THREADS, 3)
fused_layer_group_kernel(bdcore::Args a) {
  bdcore::run_groups<V, ActOut<DERIV>>(a);
}

template <int V>
__global__ void __launch_bounds__(bdcore::THREADS, 3)
fused_layer_i8_group_kernel(bdcore::Args a) {
  bdcore::run_groups<V, ActOut<false>, bdcore::I8W>(a);
}

template <int V, bool DERIV>
__global__ void __launch_bounds__(bdcore::THREADS, 3)
fused_layer_bf16_group_kernel(bdcore::Args a) {
  bdcore::run_groups<V, ActOut<DERIV, true>, bdcore::BF16W>(a);
}

template <int V>
__global__ void __launch_bounds__(bdcore::THREADS, 3)
fused_layer_i8_bf16_group_kernel(bdcore::Args a) {
  bdcore::run_groups<V, ActOut<false, true>, bdcore::I8BW>(a);
}

// the bf16 entries' launch: y (and g') bf16, x and the tiles bf16
int launch_bf16(const bdcore::bf16* x, const bdcore::bf16* wb,
                const float* b_eff, const float* mask, const int* tile_act,
                const int* s_in, const int* s_w, const int* groups,
                bdcore::bf16* y, bdcore::bf16* g, int B, int n_in_tiles,
                int n_out_tiles, int blk, int n_groups, void* stream) {
  if (n_out_tiles <= 0) return 0;
  bdcore::Args a{nullptr, nullptr, s_in,  s_w,      groups,
                 nullptr, nullptr, b_eff, mask,     tile_act,
                 B,       n_in_tiles, n_out_tiles, blk, n_groups};
  a.xh = x;
  a.wh = wb;
  a.yh = y;
  a.gh = g;
  if (g == nullptr)
    return bdcore::launch_groups(
        reinterpret_cast<const void*>(fused_layer_bf16_group_kernel<4, false>),
        reinterpret_cast<const void*>(fused_layer_bf16_group_kernel<1, false>),
        a, stream);
  return bdcore::launch_groups(
      reinterpret_cast<const void*>(fused_layer_bf16_group_kernel<4, true>),
      reinterpret_cast<const void*>(fused_layer_bf16_group_kernel<1, true>),
      a, stream);
}

}  // namespace

// x (B, n_in_tiles·blk), wb (n_tiles, blk, blk), b_eff, mask, tile_act, the
// CSR steps' s_in and s_w, and the group table (n_groups, 7) of its
// n_out_tiles rows (block_diag.py::fwd_groups) → y (and g').
extern "C" int fused_layer_infer_f32(const float* x, const float* wb,
                                     const float* b_eff, const float* mask,
                                     const int* tile_act, const int* s_in,
                                     const int* s_w, const int* groups,
                                     float* y, int B, int n_in_tiles,
                                     int n_out_tiles, int blk, int n_groups,
                                     void* stream) {
  if (n_out_tiles <= 0) return 0;
  bdcore::Args a{x,     wb,      s_in,  s_w,      groups,
                 y,     nullptr, b_eff, mask,     tile_act,
                 B,     n_in_tiles, n_out_tiles, blk, n_groups};
  return bdcore::launch_groups(
      reinterpret_cast<const void*>(fused_layer_group_kernel<4, false>),
      reinterpret_cast<const void*>(fused_layer_group_kernel<1, false>), a,
      stream);
}

extern "C" int fused_layer_train_f32(const float* x, const float* wb,
                                     const float* b_eff, const float* mask,
                                     const int* tile_act, const int* s_in,
                                     const int* s_w, const int* groups,
                                     float* y, float* g, int B,
                                     int n_in_tiles, int n_out_tiles, int blk,
                                     int n_groups, void* stream) {
  if (n_out_tiles <= 0) return 0;
  bdcore::Args a{x,     wb,      s_in,  s_w,      groups,
                 y,     g,       b_eff, mask,     tile_act,
                 B,     n_in_tiles, n_out_tiles, blk, n_groups};
  return bdcore::launch_groups(
      reinterpret_cast<const void*>(fused_layer_group_kernel<4, true>),
      reinterpret_cast<const void*>(fused_layer_group_kernel<1, true>), a,
      stream);
}

// wb_q (n_param_blocks + 1, blk, blk) int8, wb_scale (n_param_blocks + 1,),
// b_eff, mask, tile_act, the CSR steps' s_in and s_w, and the group table
// (n_groups, 7) → y.
extern "C" int fused_layer_infer_i8(const float* x, const int8_t* wb_q,
                                    const float* wb_scale,
                                    const float* b_eff, const float* mask,
                                    const int* tile_act, const int* s_in,
                                    const int* s_w, const int* groups,
                                    float* y, int B, int n_in_tiles,
                                    int n_out_tiles, int blk, int n_groups,
                                    void* stream) {
  if (n_out_tiles <= 0) return 0;
  bdcore::Args a{x,     nullptr, s_in,  s_w,      groups,
                 y,     nullptr, b_eff, mask,     tile_act,
                 B,     n_in_tiles, n_out_tiles, blk, n_groups,
                 wb_q,  wb_scale};
  return bdcore::launch_groups(
      reinterpret_cast<const void*>(fused_layer_i8_group_kernel<4>),
      reinterpret_cast<const void*>(fused_layer_i8_group_kernel<1>), a,
      stream);
}

// The bf16 compute policy: x (B, n_in_tiles·blk) and wb (n_tiles, blk, blk)
// bf16, b_eff, mask f32 → y (and g') bf16, each rounded once from its f32
// value; the group table as for the f32 entries.
extern "C" int fused_layer_infer_bf16(const bdcore::bf16* x,
                                      const bdcore::bf16* wb,
                                      const float* b_eff, const float* mask,
                                      const int* tile_act, const int* s_in,
                                      const int* s_w, const int* groups,
                                      bdcore::bf16* y, int B, int n_in_tiles,
                                      int n_out_tiles, int blk, int n_groups,
                                      void* stream) {
  return launch_bf16(x, wb, b_eff, mask, tile_act, s_in, s_w, groups, y,
                     nullptr, B, n_in_tiles, n_out_tiles, blk, n_groups,
                     stream);
}

extern "C" int fused_layer_train_bf16(const bdcore::bf16* x,
                                      const bdcore::bf16* wb,
                                      const float* b_eff, const float* mask,
                                      const int* tile_act, const int* s_in,
                                      const int* s_w, const int* groups,
                                      bdcore::bf16* y, bdcore::bf16* g, int B,
                                      int n_in_tiles, int n_out_tiles,
                                      int blk, int n_groups, void* stream) {
  return launch_bf16(x, wb, b_eff, mask, tile_act, s_in, s_w, groups, y, g,
                     B, n_in_tiles, n_out_tiles, blk, n_groups, stream);
}

// The int8 serve copy under the bf16 compute policy: x (B, n_in_tiles·blk)
// bf16, wb_q and wb_scale as for fused_layer_infer_i8 → y bf16, rounded
// once from its f32 value.
extern "C" int fused_layer_infer_i8_bf16(const bdcore::bf16* x,
                                         const int8_t* wb_q,
                                         const float* wb_scale,
                                         const float* b_eff,
                                         const float* mask,
                                         const int* tile_act,
                                         const int* s_in, const int* s_w,
                                         const int* groups, bdcore::bf16* y,
                                         int B, int n_in_tiles,
                                         int n_out_tiles, int blk,
                                         int n_groups, void* stream) {
  if (n_out_tiles <= 0) return 0;
  bdcore::Args a{nullptr, nullptr, s_in,  s_w,      groups,
                 nullptr, nullptr, b_eff, mask,     tile_act,
                 B,       n_in_tiles, n_out_tiles, blk, n_groups,
                 wb_q,    wb_scale};
  a.xh = x;
  a.yh = y;
  return bdcore::launch_groups(
      reinterpret_cast<const void*>(fused_layer_i8_bf16_group_kernel<4>),
      reinterpret_cast<const void*>(fused_layer_i8_bf16_group_kernel<1>),
      a, stream);
}
