// The backward role of the streaming output heads, shared by the training
// loss head's backward (loss_head.cu: dh and dW of the logits' cotangent
// dl · d_per) and the M3 dW (m3_matmul.cu: dW alone, no d_per):
//
//   dh[b, j] = Σ_o g[b, m(j), o] · w2[o, j]        (DH only)
//   dW[o, j] = Σ_b g[b, m(j), o] · h[b, j]
//
// with g = dl · d_per[m] (dl as it is where d_per is absent: the dW-only
// instance), m(j) the member of unit j's block (block_seg), h (B, H), w2
// and dW (O, H), dl (B, P, ·) with its classes at stride ldo (O with DH).
// What bounds it is bytes (h read once, dh and dW written once; dl is
// small), so, one role: a CTA takes a tile of units (not aligned to
// members), stages g of the blocks the tile touches in shared memory, a
// chunk of rows at a time (dl is read once a block, not once a unit;
// without DH each lane's first rows of h are already in flight; with DH
// the loss head keeps its own order, its rows issued after the stage),
// then streams h (and writes dh) row by row while it accumulates dW in
// registers; the lanes' dW sums are added in lane order and written once.
// Each column's sum has one fixed order, no floating-point atomics: at one
// lane it runs b = 0 … B − 1 with fmaf(g, h, acc), at several each lane
// takes R rows of every R · lanes.  The tile, lanes and rows come from
// bwd_shape (the forward's lane rule, cta_lanes, and takes_vec4 of
// head_stream.cuh).
#pragma once

#include <algorithm>
#include <climits>
#include <cuda_runtime.h>

#include "head_stream.cuh"

namespace head {

constexpr int BWD_STAGE_FLOATS = 8192;  // the backward's g stage (32 KB)

// blocks a backward tile of U units touches (it need not start on one)
__host__ __device__ inline int bwd_max_blocks(int U, int block) {
  return (U - 1) / block + 2;
}

// floats of the backward's stage: g of `rows` rows, and after the rows the
// lanes' dW sums (T · VW floats) where there are several lanes
__host__ __device__ inline int bwd_stage_floats(int rows, int max_blk,
                                                int ot, int t_vw, int lanes) {
  const int stage = rows * max_blk * ot;
  return lanes > 1 && t_vw > stage ? t_vw : stage;
}

template <typename E>
struct given {  // E named, never deduced
  using type = E;
};

// One CTA's tile: writes its units' dW once, and with DH (the loss head's
// role) its dh, g being dl · d_per; without DH, dW alone of g = dl (d_per
// absent, no multiply; w2, dh and dper are not touched).  E is h's, w2's,
// dh's and dW's type: float, or bf16 under the compute policy, where g is
// rounded to bf16 as it is staged (repro/kernels/loss_head.py:157, :166:
// dl · d_per cast to the operands' dtype before each product) and dh and
// dW are rounded once from their f32 sums.  D is dl's type: f32, or, in
// the dW-only role under the compute policy (the M3 dW's bf16 dy), bf16,
// widened as it is staged.  Every thread must call it; it may be called
// again in the same launch (its shared-memory writes follow a barrier or
// touch what no thread reads after the last one).
template <int OT, int VW, bool DH, typename E = float, typename D = float>
__device__ __forceinline__ void stream_bwd(
    const float* __restrict__ dper, const D* __restrict__ dl, int ldo,
    const typename given<E>::type* __restrict__ h,
    const typename given<E>::type* __restrict__ w2,
    const int* __restrict__ block_seg, typename given<E>::type* __restrict__ dh,
    typename given<E>::type* __restrict__ dw, int B, int H, int O, int P,
    int block, int lanes, int rows) {
  constexpr int R = rows_in_flight<OT>();
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int TQ = T / lanes;          // unit slots; lanes of rows share them
  const int q = tid % TQ, lane = tid / TQ;
  const int U = VW * TQ;             // the tile
  const int GR = R * lanes;          // rows a group
  const int t0 = blockIdx.x * U;     // the tile's first unit
  const int kb0 = t0 / block;        // its first block
  const int nblk = (min(t0 + U, H) - 1) / block - kb0 + 1;
  const int max_blk = bwd_max_blocks(U, block);
  const int j = t0 + VW * q;         // this thread's first unit
  const bool act = j < H;
  const int slot = act ? j / block - kb0 : 0;  // its block in the stage
  extern __shared__ float smem[];
  float* stage = smem;               // [rows][nblk][OT]; then the dW sums
  float* sdper = stage + bwd_stage_floats(rows, max_blk, OT, T * VW, lanes);
  int* sseg = reinterpret_cast<int*>(sdper + max_blk);

  for (int k = tid; k < nblk; k += T) {
    const int m = block_seg[kb0 + k];
    sseg[k] = m;
    if constexpr (DH) sdper[k] = dper[m];
  }
  float w[OT][VW], acc[OT][VW];
#pragma unroll
  for (int o = 0; o < OT; ++o) {
    if constexpr (DH) {
      if (act && o < O) {
        load_units<VW>(w[o], w2 + (size_t)o * H + j);
      } else {
#pragma unroll
        for (int v = 0; v < VW; ++v) w[o][v] = 0.f;
      }
    }
#pragma unroll
    for (int v = 0; v < VW; ++v) acc[o][v] = 0.f;
  }

  for (int r0 = 0; r0 < B; r0 += rows) {
    const int nr = min(rows, B - r0);
    // dW alone: this lane's first rows of the chunk, in flight during the
    // staging (with DH, the loss head's codegen: its rows after the stage)
    float hv[R][VW];
    if constexpr (!DH)
      load_rows<R, VW>(hv, h, H, j, r0 + lane * R, act ? nr - lane * R : 0);
    __syncthreads();  // sseg / sdper written, the previous stage consumed
#pragma unroll 4
    for (int i = tid; i < nr * nblk * OT; i += T) {
      const int o = i % OT, k = (i / OT) % nblk, rr = i / (OT * nblk);
      if constexpr (DH && sizeof(E) == 2) {
        stage[i] =
            o < O ? bf16x::round_bf16(
                        dl[((size_t)(r0 + rr) * P + sseg[k]) * O + o] *
                        sdper[k])
                  : 0.f;
      } else if constexpr (DH) {
        stage[i] = o < O ? dl[((size_t)(r0 + rr) * P + sseg[k]) * O + o] *
                               sdper[k]
                         : 0.f;
      } else {
        const D* src = dl + ((size_t)(r0 + rr) * P + sseg[k]) * ldo + o;
        stage[i] = o < O ? bf16x::to_f32(*src) : 0.f;
      }
    }
    __syncthreads();
    if (!act) continue;
    // this lane's rows of a group: g + lane·R ... g + lane·R + R − 1
    for (int g = lane * R; g < nr; g += GR) {
      if (DH || g != lane * R)
        load_rows<R, VW>(hv, h, H, j, r0 + g, nr - g);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (g + r >= nr) break;
        const float* gr = stage + ((g + r) * nblk + slot) * OT;
        float d[VW];
#pragma unroll
        for (int v = 0; v < VW; ++v) d[v] = 0.f;
#pragma unroll
        for (int o = 0; o < OT; ++o) {
          const float gv = gr[o];
#pragma unroll
          for (int v = 0; v < VW; ++v) {
            if constexpr (DH) d[v] = fmaf(gv, w[o][v], d[v]);
            acc[o][v] = fmaf(gv, hv[r][v], acc[o][v]);
          }
        }
        if constexpr (DH)
          store_units<VW>(dh + (size_t)(r0 + g + r) * H + j, d);
      }
    }
  }
  if (lanes == 1) {
    if (!act) return;
#pragma unroll
    for (int o = 0; o < OT; ++o)
      if (o < O) store_units<VW>(dw + (size_t)o * H + j, acc[o]);
    return;
  }
  // dW: the lanes' sums added in lane order, one class at a time
#pragma unroll
  for (int o = 0; o < OT; ++o) {
    if (o >= O) break;
    __syncthreads();
    store_units<VW>(stage + (lane * TQ + q) * VW, acc[o]);
    __syncthreads();
    if (lane == 0 && act) {
      float s[VW];
#pragma unroll
      for (int v = 0; v < VW; ++v) s[v] = 0.f;
      for (int l = 0; l < lanes; ++l) {
#pragma unroll
        for (int v = 0; v < VW; ++v) s[v] += stage[(l * TQ + q) * VW + v];
      }
      store_units<VW>(dw + (size_t)o * H + j, s);
    }
  }
}

// A stream_bwd launch's shape: the instance (vec4 or scalar, by
// takes_vec4 of the tensors walked 4 units at a time), the lanes
// (cta_lanes), the tile, one CTA a tile, the rows a stage holds and the
// shared memory (the stage, then d_per and the member ids of the tile's
// blocks); false where the grid or the shared memory is out of range.
struct BwdShape {
  bool vec;
  int lanes, tile, rows;
  long long n_tiles;
  size_t smem;
};

template <int OT>
bool bwd_shape(int B, int H, int block, bool vec, BwdShape& s) {
  const int vw = vec ? 4 : 1;
  s.vec = vec;
  s.lanes = cta_lanes(H, vw);
  s.tile = vw * (MAX_THREADS / s.lanes);
  s.n_tiles = ((long long)H + s.tile - 1) / s.tile;
  const int max_blk = bwd_max_blocks(s.tile, block);
  s.rows = std::min(B, std::max(1, BWD_STAGE_FLOATS / (max_blk * OT)));
  s.smem = sizeof(float) * ((size_t)bwd_stage_floats(s.rows, max_blk, OT,
                                                     MAX_THREADS * vw,
                                                     s.lanes) +
                            max_blk) +
           sizeof(int) * max_blk;
  return s.n_tiles <= INT_MAX && s.smem <= SMEM_LIMIT;
}

}  // namespace head
