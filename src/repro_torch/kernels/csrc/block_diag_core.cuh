// The block-sparse product shared by the unfused forward (block_diag.cu)
// and the fused mid layer's forward (fused_layer.cu, f32 and int8 tiles):
//   u[:, o] = Σ_{steps s of CSR row o} x[:, s_in[s]] · wb[s_w[s]]ᵀ
// walked by the groups of block_diag.py::fwd_groups, one warp a group, with
// the tiles read through a weight policy (F32W: f32 tiles; I8W: int8 tiles
// and one f32 scale a tile, each weight formed as (float)q · scale; BF16W:
// the bf16 compute policy, bf16 x and tiles widened to f32 as they are
// staged; I8BW: I8W's tiles under the bf16 compute policy, bf16 x widened
// as BF16W stages it) and u handed to an epilogue policy (u stored as it
// is, or bias, activation, mask and g'; in f32, or rounded once to bf16).
//
// A group (row0, nr, u0, nu, L, diag, s0) is nr consecutive CSR rows of L
// steps each, from step s0 on, and their output units [u0, u0 + nu):
//   * diag 0: every row has the same input tiles (a member's output tiles
//     over its input tiles, or in the transposed schedule its input tiles
//     over its output tiles): step j reads input tile s_in[s0 + j], row r's
//     step j weight tile s_w[s0 + r·L + j];
//   * diag 1 (L = 1): row r reads input tile s_in[s0 + r] through tile
//     s_w[s0 + r] (a run of pass-through members, through the identity
//     tile: kept a product, not a copy, so that -0 and a non-finite x
//     elsewhere in the tile give the product's bits).
//
// A group's reduction axis (its L steps, blk deep each) is cut into chunks
// of KC = 32; a chunk stages, for 32 batch rows, x's slice (one panel; a
// diag group one panel a row) and the matching slice of every output
// column's tile row in shared memory with cp.async (16-byte copies where
// the vec4 instance runs, else 4-byte), each tile's index read from s_in
// or s_w.  Each warp has two stages: its group's next chunk is in flight
// while the warp multiplies this one.  B > 32 runs the batch tiles of a
// group one after the other on the same warp (W again, from L2).
//
// A lane owns 4 batch rows (rg + 8i) × 8 consecutive units of one output
// tile: 32 accumulators, each starting at 0 and taking fmaf(x, w, acc) over
// the row's steps in CSR order and, within a step, over k = 0 … blk−1 —
// the chain of the kernels this replaces, so outputs are bitwise theirs.
// Per 4 deep a lane reads 4 float4 of x and 8 of W for 128 FMA; rows of the
// stage are 4 (mod 8) floats apart, conflict-free for the 8 lanes of a
// quarter-warp.  Batch rows past B take no FMA beyond the 8-row group.
//
// Grid: one warp a group, CTAs of WARPS independent warps.  The groups come
// heaviest first, so that the first wave of resident CTAs takes the
// largest and the light ones fill the slots as they free.  (A persistent
// grid, each warp walking groups w, w + n_warps, …, was slower: at B = 32 a
// group is a chunk or two, bound by the latency of its copies, and a
// warp's second group ran after its first on the launch's critical path.)
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "bf16.cuh"

namespace bdcore {

using bf16x::bf16;

constexpr int WARPS = 4;              // warps a CTA, each on its own group
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;             // a warp's stages: copy one, use one
constexpr int BT = 32;                // batch rows a pass
constexpr int KC = 32;                // reduction depth a chunk
constexpr int CG = 8;                 // units of a lane's register tile
constexpr int NG = 4;                 // column groups of a warp
constexpr int RPL = BT / 8;           // batch rows of a lane
constexpr int MAX_BLK = 128;
// row0, nr, u0, nu, L, diag, s0
constexpr int GROUP_INTS = 7;

// the row stride of a stage of kc deep: a multiple of 4 floats that is
// 4 (mod 8), so that the 8 rows a quarter-warp reads start in 8 different
// 4-bank slots
__host__ __device__ constexpr int stage_ld(int kc) {
  return ((kc + 3) & ~3) + 4 + 4 * ((((kc + 3) & ~3) / 4) & 1);
}
// a stage holds a chunk of any group of any block: a shared group's panel
// (BT × stage_ld(32)) or a diag group's ≤ NG panels (a block ≤ 8: ≤ 8
// deep; ≤ 16: 2 panels), and NG·CG column slots
constexpr int STAGE_FLOATS = BT * stage_ld(KC) + NG * CG * stage_ld(KC);
static_assert(NG * BT * stage_ld(8) + NG * CG * stage_ld(8) <= STAGE_FLOATS &&
                  2 * BT * stage_ld(16) + NG * CG * stage_ld(16) <=
                      STAGE_FLOATS,
              "a diag group's panels fit a stage");
constexpr int SMEM_BYTES = WARPS * STAGES * STAGE_FLOATS * 4;
static_assert(STAGES == 2, "run_groups alternates two stages");

struct Args {
  const float* x;
  const float* wb;
  const int* s_in;
  const int* s_w;
  const int* groups;
  float* y;
  float* g;              // g' (fused_layer's training epilogue)
  const float* b_eff;    // fused_layer's epilogue
  const float* mask;
  const int* tile_act;
  int B, in_w, out_w, blk, n_groups;
  const int8_t* wq = nullptr;      // I8W: the int8 tiles (wb unused)
  const float* wscale = nullptr;   // I8W: one scale a tile
  const bf16* xh = nullptr;        // BF16W: x and the tiles (x, wb unused)
  const bf16* wh = nullptr;
  bf16* yh = nullptr;              // a bf16 epilogue's y and g' (y, g unused)
  bf16* gh = nullptr;
};

// a group as its warp holds it (the table's row, packed): bits = nr | nu << 3
// | u0 << 9 | diag << 16
struct Packed {
  int row0, s0, L, bits;
};
__device__ __forceinline__ int nr_of(int bits) { return bits & 7; }
__device__ __forceinline__ int nu_of(int bits) { return (bits >> 3) & 63; }
__device__ __forceinline__ int u0_of(int bits) { return (bits >> 9) & 127; }
__device__ __forceinline__ bool diag_of(int bits) { return (bits >> 16) & 1; }

// group gi's table row: lane f < GROUP_INTS loads field f, and the warp
// shares the fields by shuffle
__device__ __forceinline__ Packed load_group(const Args& a, long long gi,
                                             int lane) {
  const int v =
      lane < GROUP_INTS ? __ldg(a.groups + gi * GROUP_INTS + lane) : 0;
  int f[GROUP_INTS];  // row0, nr, u0, nu, L, diag, s0
#pragma unroll
  for (int i = 0; i < GROUP_INTS; ++i) f[i] = __shfl_sync(0xffffffffu, v, i);
  return {f[0], f[6], f[4], f[1] | f[3] << 3 | f[2] << 9 | f[5] << 16};
}

__device__ __forceinline__ int n_chunks(int L, int blk) {
  return L > 0 ? (L * blk + KC - 1) / KC : 1;
}

// a chunk of the warp's group: its batch tile bt and chunk c of nc
struct Rec {
  int row0, L, bits, bt, c, nc;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// V floats global → shared; L1 true keeps the line in L1 (.ca), false
// streams it through L2 only (.cg; 16-byte copies only)
template <int V, bool L1>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  if constexpr (V == 4 && !L1)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(4 * V));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// 4 bytes global → shared (.ca), of any type
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the chunk's geometry
struct Chunk {
  int k0, kc, ld, panels, b0, nb;
};

__device__ __forceinline__ Chunk chunk_of(int L, int bits, int bt, int c,
                                          const Args& a) {
  Chunk h;
  h.k0 = c * KC;
  h.kc = min(KC, L * a.blk - h.k0);
  h.ld = stage_ld(h.kc);
  h.panels = diag_of(bits) ? nr_of(bits) : 1;
  h.b0 = bt * BT;
  h.nb = min(BT, a.B - h.b0);
  return h;
}

// a lane's column group: output tile row0 + r, units ub … ub + 7 of the
// group's [u0, u0 + nu) (the group's rows × ⌈nu / CG⌉ column groups)
__device__ __forceinline__ int col_row(int nu, int col_group, int& ub) {
  const int per_row = (nu + CG - 1) / CG;
  const int r = col_group / per_row;
  ub = (col_group - r * per_row) * CG;
  return r;
}

// The weight policies: how column slot n of a stage (kc deep, ld apart)
// gets piece q (V deep, from element `at` of tile `tile`, the chunk's js-th
// step) of its tile row, and how the landed stage becomes f32 slots
// (row_first: the column's group row where the piece is the first of its
// step in the chunk and the column its row's first, else −1).
// copy_x stages V deep of x's row from element `at` at `dst` (f32 slots).
// F32W copies the f32 tile row and x as they are.
struct F32W {
  template <int V>
  __device__ __forceinline__ static void copy_x(const Args& a, float* dst,
                                                size_t at) {
    cp_async<V, false>(dst, a.x + at);
  }
  template <int V>
  __device__ __forceinline__ static void copy(const Args& a, float* ws,
                                              const Chunk& h, int n, int q,
                                              size_t at, int, int, int) {
    cp_async<V, true>(ws + n * h.ld + q * V, a.wb + at);
  }
  template <int V>
  __device__ __forceinline__ static void land(const Args&, const Chunk&,
                                              int, float*, int) {}
};

// I8W: int8 tiles, one f32 scale a tile, each weight (float)q · scale —
// the value the f32 instance reads from tiles dequantized the same way, so
// that the two give the same bits.  vec4: a piece is 4 bytes (a quarter of
// the f32 copy); the bytes (column n's kc of them at byte n·(kc + 4)) and
// each step's scale (group row r's at float 8·(kc + 4) + r·(kc/4 + 1) +
// js, copied with the step's first piece in the chunk of the row's first
// column: the row's columns share its tile) land in the stage's W slots,
// and `land` turns them into the f32 slots in place: a lane a column
// reads its bytes and scales, the warp syncs, the lane writes its kc
// floats.  Scalar (a block not a multiple of 4, or wq off a 4-byte
// boundary): a piece is one byte, loaded and converted at issue.
struct I8W {
  __device__ __forceinline__ static int bytes_words(int kc) {
    return kc / 4 + 1;
  }
  template <int V>
  __device__ __forceinline__ static void copy_x(const Args& a, float* dst,
                                                size_t at) {
    cp_async<V, false>(dst, a.x + at);
  }
  template <int V>
  __device__ __forceinline__ static void copy(const Args& a, float* ws,
                                              const Chunk& h, int n, int q,
                                              size_t at, int tile, int js,
                                              int row_first) {
    if constexpr (V == 4) {
      const int nw = bytes_words(h.kc);
      cp_async4(ws + n * nw + q, a.wq + at);
      if (row_first >= 0)
        cp_async4(ws + NG * CG * nw + row_first * nw + js, a.wscale + tile);
    } else {
      ws[n * h.ld + q] = (float)__ldg(a.wq + at) * __ldg(a.wscale + tile);
    }
  }
  template <int V>
  __device__ __forceinline__ static void land(const Args& a, const Chunk& h,
                                              int bits, float* slot,
                                              int lane) {
    if constexpr (V == 4) {
      float* ws = slot + h.panels * BT * h.ld;
      const int nw = bytes_words(h.kc), np = h.kc / 4;
      // piece p's step in the chunk, counted up as its depth crosses a
      // tile row's end (a diag chunk ends with its one step); a division
      // by the block a piece made the depth-3 int8 forward 10 % slower
      // (NVIDIA H100 80GB HBM3, 700.00 W)
      int kk = h.k0 % a.blk, js = 0;
      int ub;
      const int r = col_row(nu_of(bits), lane / CG, ub);
      const bool used = r < nr_of(bits) && ub + lane % CG < nu_of(bits);
      const uint32_t* wb = reinterpret_cast<const uint32_t*>(ws) + lane * nw;
      const float* sc = ws + NG * CG * nw + r * nw;
      uint32_t w[KC / 4];
      float s[KC / 4];
#pragma unroll
      for (int p = 0; p < KC / 4; ++p) {
        if (used && p < np) {
          w[p] = wb[p];
          s[p] = sc[js];
        }
        kk += 4;
        if (kk == a.blk) kk = 0, ++js;
      }
      __syncwarp();  // every lane has read its bytes before any is written
#pragma unroll
      for (int p = 0; p < KC / 4; ++p)
        if (used && p < np) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)  // byte e, sign-extended
            v[e] = (float)((int)(w[p] << (24 - 8 * e)) >> 24) * s[p];
          *reinterpret_cast<float4*>(ws + lane * h.ld + 4 * p) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      __syncwarp();  // every slot is written before any lane reads it
    }
  }
};
static_assert(NG * CG == 32, "I8W::land converts a column slot a lane");

// BF16W: the bf16 compute policy.  x and the tiles are bf16; each piece is
// loaded (8 bytes at V = 4, one value else) and widened into the stage's
// f32 slots as it is issued — a load and a store, not a cp.async, so the
// copy is not in flight behind the other stage's product — and the f32
// product runs as over f32 tiles (a widened bf16 value is exact).
struct BF16W {
  template <int V>
  __device__ __forceinline__ static void widen_to(float* dst, const bf16* p) {
    if constexpr (V == 4)
      *reinterpret_cast<float4*>(dst) = bf16x::ldg4(p);
    else
      *dst = __bfloat162float(*p);
  }
  template <int V>
  __device__ __forceinline__ static void copy_x(const Args& a, float* dst,
                                                size_t at) {
    widen_to<V>(dst, a.xh + at);
  }
  template <int V>
  __device__ __forceinline__ static void copy(const Args& a, float* ws,
                                              const Chunk& h, int n, int q,
                                              size_t at, int, int, int) {
    widen_to<V>(ws + n * h.ld + q * V, a.wh + at);
  }
  template <int V>
  __device__ __forceinline__ static void land(const Args&, const Chunk&,
                                              int, float*, int) {}
};

// I8BW: the int8 serve copy under the bf16 compute policy — I8W's tiles,
// scales and landing pass (the bytes by cp.async, turned into f32 slots
// after they land), with x bf16, widened into its f32 slots as BF16W
// stages it (a load and a store at issue)
struct I8BW : I8W {
  template <int V>
  __device__ __forceinline__ static void copy_x(const Args& a, float* dst,
                                                size_t at) {
    BF16W::widen_to<V>(dst, a.xh + at);
  }
};

// one chunk's copies, spread over the warp: lane l copies piece
// q = l mod npp (V floats deep) of rows l / npp, l / npp + 32 / npp, …,
// each tile's index read from s_in or s_w.  x streams through L2; the tiles come through L1, because the
// pass-through groups all read one identity tile: from L2 alone, a
// thousand warps queue on its two lines (on an H100, at the depth-3
// population's second mid layer, 15.2 µs a launch against 7.3 through L1).
template <int V, class Wt>
__device__ void issue(const Packed& g, int bt, int c, const Args& a,
                      float* slot, int lane) {
  const Chunk h = chunk_of(g.L, g.bits, bt, c, a);
  if (h.kc <= 0) return;
  const int blk = a.blk;
  const int nr = nr_of(g.bits), nu = nu_of(g.bits), u0 = u0_of(g.bits);
  const bool diag = diag_of(g.bits);
  const int npc = h.kc / V;  // pieces a row (kc is a multiple of V)
  int lg = 0;
  while ((1 << lg) < npc) ++lg;
  const int q = lane & ((1 << lg) - 1);
  if (q >= npc) return;
  const int step = 32 >> lg;
  const int kq = h.k0 + q * V;           // depth on the group's axis
  const int j = diag ? 0 : kq / blk;     // the step
  const int kk = kq - j * blk;           // depth within the step's tile
  // a shared panel reads input tile s_in[s0 + j], a diag group's panel pn
  // s_in[s0 + pn]
  const int x_tile = diag ? 0 : __ldg(a.s_in + g.s0 + j);
  for (int i = lane >> lg; i < h.panels * BT; i += step) {
    const int pn = i / BT, b = i - pn * BT;
    if (b >= h.nb) continue;
    const int tile = diag ? __ldg(a.s_in + g.s0 + pn) : x_tile;
    Wt::template copy_x<V>(
        a, slot + i * h.ld + q * V,
        (size_t)(h.b0 + b) * a.in_w + (size_t)tile * blk + kk);
  }
  float* ws = slot + h.panels * BT * h.ld;
  const int js = j - (diag ? 0 : h.k0 / blk);  // the step in the chunk
  for (int n = lane >> lg; n < NG * CG; n += step) {
    int ub;
    const int r = col_row(nu, n / CG, ub);
    const int u = ub + n % CG;
    if (r >= nr || u >= nu) continue;
    const int tile = __ldg(a.s_w + g.s0 + r * g.L + j);
    Wt::template copy<V>(a, ws, h, n, q,
                         ((size_t)tile * blk + u0 + u) * blk + kk, tile, js,
                         u == 0 && (q == 0 || kk < V) ? r : -1);
  }
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][c] over the chunk's kc deep: x rows xp + 8i·ld, W columns wp + c·ld
template <int V, int RI>
__device__ __forceinline__ void fma_chunk(float (&acc)[RPL][CG],
                                          const float* xp, const float* wp,
                                          int kc, int ld) {
  if constexpr (V == 4) {
#pragma unroll 2
    for (int k = 0; k < kc; k += 4) {
      float4 xv[RI], wv[CG];
#pragma unroll
      for (int i = 0; i < RI; ++i) xv[i] = lds4(xp + 8 * i * ld + k);
#pragma unroll
      for (int c = 0; c < CG; ++c) wv[c] = lds4(wp + c * ld + k);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < CG; ++c) {
          float s = acc[i][c];
          s = fmaf(xv[i].x, wv[c].x, s);
          s = fmaf(xv[i].y, wv[c].y, s);
          s = fmaf(xv[i].z, wv[c].z, s);
          s = fmaf(xv[i].w, wv[c].w, s);
          acc[i][c] = s;
        }
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < kc; ++k) {
      float xv[RI], wv[CG];
#pragma unroll
      for (int i = 0; i < RI; ++i) xv[i] = xp[8 * i * ld + k];
#pragma unroll
      for (int c = 0; c < CG; ++c) wv[c] = wp[c * ld + k];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < CG; ++c) acc[i][c] = fmaf(xv[i], wv[c], acc[i][c]);
    }
  }
}

template <int V>
__device__ void compute(const Rec& q, const Args& a, const float* slot,
                        int lane, float (&acc)[RPL][CG]) {
  const Chunk h = chunk_of(q.L, q.bits, q.bt, q.c, a);
  if (h.kc <= 0) return;
  int ub;
  const int r = col_row(nu_of(q.bits), lane >> 3, ub);
  if (r >= nr_of(q.bits)) return;  // a column group the group does not use
  const int rg = lane & 7;
  const float* xp = slot + ((diag_of(q.bits) ? r : 0) * BT + rg) * h.ld;
  const float* wp = slot + h.panels * BT * h.ld + (lane >> 3) * CG * h.ld;
  switch ((h.nb + 7) >> 3) {
    case 1: fma_chunk<V, 1>(acc, xp, wp, h.kc, h.ld); break;
    case 2: fma_chunk<V, 2>(acc, xp, wp, h.kc, h.ld); break;
    case 3: fma_chunk<V, 3>(acc, xp, wp, h.kc, h.ld); break;
    default: fma_chunk<V, 4>(acc, xp, wp, h.kc, h.ld); break;
  }
}

// the lane's outputs: its column group's tile, first column and columns, or
// false where the group leaves the column group idle
__device__ __forceinline__ bool lane_cols(const Rec& q, const Args& a,
                                          int lane, int& tile, size_t& col0,
                                          int& ncol) {
  int ub;
  const int nu = nu_of(q.bits);
  const int r = col_row(nu, lane >> 3, ub);
  if (r >= nr_of(q.bits)) return false;
  tile = q.row0 + r;
  col0 = (size_t)tile * a.blk + u0_of(q.bits) + ub;
  ncol = min(CG, nu - ub);
  return true;
}

// The warp's loop over its group's chunks (its batch tiles, each over the
// reduction): chunk i + 1 is copied into the other stage while chunk i is
// multiplied, once the weight policy has landed it.  A finished batch tile
// goes through the epilogue policy, Epi::run<V>(args, chunk record, lane,
// acc, stage), the stage just multiplied being free until the next copy
// into it.
template <int V, class Epi, class Wt = F32W>
__device__ void run_groups(const Args& a) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long gi = (long long)blockIdx.x * WARPS + warp;
  if (gi >= a.n_groups) return;
  float* ring = smem + warp * STAGES * STAGE_FLOATS;
  const Packed g = load_group(a, gi, lane);
  const int nc = n_chunks(g.L, a.blk);
  const int total = (a.B + BT - 1) / BT * nc;
  issue<V, Wt>(g, 0, 0, a, ring, lane);
  cp_async_commit();
  float acc[RPL][CG];
#pragma unroll
  for (int i = 0; i < RPL; ++i)
#pragma unroll
    for (int c = 0; c < CG; ++c) acc[i][c] = 0.f;
  for (int i = 0; i < total; ++i) {
    if (i + 1 < total)
      issue<V, Wt>(g, (i + 1) / nc, (i + 1) % nc, a,
               ring + ((i + 1) & 1) * STAGE_FLOATS, lane);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const Rec q{g.row0, g.L, g.bits, i / nc, i % nc, nc};
    float* slot = ring + (i & 1) * STAGE_FLOATS;
    Wt::template land<V>(a, chunk_of(q.L, q.bits, q.bt, q.c, a), q.bits,
                         slot, lane);
    compute<V>(q, a, slot, lane, acc);
    if (q.c == nc - 1) {  // the batch tile is done: its epilogue
      Epi().template run<V>(a, q, lane, acc, slot);
#pragma unroll
      for (int r = 0; r < RPL; ++r)
#pragma unroll
        for (int c = 0; c < CG; ++c) acc[r][c] = 0.f;
    }
    __syncwarp();  // the slot's readers are done before it is refilled
  }
  cp_async_wait<0>();
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Launch `vec4` or `scalar` (the rule of block_diag.py::fwd_path: a block
// that is a multiple of 4, x, y and g' on 16-byte boundaries, and the f32
// tiles wb on a 16-byte boundary or the int8 tiles wq on a 4-byte one;
// under the bf16 policy x, y and g' on 8-byte boundaries, and the bf16
// tiles on an 8-byte one or the int8 tiles on a 4-byte one), one warp a
// group.
inline int launch_groups(const void* vec4, const void* scalar, Args a,
                         void* stream) {
  if (a.blk <= 0 || a.blk > MAX_BLK || a.B < 0 || a.n_groups < 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)a.in_w * a.blk > INT32_MAX ||
      (long long)a.out_w * a.blk > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  a.in_w *= a.blk;
  a.out_w *= a.blk;
  if (a.B == 0 || a.n_groups == 0) return 0;
  using bf16x::aligned8;
  const bool bf = a.xh != nullptr;
  const bool w_ok = a.wq != nullptr
                        ? reinterpret_cast<uintptr_t>(a.wq) % 4 == 0
                        : bf ? aligned8(a.wh) : aligned16(a.wb);
  const bool v4 =
      a.blk % 4 == 0 && w_ok &&
      (bf ? aligned8(a.xh) && aligned8(a.yh) &&
                (a.gh == nullptr || aligned8(a.gh))
          : aligned16(a.x) && aligned16(a.y) &&
                (a.g == nullptr || aligned16(a.g)));
  const void* kernel = v4 ? vec4 : scalar;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((a.n_groups + WARPS - 1) / WARPS);
  void* params[] = {&a};
  return (int)cudaLaunchKernel(kernel, dim3(grid), dim3(THREADS), params,
                               SMEM_BYTES, static_cast<cudaStream_t>(stream));
}

}  // namespace bdcore
