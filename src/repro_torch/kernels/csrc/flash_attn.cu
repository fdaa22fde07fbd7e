// Flash attention, forward: masked online-softmax attention with grouped
// query heads,
//   o[b, h, i] = Σ_j softmax_j(scale · q[b, h, i] · k[b, h / G, j]) · v[b, h / G, j]
// over the columns j < Sk, with G = H / Hkv (GQA: every query head of a
// group reads its kv head straight from memory; k and v are never repeated).
//
// Replaces the TPU kernel repro/kernels/flash_attn.py::flash_attention_fwd,
// the pallas_call behind repro/kernels/ops.py::flash_attention's forward
// (its custom VJP's backward recomputes through the dense oracle, and so
// does the port's: there is no backward kernel).  q (B, H, Sq, dh), k and v
// (B, Hkv, Sk, dh), all f32 (flash_attn_fwd_f32) or all bf16
// (flash_attn_fwd_bf16), row-major → o (B, H, Sq, dh) in q's dtype.  dh is
// a multiple of 8 up to 192 (120 for h2o-danube-3-4b, 192 for
// nemotron-4-340b); Sq and Sk are any sizes, Sq ≠ Sk allowed.
//
// Semantics, as the TPU kernel and ref.flash_attn_ref:
//   * positions from 0 on both axes; causal keeps q_pos ≥ k_pos, a window
//     (> 0) keeps q_pos − k_pos < window;
//   * a masked score is the finite −1e30 (NEG_INF), not −inf: the running
//     sums restart through exp(m_prev − m_new) = 0 when the first real
//     score arrives, and a fully masked row comes out as the mean of v;
//   * the scale multiplies the f32 dot product (q is not pre-scaled);
//   * (m, l, acc) run in f32; p is rounded to v's dtype before the PV
//     product, l sums the unrounded p.
// One deliberate difference from the TPU kernel: columns at or beyond Sk
// are left out of the sums, not scored −1e30.  The TPU kernel pads k and v
// to its block_k with zeros and lets those columns count in a fully masked
// row (Σv / (Sk + pad)); the oracle, and this kernel, give the mean over Sk.
//
// The TPU grid is (B·H, Sq/block_q, Sk/block_k) with the k blocks innermost
// and (m, l, acc) carried in VMEM scratch from one k step to the next.  A
// GPU grid has no order, so here one CTA owns one (b·h, q tile) and walks
// the k tiles in order inside itself, (m, l, acc) in f32 registers.  Two
// designs, one per dtype (flash_attn.kernel_path):
//
// * bf16: the tensor cores (FlashAttention-3's shape, made simple).  A CTA
//   owns 128 q rows: two consumer warpgroups of 64 rows and one producer
//   warpgroup, of which one thread issues every TMA load.  Q is loaded
//   once; K and V tiles of 64 columns stream through a ring of STAGES
//   buffers (one full mbarrier each for K and for V, one empty), by 3-D
//   maps over (dh, S, B·heads) with 128-byte swizzle, so rows past Sq or Sk
//   read as zeros and never come from the next head.  dh is padded to DP =
//   64, 128 or 192 in shared memory (zeros past dh from the same
//   out-of-bounds fill; a row is DP / 64 boxes of 64 columns, the
//   descriptor advanced between them; 3 stages at DP 128 and 192, 4 at
//   64).  Per tile a consumer warpgroup issues S = Q·Kᵀ as
//   wgmma.m64n64k16 (both operands K-major in shared memory), applies the
//   scale, the masks and the online softmax to the accumulator registers
//   (a row's 64 columns lie in one quad of lanes: max and sum are two
//   shuffles), rounds p to bf16 pairs in registers — the A operand layout
//   of the next product — and issues O += P·V as wgmma.m64n{DP}k16 with A
//   from registers and V MN-major through the transpose bit (at DP 192 the
//   O accumulator is 96 f32 a thread).  l sums the unrounded p.  exp(x)
//   is computed as exp2f(x · log2 e).  Only tiles on the causal diagonal,
//   at the window's edge or past Sk mask per element.  CTAs take the
//   longest causal q tiles first.
// * f32: the FMA units, in full f32 (no TF32: the f32 API's contract is
//   its plain version at rtol 1e-4 / atol 1e-5), both products as
//   register-tiled SIMT GEMMs.  A CTA of 256 threads owns BQ = 128 q rows
//   and walks k tiles of BK = 64 columns (at DP 192: 64 rows and 32
//   columns, Tile<DP>, so that Q and the two-stage rings fit).  Thread
//   (ty, tx), tx the lane's low four bits, owns rows 4·ty..4·ty+3 and, at
//   BQ 128, 64+4·ty..64+4·ty+3: their scores at columns tx + 16·c (c <
//   BK / 16) and their outputs at columns 4·tx + 64·g (g < DP / 64, 4 each:
//   64 accumulators at DP 128, 48 at DP 192), so a row's 16 threads are one
//   half-warp and its max is four shuffles.  Q,
//   K and V are staged row-major in shared memory by 16-byte cp.async
//   (Q once; K and V each in their own two-stage ring, one cp.async group
//   each: tile k + 1's K and V land while tile k's two products run, two
//   __syncthreads a tile).  S = Q·Kᵀ reads a 4-deep slice of each of its
//   rows and columns as one float4 (128 FMAs for 12 loads: an 8 × 4 tile a
//   thread cannot grow, since two stages of 128-column K and V tiles do not
//   fit beside Q); p goes to shared memory column by column, so the PV
//   product reads a thread's 8 rows of p as two float4s and its 4·DP/64
//   columns of a V row as DP/64 float4s (64 FMAs for 4 loads at DP 128).
//   K's, Q's and p's 16-byte chunks are XOR-swizzled by their row (K: r % 8,
//   Q: r / 4 % 8, p: the column % 8), so that every fragment read and
//   every p store of a warp is free of bank conflicts.  Instances by the
//   head width padded to DP = 64 or 128 (flash_attn.fma_width); the d loop
//   runs to dh.  exp(x) is exp2f(x · log2 e); l is summed per thread and
//   across the half-warp once, at the end, in one fixed tree; each output
//   has one owner and one order of sums, so two launches are bitwise
//   equal.  Only edge tiles mask per element; CTAs take the longest causal
//   q tiles first.  The DP 192 instance's QKᵀ reads 6 float4s for 32 FMAs
//   (5.3 FMAs a load, against 10.7 at DP 128): a simple instance, not yet a
//   fast one.
//
// Both walk only the k tiles [kt_lo, kt_hi) that hold a column some row of
// the CTA attends, and mask per element only the edge tiles among them
// (the causal diagonal, the window's edge, past Sk); a CTA holding a fully
// masked row walks every tile, so that row keeps the oracle's value (the
// skipped columns of the other rows would have added exactly 0).  The f32
// rule is flash_attn.tile_walk in Python.
//
// What bounds it: operations.  At qwen3-1.7b's training shape (B 2, H 16,
// S 4096, dh 128, causal) the kernel reads q, k, v and writes o once (f32
// 201 MB, 0.06 ms at 3.35 TB/s; bf16 half that) for 4·dh FLOP per
// unmasked (q, k) pair, 137.4 GFLOP: 0.139 ms at bf16's dense tensor-core
// 989 TFLOP/s, 2.05 ms at the f32 rate of 67.  At h2o-danube-3-4b's (B 1,
// S 8192, H 32, Hkv 8, dh 120, window 4096) 386.6 GFLOP, 0.391 ms in bf16
// and 5.77 ms in f32.  At nemotron-4-340b's prefill (B 4, H 96, Hkv 8, S
// 512, dh 192, causal) 38.7 GFLOP: 0.578 ms in f32; in bf16 the 164 MB
// of q, k, v and o bound it (0.049 ms) above its 0.039 ms of operations.
// The f32 kernel issues 16 FMAs a shared-memory load in PV and 10.7 in
// QKᵀ at DP 128, with 8 warps an SM (registers for 64 accumulators, 32
// scores and the fragments); at the 65 % of the FMA peak
// that the SIMT GEMM of moe_gemm.cu reaches it would take 3.2 ms at
// qwen3-1.7b's shape, about 3 % above the bound's work from the diagonal
// tiles' masked half.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int MAX_DH = 192;
constexpr float NEG_INF = -1e30f;

// ---- f32 on the FMA units -----------------------------------------------

namespace f32 {

constexpr int THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

// an instance's tiles: q rows a CTA and k columns a tile.  DP 64 and 128
// take 128 × 64; DP 192 takes 64 × 32, since 128 × 64 at 192 columns would
// need 327,680 bytes of shared memory, beyond the 232,448 a block can have
// (flash_attn.FMA_TILES)
template <int DP>
struct Tile {
  static constexpr int BQ = DP > 128 ? 64 : 128;
  static constexpr int BK = DP > 128 ? 32 : 64;
};

// Q, two stages of K and of V, and the p tile (229,376 bytes at DP 128,
// 155,648 at DP 192)
template <int DP>
constexpr size_t smem_bytes() {
  constexpr int BQ = Tile<DP>::BQ, BK = Tile<DP>::BK;
  return ((size_t)BQ * DP + 4 * (size_t)BK * DP + (size_t)BK * BQ) *
         sizeof(float);
}

// the k tiles [lo, hi) of BK columns a CTA of rows q0..q_last walks: every
// tile if some row lies past Sk + window − 2 (a fully masked row: only a
// window can empty a row), else only the tiles with a column some row
// attends (flash_attn.tile_walk is the same rule)
__device__ __forceinline__ void tile_range(int q0, int q_last, int Sk,
                                           int causal, int window, int BK,
                                           int& lo, int& hi) {
  const int n_k = (Sk + BK - 1) / BK;
  lo = 0;
  hi = n_k;
  if (window <= 0 || q_last <= Sk + window - 2) {
    if (causal) hi = min(n_k, q_last / BK + 1);
    if (window > 0) lo = max(0, q0 - window + 1) / BK;
  }
}

// whether the tile of BK columns at k0 holds a column that is masked for
// some row of the CTA or lies past Sk: only such a tile masks per element
__device__ __forceinline__ bool edge_tile(int k0, int q0, int q_last, int Sk,
                                          int causal, int window, int BK) {
  return k0 + BK > Sk || (causal && k0 + BK - 1 > q0) ||
         (window > 0 && q_last - k0 >= window);
}

// ROWS rows of DP floats into shared memory by 16-byte cp.async, from
// global rows of dh floats: chunk c of row r lands at chunk c ^ swz(r);
// rows at or past n_real and chunks past dh are zeros
template <int DP, int ROWS, typename Swz>
__device__ __forceinline__ void stage(float* s, const float* g, int n_real,
                                      int dh, Swz swz) {
  constexpr int CH = DP / 4;
  static_assert(ROWS * CH % THREADS == 0, "whole copies a thread");
#pragma unroll
  for (int u = 0; u < ROWS * CH / THREADS; ++u) {
    const int idx = u * THREADS + threadIdx.x;
    const int r = idx / CH, c = idx % CH;
    const bool in = r < n_real && 4 * c < dh;
    hopper::cp_async16(s + r * DP + 4 * (c ^ swz(r)),
                       in ? g + (size_t)r * dh + 4 * c : g, in);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// grid (B·H, q tiles), 256 threads; DP: the head width padded to 64, 128
// or 192
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      int H, int Hkv, int Sq, int Sk, int dh, float scale,
                      int causal, int window) {
  constexpr int BQ = Tile<DP>::BQ, BK = Tile<DP>::BK;
  constexpr int RI = BQ / 16;  // q rows a thread: 8, or 4 at BQ 64
  constexpr int CK = BK / 16;  // score columns a thread: 4, or 2 at BK 32
  constexpr int CO = DP / 64;  // 4-column output groups a thread
  extern __shared__ float4 smem_raw[];
  // Q (BQ × DP), chunk c of row r at c ^ (r / 4 % 8); K (two stages of
  // BK × DP), chunk c of row r at c ^ (r % 8); V (two stages, row-major);
  // p (BK columns of BQ rows), chunk c of column j at c ^ (j % 8)
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + 2 * BK * DP;
  float* Ps = Vs + 2 * BK * DP;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int kvh = b * Hkv + h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest tiles first
  const int q_last = min(q0 + BQ, Sq) - 1;
  const float* kg = k + (size_t)kvh * Sk * dh;
  const float* vg = v + (size_t)kvh * Sk * dh;
  int kt_lo, kt_hi;
  tile_range(q0, q_last, Sk, causal, window, BK, kt_lo, kt_hi);
  const int n_iter = kt_hi - kt_lo;

  // tile kt's K and V into stage st, one cp.async group each
  const auto stage_kv = [&](int kt, int st) {
    const int k0 = kt * BK;
    stage<DP, BK>(Ks + st * BK * DP, kg + (size_t)k0 * dh, Sk - k0, dh,
                  [](int r) { return r & 7; });
    hopper::cp_async_commit();
    stage<DP, BK>(Vs + st * BK * DP, vg + (size_t)k0 * dh, Sk - k0, dh,
                  [](int) { return 0; });
    hopper::cp_async_commit();
  };
  stage<DP, BQ>(Qs, q + ((size_t)bh * Sq + q0) * dh, Sq - q0, dh,
                [](int r) { return (r >> 2) & 7; });  // in K's first group
  stage_kv(kt_lo, 0);

  // thread (ty, tx), a warp's two ty sharing every tx: rows 4·ty + i and,
  // at BQ 128, 64 + 4·ty + i (i < 4), score columns tx + 16·c (c < CK),
  // output columns 4·tx + 64·g + e (g < CO, e < 4); a row's 16 threads are
  // a half-warp
  const int lane = threadIdx.x & 31;
  const int tx = lane & 15, ty = 2 * (threadIdx.x >> 5) + (lane >> 4);
  const int qsw = ty & 7, ksw = tx & 7;  // Q's and K's (and p's) swizzles
  const float* qs = Qs + 4 * ty * DP;
  const int nch = dh / 4;

  float acc[RI][4 * CO], m[RI], l[RI];  // l: this thread's share of the sum
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * CO; ++j) acc[i][j] = 0.f;
  }

  for (int it = 0; it < n_iter; ++it) {
    const int st = it & 1;
    const int k0 = (kt_lo + it) * BK;
    hopper::cp_async_wait<1>();  // this thread's K (and Q) of tile it
    __syncthreads();             // everyone's; tile it − 1 is done with
    if (it + 1 < n_iter) {       // the other stage
      stage_kv(kt_lo + it + 1, st ^ 1);
    } else {                     // empty groups keep the waits' counts
      hopper::cp_async_commit();
      hopper::cp_async_commit();
    }

    // s[i][c] = q[row i] · k[column c], each over d in order
    const float* ks = Ks + st * BK * DP + tx * DP;
    float s[RI][CK];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < CK; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int ch = 0; ch < nch; ++ch) {
      float4 kf[CK];
#pragma unroll
      for (int c = 0; c < CK; ++c)
        kf[c] = ld4(ks + 16 * c * DP + 4 * (ch ^ ksw));
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float4 qf =
            ld4(qs + ((i & 3) + 64 * (i >> 2)) * DP + 4 * (ch ^ qsw));
#pragma unroll
        for (int c = 0; c < CK; ++c) {
          s[i][c] = fmaf(qf.x, kf[c].x, s[i][c]);
          s[i][c] = fmaf(qf.y, kf[c].y, s[i][c]);
          s[i][c] = fmaf(qf.z, kf[c].z, s[i][c]);
          s[i][c] = fmaf(qf.w, kf[c].w, s[i][c]);
        }
      }
    }

    // the scale on the f32 dot product; masks where the tile needs them;
    // then the online softmax of each row, exp(x) as exp2f(x · log2 e)
    const bool edge = edge_tile(k0, q0, q_last, Sk, causal, window, BK);
    float alpha[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qp = q0 + 4 * ty + (i & 3) + 64 * (i >> 2);
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        float& x = s[i][c];
        if (edge) {
          const int kp = k0 + tx + 16 * c;
          bool ok = true;
          if (causal) ok = ok && qp >= kp;
          if (window > 0) ok = ok && qp - kp < window;
          x = kp < Sk ? (ok ? x * scale : NEG_INF)
                      : -INFINITY;  // past Sk: out of the sums
        } else {
          x *= scale;
        }
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      alpha[i] = exp2f((m[i] - m_new) * LOG2E);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        s[i][c] = exp2f((s[i][c] - m_new) * LOG2E);
        sum += s[i][c];
      }
      l[i] = l[i] * alpha[i] + sum;
    }
    // p, column by column: a column's rows 4·ty.. (and 64 + 4·ty..) are
    // its 16-byte chunks ty (and 16 + ty)
#pragma unroll
    for (int c = 0; c < CK; ++c) {
      float* pc = Ps + (tx + 16 * c) * BQ;
#pragma unroll
      for (int r = 0; r < RI / 4; ++r)
        *reinterpret_cast<float4*>(pc + 4 * ((16 * r + ty) ^ ksw)) =
            make_float4(s[4 * r][c], s[4 * r + 1][c], s[4 * r + 2][c],
                        s[4 * r + 3][c]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4 * CO; ++j) acc[i][j] *= alpha[i];
    hopper::cp_async_wait<2>();  // this thread's V of tile it
    __syncthreads();             // everyone's V and p

    // acc[i][·] += Σ_j p[row i][j] · v[j][·], j in order
    const float* vs = Vs + st * BK * DP + 4 * tx;
#pragma unroll 8
    for (int j = 0; j < BK; ++j) {
      const float* pc = Ps + j * BQ;
      float p[RI];
#pragma unroll
      for (int r = 0; r < RI / 4; ++r) {
        const float4 pf = ld4(pc + 4 * ((16 * r + ty) ^ (j & 7)));
        p[4 * r] = pf.x;
        p[4 * r + 1] = pf.y;
        p[4 * r + 2] = pf.z;
        p[4 * r + 3] = pf.w;
      }
#pragma unroll
      for (int g = 0; g < CO; ++g) {
        const float4 vf = ld4(vs + j * DP + 64 * g);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          acc[i][4 * g] = fmaf(p[i], vf.x, acc[i][4 * g]);
          acc[i][4 * g + 1] = fmaf(p[i], vf.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(p[i], vf.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(p[i], vf.w, acc[i][4 * g + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const float li = row_sum16(l[i]);  // the same tree in every lane
    const int qp = q0 + 4 * ty + (i & 3) + 64 * (i >> 2);
    if (qp >= Sq) continue;
    const float inv = 1.f / fmaxf(li, 1e-30f);
    float* orow = o + ((size_t)bh * Sq + qp) * dh;
#pragma unroll
    for (int g = 0; g < CO; ++g) {
      const int d = 4 * tx + 64 * g;
      if (d < dh)  // dh % 8 == 0: a 4-group is wholly inside or outside
        *reinterpret_cast<float4*>(orow + d) = make_float4(
            acc[i][4 * g] * inv, acc[i][4 * g + 1] * inv,
            acc[i][4 * g + 2] * inv, acc[i][4 * g + 3] * inv);
    }
  }
}

template <int DP>
int launch_dp(const float* q, const float* k, const float* v, float* o,
              int B, int H, int Hkv, int Sq, int Sk, int dh, float scale,
              int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  constexpr int BQ = Tile<DP>::BQ;
  if ((Sq + BQ - 1) / BQ > 65535) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attn_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (Sq + BQ - 1) / BQ);
  flash_attn_fwd_kernel<DP><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, H, Hkv, Sq, Sk, dh, scale, causal, window);
  return (int)cudaGetLastError();
}

int launch(const float* q, const float* k, const float* v, float* o, int B,
           int H, int Hkv, int Sq, int Sk, int dh, float scale, int causal,
           int window, void* stream) {
  if (B < 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq < 0 || Sk <= 0 ||
      dh < 8 || dh > MAX_DH || dh % 8)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  if ((long long)B * H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // flash_attn.fma_width: the narrowest instance that holds dh
  if (dh <= 64)
    return launch_dp<64>(q, k, v, o, B, H, Hkv, Sq, Sk, dh, scale, causal,
                         window, s);
  if (dh <= 128)
    return launch_dp<128>(q, k, v, o, B, H, Hkv, Sq, Sk, dh, scale, causal,
                          window, s);
  return launch_dp<192>(q, k, v, o, B, H, Hkv, Sq, Sk, dh, scale, causal,
                        window, s);
}

}  // namespace f32


// ---- bf16 on the tensor cores -------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BQ = 128;  // q rows per CTA: two consumer warpgroups
constexpr int BK = 64;   // k columns per tile
constexpr float LOG2E = 1.4426950408889634f;

template <int DP>
struct Shape {
  static constexpr int NB = DP / 64;            // 64-column boxes a row
  // 4 stages at DP 64; 3 at DP 128 and 192 (197,712 bytes at 192: a
  // fourth stage would pass the 232,448 a block can have)
  static constexpr int STAGES = DP >= 128 ? 3 : 4;
  static constexpr int Q_BOX = BQ * 128;        // bytes of one Q box
  static constexpr int KV_BOX = BK * 128;       // bytes of one K or V box
  static constexpr int Q_BYTES = NB * Q_BOX;
  static constexpr int KV_BYTES = NB * KV_BOX;
  static constexpr size_t SMEM = 1024 + Q_BYTES +
                                 (size_t)STAGES * 2 * KV_BYTES +
                                 (1 + 3 * STAGES) * 8;
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int DP>
__device__ __forceinline__ void pv(float (&o)[DP / 2], const uint32_t (&a)[4],
                                   uint64_t db);
template <>
__device__ __forceinline__ void pv<64>(float (&o)[32], const uint32_t (&a)[4],
                                       uint64_t db) {
  hopper::wgmma_m64n64_rs<1>(o, a, db, 1);
}
template <>
__device__ __forceinline__ void pv<128>(float (&o)[64],
                                        const uint32_t (&a)[4], uint64_t db) {
  hopper::wgmma_m64n128_rs<1>(o, a, db, 1);
}
template <>
__device__ __forceinline__ void pv<192>(float (&o)[96],
                                        const uint32_t (&a)[4], uint64_t db) {
  hopper::wgmma_m64n192_rs<1>(o, a, db, 1);
}

// grid (B·H, q tiles); 256 consumer threads, then the producer warpgroup
template <int DP>
__global__ void __launch_bounds__(384, 1)
flash_attn_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        bf16* __restrict__ o, int H, int Hkv, int Sq, int Sk,
                        int dh, float scale, int causal, int window) {
  using namespace hopper;
  using S_ = Shape<DP>;
  constexpr int STAGES = S_::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Qs = smem;
  uint8_t* KV = Qs + S_::Q_BYTES;  // stage s: K at 2s, V at 2s + 1
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      KV + (size_t)STAGES * 2 * S_::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int kvh = b * Hkv + h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest tiles first
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int n_k = (Sk + BK - 1) / BK;
  // the k tiles to walk: all of them if some row of the CTA lies past
  // Sk + window − 2 (a fully masked row: only a window can empty a row);
  // else only those with a column some row of the CTA attends
  int kt_lo = 0, kt_hi = n_k;
  if (window <= 0 || q_last <= Sk + window - 2) {
    if (causal) kt_hi = min(n_k, q_last / BK + 1);
    if (window > 0) kt_lo = max(0, q0 - window + 1) / BK;
  }
  const int n_iter = kt_hi - kt_lo;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer: one thread issues every load
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(q_full, S_::Q_BYTES);
#pragma unroll
      for (int nb = 0; nb < S_::NB; ++nb)
        tma_load_3d(Qs + nb * S_::Q_BOX, &qmap, q_full, nb * 64, q0, bh);
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % STAGES;
        const int k0 = (kt_lo + it) * BK;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        uint8_t* Ks = KV + (size_t)(2 * s) * S_::KV_BYTES;
        uint8_t* Vs = Ks + S_::KV_BYTES;
        mbar_arrive_expect_tx(&k_full[s], S_::KV_BYTES);
#pragma unroll
        for (int nb = 0; nb < S_::NB; ++nb)
          tma_load_3d(Ks + nb * S_::KV_BOX, &kmap, &k_full[s], nb * 64, k0,
                      kvh);
        mbar_arrive_expect_tx(&v_full[s], S_::KV_BYTES);
#pragma unroll
        for (int nb = 0; nb < S_::NB; ++nb)
          tma_load_3d(Vs + nb * S_::KV_BOX, &vmap, &v_full[s], nb * 64, k0,
                      kvh);
      }
    }
    return;
  }

  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int rq0 = q0 + wg * 64;                        // this warpgroup's rows
  const int qrow = rq0 + (tid / 32) * 16 + lane / 4;   // and qrow + 8
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % STAGES;
    const uint32_t ph = (it / STAGES) & 1;
    const int k0 = (kt_lo + it) * BK;
    const uint8_t* Ks = KV + (size_t)(2 * s) * S_::KV_BYTES;
    const uint8_t* Vs = Ks + S_::KV_BYTES;

    // S = Q·Kᵀ over DP / 16 slices of 16
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    mbar_wait(&k_full[s], ph);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const int nb = ks / 4, kk = ks % 4;
      const uint64_t da =
          desc_sw128(Qs + nb * S_::Q_BOX + wg * 64 * 128 + kk * 32, 16, 1024);
      const uint64_t db = desc_sw128(Ks + nb * S_::KV_BOX + kk * 32, 16, 1024);
      wgmma_m64n64_ss<0>(sc, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // the scale on the f32 dot product; masks where the tile needs them
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > rq0) ||
                      (window > 0 && rq0 + 63 - k0 >= window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int qp = qrow + 8 * i;
            const int kp = k0 + 8 * j + 2 * (lane % 4) + c;
            bool ok = true;
            if (causal) ok = ok && qp >= kp;
            if (window > 0) ok = ok && qp - kp < window;
            float& v = sc[4 * j + 2 * i + c];
            v = kp < Sk ? (ok ? v * scale : NEG_INF)
                        : -INFINITY;  // past Sk: out of the sums
          }
    } else {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] *= scale;
    }

    // the online softmax of this thread's two rows
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
      const float m_new = fmaxf(m[i], quad_max(mx));
      alpha[i] = exp2f((m[i] - m_new) * LOG2E);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& v = sc[4 * j + 2 * i + c];
          v = exp2f((v - m_new) * LOG2E);
          sum += v;
        }
      l[i] = l[i] * alpha[i] + quad_sum(sum);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }

    // p as bf16 A fragments: columns 16kk.. of the tile, in place
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

    // O += P·V: V's 16-row slices 2048 bytes apart, its 64-column boxes
    // KV_BOX bytes apart
    mbar_wait(&v_full[s], ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      pv<DP>(acc, pa[kk], desc_sw128(Vs + kk * 2048, S_::KV_BOX, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = qrow + 8 * i;
    if (qp >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    bf16* orow = o + ((size_t)bh * Sq + qp) * dh;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + 2 * (lane % 4);
      if (d < dh)  // dh % 8 == 0: a pair is wholly inside or outside
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
            acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
    }
  }
}

template <int DP>
int launch_dp(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B,
              int H, int Hkv, int Sq, int Sk, int dh, float scale, int causal,
              int window, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  const cuuint64_t row = (cuuint64_t)dh * 2;
  const cuuint64_t qdims[3] = {(cuuint64_t)dh, (cuuint64_t)Sq,
                               (cuuint64_t)B * H};
  const cuuint64_t qstr[2] = {row, row * Sq};
  const cuuint32_t qbox[3] = {64, BQ, 1};
  const cuuint64_t kdims[3] = {(cuuint64_t)dh, (cuuint64_t)Sk,
                               (cuuint64_t)B * Hkv};
  const cuuint64_t kstr[2] = {row, row * Sk};
  const cuuint32_t kbox[3] = {64, BK, 1};
  int rc = hopper::make_map_bf16(&qm, q, 3, qdims, qstr, qbox);
  if (!rc) rc = hopper::make_map_bf16(&km, k, 3, kdims, kstr, kbox);
  if (!rc) rc = hopper::make_map_bf16(&vm, v, 3, kdims, kstr, kbox);
  if (rc) return rc;
  const size_t smem = Shape<DP>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attn_wgmma_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (Sq + BQ - 1) / BQ);
  flash_attn_wgmma_kernel<DP><<<grid, 384, smem, stream>>>(
      qm, km, vm, o, H, Hkv, Sq, Sk, dh, scale, causal, window);
  return (int)cudaGetLastError();
}

int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B,
           int H, int Hkv, int Sq, int Sk, int dh, float scale, int causal,
           int window, void* stream) {
  if (B < 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq < 0 || Sk <= 0 ||
      dh < 8 || dh > MAX_DH || dh % 8)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  if ((long long)B * H > 65535 || (Sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= 64)
    return launch_dp<64>(q, k, v, o, B, H, Hkv, Sq, Sk, dh, scale, causal,
                         window, s);
  if (dh <= 128)
    return launch_dp<128>(q, k, v, o, B, H, Hkv, Sq, Sk, dh, scale, causal,
                          window, s);
  return launch_dp<192>(q, k, v, o, B, H, Hkv, Sq, Sk, dh, scale, causal,
                        window, s);
}

}  // namespace tc

}  // namespace

// q (B, H, Sq, dh), k/v (B, Hkv, Sk, dh) f32 → o (B, H, Sq, dh) f32.
extern "C" int flash_attn_fwd_f32(const float* q, const float* k,
                                  const float* v, float* o, int B, int H,
                                  int Hkv, int Sq, int Sk, int dh,
                                  float scale, int causal, int window,
                                  void* stream) {
  return f32::launch(q, k, v, o, B, H, Hkv, Sq, Sk, dh, scale, causal, window,
                     stream);
}

// The same over bf16 q, k, v → o bf16 (f32 running sums), on the tensor
// cores.
extern "C" int flash_attn_fwd_bf16(const __nv_bfloat16* q,
                                   const __nv_bfloat16* k,
                                   const __nv_bfloat16* v, __nv_bfloat16* o,
                                   int B, int H, int Hkv, int Sq, int Sk,
                                   int dh, float scale, int causal,
                                   int window, void* stream) {
  return tc::launch(q, k, v, o, B, H, Hkv, Sq, Sk, dh, scale, causal, window,
                    stream);
}
