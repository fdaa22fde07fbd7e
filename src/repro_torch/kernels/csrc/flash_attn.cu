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
// a multiple of 8 up to 128 (120 for h2o-danube-3-4b); Sq and Sk are any
// sizes, Sq ≠ Sk allowed.
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
//   64 or 128 in shared memory (zeros past dh from the same out-of-bounds
//   fill; dh 128 is two 64-column boxes, the descriptor advanced between
//   them).  Per tile a consumer warpgroup issues S = Q·Kᵀ as
//   wgmma.m64n64k16 (both operands K-major in shared memory), applies the
//   scale, the masks and the online softmax to the accumulator registers
//   (a row's 64 columns lie in one quad of lanes: max and sum are two
//   shuffles), rounds p to bf16 pairs in registers — the A operand layout
//   of the next product — and issues O += P·V as wgmma.m64n{DP}k16 with A
//   from registers and V MN-major through the transpose bit.  l sums the
//   unrounded p.  exp(x) is computed as exp2f(x · log2 e).  Only tiles on
//   the causal diagonal, at the window's edge or past Sk mask per element.
//   CTAs take the longest causal q tiles first.
// * f32: the FMA units.  A CTA owns 64 q rows, 256 threads as 16 × 16:
//   thread (ty, tx) holds the scores of rows 4·ty..4·ty+3 and columns
//   tx + 16·c (c < 4), and the output of the same rows at columns
//   tx + 16·c (c < 8, d < dh), all in registers; Q stays in shared memory
//   for the whole walk; K and then V of a 64-column tile take turns in one
//   buffer (row stride dh + 4, so the 16-byte reads of a quarter-warp hit
//   distinct banks), the tile's p in another; a row's max and sum are
//   shuffles across the 16 lanes that hold it.
//
// Both skip a k tile that is masked for every row of the CTA only when
// every row of the CTA has a real column somewhere (then the skipped
// columns would have added exactly 0); a CTA holding a fully masked row
// walks every tile, so that row keeps the oracle's value.
//
// What bounds it: operations.  At qwen3-1.7b's training shape (B 2, H 16,
// S 4096, dh 128, causal) the kernel reads q, k, v and writes o once (f32
// 201 MB, 0.06 ms at 3.35 TB/s; bf16 half that) for 4·dh FLOP per
// unmasked (q, k) pair, 137.4 GFLOP: 0.139 ms at bf16's dense tensor-core
// 989 TFLOP/s, 2.05 ms at the f32 rate of 67.  At h2o-danube-3-4b's (B 1,
// S 8192, H 32, Hkv 8, dh 120, window 4096) 386.6 GFLOP, 0.391 ms in bf16.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 64;            // q rows per CTA
constexpr int BK = 64;            // k columns per tile
constexpr int RQ = 4;             // q rows per thread
constexpr int CK = BK / 16;       // k columns per thread
constexpr int MAX_DH = 128;
constexpr int CD = MAX_DH / 16;   // output columns per thread (at most)
constexpr int PS = BK + 4;        // row stride of the p tile
constexpr float NEG_INF = -1e30f;

__host__ __device__ constexpr size_t smem_floats(int dh) {
  return (size_t)BQ * dh + (size_t)BK * (dh + 4) + (size_t)BQ * PS;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }

// rows × dh elements of T from global (row stride dh) into f32 shared
// memory (row stride ld), in 16-byte pieces; rows ≥ n_real are zeros
template <typename T>
__device__ void load_tile(const T* __restrict__ g, float* __restrict__ s,
                          int rows, int n_real, int dh, int ld) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = dh / V;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += THREADS) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) * V;
    float* dst = s + r * ld + c;
    if (r < n_real) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          g + (size_t)r * dh + c));
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < V; e += 4)
        *reinterpret_cast<float4*>(dst + e) =
            make_float4(to_f32(vals[e]), to_f32(vals[e + 1]),
                        to_f32(vals[e + 2]), to_f32(vals[e + 3]));
    } else {
#pragma unroll
      for (int e = 0; e < V; e += 4)
        *reinterpret_cast<float4*>(dst + e) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
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

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int H,
                      int Hkv, int Sq, int Sk, int dh, float scale,
                      int causal, int window) {
  extern __shared__ float4 smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);    // BQ × dh
  float* KVs = Qs + BQ * dh;                          // BK × (dh + 4)
  float* Ps = KVs + BK * (dh + 4);                    // BQ × PS
  const int ldkv = dh + 4;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int kvh = b * Hkv + h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const T* qg = q + ((size_t)bh * Sq + q0) * dh;
  const T* kg = k + (size_t)kvh * Sk * dh;
  const T* vg = v + (size_t)kvh * Sk * dh;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = ty * RQ;

  load_tile(qg, Qs, BQ, Sq - q0, dh, dh);

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  // every row of the tile has a real column unless some row lies past
  // Sk + window − 2 (only a window can empty a row)
  const bool rows_all_real = window <= 0 || q_last <= Sk + window - 2;

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    const int k_end = min(k0 + BK, Sk) - 1;
    const bool all_masked = (causal && k0 > q_last) ||
                            (window > 0 && q0 - k_end >= window);
    if (all_masked && rows_all_real) continue;  // uniform across the CTA

    __syncthreads();  // the previous tile's V and p are consumed
    load_tile(kg + (size_t)k0 * dh, KVs, BK, Sk - k0, dh, ldkv);
    __syncthreads();

    // scores: s[i][c] = q[r0 + i] · k[tx + 16c]
    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int c = 0; c < CK; ++c) s[i][c] = 0.f;
    for (int d = 0; d < dh; d += 4) {
      float4 qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (r0 + i) * dh + d);
#pragma unroll
      for (int c = 0; c < CK; ++c)
        kv[c] = *reinterpret_cast<const float4*>(KVs + (tx + 16 * c) * ldkv
                                                 + d);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < CK; ++c) {
          s[i][c] = fmaf(qv[i].x, kv[c].x, s[i][c]);
          s[i][c] = fmaf(qv[i].y, kv[c].y, s[i][c]);
          s[i][c] = fmaf(qv[i].z, kv[c].z, s[i][c]);
          s[i][c] = fmaf(qv[i].w, kv[c].w, s[i][c]);
        }
    }

    // mask, then the online softmax of each row
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qp = q0 + r0 + i;
      float tile_max = -INFINITY;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int kp = k0 + tx + 16 * c;
        bool ok = true;
        if (causal) ok = ok && qp >= kp;
        if (window > 0) ok = ok && qp - kp < window;
        const float sc = ok ? s[i][c] * scale : NEG_INF;
        s[i][c] = kp < Sk ? sc : -INFINITY;  // past Sk: out of the sums
        tile_max = fmaxf(tile_max, s[i][c]);
      }
      const float m_new = fmaxf(m[i], row_max16(tile_max));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int kp = k0 + tx + 16 * c;
        const float p = kp < Sk ? expf(s[i][c] - m_new) : 0.f;
        psum += p;
        Ps[(r0 + i) * PS + tx + 16 * c] = p;
      }
      l[i] = l[i] * alpha + row_sum16(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread is done with K; p is written
    load_tile(vg + (size_t)k0 * dh, KVs, BK, Sk - k0, dh, ldkv);
    __syncthreads();

    // acc[i][c] += Σ_j p[r0 + i][j] · v[j][tx + 16c]
    const int kn = min(BK, Sk - k0);
    for (int j = 0; j < kn; ++j) {
      float p[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) p[i] = Ps[(r0 + i) * PS + j];
      const float* vr = KVs + j * ldkv + tx;
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        if (tx + 16 * c < dh) {
          const float vv = vr[16 * c];
#pragma unroll
          for (int i = 0; i < RQ; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qp = q0 + r0 + i;
    if (qp >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)bh * Sq + qp) * dh;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int d = tx + 16 * c;
      if (d < dh) from_f32(acc[i][c] * inv, orow + d);
    }
  }
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, int B, int H, int Hkv,
           int Sq, int Sk, int dh, float scale, int causal, int window,
           void* stream) {
  if (B < 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq < 0 || Sk <= 0 ||
      dh < 8 || dh > MAX_DH || dh % 8)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  const long long n_bh = (long long)B * H;
  if (n_bh > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(dh) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(smem_floats(MAX_DH) * sizeof(float)));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, (unsigned)n_bh);
  flash_attn_fwd_kernel<T><<<grid, THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      q, k, v, o, H, Hkv, Sq, Sk, dh, scale, causal, window);
  return (int)cudaGetLastError();
}


// ---- bf16 on the tensor cores -------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BQ = 128;  // q rows per CTA: two consumer warpgroups
constexpr int BK = 64;   // k columns per tile
constexpr float LOG2E = 1.4426950408889634f;

template <int DP>
struct Shape {
  static constexpr int NB = DP / 64;            // 64-column boxes a row
  static constexpr int STAGES = DP == 128 ? 3 : 4;
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

    // O += P·V: V's 16-row slices 2048 bytes apart, its second 64-column
    // box KV_BOX bytes away
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
  return dh <= 64 ? launch_dp<64>(q, k, v, o, B, H, Hkv, Sq, Sk, dh, scale,
                                  causal, window, s)
                  : launch_dp<128>(q, k, v, o, B, H, Hkv, Sq, Sk, dh, scale,
                                   causal, window, s);
}

}  // namespace tc

}  // namespace

// q (B, H, Sq, dh), k/v (B, Hkv, Sk, dh) f32 → o (B, H, Sq, dh) f32.
extern "C" int flash_attn_fwd_f32(const float* q, const float* k,
                                  const float* v, float* o, int B, int H,
                                  int Hkv, int Sq, int Sk, int dh,
                                  float scale, int causal, int window,
                                  void* stream) {
  return launch(q, k, v, o, B, H, Hkv, Sq, Sk, dh, scale, causal, window,
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
