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
// GPU grid has no order, so here one CTA owns one (b·h, 64-row q tile) and
// walks the 64-column k tiles in order inside itself:
//   * 256 threads as 16 × 16: thread (ty, tx) holds the scores of rows
//     4·ty..4·ty+3 and columns tx + 16·c (c < 4), and the output of the
//     same rows at columns tx + 16·c (c < 8, d < dh), all in registers;
//   * Q stays in shared memory for the whole walk; K and then V of a tile
//     take turns in one buffer (row stride dh + 4, so the 16-byte reads of
//     a quarter-warp hit distinct banks), the tile's p in another;
//   * a row's max and sum are shuffles across the 16 lanes that hold it;
//   * a tile that is masked for every row of the CTA is skipped only when
//     every row of the CTA has a real column somewhere (then the skipped
//     columns would have added exactly 0); a CTA holding a fully masked row
//     walks every tile, so that row keeps the oracle's value.
//
// What bounds it: operations.  At qwen3-1.7b's training shape (B 2, H 16,
// S 4096, dh 128, causal) the kernel reads q, k, v and writes o once,
// 201 MB (0.06 ms at 3.35 TB/s), for 4·dh FLOP per unmasked (q, k) pair,
// 137 GFLOP (2.05 ms at the f32 rate of 67 TFLOP/s, 0.139 ms at bf16's
// dense tensor-core 989).  This first kernel runs on the FMA units with
// shared-memory operands, for both dtypes: tensor cores (wgmma on bf16
// tiles), a pipelined K/V ring and a larger q tile are left for later.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}
// p as the PV product sees it: rounded to v's dtype
__device__ __forceinline__ float round_as(float v, float) { return v; }
__device__ __forceinline__ float round_as(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}

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
        Ps[(r0 + i) * PS + tx + 16 * c] = round_as(p, T());
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

// The same over bf16 q, k, v → o bf16 (f32 running sums).
extern "C" int flash_attn_fwd_bf16(const __nv_bfloat16* q,
                                   const __nv_bfloat16* k,
                                   const __nv_bfloat16* v, __nv_bfloat16* o,
                                   int B, int H, int Hkv, int Sq, int Sk,
                                   int dh, float scale, int causal,
                                   int window, void* stream) {
  return launch(q, k, v, o, B, H, Hkv, Sq, Sk, dh, scale, causal, window,
                stream);
}
