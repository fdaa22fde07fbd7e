// Fused block-diagonal mid layer, backward:  du = dy ⊙ g'  (in registers)
//   dx[:, i] = Σ_{transposed steps s of input tile i}
//                du[:, s_in_t[s]] · wb_t[s_w_t[s]]ᵀ
//   dWB[q]   = Σ_b du[b, wb_out_tile[q]]ᵀ · x[b, wb_in_tile[q]]
//
// Replaces the TPU kernel repro/kernels/fused_layer.py::fused_layer_dx_dw,
// the backward of repro/kernels/ops.py::fused_layer's custom VJP.  dy, g'
// (B, n_out_tiles·blk), x (B, n_in_tiles·blk), the per-member-transposed
// tile array wb_t (n_param_blocks + 1, blk, blk) with the identity tile
// last (built as ops.py::_bd_transposed_tiles builds it), the transposed
// steps in CSR form (rowptr_t over input tiles, s_in_t, s_w_t) and each
// parameter tile's output and input tile (wb_out_tile, wb_in_tile) →
// dx (B, n_in_tiles·blk), dWB (n_param_blocks, blk, blk) f32.  The bias
// cotangent Σ_b du stays a plain tensor op outside, as in the JAX package.
//
// The TPU kernel walks the transposed steps on its outer grid axis and the
// batch tiles on the inner one, carrying dx run sums in a (B, blk) scratch
// and each dw tile across the inner batch tiles.  A GPU grid has no order,
// so one launch runs two roles split by blockIdx, every output with one
// owner:
//   * role A, a CTA per (32-row batch tile, input tile), walks that tile's
//     run of transposed steps — pass-through steps through the identity
//     tile — and writes dx once (the forward kernel's loop, with du formed
//     from dy and g' as the tile is staged);
//   * role B, a CTA per group of parameter tiles (128 / blk of them, so a
//     CTA has 128·blk outputs), loops privately over every batch tile.
//     Pass-through steps have no parameter tile, so they write no dW.
// No floating-point atomics: a step is bitwise reproducible.  Any block up
// to 128 (block 8, the LayeredPopulation default, included).
//
// What bounds it: bytes at training batch sizes.  Per parameter tile the
// kernel reads the weight tile once and does 4·B·blk² FLOP (dx and dW):
// at B = 32 that is 32 FLOP per weight byte, near the card's f32 ridge
// (67 TFLOP/s over 3.35 TB/s = 20); dy, g' and x are read once per role.
//
// Left for later: plain FMA (no tensor cores), no double buffering, and at
// blk = 8 a dx CTA computes only 32 × 8 outputs — many small CTAs.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLK = 128;
// role A (dx)
constexpr int BM = 32;                              // batch rows per CTA
constexpr int KC = 32;                              // reduction chunk
constexpr int MAX_ACC_A = BM * MAX_BLK / THREADS;   // 16
// role B (dW)
constexpr int KB = 32;                              // batch rows per chunk
constexpr int WB_COLS = 128;                        // G·blk ≤ 128 columns
constexpr int MAX_ACC_B = WB_COLS * MAX_BLK / THREADS;  // 64
constexpr int SMEM_A = BM * (KC + 1) + MAX_BLK * (KC + 1);
constexpr int SMEM_B = 2 * KB * (WB_COLS + 1);
constexpr int SMEM = SMEM_A > SMEM_B ? SMEM_A : SMEM_B;

__global__ void __launch_bounds__(THREADS)
fused_layer_dx_dw_kernel(const float* __restrict__ dy,
                         const float* __restrict__ g,
                         const float* __restrict__ x,
                         const float* __restrict__ wb_t,
                         const int* __restrict__ rowptr_t,
                         const int* __restrict__ s_in_t,
                         const int* __restrict__ s_w_t,
                         const int* __restrict__ wb_out_tile,
                         const int* __restrict__ wb_in_tile,
                         float* __restrict__ dx, float* __restrict__ dwb,
                         int B, int in_width, int out_width, int blk,
                         int n_param, int tiles_per_cta, int n_dx_ctas,
                         int n_btiles) {
  __shared__ float smem[SMEM];
  const int t = threadIdx.x;

  if ((int)blockIdx.x < n_dx_ctas) {
    // ---- role A: dx of one (batch tile, input tile)
    float(*us)[KC + 1] = reinterpret_cast<float(*)[KC + 1]>(smem);
    float(*ws)[KC + 1] =
        reinterpret_cast<float(*)[KC + 1]>(smem + BM * (KC + 1));
    const int bt = blockIdx.x % n_btiles;
    const int it = blockIdx.x / n_btiles;
    const int b0 = bt * BM;
    const int n_out = BM * blk;
    float acc[MAX_ACC_A];
#pragma unroll
    for (int a = 0; a < MAX_ACC_A; ++a) acc[a] = 0.f;
    const int s_end = rowptr_t[it + 1];
    for (int s = rowptr_t[it]; s < s_end; ++s) {
      const int col0 = s_in_t[s] * blk;   // a tile of the layer above
      const float* wt = wb_t + (size_t)s_w_t[s] * blk * blk;
      for (int k0 = 0; k0 < blk; k0 += KC) {
        const int kc = min(KC, blk - k0);
        __syncthreads();  // the previous chunk's reads are done
        for (int i = t; i < BM * kc; i += THREADS) {
          const int r = i / kc, c = i % kc;
          const int b = b0 + r;
          const size_t at = (size_t)b * out_width + col0 + k0 + c;
          us[r][c] = b < B ? dy[at] * g[at] : 0.f;
        }
        for (int i = t; i < blk * kc; i += THREADS) {
          const int r = i / kc, c = i % kc;
          ws[r][c] = wt[(size_t)r * blk + k0 + c];
        }
        __syncthreads();
#pragma unroll
        for (int a = 0; a < MAX_ACC_A; ++a) {
          const int o = t + a * THREADS;
          if (o < n_out) {
            const int r = o / blk, col = o % blk;
            float sum = acc[a];
            for (int c = 0; c < kc; ++c) sum = fmaf(us[r][c], ws[col][c], sum);
            acc[a] = sum;
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < MAX_ACC_A; ++a) {
      const int o = t + a * THREADS;
      if (o < n_out) {
        const int b = b0 + o / blk;
        if (b < B) dx[(size_t)b * in_width + it * blk + o % blk] = acc[a];
      }
    }
    return;
  }

  // ---- role B: dW of tiles q0 .. q0 + tiles_per_cta over every batch row
  float(*us)[WB_COLS + 1] = reinterpret_cast<float(*)[WB_COLS + 1]>(smem);
  float(*xs)[WB_COLS + 1] =
      reinterpret_cast<float(*)[WB_COLS + 1]>(smem + KB * (WB_COLS + 1));
  const int q0 = (blockIdx.x - n_dx_ctas) * tiles_per_cta;
  const int nq = min(tiles_per_cta, n_param - q0);
  const int bb = blk * blk;
  const int n_out = nq * bb;
  const int cols = nq * blk;
  float acc[MAX_ACC_B];
#pragma unroll
  for (int a = 0; a < MAX_ACC_B; ++a) acc[a] = 0.f;
  for (int b0 = 0; b0 < B; b0 += KB) {
    __syncthreads();  // the previous chunk's reads are done
    for (int i = t; i < KB * cols; i += THREADS) {
      const int k = i / cols, c = i % cols;
      const int gq = c / blk, e = c % blk;
      const int b = b0 + k;
      float u = 0.f, xv = 0.f;
      if (b < B) {
        const size_t au =
            (size_t)b * out_width + wb_out_tile[q0 + gq] * blk + e;
        u = dy[au] * g[au];
        xv = x[(size_t)b * in_width + wb_in_tile[q0 + gq] * blk + e];
      }
      us[k][c] = u;
      xs[k][c] = xv;
    }
    __syncthreads();
    const int kb = min(KB, B - b0);
#pragma unroll
    for (int a = 0; a < MAX_ACC_B; ++a) {
      const int o = t + a * THREADS;
      if (o < n_out) {
        const int gq = o / bb, rem = o % bb;
        const int ru = gq * blk + rem / blk;   // output unit of the tile
        const int cx = gq * blk + rem % blk;   // input unit of the tile
        float sum = acc[a];
        for (int k = 0; k < kb; ++k) sum = fmaf(us[k][ru], xs[k][cx], sum);
        acc[a] = sum;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < MAX_ACC_B; ++a) {
    const int o = t + a * THREADS;
    if (o < n_out) dwb[(size_t)q0 * bb + o] = acc[a];
  }
}

}  // namespace

extern "C" int fused_layer_dx_dw_f32(const float* dy, const float* g,
                                     const float* x, const float* wb_t,
                                     const int* rowptr_t, const int* s_in_t,
                                     const int* s_w_t, const int* wb_out_tile,
                                     const int* wb_in_tile, float* dx,
                                     float* dwb, int B, int n_in_tiles,
                                     int n_out_tiles, int n_param, int blk,
                                     void* stream) {
  if (B <= 0) return 0;
  if (blk <= 0 || blk > MAX_BLK || n_param < 0)
    return (int)cudaErrorInvalidValue;
  const int tiles_per_cta = WB_COLS / blk;
  const long long n_btiles = (B + BM - 1) / BM;
  const long long n_dx = n_btiles * n_in_tiles;
  const long long n_dw = (n_param + tiles_per_cta - 1) / tiles_per_cta;
  if (n_dx + n_dw > INT_MAX) return (int)cudaErrorInvalidValue;
  if (n_dx + n_dw == 0) return 0;
  fused_layer_dx_dw_kernel<<<(unsigned)(n_dx + n_dw), THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      dy, g, x, wb_t, rowptr_t, s_in_t, s_w_t, wb_out_tile, wb_in_tile, dx,
      dwb, B, n_in_tiles * blk, n_out_tiles * blk, blk, n_param,
      tiles_per_cta, (int)n_dx, (int)n_btiles);
  return (int)cudaGetLastError();
}
