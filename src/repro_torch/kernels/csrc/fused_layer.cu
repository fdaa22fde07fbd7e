// Fused block-diagonal mid layer, forward:
//   y[:, o] = act(u[:, o]) · mask[o],
//   u[:, o] = Σ_{steps s of output tile o} x[:, s_in[s]] · wb[s_w[s]]ᵀ
//             + b_eff[o]
// and, for training, g'[:, o] = act'(u[:, o]) · mask[o] as a second output.
//
// Replaces the TPU kernel repro/kernels/fused_layer.py::fused_layer_fwd,
// with_deriv=False (serving, repro/kernels/ops.py::fused_layer_infer:
// fused_layer_infer_f32 here) and with_deriv=True (training, the forward of
// ops.py::fused_layer's custom VJP: fused_layer_train_f32 here).  One kernel
// template, the flag DERIV selecting the second output.
//
// The same template, with int8 tiles, replaces
// repro/kernels/fused_layer.py::fused_layer_int8_fwd (the int8 serve copy,
// ops.py::fused_layer_infer_int8: fused_layer_infer_i8 here): wb is the
// packer's (n_param_blocks + 1, blk, blk) int8 array, identity tile already
// appended, with one f32 scale per tile (n_param_blocks + 1,), 1.0 for the
// identity.  An output tile sums over several steps, each with its own
// tile and so its own scale (JAX: sc_ref[w_ids[s]]), so the scale is
// applied per step: each int8 byte is read from device memory once per
// CTA, converted to f32 and multiplied by its step's scale as it is staged
// in shared memory (q·s, then the dot, as in JAX); the FMA loop is the f32
// kernel's.  A tile at block 8 is 64 bytes; the bytes are loaded one by
// one, so no load depends on the tile's alignment.
//
// x (B, n_in_tiles·blk), wb (n_param_blocks + 1, blk, blk) f32 with the
// shared identity tile appended (pass-through members), b_eff and mask
// (n_out_tiles·blk,) f32, one activation id per output tile (int32), and the
// layout's steps in CSR form: rowptr (n_out_tiles + 1,), s_in and s_w
// (n_steps,) int32 → y [and g'] (B, n_out_tiles·blk) f32.
//
// The TPU kernel walks the flat ragged step list on a sequential grid axis
// and opens/closes a VMEM accumulator on s_first/s_last.  A GPU grid has no
// order, so here one CTA owns one (32-row batch tile, output tile) pair and
// loops privately over that tile's run of steps (rowptr[o] .. rowptr[o+1]),
// accumulating in registers; the epilogue then adds the gated bias, applies
// the tile's activation and the mask.  Nothing is shared between CTAs.
//
// What bounds it: bytes at serving batch sizes.  Each step reads one
// blk × blk weight tile and one (32 × blk) input tile and does 2·32·blk²
// FLOP: 16 FLOP per weight byte at B = 32, below the card's f32 ridge
// (67 TFLOP/s over 3.35 TB/s = 20).  Batch tiles of one output tile are
// adjacent in launch order, so larger batches re-read weight tiles from L2.
// Works for any blk ≤ 128 (block 8, the LayeredPopulation default, included).
//
// Left for later: no double buffering of the tile loads, plain FMA instead
// of tensor cores, and at blk = 8 a CTA of 256 threads computes only
// 32 × 8 outputs — many small CTAs.
#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "activations.cuh"

namespace {

constexpr int BM = 32;          // batch rows per CTA
constexpr int KC = 32;          // reduction chunk staged in shared memory
constexpr int THREADS = 256;
constexpr int MAX_BLK = 128;
constexpr int MAX_ACC = BM * MAX_BLK / THREADS;  // outputs per thread (16)

// W is float (wb_scale unused) or int8_t (wb_scale one f32 per tile).
template <typename W, bool DERIV>
__global__ void __launch_bounds__(THREADS)
fused_layer_kernel(const float* __restrict__ x, const W* __restrict__ wb,
                   const float* __restrict__ wb_scale,
                   const float* __restrict__ b_eff,
                   const float* __restrict__ mask,
                   const int* __restrict__ tile_act,
                   const int* __restrict__ rowptr,
                   const int* __restrict__ s_in, const int* __restrict__ s_w,
                   float* __restrict__ y, float* __restrict__ g, int B,
                   int in_width, int out_width, int blk, int n_btiles) {
  __shared__ float xs[BM][KC + 1];
  __shared__ float ws[MAX_BLK][KC + 1];

  const int bt = blockIdx.x % n_btiles;
  const int ot = blockIdx.x / n_btiles;
  const int b0 = bt * BM;
  const int t = threadIdx.x;
  const int n_out = BM * blk;  // outputs of this CTA: (row, column) pairs

  float acc[MAX_ACC];
#pragma unroll
  for (int a = 0; a < MAX_ACC; ++a) acc[a] = 0.f;

  const int s_end = rowptr[ot + 1];
  for (int s = rowptr[ot]; s < s_end; ++s) {
    const int in_col0 = s_in[s] * blk;
    const W* wt = wb + (size_t)s_w[s] * blk * blk;
    float sc = 1.f;
    if constexpr (std::is_same<W, int8_t>::value) sc = wb_scale[s_w[s]];
    for (int k0 = 0; k0 < blk; k0 += KC) {
      const int kc = min(KC, blk - k0);
      __syncthreads();  // the previous chunk's reads are done
      for (int i = t; i < BM * kc; i += THREADS) {
        const int r = i / kc, c = i % kc;
        const int b = b0 + r;
        xs[r][c] = b < B ? x[(size_t)b * in_width + in_col0 + k0 + c] : 0.f;
      }
      for (int i = t; i < blk * kc; i += THREADS) {
        const int r = i / kc, c = i % kc;
        if constexpr (std::is_same<W, int8_t>::value)
          ws[r][c] = (float)wt[(size_t)r * blk + k0 + c] * sc;
        else
          ws[r][c] = wt[(size_t)r * blk + k0 + c];
      }
      __syncthreads();
#pragma unroll
      for (int a = 0; a < MAX_ACC; ++a) {
        const int o = t + a * THREADS;
        if (o < n_out) {
          const int r = o / blk, col = o % blk;
          float sum = acc[a];
          for (int c = 0; c < kc; ++c) sum = fmaf(xs[r][c], ws[col][c], sum);
          acc[a] = sum;
        }
      }
    }
  }

  const int act = tile_act[ot];
#pragma unroll
  for (int a = 0; a < MAX_ACC; ++a) {
    const int o = t + a * THREADS;
    if (o < n_out) {
      const int b = b0 + o / blk;
      const int col = ot * blk + o % blk;
      if (b < B) {
        const float u = acc[a] + b_eff[col];
        y[(size_t)b * out_width + col] = apply_act(act, u) * mask[col];
        if constexpr (DERIV)
          g[(size_t)b * out_width + col] = apply_act_deriv(act, u) * mask[col];
      }
    }
  }
}

template <typename W, bool DERIV>
int launch(const float* x, const W* wb, const float* wb_scale,
           const float* b_eff, const float* mask, const int* tile_act,
           const int* rowptr, const int* s_in, const int* s_w, float* y,
           float* g, int B, int n_in_tiles, int n_out_tiles, int blk,
           void* stream) {
  if (B <= 0 || n_out_tiles <= 0) return 0;
  if (blk <= 0 || blk > MAX_BLK) return (int)cudaErrorInvalidValue;
  const long long n_btiles = (B + BM - 1) / BM;
  const long long n_tiles = n_btiles * n_out_tiles;
  if (n_tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  fused_layer_kernel<W, DERIV><<<(unsigned)n_tiles, THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      x, wb, wb_scale, b_eff, mask, tile_act, rowptr, s_in, s_w, y, g, B,
      n_in_tiles * blk, n_out_tiles * blk, blk, (int)n_btiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_layer_infer_f32(const float* x, const float* wb,
                                     const float* b_eff, const float* mask,
                                     const int* tile_act, const int* rowptr,
                                     const int* s_in, const int* s_w,
                                     float* y, int B, int n_in_tiles,
                                     int n_out_tiles, int blk, void* stream) {
  return launch<float, false>(x, wb, nullptr, b_eff, mask, tile_act, rowptr,
                              s_in, s_w, y, nullptr, B, n_in_tiles,
                              n_out_tiles, blk, stream);
}

extern "C" int fused_layer_train_f32(const float* x, const float* wb,
                                     const float* b_eff, const float* mask,
                                     const int* tile_act, const int* rowptr,
                                     const int* s_in, const int* s_w,
                                     float* y, float* g, int B,
                                     int n_in_tiles, int n_out_tiles, int blk,
                                     void* stream) {
  return launch<float, true>(x, wb, nullptr, b_eff, mask, tile_act, rowptr,
                             s_in, s_w, y, g, B, n_in_tiles, n_out_tiles,
                             blk, stream);
}

// wb_q (n_param_blocks + 1, blk, blk) int8, wb_scale (n_param_blocks + 1,).
extern "C" int fused_layer_infer_i8(const float* x, const int8_t* wb_q,
                                    const float* wb_scale,
                                    const float* b_eff, const float* mask,
                                    const int* tile_act, const int* rowptr,
                                    const int* s_in, const int* s_w,
                                    float* y, int B, int n_in_tiles,
                                    int n_out_tiles, int blk, void* stream) {
  return launch<int8_t, false>(x, wb_q, wb_scale, b_eff, mask, tile_act,
                               rowptr, s_in, s_w, y, nullptr, B, n_in_tiles,
                               n_out_tiles, blk, stream);
}
