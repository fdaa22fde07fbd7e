// Fused input layer, forward:  y = act(x · Wᵀ + b) · mask
//                    training:  also g' = act'(x · Wᵀ + b) · mask
//
// Replaces the TPU kernel repro/kernels/fused_input.py::fused_input_fwd,
// with_deriv=False (serving, repro/kernels/ops.py::fused_input_infer:
// fused_input_infer_f32 here) and with_deriv=True (training, the forward of
// ops.py::fused_input's custom VJP: fused_input_train_f32 here).  One kernel
// template, the flag DERIV selecting the second output.
//
// The same template, with int8 weights, replaces
// repro/kernels/fused_input.py::fused_input_int8_fwd (the int8 serve copy,
// ops.py::fused_input_infer_int8: fused_input_infer_i8 here).  W_q is
// (H, F_pad) int8, stored pre-padded to F_pad (104 for F = 100); x stays
// (B, F) and the kernel reads only the first F bytes of each weight row.
// Each hidden row block of `block` rows has one f32 scale (H / block,).  The
// int8 bytes are read from device memory once per CTA, converted to f32 and
// multiplied by their row's scale as they are staged in shared memory
// (q·s, then the dot, as JAX dequantizes before its contraction); the FMA
// loop is the f32 kernel's.  Converting once at staging matters: a staged
// weight is read by the 16 threads that share its column, and an SM
// converts integers to floats at an eighth of its f32 FMA rate.
//
// x (B, F), W (H, F), b and mask (H,) f32, act ids one per population block
// (H / block,) int32 → y (B, H) f32 [and g' (B, H) f32].  The
// pre-activation z never reaches device memory: the bias, the block's
// activation (and its derivative) and the padding mask are applied to the
// accumulator in registers.
//
// What bounds it: bytes.  At the paper's 10,000-member width (H = 1,280,000,
// F = 100) and a flush of B = 32, one launch must read W (512 MB) and write
// y (164 MB) against 8.2 GFLOP — about 0.2 ms of memory traffic at
// 3.35 TB/s against 0.12 ms of f32 FMA work (the training variant writes
// g' too: 164 MB more).  The design therefore reads W
// exactly once per batch tile: a CTA owns a (32 batch rows × 128 hidden
// units) output tile and walks F in chunks of 16 staged in shared memory.
// Batch tiles of one hidden tile are adjacent in launch order, so at larger
// B the W tile is re-read from L2, not from device memory.  The hidden tile
// is independent of the population block, so block 8 and block 128 run the
// same code (the activation id is looked up per column).
//
// With int8 weights the byte bound falls (W is 133 MB at full width, so the
// 164 MB output write is the larger part) and the f32 FMA work, 8.2 GFLOP
// (0.12 ms at 67 TFLOP/s), becomes the bound.
//
// Left for later: no cp.async/TMA double buffering (each chunk's loads are
// waited for before its FMAs), plain FMA instead of tensor cores (f32 only
// in this slice), and a fixed 32-row batch tile that wastes half the tile's
// rows' compute when B < 32.
#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "activations.cuh"

namespace {

constexpr int BM = 32;        // batch rows per CTA
constexpr int BN = 128;       // hidden units per CTA
constexpr int BK = 16;        // feature chunk staged in shared memory
constexpr int THREADS = 256;  // 16 × 16 threads
constexpr int RM = BM / 16;   // rows per thread
constexpr int RN = BN / 16;   // columns per thread (strided by 16)

// W is float (w_scale and ldw unused: rows are F long) or int8_t (w_scale
// one f32 per row block, ldw = F_pad the row stride).
template <typename W, bool DERIV>
__global__ void __launch_bounds__(THREADS)
fused_input_kernel(const float* __restrict__ x, const W* __restrict__ w,
                   const float* __restrict__ w_scale, int ldw,
                   const float* __restrict__ bias,
                   const float* __restrict__ mask,
                   const int* __restrict__ act_ids, float* __restrict__ y,
                   float* __restrict__ g, int B, int F, int H, int block,
                   int n_btiles) {
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN + 1];
  __shared__ float row_scale[BN];  // int8 weights: each staged row's scale

  const int bt = blockIdx.x % n_btiles;
  const int ht = blockIdx.x / n_btiles;
  const int b0 = bt * BM;
  const int h0 = ht * BN;
  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;

  constexpr bool INT8 = std::is_same<W, int8_t>::value;
  if constexpr (INT8) {
    for (int r = t; r < BN; r += THREADS)
      row_scale[r] = h0 + r < H ? w_scale[(h0 + r) / block] : 0.f;
    __syncthreads();
  }

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (int f0 = 0; f0 < F; f0 += BK) {
    for (int i = t; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int b = b0 + r, f = f0 + c;
      xs[c][r] = (b < B && f < F) ? x[(size_t)b * F + f] : 0.f;
    }
    for (int i = t; i < BN * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int h = h0 + r, f = f0 + c;
      if constexpr (INT8)
        ws[c][r] = (h < H && f < F)
                       ? (float)w[(size_t)h * ldw + f] * row_scale[r]
                       : 0.f;
      else
        ws[c][r] = (h < H && f < F) ? w[(size_t)h * F + f] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[RM], bv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = xs[k][ty * RM + i];
#pragma unroll
      for (int j = 0; j < RN; ++j) bv[j] = ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < RN; ++j) {
    const int h = h0 + tx + 16 * j;
    if (h >= H) continue;
    const float bb = bias[h];
    const float mm = mask[h];
    const int id = act_ids[h / block];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int b = b0 + ty * RM + i;
      if (b >= B) continue;
      const float u = acc[i][j] + bb;
      y[(size_t)b * H + h] = apply_act(id, u) * mm;
      if constexpr (DERIV) g[(size_t)b * H + h] = apply_act_deriv(id, u) * mm;
    }
  }
}

template <typename W, bool DERIV>
int launch(const float* x, const W* w, const float* w_scale, int ldw,
           const float* bias, const float* mask, const int* act_ids, float* y,
           float* g, int B, int F, int H, int block, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (F <= 0 || block <= 0 || ldw < F) return (int)cudaErrorInvalidValue;
  const long long n_btiles = (B + BM - 1) / BM;
  const long long n_tiles = n_btiles * ((H + BN - 1) / BN);
  if (n_tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  fused_input_kernel<W, DERIV><<<(unsigned)n_tiles, THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      x, w, w_scale, ldw, bias, mask, act_ids, y, g, B, F, H, block,
      (int)n_btiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_input_infer_f32(const float* x, const float* w,
                                     const float* bias, const float* mask,
                                     const int* act_ids, float* y, int B,
                                     int F, int H, int block, void* stream) {
  return launch<float, false>(x, w, nullptr, F, bias, mask, act_ids, y,
                              nullptr, B, F, H, block, stream);
}

extern "C" int fused_input_train_f32(const float* x, const float* w,
                                     const float* bias, const float* mask,
                                     const int* act_ids, float* y, float* g,
                                     int B, int F, int H, int block,
                                     void* stream) {
  return launch<float, true>(x, w, nullptr, F, bias, mask, act_ids, y, g, B,
                             F, H, block, stream);
}

// x (B, F) f32, w_q (H, F_pad) int8, w_scale (H / block,) f32.
extern "C" int fused_input_infer_i8(const float* x, const int8_t* w_q,
                                    const float* w_scale, const float* bias,
                                    const float* mask, const int* act_ids,
                                    float* y, int B, int F, int F_pad, int H,
                                    int block, void* stream) {
  return launch<int8_t, false>(x, w_q, w_scale, F_pad, bias, mask, act_ids,
                               y, nullptr, B, F, H, block, stream);
}
