// Ragged block-diagonal GEMM (the unfused mid-layer projection), forward
// and weight gradient:
//   forward:  y[:, o] = Σ_{steps s of row o} x[:, s_in[s]] · wb[s_w[s]]ᵀ
//   dW:       dWB[q]  = Σ_b dy[b, wb_out_tile[q]]ᵀ · x[b, wb_in_tile[q]]
//
// Replaces the TPU kernels repro/kernels/block_diag.py::block_diag_fwd
// (block_diag_fwd_f32 here) and ::block_diag_dw (block_diag_dw_f32 here),
// the pair behind repro/kernels/ops.py::block_diag_gemm's custom VJP.  As
// there, the forward kernel is also the backward's dh: fed dy, the
// per-member-transposed tiles and the transposed steps it computes
// dh[:, i] = Σ_{transposed steps s of input tile i} dy[:, s_in_t[s]] ·
// wb_t[s_w_t[s]]ᵀ.  wb is the (n_param_blocks + 1, blk, blk) tile array
// with the shared identity tile last (pass-through members); the steps come
// in CSR form (s_in, s_w (n_steps,) int32, one CSR row per output tile),
// walked by the group table of block_diag.py::fwd_groups.  x (B,
// n_in_tiles·blk) → y (B, n_rows·blk) f32; dy (B, n_out_tiles·blk), x →
// dWB (n_param_blocks, blk, blk) f32.
//
// The TPU kernels walk a sequential grid: the forward opens and flushes a
// VMEM accumulator on s_first/s_last as it passes an output tile's run of
// steps, and dW carries each tile's sum across the inner batch-tile axis.
// A GPU grid has no order, so every output has one owner that loops
// privately:
//   * forward: block_diag_core.cuh, shared with fused_layer.cu's forward:
//     one warp owning each group of rows (a member's output tiles, which
//     read the same input tiles, or a run of pass-through tiles), x and
//     the tiles staged once a group with cp.async in two stages, a 4 × 8
//     register tile a lane; this file's epilogue stores u;
//   * dW: one CTA per group of parameter tiles (128 / blk of them, so a
//     CTA has 128·blk outputs) loops over every batch row in a fixed
//     order, 32 rows at a time, and adds each chunk's sum to the total (one
//     running f32 sum over B = 300 rows strays about 1e-5 from the exact
//     sum).  No floating-point atomics: launched twice on the same inputs
//     it gives the same bits.
// Any block up to 128 (block 8, the LayeredPopulation default, included).
//
// What bounds it: bytes at training and serving batch sizes.  A step reads
// one blk × blk weight tile and one (32 × blk) input tile for 2·32·blk²
// FLOP (16 FLOP per weight byte at B = 32), below the card's f32 ridge
// (67 TFLOP/s over 3.35 TB/s = 20); the forward reads each x column and
// tile of a group once; dW reads dy and x once per parameter tile.
#include <climits>
#include <cuda_runtime.h>

#include "block_diag_core.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLK = 128;
// dW
constexpr int KB = 32;                               // batch rows per chunk
constexpr int W_COLS = 128;                          // G·blk ≤ 128 columns
constexpr int MAX_ACC_W = W_COLS * MAX_BLK / THREADS;  // 64

__global__ void __launch_bounds__(THREADS)
block_diag_dw_kernel(const float* __restrict__ dy,
                     const float* __restrict__ x,
                     const int* __restrict__ wb_out_tile,
                     const int* __restrict__ wb_in_tile,
                     float* __restrict__ dwb, int B, int out_width,
                     int in_width, int blk, int n_param, int tiles_per_cta) {
  __shared__ float us[KB][W_COLS + 1];
  __shared__ float xs[KB][W_COLS + 1];

  const int t = threadIdx.x;
  const int q0 = blockIdx.x * tiles_per_cta;
  const int nq = min(tiles_per_cta, n_param - q0);
  const int bb = blk * blk;
  const int n_out = nq * bb;
  const int cols = nq * blk;

  float acc[MAX_ACC_W];
#pragma unroll
  for (int a = 0; a < MAX_ACC_W; ++a) acc[a] = 0.f;

  for (int b0 = 0; b0 < B; b0 += KB) {
    __syncthreads();  // the previous chunk's reads are done
    for (int i = t; i < KB * cols; i += THREADS) {
      const int k = i / cols, c = i % cols;
      const int gq = c / blk, e = c % blk;
      const int b = b0 + k;
      float u = 0.f, xv = 0.f;
      if (b < B) {
        u = dy[(size_t)b * out_width + wb_out_tile[q0 + gq] * blk + e];
        xv = x[(size_t)b * in_width + wb_in_tile[q0 + gq] * blk + e];
      }
      us[k][c] = u;
      xs[k][c] = xv;
    }
    __syncthreads();
    const int kb = min(KB, B - b0);
#pragma unroll
    for (int a = 0; a < MAX_ACC_W; ++a) {
      const int o = t + a * THREADS;
      if (o < n_out) {
        const int gq = o / bb, rem = o % bb;
        const int ru = gq * blk + rem / blk;   // output unit of the tile
        const int cx = gq * blk + rem % blk;   // input unit of the tile
        float sum = 0.f;  // this chunk's sum, then added to the total
        for (int k = 0; k < kb; ++k) sum = fmaf(us[k][ru], xs[k][cx], sum);
        acc[a] += sum;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < MAX_ACC_W; ++a) {
    const int o = t + a * THREADS;
    if (o < n_out) dwb[(size_t)q0 * bb + o] = acc[a];
  }
}

// the forward's epilogue: u as it is, from the lane's registers, 16-byte
// evict-first stores where the vec4 instance runs
struct StoreU {
  template <int V>
  __device__ __forceinline__ void run(const bdcore::Args& a,
                                      const bdcore::Rec& q, int lane,
                                      const float (&acc)[bdcore::RPL]
                                                        [bdcore::CG],
                                      float*) const {
    int tile, ncol;
    size_t col0;
    if (!bdcore::lane_cols(q, a, lane, tile, col0, ncol)) return;
    const int b0 = q.bt * bdcore::BT, nb = min(bdcore::BT, a.B - b0);
#pragma unroll
    for (int i = 0; i < bdcore::RPL; ++i) {
      const int b = (lane & 7) + 8 * i;
      if (b >= nb) break;
      float* y = a.y + (size_t)(b0 + b) * a.out_w + col0;
      if constexpr (V == 4) {
#pragma unroll
        for (int c = 0; c < bdcore::CG; c += 4)
          if (c < ncol)
            __stcs(reinterpret_cast<float4*>(y + c),
                   make_float4(acc[i][c], acc[i][c + 1], acc[i][c + 2],
                               acc[i][c + 3]));
      } else {
#pragma unroll
        for (int c = 0; c < bdcore::CG; ++c)
          if (c < ncol) __stcs(y + c, acc[i][c]);
      }
    }
  }
};

template <int V>
__global__ void __launch_bounds__(bdcore::THREADS, 3)
block_diag_group_kernel(bdcore::Args a) {
  bdcore::run_groups<V, StoreU>(a);
}

}  // namespace

// The group core's register tile, which block_diag.py restates
// (GROUP_COLS, LANE_COLS): a warp's columns and a lane's.
extern "C" int block_diag_core_shapes(int* out) {
  out[0] = bdcore::NG * bdcore::CG;
  out[1] = bdcore::CG;
  return 0;
}

// x (B, n_in_tiles·blk), wb (n_tiles, blk, blk), the CSR steps' s_in and
// s_w, and the group table (n_groups, 7) of its n_rows rows → y (B,
// n_rows·blk).
extern "C" int block_diag_fwd_f32(const float* x, const float* wb,
                                  const int* s_in, const int* s_w,
                                  const int* groups, float* y, int B,
                                  int n_in_tiles, int n_rows, int blk,
                                  int n_groups, void* stream) {
  if (n_rows <= 0) return 0;
  bdcore::Args a{x,       wb,      s_in,    s_w,        groups,
                 y,       nullptr, nullptr, nullptr,    nullptr,
                 B,       n_in_tiles, n_rows, blk,      n_groups};
  return bdcore::launch_groups(
      reinterpret_cast<const void*>(block_diag_group_kernel<4>),
      reinterpret_cast<const void*>(block_diag_group_kernel<1>), a, stream);
}

// dy (B, n_out_tiles·blk), x (B, n_in_tiles·blk), each parameter tile's
// output and input tile (n_param,) → dWB (n_param, blk, blk).
extern "C" int block_diag_dw_f32(const float* dy, const float* x,
                                 const int* wb_out_tile,
                                 const int* wb_in_tile, float* dwb, int B,
                                 int n_out_tiles, int n_in_tiles,
                                 int n_param, int blk, void* stream) {
  if (n_param <= 0) return 0;
  if (blk <= 0 || blk > MAX_BLK || B < 0) return (int)cudaErrorInvalidValue;
  const int tiles_per_cta = W_COLS / blk;
  const long long n_ctas = (n_param + tiles_per_cta - 1) / tiles_per_cta;
  block_diag_dw_kernel<<<(unsigned)n_ctas, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      dy, x, wb_out_tile, wb_in_tile, dwb, B, n_out_tiles * blk,
      n_in_tiles * blk, blk, n_param, tiles_per_cta);
  return (int)cudaGetLastError();
}
