// Ragged block-diagonal GEMM (the unfused mid-layer projection), forward
// and weight gradient:
//   forward:  y[:, o] = Σ_{steps s of row o} x[:, s_in[s]] · wb[s_w[s]]ᵀ
//   dW:       dWB[q]  = Σ_b dy[b, wb_out_tile[q]]ᵀ · x[b, wb_in_tile[q]]
//
// Replaces the TPU kernels repro/kernels/block_diag.py::block_diag_fwd
// (block_diag_fwd_f32 here) and ::block_diag_dw (block_diag_dw_f32 here),
// the pair behind repro/kernels/ops.py::block_diag_gemm's custom VJP, and
// their instances under the bf16 compute policy (block_diag_fwd_bf16,
// block_diag_dw_bf16; see below).  As
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
//   * dW: member-owned units (member_units.cuh, the packing of
//     fused_layer_dx_dw.cu, from block_diag.py::dw_units): a unit is a
//     member's rectangle of parameter tiles — ob output tiles × ib input
//     tiles, tile (r, c) at q + r·ib + c, the layout's member-major order —
//     or a chunk of its input-tile columns, or one tile where the tile
//     list traces no rectangle.  A unit stages its dy columns (32 rows ×
//     ob·blk) and x columns (32 rows × its columns) once per 32-row batch
//     chunk with 16-byte loads, forms every dW tile of the rectangle from
//     shared memory in 4 × 4 register tiles, adds each chunk's sum to its
//     total in registers, in chunk order (one running f32 sum over B = 300
//     rows strays about 1e-5 from the exact sum), and writes its
//     contiguous run of dWB once, 16 bytes at a time, evict-first.  Each
//     output has one owner, no floating-point atomics: launched twice on
//     the same inputs it gives the same bits, and every element's chain
//     (each chunk's sum from 0 over its rows in order, then the sums added
//     in order) is the one of the per-tile kernel it replaced.
// Any block up to 128 (block 8, the LayeredPopulation default, included).
//
// bf16 (the compute policy: x, the tiles and dy bf16, as JAX's kernels
// take them on the unfused route; block_diag_fwd_bf16, kernel
// block_diag_bf16_group_kernel; block_diag_dw_bf16, kernel
// block_diag_dw_bf16_member_kernel): the forward runs the group core under
// its BF16W policy (x and the tiles widened into the f32 stage as a chunk
// is issued) and stores u rounded once to bf16, 4 values an 8-byte store;
// the dW stages dy and x widened (8-byte loads) and keeps the same chain —
// each 32-row chunk's sum from 0, the chunks' sums added in order, in
// registers — then rounds each dW element once, at the end, as JAX sums
// every batch tile into one f32 accumulator and rounds it once
// (repro/kernels/block_diag.py:131-135).  The vec4 instances take bf16
// tensors on 8-byte boundaries (4 values a load or a store).
//
// What bounds it: bytes at training and serving batch sizes.  A step reads
// one blk × blk weight tile and one (32 × blk) input tile for 2·32·blk²
// FLOP (16 FLOP per weight byte at B = 32), below the card's f32 ridge
// (67 TFLOP/s over 3.35 TB/s = 20); the forward reads each x column and
// tile of a group once; dW reads a member's dy and x columns once a
// column chunk (a member at most 64 units wide: once) and writes each dW
// tile once.
#include <climits>
#include <cuda_runtime.h>
#include <type_traits>

#include "block_diag_core.cuh"
#include "member_units.cuh"

namespace {

constexpr int MAX_BLK = 128;

using bdcore::bf16;

// T: float, or bf16 under the compute policy (dWB rounded once)
template <typename T>
struct DwArgs {
  const T* dy;
  const T* x;
  T* dwb;
  int B, out_w, in_w, blk;
};

// dW of one unit (in0, nc, out0, no, q, ld) on NT threads (lane l) over
// the stage at `s`: per chunk of ≤ S::OCH output units × ≤ S::CWM input
// units, a thread's 4 × 4 tile of it (output units r0.., input units j0..)
// summed over the batch 32 rows at a time
template <int V>
struct DwUnit {
  template <int NT, class S, typename T>
  __device__ static void run(const int* u, const DwArgs<T>& a, float* s,
                             int l) {
    using namespace munits;
    const int in0 = u[0], nc = u[1], out0 = u[2], no = u[3], q = u[4],
              ld = u[5];
    const int blk = a.blk;
    const int ncols = nc * blk, nouts = no * blk;
    const size_t xcol = (size_t)in0 * blk, ycol = (size_t)out0 * blk;
    float* xs = s + S::X;
    float* dys = s + S::DY;
    for (int u0 = 0; u0 < nouts; u0 += S::OCH) {
      const int oc = min(S::OCH, nouts - u0);
      for (int cc0 = 0; cc0 < ncols; cc0 += S::CWM) {
        const int cw = min(S::CWM, ncols - cc0);
        const int txn = (cw + 3) >> 2;  // column groups of 4
        const int j0 = l % txn * 4, r0 = l / txn * 4;
        float tot[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) tot[i][j] = 0.f;
        for (int b0 = 0; b0 < a.B; b0 += S::BCH) {
          const int bc = min(S::BCH, a.B - b0);
          team_sync<NT>();  // the previous chunk's readers are done
          stage_rows<NT, V>(xs, S::CWM,
                            a.x + (size_t)b0 * a.in_w + xcol + cc0, a.in_w,
                            bc, cw, l);
          stage_rows<NT, V>(dys, S::OCH,
                            a.dy + (size_t)b0 * a.out_w + ycol + u0,
                            a.out_w, bc, oc, l);
          team_sync<NT>();
          if (r0 < oc) {  // this chunk's sum, from 0, then into the total
            float acc[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
            for (int k = 0; k < bc; ++k)
              fma4x4(acc, lds4(dys + k * S::OCH + r0),
                     lds4(xs + k * S::CWM + j0));
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) tot[i][j] += acc[i][j];
          }
        }
        if (r0 >= oc) continue;
        // output unit u0 + r0 + i: row tile rt, unit au of it (stepped)
        int rt = (u0 + r0) / blk, au = (u0 + r0) - rt * blk;
        const int ja = cc0 + j0, ct = ja / blk, jc = ja - ct * blk;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (r0 + i >= oc) break;
          const size_t row = (size_t)q + (size_t)rt * ld;
          if constexpr (std::is_same<T, bf16>::value) {  // rounded once
            if constexpr (V == 4) {
              bf16x::store4<true>(a.dwb + ((row + ct) * blk + au) * blk + jc,
                                  tot[i][0], tot[i][1], tot[i][2],
                                  tot[i][3]);
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if (j0 + j >= cw) break;
                const int jb = ja + j;
                bf16x::store1<true>(
                    a.dwb + ((row + jb / blk) * blk + au) * blk + jb % blk,
                    tot[i][j]);
              }
            }
          } else if constexpr (V == 4) {  // 4 columns of one tile (blk % 4 == 0)
            __stcs(reinterpret_cast<float4*>(
                       a.dwb + ((row + ct) * blk + au) * blk + jc),
                   make_float4(tot[i][0], tot[i][1], tot[i][2], tot[i][3]));
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (j0 + j >= cw) break;
              const int jb = ja + j;
              __stcs(a.dwb + ((row + jb / blk) * blk + au) * blk + jb % blk,
                     tot[i][j]);
            }
          }
          if (++au == blk) au = 0, ++rt;
        }
      }
    }
  }
};

constexpr int DW_SMEM =
    munits::TeamStage::DW_FLOATS > munits::WARPS * munits::WarpStage::DW_FLOATS
        ? munits::TeamStage::DW_FLOATS
        : munits::WARPS * munits::WarpStage::DW_FLOATS;

template <int V>
__global__ void __launch_bounds__(munits::THREADS)
block_diag_dw_member_kernel(DwArgs<float> a, const int* __restrict__ units,
                            const int* __restrict__ job_ptr) {
  __shared__ __align__(16) float smem[DW_SMEM];
  munits::run_job<DwUnit<V>>(a, units, job_ptr, smem,
                             munits::WarpStage::DW_FLOATS);
}

template <int V>
__global__ void __launch_bounds__(munits::THREADS)
block_diag_dw_bf16_member_kernel(DwArgs<bf16> a,
                                 const int* __restrict__ units,
                                 const int* __restrict__ job_ptr) {
  __shared__ __align__(16) float smem[DW_SMEM];
  munits::run_job<DwUnit<V>>(a, units, job_ptr, smem,
                             munits::WarpStage::DW_FLOATS);
}

// the forward's epilogue: u as it is, from the lane's registers, 16-byte
// evict-first stores where the vec4 instance runs; with BF (the bf16
// compute policy) to a.yh, each value rounded once to bf16, 4 values an
// 8-byte store
template <bool BF = false>
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
      if constexpr (BF) {
        bf16* yh = a.yh + (size_t)(b0 + b) * a.out_w + col0;
#pragma unroll
        for (int c = 0; c < bdcore::CG; c += (V == 4 ? 4 : 1)) {
          if (c >= ncol) break;
          if constexpr (V == 4)
            bf16x::store4<true>(yh + c, acc[i][c], acc[i][c + 1],
                                acc[i][c + 2], acc[i][c + 3]);
          else
            bf16x::store1<true>(yh + c, acc[i][c]);
        }
        continue;
      }
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
  bdcore::run_groups<V, StoreU<>>(a);
}

template <int V>
__global__ void __launch_bounds__(bdcore::THREADS, 3)
block_diag_bf16_group_kernel(bdcore::Args a) {
  bdcore::run_groups<V, StoreU<true>, bdcore::BF16W>(a);
}

bool dw_args_bad(int B, int n_out_tiles, int n_in_tiles, int blk,
                 int n_jobs) {
  return blk <= 0 || blk > MAX_BLK || B < 0 || n_jobs < 0 ||
         (long long)n_in_tiles * blk > INT_MAX ||
         (long long)n_out_tiles * blk > INT_MAX;
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

// dy (B, n_out_tiles·blk), x (B, n_in_tiles·blk), the units (n_units, 8)
// and job_ptr (n_jobs + 1,) int32 of block_diag.py::dw_units → dWB
// (n_param, blk, blk), every tile of which some unit owns.
extern "C" int block_diag_dw_f32(const float* dy, const float* x,
                                 const int* units, const int* job_ptr,
                                 float* dwb, int B, int n_out_tiles,
                                 int n_in_tiles, int blk, int n_jobs,
                                 void* stream) {
  if (dw_args_bad(B, n_out_tiles, n_in_tiles, blk, n_jobs))
    return (int)cudaErrorInvalidValue;
  if (n_jobs == 0) return 0;
  const DwArgs<float> a{dy, x, dwb, B, n_out_tiles * blk, n_in_tiles * blk,
                        blk};
  const bool v4 = blk % 4 == 0 && munits::aligned16(dy) &&
                  munits::aligned16(x) && munits::aligned16(dwb);
  auto* kernel =
      v4 ? block_diag_dw_member_kernel<4> : block_diag_dw_member_kernel<1>;
  kernel<<<(unsigned)n_jobs, munits::THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(a, units, job_ptr);
  return (int)cudaGetLastError();
}

// The bf16 compute policy: x (B, n_in_tiles·blk) and wb (n_tiles, blk,
// blk) bf16, the CSR steps and their group table as for the f32 entry → y
// (B, n_rows·blk) bf16, each value rounded once from its f32 sum.
extern "C" int block_diag_fwd_bf16(const bf16* x, const bf16* wb,
                                   const int* s_in, const int* s_w,
                                   const int* groups, bf16* y, int B,
                                   int n_in_tiles, int n_rows, int blk,
                                   int n_groups, void* stream) {
  if (n_rows <= 0) return 0;
  bdcore::Args a{nullptr, nullptr, s_in,    s_w,        groups,
                 nullptr, nullptr, nullptr, nullptr,    nullptr,
                 B,       n_in_tiles, n_rows, blk,      n_groups};
  a.xh = x;
  a.wh = wb;
  a.yh = y;
  return bdcore::launch_groups(
      reinterpret_cast<const void*>(block_diag_bf16_group_kernel<4>),
      reinterpret_cast<const void*>(block_diag_bf16_group_kernel<1>), a,
      stream);
}

// The bf16 compute policy: dy (B, n_out_tiles·blk) and x (B,
// n_in_tiles·blk) bf16, the units and job_ptr as for the f32 entry → dWB
// (n_param, blk, blk) bf16, each element rounded once from its f32 sum
// over the whole batch.
extern "C" int block_diag_dw_bf16(const bf16* dy, const bf16* x,
                                  const int* units, const int* job_ptr,
                                  bf16* dwb, int B, int n_out_tiles,
                                  int n_in_tiles, int blk, int n_jobs,
                                  void* stream) {
  if (dw_args_bad(B, n_out_tiles, n_in_tiles, blk, n_jobs))
    return (int)cudaErrorInvalidValue;
  if (n_jobs == 0) return 0;
  const DwArgs<bf16> a{dy, x, dwb, B, n_out_tiles * blk, n_in_tiles * blk,
                       blk};
  using bf16x::aligned8;
  const bool v4 =
      blk % 4 == 0 && aligned8(dy) && aligned8(x) && aligned8(dwb);
  auto* kernel = v4 ? block_diag_dw_bf16_member_kernel<4>
                    : block_diag_dw_bf16_member_kernel<1>;
  kernel<<<(unsigned)n_jobs, munits::THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(a, units, job_ptr);
  return (int)cudaGetLastError();
}
