// Segment-blocked matmul — the paper's M3 (Modified Matrix Multiplication)
// — and its two gradients:
//   forward:  y[b, m, o] = Σ_{j in member m} h[b, j] · w2[o, j]
//   dh:       dh[b, j]   = Σ_o dy[b, seg(j), o] · w2[o, j]
//   dW:       dw2[o, j]  = Σ_b h[b, j] · dy[b, seg(j), o]
//
// Replaces the TPU kernels repro/kernels/m3_matmul.py::m3_matmul_fwd
// (m3_fwd_f32 here), ::m3_matmul_dh (m3_dh_f32) and ::m3_matmul_dw
// (m3_dw_f32), the three pallas_calls of repro/kernels/ops.py::m3_matmul's
// custom VJP.  h (B, H), w2 (O, H), dy (B, P, O) f32 row-major, H ≤
// INT_MAX; members own contiguous runs of hidden blocks of `block` units
// (1 ≤ block ≤ 128), given as CSR row pointers member_ptr (P + 1,) int32
// over blocks for the forward and as per-block member ids seg (H / block,)
// int32 for the gradients.  Any class count O.
//
// The forward is the output heads' logits without a bias, and the dW is
// the loss head's dW without d_per, so both run the heads' streaming
// cores, under kernel names of their own:
//   * forward (m3_fwd_stream_kernel_*): head_stream.cuh's stream_members,
//     as infer_head.cu's f32 kernel runs it — each thread holds VW units'
//     w2 in registers once a tile, streams h with 16 / OT rows in flight
//     (16-byte loads in the vec4 instance, 4-byte ones in the scalar one),
//     256-thread CTAs in lanes of rows, member m owned by the CTA whose
//     tile holds its first unit, partial dot products added in unit order
//     in shared memory — with an epilogue that stores z as it is: one
//     owner per (row, member) writes y once, and a member that owns no
//     block gets y = 0 (the JAX kernel never visits its output block and
//     leaves it unwritten).  Its sums are infer_head's, so y is bitwise
//     infer_head's logits with a zero bias where both take one instance.
//   * dW (m3_dw_stream_kernel_*): head_bwd.cuh's stream_bwd without dh
//     and without d_per — a CTA takes a tile of units, stages dy of the
//     blocks it touches in shared memory, streams h and keeps dW in
//     registers, the lanes' sums added in lane order.  At one lane (block
//     128 at the paper's width: 1,250 tiles of 1,024 units) each column's
//     sum runs b = 0 … B − 1 with fmaf, the chain of the kernel it
//     replaced, whose bits it keeps; at the depth-3 head (H 32,000) eight
//     lanes over 128-unit tiles give 250 CTAs.  Its dW is bitwise
//     loss_head's with d_per = 1 where both take one instance.
// Beyond 16 classes both walk them 16 at a time inside the launch (the
// head cores hold at most head::MAX_O in registers): the weight or dy
// pointer offset by o0, y and dW written at stride O.  Only the 16-class
// instances carry that loop (around the core it cost the forward's
// 2-class instance 17 registers).  Instances: vec4
// where block and H are multiples of 4 and the tensors walked 4 units at a
// time (h and w2; h and dW) are 16-byte aligned, else scalar (takes_vec4;
// kernel_path() in m3_matmul.py).
//
// dh is a pure store stream: it writes (B, H) and reads only w2 and a small
// dy.  A persistent grid, sized by the SM count and the CTAs that fit one,
// walks tasks of one column chunk (256·VEC columns) by one block of up to 8
// batch rows.  Before any store a task stages dy[b, seg(k), :] for its rows
// and hidden blocks k in shared memory (one sweep, one barrier) and holds
// its columns' weights in registers (VEC = 4, 16-byte accesses, where
// takes_vec4 of w2 and dh allows; else a scalar instance); the store loop
// has no global load, keeps its rows' stores in flight and writes
// evict-first (st.global.cs), so the stream does not push the operands out
// of L2.
// Eight-row tasks keep the last wave of a grid-stride loop short.  Beyond
// 16 classes the weights and dy come from L1/L2 per row.  One thread per
// output, one order over the classes.
//
// bf16 (the compute policy: h, w2 and dy bf16, as JAX's kernels take them
// under it; entries m3_fwd_bf16, m3_dh_bf16, m3_dw_bf16, kernels
// m3_fwd_bf16_stream_kernel_*, m3_dh_bf16_kernel, m3_dw_bf16_stream_kernel_*):
// the same three designs over bf16 operands, widened to f32 as they are
// loaded (8 bytes a thread's 4 units in the vec4 instances, which take the
// bf16 tensors on 8-byte boundaries), every product and sum in f32, and
// each output rounded once to bf16: the forward's logits in its epilogue
// (JAX's out dtype is h's, repro/kernels/m3_matmul.py:74, the heads'
// first bf16 store), dh in its store stream (:89, :109), dW after its
// whole-batch sum (:131-135, :156).  dy is widened as dh and dW stage it.
//
// Every sum has one fixed order and no float atomics: all three are
// bitwise reproducible.  What bounds them: bytes.  At the paper's full
// width (B = 32, H = 1,280,000, P = 10,000, O = 2) each kernel moves h or
// dh (164 MB), w2 or dw2 (10 MB) and y or dy (2.6 MB), about 0.053 ms at
// 3.35 TB/s, for 4·B·H FLOP (0.002 ms at 67 TFLOP/s); at the depth-3 head
// (H 32,000, P 3,000) 4.9 MB, 0.0015 ms.
#include <algorithm>
#include <climits>
#include <cuda_runtime.h>
#include <type_traits>

#include "head_bwd.cuh"
#include "head_stream.cuh"

namespace {

constexpr int THREADS = 256;     // dh's CTAs
constexpr int DH_ROWS = 8;       // batch rows of a dh task: stores in flight
constexpr int DH_STAGE = 4352;   // staged dy floats: ≥ 16 classes × 257 blocks

using head::bf16;

template <int VEC>
__device__ __forceinline__ void load(const float* __restrict__ p,
                                     float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

// bf16: VEC values widened, 4 from one 8-byte load
template <int VEC>
__device__ __forceinline__ void load(const bf16* __restrict__ p,
                                     float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = bf16x::ldg4(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __bfloat162float(__ldg(p));
  }
}

__device__ __forceinline__ float ldg1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg1(const bf16* p) {
  return __bfloat162float(__ldg(p));
}

// a store that is not read again here: evict-first (st.global.cs)
template <int VEC>
__device__ __forceinline__ void store_stream(float* __restrict__ p,
                                             const float (&v)[VEC]) {
  if constexpr (VEC == 4)
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  else
    __stcs(p, v[0]);
}

// bf16: each value rounded once, 4 in one 8-byte store
template <int VEC>
__device__ __forceinline__ void store_stream(bf16* __restrict__ p,
                                             const float (&v)[VEC]) {
  if constexpr (VEC == 4)
    bf16x::store4<true>(p, v[0], v[1], v[2], v[3]);
  else
    bf16x::store1<true>(p, v[0]);
}

// SMs of the current device (cached per device)
int sm_count() {
  static int count[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (count[dev] == 0)
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev] > 0 ? count[dev] : 1;
}

// dh: a persistent grid of THREADS-thread CTAs walks tasks of one
// column chunk (THREADS·VEC columns) by one row block (up to DH_ROWS
// batch rows) in a grid-stride loop.  Before any store a task stages the
// dy[b, seg(k), :] of its blocks k and rows in shared memory (one load
// sweep, one barrier) and holds its columns' weights in registers; the
// store loop then reads only shared memory and keeps its rows' stores in
// flight, with the evict-first hint.  O > 16: the weights and dy come from
// L1/L2 per row.  T: float, or bf16 under the compute policy (dy and w2
// widened, dh rounded once).
template <int VEC, int OT, typename T>
__device__ __forceinline__ void dh_body(
    const T* __restrict__ dy, const T* __restrict__ w2,
    const int* __restrict__ seg, T* __restrict__ dh, int B, long long H,
    int O, int P, int block, int rows, long long n_tasks, int n_rblocks) {
  __shared__ float dys[DH_STAGE];  // [row][block of the chunk][class]
  constexpr long long CC = (long long)THREADS * VEC;
  for (long long task = blockIdx.x; task < n_tasks; task += gridDim.x) {
    const long long c_lo = task / n_rblocks * CC;
    const int b0 = (int)(task % n_rblocks) * rows;
    const int nr = min(rows, B - b0);
    const long long c_hi = c_lo + CC < H ? c_lo + CC : H;
    const long long k_lo = c_lo / block;
    const long long c0 = c_lo + (long long)threadIdx.x * VEC;
    const bool live = c0 < c_hi;  // VEC = 4 only when block % 4 == 0
    if constexpr (OT == 0) {
      if (!live) continue;
      const int s = seg[c0 / block];
      for (int r = 0; r < nr; ++r) {
        const T* d = dy + ((size_t)(b0 + r) * P + s) * O;
        float acc[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
        for (int o = 0; o < O; ++o) {
          const float gv = ldg1(d + o);
          float wv[VEC];
          load<VEC>(w2 + (size_t)o * H + c0, wv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = fmaf(gv, wv[e], acc[e]);
        }
        store_stream<VEC>(dh + (size_t)(b0 + r) * H + c0, acc);
      }
    } else {
      const int per_row = (int)((c_hi - 1) / block - k_lo + 1) * O;
      __syncthreads();  // the previous task's readers are done
      for (int i = threadIdx.x; i < nr * per_row; i += THREADS) {
        const int r = i / per_row, rem = i - r * per_row;
        const int k = rem / O, o = rem - k * O;
        dys[i] = ldg1(dy + ((size_t)(b0 + r) * P + __ldg(seg + k_lo + k)) *
                               O + o);
      }
      float w[OT][VEC];
#pragma unroll
      for (int o = 0; o < OT; ++o) {
        if (live && o < O) {
          load<VEC>(w2 + (size_t)o * H + c0, w[o]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) w[o][e] = 0.f;
        }
      }
      __syncthreads();
      if (!live) continue;
      const float* d = dys + (c0 / block - k_lo) * O;
#pragma unroll
      for (int r = 0; r < DH_ROWS; ++r) {
        if (r < nr) {
          float acc[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
          for (int o = 0; o < OT; ++o) {
            if (o < O) {
              const float gv = d[r * per_row + o];
#pragma unroll
              for (int e = 0; e < VEC; ++e) acc[e] = fmaf(gv, w[o][e], acc[e]);
            }
          }
          store_stream<VEC>(dh + (size_t)(b0 + r) * H + c0, acc);
        }
      }
    }
  }
}

template <int VEC, int OT>
__global__ void __launch_bounds__(THREADS)
m3_dh_kernel(const float* __restrict__ dy, const float* __restrict__ w2,
             const int* __restrict__ seg, float* __restrict__ dh, int B,
             long long H, int O, int P, int block, int rows,
             long long n_tasks, int n_rblocks) {
  dh_body<VEC, OT>(dy, w2, seg, dh, B, H, O, P, block, rows, n_tasks,
                   n_rblocks);
}

template <int VEC, int OT>
__global__ void __launch_bounds__(THREADS)
m3_dh_bf16_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ w2,
                  const int* __restrict__ seg, bf16* __restrict__ dh, int B,
                  long long H, int O, int P, int block, int rows,
                  long long n_tasks, int n_rblocks) {
  dh_body<VEC, OT>(dy, w2, seg, dh, B, H, O, P, block, rows, n_tasks,
                   n_rblocks);
}

// the dh kernel of an operand type
template <int VEC, int OT, typename T>
constexpr auto dh_kernel() {
  if constexpr (std::is_same<T, bf16>::value)
    return m3_dh_bf16_kernel<VEC, OT>;
  else
    return m3_dh_kernel<VEC, OT>;
}

bool bad_args(int B, long long H, int O, int P, int block) {
  return B < 0 || H < 0 || O <= 0 || P <= 0 || block < 1 || block > 128 ||
         H % block;
}

template <int VEC, int OT, typename T>
int dh_launch(const T* dy, const T* w2, const int* seg, T* dh, int B,
              long long H, int O, int P, int block, cudaStream_t s) {
  auto* kernel = dh_kernel<VEC, OT, T>();
  // blocks one chunk can touch, and the rows whose dy fits the stage
  const long long cc = (long long)THREADS * VEC;
  const long long nb = (cc + block - 2) / block + 1;
  const int rows = OT == 0 ? DH_ROWS
                           : (int)std::min<long long>(DH_ROWS,
                                                      DH_STAGE / (nb * O));
  const long long n_rblocks = (B + rows - 1) / rows;
  const long long n_tasks = (H + cc - 1) / cc * n_rblocks;
  static int per_sm = 0;  // resident CTAs an SM, the same on every H100
  if (per_sm == 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &per_sm, kernel, THREADS, 0) != cudaSuccess)
    return (int)cudaGetLastError();
  const long long grid =
      std::min<long long>(n_tasks, (long long)sm_count() * std::max(per_sm, 1));
  kernel<<<(unsigned)grid, THREADS, 0, s>>>(
      dy, w2, seg, dh, B, H, O, P, block, rows, n_tasks, (int)n_rblocks);
  return (int)cudaGetLastError();
}

// The forward's epilogue: z as it is, classes o0 … o0 + oc − 1 of y (T
// bf16: each logit rounded once to bf16)
template <typename T>
struct M3Store {
  T* __restrict__ y;
  int P, O, o0, oc;
  template <int N>
  __device__ __forceinline__ void operator()(float (&acc)[N], int b,
                                             int m) const {
    T* yr = y + ((size_t)b * P + m) * O + o0;
#pragma unroll
    for (int o = 0; o < N; ++o) {
      if (o < oc) {
        if constexpr (std::is_same<T, bf16>::value)
          yr[o] = __float2bfloat16_rn(acc[o]);
        else
          yr[o] = acc[o];
      }
    }
  }
};

// The forward's and dW's instances, one name each, so that a profiler
// trace tells them from the heads' kernels on the same cores.
#define M3_FWD_PARAMS                                                       \
  const float *__restrict__ h, const float *__restrict__ w2,                \
      const int *__restrict__ member_ptr, float *__restrict__ y, int B,     \
      int H, int O, int P, int block, int n_tiles, int lanes, int mb_cap
#define M3_FWD_ARGS \
  h, w2, member_ptr, y, B, H, O, P, block, n_tiles, lanes, mb_cap
#define M3_DW_PARAMS                                                        \
  const float *__restrict__ h, const float *__restrict__ dy,                \
      const int *__restrict__ seg, float *__restrict__ dw, int B, int H,    \
      int O, int P, int block, int lanes, int rows
#define M3_DW_ARGS h, dy, seg, dw, B, H, O, P, block, lanes, rows
#define M3_FWD_BF16_PARAMS                                                  \
  const bf16 *__restrict__ h, const bf16 *__restrict__ w2,                  \
      const int *__restrict__ member_ptr, bf16 *__restrict__ y, int B,      \
      int H, int O, int P, int block, int n_tiles, int lanes, int mb_cap
#define M3_DW_BF16_PARAMS                                                   \
  const bf16 *__restrict__ h, const bf16 *__restrict__ dy,                  \
      const int *__restrict__ seg, bf16 *__restrict__ dw, int B, int H,     \
      int O, int P, int block, int lanes, int rows

// The classes in one pass where O ≤ OT < 16, else 16 at a time.  T: the
// operands' and outputs' type (f32, or bf16 under the compute policy)
template <int OT, int VW, typename T>
__device__ __forceinline__ void fwd_body(
    const T* __restrict__ h, const T* __restrict__ w2,
    const int* __restrict__ member_ptr, T* __restrict__ y, int B, int H,
    int O, int P, int block, int n_tiles, int lanes, int mb_cap) {
  using Weights = head::DenseWeights<T>;
  if constexpr (OT < head::MAX_O) {
    head::stream_members<OT, VW>(h, Weights{w2, H}, member_ptr, B, H, O, P,
                                 block, n_tiles, lanes, mb_cap,
                                 M3Store<T>{y, P, O, 0, O});
  } else {
    for (int o0 = 0; o0 < O; o0 += OT) {
      const int oc = min(OT, O - o0);
      head::stream_members<OT, VW>(
          h, Weights{w2 + (size_t)o0 * H, H}, member_ptr, B, H, oc, P, block,
          n_tiles, lanes, mb_cap, M3Store<T>{y, P, O, o0, oc});
    }
  }
}

template <int OT, int VW, typename T>
__device__ __forceinline__ void dw_body(
    const T* __restrict__ h, const T* __restrict__ dy,
    const int* __restrict__ seg, T* __restrict__ dw, int B, int H, int O,
    int P, int block, int lanes, int rows) {
  if constexpr (OT < head::MAX_O) {
    head::stream_bwd<OT, VW, false, T>(nullptr, dy, O, h, nullptr, seg,
                                       nullptr, dw, B, H, O, P, block, lanes,
                                       rows);
  } else {
    for (int o0 = 0; o0 < O; o0 += OT)
      head::stream_bwd<OT, VW, false, T>(
          nullptr, dy + o0, O, h, nullptr, seg, nullptr, dw + (size_t)o0 * H,
          B, H, min(OT, O - o0), P, block, lanes, rows);
  }
}

template <int OT>
__global__ void __launch_bounds__(head::MAX_THREADS)
m3_fwd_stream_kernel_vec4(M3_FWD_PARAMS) {
  fwd_body<OT, 4>(M3_FWD_ARGS);
}
template <int OT>
__global__ void __launch_bounds__(head::MAX_THREADS)
m3_fwd_stream_kernel_scalar(M3_FWD_PARAMS) {
  fwd_body<OT, 1>(M3_FWD_ARGS);
}
template <int OT>
__global__ void __launch_bounds__(head::MAX_THREADS)
m3_dw_stream_kernel_vec4(M3_DW_PARAMS) {
  dw_body<OT, 4>(M3_DW_ARGS);
}
template <int OT>
__global__ void __launch_bounds__(head::MAX_THREADS)
m3_dw_stream_kernel_scalar(M3_DW_PARAMS) {
  dw_body<OT, 1>(M3_DW_ARGS);
}
template <int OT>
__global__ void __launch_bounds__(head::MAX_THREADS)
m3_fwd_bf16_stream_kernel_vec4(M3_FWD_BF16_PARAMS) {
  fwd_body<OT, 4>(M3_FWD_ARGS);
}
template <int OT>
__global__ void __launch_bounds__(head::MAX_THREADS)
m3_fwd_bf16_stream_kernel_scalar(M3_FWD_BF16_PARAMS) {
  fwd_body<OT, 1>(M3_FWD_ARGS);
}
template <int OT>
__global__ void __launch_bounds__(head::MAX_THREADS)
m3_dw_bf16_stream_kernel_vec4(M3_DW_BF16_PARAMS) {
  dw_body<OT, 4>(M3_DW_ARGS);
}
template <int OT>
__global__ void __launch_bounds__(head::MAX_THREADS)
m3_dw_bf16_stream_kernel_scalar(M3_DW_BF16_PARAMS) {
  dw_body<OT, 1>(M3_DW_ARGS);
}

// the streaming kernels of an operand type, vec4 or scalar
template <int OT, typename T>
auto fwd_kernel(bool vec) {
  if constexpr (std::is_same<T, bf16>::value)
    return vec ? m3_fwd_bf16_stream_kernel_vec4<OT>
               : m3_fwd_bf16_stream_kernel_scalar<OT>;
  else
    return vec ? m3_fwd_stream_kernel_vec4<OT>
               : m3_fwd_stream_kernel_scalar<OT>;
}
template <int OT, typename T>
auto dw_kernel(bool vec) {
  if constexpr (std::is_same<T, bf16>::value)
    return vec ? m3_dw_bf16_stream_kernel_vec4<OT>
               : m3_dw_bf16_stream_kernel_scalar<OT>;
  else
    return vec ? m3_dw_stream_kernel_vec4<OT> : m3_dw_stream_kernel_scalar<OT>;
}

// the vec4 rule over the tensors a launch walks 4 units at a time (f32: 16
// bytes; bf16: 8)
inline bool takes_vec4_of(const float*, int block, long long H,
                          const void* const* ptrs, int n) {
  return head::takes_vec4(block, H, ptrs, n);
}
inline bool takes_vec4_of(const bf16*, int block, long long H,
                          const void* const* ptrs, int n) {
  return head::takes_vec4_bf16(block, H, ptrs, n);
}

template <int OT, typename T>
int fwd_launch(const T* h, const T* w2, const int* member_ptr, T* y, int B,
               int H, int O, int P, int block, cudaStream_t s) {
  const void* ptrs[] = {h, w2};
  head::FwdShape sh;
  size_t smem;
  if (!head::head_launch_shape<OT>(
          H, block, takes_vec4_of(h, block, H, ptrs, 2), sh, smem))
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)sh.n_tiles, lanes = sh.lanes, mb_cap = sh.mb_cap;
  auto* kernel = fwd_kernel<OT, T>(sh.vec);
  kernel<<<(unsigned)n_tiles, head::MAX_THREADS, smem, s>>>(M3_FWD_ARGS);
  return (int)cudaGetLastError();
}

template <int OT, typename T>
int dw_launch(const T* h, const T* dy, const int* seg, T* dw, int B, int H,
              int O, int P, int block, cudaStream_t s) {
  const void* ptrs[] = {h, dw};
  head::BwdShape sh;
  if (!head::bwd_shape<OT>(B, H, block, takes_vec4_of(h, block, H, ptrs, 2),
                           sh))
    return (int)cudaErrorInvalidValue;
  const int lanes = sh.lanes, rows = sh.rows;
  auto* kernel = dw_kernel<OT, T>(sh.vec);
  kernel<<<(unsigned)sh.n_tiles, head::MAX_THREADS, sh.smem, s>>>(M3_DW_ARGS);
  return (int)cudaGetLastError();
}

// the class tile of the two streaming kernels: O, or 16 at a time beyond
int classes_tile(int O) { return head::classes_tile(std::min(O, head::MAX_O)); }

// h (B, H), w2 (O, H), member_ptr (P + 1,) → y (B, P, O); T f32 or bf16.
template <typename T>
int m3_fwd(const T* h, const T* w2, const int* member_ptr, T* y, int B,
           long long H, int O, int P, int block, void* stream) {
  if (bad_args(B, H, O, P, block) || H > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int h32 = (int)H;
  switch (classes_tile(O)) {
    case 2: return fwd_launch<2>(h, w2, member_ptr, y, B, h32, O, P, block, s);
    case 4: return fwd_launch<4>(h, w2, member_ptr, y, B, h32, O, P, block, s);
    case 8: return fwd_launch<8>(h, w2, member_ptr, y, B, h32, O, P, block, s);
    default:
      return fwd_launch<16>(h, w2, member_ptr, y, B, h32, O, P, block, s);
  }
}

// dy (B, P, O), w2 (O, H), seg (H / block,) → dh (B, H).
template <typename T>
int m3_dh(const T* dy, const T* w2, const int* seg, T* dh, int B,
          long long H, int O, int P, int block, void* stream) {
  if (bad_args(B, H, O, P, block)) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  const void* ptrs[] = {w2, dh};
  const bool v4 = takes_vec4_of(w2, block, H, ptrs, 2);
  auto* fn = v4 ? (O <= 4 ? dh_launch<4, 4, T>
                          : O <= 16 ? dh_launch<4, 16, T> : dh_launch<4, 0, T>)
                : (O <= 4 ? dh_launch<1, 4, T>
                          : O <= 16 ? dh_launch<1, 16, T> : dh_launch<1, 0, T>);
  return fn(dy, w2, seg, dh, B, H, O, P, block,
            static_cast<cudaStream_t>(stream));
}

// h (B, H), dy (B, P, O), seg (H / block,) → dw2 (O, H).
template <typename T>
int m3_dw(const T* h, const T* dy, const int* seg, T* dw, int B,
          long long H, int O, int P, int block, void* stream) {
  if (bad_args(B, H, O, P, block) || H > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int h32 = (int)H;
  switch (classes_tile(O)) {
    case 2: return dw_launch<2>(h, dy, seg, dw, B, h32, O, P, block, s);
    case 4: return dw_launch<4>(h, dy, seg, dw, B, h32, O, P, block, s);
    case 8: return dw_launch<8>(h, dy, seg, dw, B, h32, O, P, block, s);
    default: return dw_launch<16>(h, dy, seg, dw, B, h32, O, P, block, s);
  }
}

}  // namespace

extern "C" int m3_fwd_f32(const float* h, const float* w2,
                          const int* member_ptr, float* y, int B, long long H,
                          int O, int P, int block, void* stream) {
  return m3_fwd(h, w2, member_ptr, y, B, H, O, P, block, stream);
}

extern "C" int m3_dh_f32(const float* dy, const float* w2, const int* seg,
                         float* dh, int B, long long H, int O, int P,
                         int block, void* stream) {
  return m3_dh(dy, w2, seg, dh, B, H, O, P, block, stream);
}

extern "C" int m3_dw_f32(const float* h, const float* dy, const int* seg,
                         float* dw, int B, long long H, int O, int P,
                         int block, void* stream) {
  return m3_dw(h, dy, seg, dw, B, H, O, P, block, stream);
}

// The bf16 compute policy: the same entries over bf16 h, w2 and dy, each
// output (y, dh, dw2) bf16, rounded once from its f32 sum.
extern "C" int m3_fwd_bf16(const bf16* h, const bf16* w2,
                           const int* member_ptr, bf16* y, int B,
                           long long H, int O, int P, int block,
                           void* stream) {
  return m3_fwd(h, w2, member_ptr, y, B, H, O, P, block, stream);
}

extern "C" int m3_dh_bf16(const bf16* dy, const bf16* w2, const int* seg,
                          bf16* dh, int B, long long H, int O, int P,
                          int block, void* stream) {
  return m3_dh(dy, w2, seg, dh, B, H, O, P, block, stream);
}

extern "C" int m3_dw_bf16(const bf16* h, const bf16* dy, const int* seg,
                          bf16* dw, int B, long long H, int O, int P,
                          int block, void* stream) {
  return m3_dw(h, dy, seg, dw, B, H, O, P, block, stream);
}
