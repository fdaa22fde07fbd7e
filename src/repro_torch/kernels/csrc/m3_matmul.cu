// Segment-blocked matmul — the paper's M3 (Modified Matrix Multiplication)
// — and its two gradients:
//   forward:  y[b, m, o] = Σ_{j in member m} h[b, j] · w2[o, j]
//   dh:       dh[b, j]   = Σ_o dy[b, seg(j), o] · w2[o, j]
//   dW:       dw2[o, j]  = Σ_b h[b, j] · dy[b, seg(j), o]
//
// Replaces the TPU kernels repro/kernels/m3_matmul.py::m3_matmul_fwd
// (m3_fwd_f32 here), ::m3_matmul_dh (m3_dh_f32) and ::m3_matmul_dw
// (m3_dw_f32), the three pallas_calls of repro/kernels/ops.py::m3_matmul's
// custom VJP.  h (B, H), w2 (O, H), dy (B, P, O) f32 row-major; members own
// contiguous runs of hidden blocks of `block` units (1 ≤ block ≤ 128), given
// as CSR row pointers member_ptr (P + 1,) int32 over blocks for the forward
// and as per-block member ids seg (H / block,) int32 for the gradients.  Any
// class count O: accumulators live in registers for O ≤ OT, with OT = 4 or
// 16 picked at launch; beyond 16 the forward and dW walk the classes in
// chunks of 16 and dh re-reads the weights per row.
//
// The TPU forward walks a sequential grid and opens a VMEM accumulator when
// the segment id changes, flushing it on the member's last tile.  A GPU
// grid has no order, so here one warp owns one (batch tile, member) pair:
// it walks the member's column range [member_ptr[m]·block,
// member_ptr[m+1]·block), its lanes split into groups of L (the smallest
// power of two covering the member's 16-byte vectors, at most 32), one
// group per batch row, and a butterfly of shuffles inside each group
// finishes the dot products in a fixed order before one lane stores.  No
// atomics; y is written once.  A member that owns no block gets y = 0 (the
// JAX kernel never visits its output block and leaves it unwritten).
//
// dh is a pure store stream: it writes (B, H) and reads only w2 and a small
// dy.  A persistent grid, sized by the SM count and the CTAs that fit one,
// walks tasks of one column chunk (256·VEC columns) by one block of up to 8
// batch rows.  Before any store a task stages dy[b, seg(k), :] for its rows
// and hidden blocks k in shared memory (one sweep, one barrier) and holds
// its columns' weights in registers (VEC = 4, 16-byte accesses, when block,
// H and the pointers allow; else a scalar instance); the store loop has no
// global load, keeps its rows' stores in flight and writes evict-first
// (st.global.cs), so the stream does not push the operands out of L2.
// Eight-row tasks keep the last wave of a grid-stride loop short.  Beyond
// 16 classes the weights and dy come from L1/L2 per row.
//
// The TPU dW carries each tile's sum across the batch-tile grid axis.  Here
// one thread owns VEC columns j and loops b = 0..B−1 in order, so the sum
// has one fixed order and no float atomics: dW is bitwise reproducible, as
// is dh (one thread per output, one order over the classes).
//
// What bounds them: bytes.  At the paper's full width (B = 32, H =
// 1,280,000, P = 10,000, O = 2) each kernel moves h or dh (164 MB), w2 or
// dw2 (10 MB) and y or dy (2.6 MB), about 0.053 ms at 3.35 TB/s, for 8·B·H
// FLOP (0.005 ms at 67 TFLOP/s).  Left for later: w2 is re-read from L1
// per batch row in the forward.
#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BT = 16;     // batch rows per warp task (forward)
constexpr int DH_ROWS = 8;       // batch rows of a dh task: stores in flight
constexpr int DH_STAGE = 4352;   // staged dy floats: ≥ 16 classes × 257 blocks

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

template <int VEC>
__device__ __forceinline__ void store(float* __restrict__ p,
                                      const float (&v)[VEC]) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    p[0] = v[0];
}

template <int VEC, int OT>
__global__ void __launch_bounds__(THREADS)
m3_fwd_kernel(const float* __restrict__ h, const float* __restrict__ w2,
              const int* __restrict__ member_ptr, float* __restrict__ y,
              int B, long long H, int O, int P, int block, int n_btiles) {
  const int lane = threadIdx.x & 31;
  const long long task = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (task >= (long long)P * n_btiles) return;  // uniform across the warp
  const int m = (int)(task / n_btiles);
  const int b0 = (int)(task % n_btiles) * BT;
  const long long j0 = (long long)member_ptr[m] * block;
  const int nv = (int)(((long long)member_ptr[m + 1] * block - j0) / VEC);
  int L = 1;  // lanes per batch row
  while (L < 32 && L < nv) L <<= 1;
  const int R = 32 / L;  // batch rows per pass of the warp
  const int sub = lane & (L - 1);
  const int n_rows = BT > R ? BT : R;  // BT % R == 0 whenever R < BT
  for (int o0 = 0; o0 < O; o0 += OT) {
    const int oc = min(OT, O - o0);
    // every lane makes the same number of passes (the shuffles need all 32)
#pragma unroll 2
    for (int r = lane / L; r < n_rows; r += R) {
      const int b = b0 + r;
      const bool live = r < BT && b < B;
      float acc[OT];
#pragma unroll
      for (int o = 0; o < OT; ++o) acc[o] = 0.f;
      if (live) {
        const float* hr = h + (size_t)b * H + j0;
        for (int v = sub; v < nv; v += L) {
          float hv[VEC];
          load<VEC>(hr + (size_t)v * VEC, hv);
#pragma unroll
          for (int o = 0; o < OT; ++o) {
            if (o < oc) {
              float wv[VEC];
              load<VEC>(w2 + (size_t)(o0 + o) * H + j0 + (size_t)v * VEC, wv);
#pragma unroll
              for (int e = 0; e < VEC; ++e) acc[o] = fmaf(hv[e], wv[e], acc[o]);
            }
          }
        }
      }
#pragma unroll
      for (int o = 0; o < OT; ++o) {
        if (o < oc) {
          for (int off = L >> 1; off > 0; off >>= 1)
            acc[o] += __shfl_xor_sync(0xffffffffu, acc[o], off);
        }
      }
      if (live && sub == 0) {
        float* yr = y + ((size_t)b * P + m) * O + o0;
#pragma unroll
        for (int o = 0; o < OT; ++o)
          if (o < oc) yr[o] = acc[o];
      }
    }
  }
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
// L1/L2 per row.
template <int VEC, int OT>
__global__ void __launch_bounds__(THREADS)
m3_dh_kernel(const float* __restrict__ dy, const float* __restrict__ w2,
             const int* __restrict__ seg, float* __restrict__ dh, int B,
             long long H, int O, int P, int block, int rows,
             long long n_tasks, int n_rblocks) {
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
        const float* d = dy + ((size_t)(b0 + r) * P + s) * O;
        float acc[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
        for (int o = 0; o < O; ++o) {
          const float gv = __ldg(d + o);
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
        dys[i] = __ldg(dy + ((size_t)(b0 + r) * P + __ldg(seg + k_lo + k)) *
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
m3_dw_kernel(const float* __restrict__ h, const float* __restrict__ dy,
             const int* __restrict__ seg, float* __restrict__ dw, int B,
             long long H, int O, int P, int block) {
  const long long c0 = ((long long)blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (c0 >= H) return;
  const int s = seg[c0 / block];  // VEC = 4 only when block % 4 == 0
  for (int o0 = 0; o0 < O; o0 += OT) {
    const int oc = min(OT, O - o0);
    float acc[OT][VEC];
#pragma unroll
    for (int o = 0; o < OT; ++o)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[o][e] = 0.f;
#pragma unroll 4
    for (int b = 0; b < B; ++b) {
      float hv[VEC];
      load<VEC>(h + (size_t)b * H + c0, hv);
      const float* d = dy + ((size_t)b * P + s) * O + o0;
#pragma unroll
      for (int o = 0; o < OT; ++o) {
        if (o < oc) {
          const float g = __ldg(d + o);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[o][e] = fmaf(hv[e], g, acc[o][e]);
        }
      }
    }
#pragma unroll
    for (int o = 0; o < OT; ++o)
      if (o < oc) store<VEC>(dw + (size_t)(o0 + o) * H + c0, acc[o]);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool bad_args(int B, long long H, int O, int P, int block) {
  return B < 0 || H < 0 || O <= 0 || P <= 0 || block < 1 || block > 128 ||
         H % block;
}

// 16-byte accesses need every member edge, row and pointer 16-byte aligned
bool vec4(long long H, int block, const void* a, const void* b) {
  return block % 4 == 0 && H % 4 == 0 && aligned16(a) && aligned16(b);
}

template <int VEC, int OT>
void fwd(const float* h, const float* w2, const int* member_ptr, float* y,
         int B, long long H, int O, int P, int block, int n_btiles,
         unsigned grid, cudaStream_t s) {
  m3_fwd_kernel<VEC, OT><<<grid, THREADS, 0, s>>>(h, w2, member_ptr, y, B, H,
                                                  O, P, block, n_btiles);
}

template <int VEC, int OT>
int dh_launch(const float* dy, const float* w2, const int* seg, float* dh,
              int B, long long H, int O, int P, int block, cudaStream_t s) {
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
                         &per_sm, m3_dh_kernel<VEC, OT>, THREADS, 0) !=
                         cudaSuccess)
    return (int)cudaGetLastError();
  const long long grid =
      std::min<long long>(n_tasks, (long long)sm_count() * std::max(per_sm, 1));
  m3_dh_kernel<VEC, OT><<<(unsigned)grid, THREADS, 0, s>>>(
      dy, w2, seg, dh, B, H, O, P, block, rows, n_tasks, (int)n_rblocks);
  return (int)cudaGetLastError();
}

template <int VEC, int OT>
void dw_launch(const float* h, const float* dy, const int* seg, float* dw,
               int B, long long H, int O, int P, int block, unsigned grid,
               cudaStream_t s) {
  m3_dw_kernel<VEC, OT><<<grid, THREADS, 0, s>>>(h, dy, seg, dw, B, H, O, P,
                                                 block);
}

// the column grid of dW: one thread per VEC columns
bool col_grid(long long H, int vec, unsigned* gx) {
  const long long n = (H / vec + THREADS - 1) / THREADS;
  if (n > 0x7fffffffLL) return false;
  *gx = (unsigned)n;
  return true;
}

}  // namespace

// h (B, H), w2 (O, H), member_ptr (P + 1,) → y (B, P, O).
extern "C" int m3_fwd_f32(const float* h, const float* w2,
                          const int* member_ptr, float* y, int B, long long H,
                          int O, int P, int block, void* stream) {
  if (bad_args(B, H, O, P, block)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const long long n_btiles = (B + BT - 1) / BT;
  const long long n_grid = (n_btiles * P + WARPS - 1) / WARPS;
  if (n_grid > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v4 = vec4(H, block, h, w2);
  auto* fn = v4 ? (O <= 4 ? fwd<4, 4> : fwd<4, 16>)
                : (O <= 4 ? fwd<1, 4> : fwd<1, 16>);
  fn(h, w2, member_ptr, y, B, H, O, P, block, (int)n_btiles,
     (unsigned)n_grid, s);
  return (int)cudaGetLastError();
}

// dy (B, P, O), w2 (O, H), seg (H / block,) → dh (B, H).
extern "C" int m3_dh_f32(const float* dy, const float* w2, const int* seg,
                         float* dh, int B, long long H, int O, int P,
                         int block, void* stream) {
  if (bad_args(B, H, O, P, block)) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  const bool v4 = vec4(H, block, w2, dh);
  auto* fn = v4 ? (O <= 4 ? dh_launch<4, 4>
                          : O <= 16 ? dh_launch<4, 16> : dh_launch<4, 0>)
                : (O <= 4 ? dh_launch<1, 4>
                          : O <= 16 ? dh_launch<1, 16> : dh_launch<1, 0>);
  return fn(dy, w2, seg, dh, B, H, O, P, block,
            static_cast<cudaStream_t>(stream));
}

// h (B, H), dy (B, P, O), seg (H / block,) → dw2 (O, H).
extern "C" int m3_dw_f32(const float* h, const float* dy, const int* seg,
                         float* dw, int B, long long H, int O, int P,
                         int block, void* stream) {
  if (bad_args(B, H, O, P, block)) return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  const bool v4 = vec4(H, block, h, dw);
  unsigned gx;
  if (!col_grid(H, v4 ? 4 : 1, &gx)) return (int)cudaErrorInvalidValue;
  auto* fn = v4 ? (O <= 4 ? dw_launch<4, 4> : dw_launch<4, 16>)
                : (O <= 4 ? dw_launch<1, 4> : dw_launch<1, 16>);
  fn(h, dy, seg, dw, B, H, O, P, block, gx,
     static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
