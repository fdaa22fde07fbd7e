// The streaming core of the output head's forward, shared by the serving
// head (infer_head.cu, the logits over f32 or int8 weights), the training
// loss head's forward (loss_head.cu, the logits fused with softmax
// cross-entropy) and the M3 forward (m3_matmul.cu, the logits as they are,
// the classes 16 at a time):
//
//   z[b, m, :] = Σ_{j in member m} h[b, j] · w2[:, j]
//
// h (B, H) f32, w2 (O, H), O ≤ 16, the members' hidden ranges in CSR form
// over blocks of `block` units.  What bounds it is bytes (h and w2 read
// once), so the design is about bytes in flight and latency:
//   * every thread owns VW consecutive hidden units (VW = 4: one 16-byte
//     load of h a row; VW = 1, the scalar instance of the same code, where
//     a block is not a multiple of 4, a row not a multiple of 4 units or a
//     tensor not aligned to 4 of its elements: kernel_path() in
//     infer_head.py holds the same rule, takes_vec4 here) and keeps its w2
//     columns in registers, loaded once a tile by the weight policy:
//       - F32Weights: w2 f32, VW floats a class in one load;
//       - I8Weights: w2 int8 with one f32 scale per block of units; VW
//         int8 a class in one load (4 bytes at VW = 4), dequantized in
//         registers as q · s with the scale of the block that holds them
//         (block % 4 == 0 at VW = 4, so a thread's units share one block).
//     Both hand stream_logits the same f32 weights for the same values
//     (q · s is exact-rounded either way), so the int8 kernel is bitwise
//     the f32 kernel on the dequantized weight at the same instance;
//       - BF16Weights (the bf16 compute policy, with bf16 h): w2 bf16, VW
//         values a class in one load (8 bytes at VW = 4), widened; h's VW
//         units come in one 8-byte load a row, and every product and sum
//         runs in f32 as over f32 operands;
//   * it streams h rows with R of them in flight (R · OT = 16 floats) and
//     issues the next R rows before it reduces these;
//   * a CTA is 256 threads in 1, 2, 4 or 8 lanes of rows over one tile of
//     units, the fewest lanes that still give the grid two CTAs an SM
//     (cta_lanes): at block 128 one lane over 1024 units, at the depth-3
//     head (H 32,000) eight over 128;
//   * member m belongs to the CTA whose tile holds its first unit, and the
//     last CTA also takes the members that start at or past its tile's end
//     (cta_members() in infer_head.py is the same rule); a CTA finds its
//     members with a k-ary search over member_ptr (first_members_from), so
//     no schedule is built on the host;
//   * a CTA walks its members' units a tile at a time (a member wider than
//     a tile spans several), writes each thread's partial logits to shared
//     memory, and one thread per (row, member) adds them in unit order: no
//     floating-point atomics, every sum in a fixed order.
// Each kernel runs its own epilogue on the finished z: stream_members (the
// member loop around stream_logits, infer_head.cu's and m3_matmul.cu's)
// hands it to an epilogue functor; loss_head.cu runs its own loop.  The
// backward role (dh and dW of the same heads) is head_bwd.cuh.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bf16.cuh"

namespace head {

using bf16x::bf16;

constexpr int MAX_O = 16;
constexpr int MAX_THREADS = 256;  // threads a CTA
constexpr int MAX_LANES = 8;      // row lanes: at least 32 unit slots
constexpr int FWD_MAX_MEMBERS = 64;  // members a forward CTA holds at once
constexpr size_t SMEM_LIMIT = 48 * 1024;  // without the opt-in attribute

// O rounded up to the register width the kernels are instantiated at
inline int classes_tile(int O) {
  return O <= 2 ? 2 : O <= 4 ? 4 : O <= 8 ? 8 : 16;
}

// rows of h in flight per thread
template <int OT>
__host__ __device__ constexpr int rows_in_flight() { return 16 / OT; }
// the forward's rows of logits held in shared memory at once: a multiple
// of its row group, R · lanes
template <int OT>
__host__ __device__ constexpr int fwd_rows_held(int lanes) {
  return 64 / OT > rows_in_flight<OT>() * lanes ? 64 / OT
                                                 : rows_in_flight<OT>() * lanes;
}

template <int VW>
__device__ __forceinline__ void load_units(float (&v)[VW],
                                           const float* __restrict__ p) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < VW; ++i) v[i] = p[i];
  }
}

template <int VW>
__device__ __forceinline__ void store_units(float* __restrict__ p,
                                            const float (&v)[VW]) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < VW; ++i) p[i] = v[i];
  }
}

// bf16: VW values widened from one 8-byte load (VW = 4), and stored each
// rounded to nearest even, 4 packed in one 8-byte store
template <int VW>
__device__ __forceinline__ void load_units(float (&v)[VW],
                                           const bf16* __restrict__ p) {
  if constexpr (VW == 4) {
    const float4 t = bf16x::load4(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < VW; ++i) v[i] = __bfloat162float(p[i]);
  }
}

template <int VW>
__device__ __forceinline__ void store_units(bf16* __restrict__ p,
                                            const float (&v)[VW]) {
  if constexpr (VW == 4) {
    bf16x::store4(p, v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < VW; ++i) bf16x::store1(p + i, v[i]);
  }
}

// rows b0, b0 + 1, ... b0 + R − 1 of h (f32 or bf16) at unit j; rows from
// the n-th on read as zeros
template <int R, int VW, typename HT>
__device__ __forceinline__ void load_rows(float (&hv)[R][VW],
                                          const HT* __restrict__ h, int H,
                                          int j, int b0, int n) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < n) {
      load_units<VW>(hv[r], h + (size_t)(b0 + r) * H + j);
    } else {
#pragma unroll
      for (int v = 0; v < VW; ++v) hv[r][v] = 0.f;
    }
  }
}

// The weight policies: the w[OT][VW] a thread holds for its units j … j +
// VW − 1, class o < O, zeros past O or where the thread has no units.
// DenseWeights<float> (F32Weights) reads f32 w2, DenseWeights<bf16>
// (BF16Weights) bf16 w2 widened.
template <typename T>
struct DenseWeights {
  const T* __restrict__ w2;  // (O, H)
  int H;
  template <int OT, int VW>
  __device__ __forceinline__ void load(float (&w)[OT][VW], int O, int j,
                                       bool act) const {
#pragma unroll
    for (int o = 0; o < OT; ++o) {
      if (act && o < O) {
        load_units<VW>(w[o], w2 + (size_t)o * H + j);
      } else {
#pragma unroll
        for (int v = 0; v < VW; ++v) w[o][v] = 0.f;
      }
    }
  }
};

using F32Weights = DenseWeights<float>;
using BF16Weights = DenseWeights<bf16>;

struct I8Weights {
  const int8_t* __restrict__ q;      // (O, H)
  const float* __restrict__ scale;   // (H / block,)
  int H, block;
  template <int OT, int VW>
  __device__ __forceinline__ void load(float (&w)[OT][VW], int O, int j,
                                       bool act) const {
    const float s = act ? scale[j / block] : 0.f;
#pragma unroll
    for (int o = 0; o < OT; ++o) {
      if (act && o < O) {
        const int8_t* p = q + (size_t)o * H + j;
        if constexpr (VW == 4) {
          const char4 t = *reinterpret_cast<const char4*>(p);
          w[o][0] = (float)t.x * s; w[o][1] = (float)t.y * s;
          w[o][2] = (float)t.z * s; w[o][3] = (float)t.w * s;
        } else {
#pragma unroll
          for (int v = 0; v < VW; ++v) w[o][v] = (float)p[v] * s;
        }
      } else {
#pragma unroll
        for (int v = 0; v < VW; ++v) w[o][v] = 0.f;
      }
    }
  }
};

// The first members whose first unit lies at or past u0 and u1 (P if
// none), found by the whole CTA together: each round every thread tests
// one of blockDim.x evenly spaced candidates for each, and the count of
// those below the unit (a prefix, the starts being sorted) narrows the
// range to one spacing.  Two rounds at P = 10,000 and 256 threads, the two
// searches' loads in flight together.  Every thread must call it.
__device__ inline void first_members_from(const int* __restrict__ member_ptr,
                                          int P, int block, long long u0,
                                          long long u1, int& m0, int& m1) {
  int lo[2] = {0, 0}, hi[2] = {P, P};  // each answer lies in [lo, hi]
  const long long unit[2] = {u0, u1};
  while (lo[0] < hi[0] || lo[1] < hi[1]) {
    int step[2], below[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      step[k] = (hi[k] - lo[k] + blockDim.x - 1) / blockDim.x;
      const int idx = lo[k] + threadIdx.x * step[k];
      below[k] = idx < hi[k] && (long long)member_ptr[idx] * block < unit[k]
                     ? 1 : 0;
    }
    const int cnt[2] = {__syncthreads_count(below[0]),
                        __syncthreads_count(below[1])};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (lo[k] == hi[k]) continue;
      if (cnt[k] == 0) {
        hi[k] = lo[k];
      } else {
        hi[k] = min(hi[k], lo[k] + cnt[k] * step[k]);
        lo[k] += (cnt[k] - 1) * step[k] + 1;
      }
    }
  }
  m0 = lo[0];
  m1 = lo[1];
}

// This CTA's members [m0, m1): those whose first unit lies in its tile of
// `tile` units, the last of n_tiles CTAs also those past its tile's end.
// Every thread must call it.
__device__ inline void cta_members(const int* __restrict__ member_ptr, int P,
                                   int block, int tile, int n_tiles, int& m0,
                                   int& m1) {
  const int c = blockIdx.x;
  first_members_from(member_ptr, P, block, (long long)c * tile,
                     c + 1 == n_tiles ? LLONG_MAX : (long long)(c + 1) * tile,
                     m0, m1);
}

// Adds to z[(r · mb_cap + i) · OT + o] the dot products of rows r0 … r0 +
// nr − 1 of h with w2's class o (loaded by the weight policy wl) over the
// units of members i = 0 … nb − 1, whose first units mstart[0 … nb] (in
// shared memory, mstart[nb] the end) bound them.  part is the [R ·
// lanes][OT][pad] shared scratch of the partials.  Every thread must call
// it, after a barrier that makes mstart and z visible; z is complete for
// every thread when it returns.
template <int OT, int VW, class W, typename HT>
__device__ __forceinline__ void stream_logits(
    const HT* __restrict__ h, const W& wl, int H, int O, int r0, int nr,
    const int* mstart, int nb, int mb_cap, int lanes, float* part,
    float* z) {
  constexpr int R = rows_in_flight<OT>();
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int TQ = T / lanes;         // unit slots; lanes of rows share them
  const int q = tid % TQ, lane = tid / TQ;
  const int U = VW * TQ;            // the tile
  const int GR = R * lanes;         // rows a group
  const int pad = TQ + TQ / 32;     // one float of padding every 32 slots
  const int ustart = mstart[0], uend = mstart[nb];

  for (int u0 = ustart; u0 < uend; u0 += U) {
    const int j = u0 + VW * q;  // this thread's first unit
    const bool act = j < uend;
    const int u1 = min(u0 + U, uend);
    float w[OT][VW];
    wl.template load<OT, VW>(w, O, j, act);
    // this lane's rows of a group: g + lane·R ... g + lane·R + R − 1
    float hv[R][VW];
    load_rows<R, VW>(hv, h, H, j, r0 + lane * R, act ? nr - lane * R : 0);
    for (int g = 0; g < nr; g += GR) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int o = 0; o < OT; ++o) {
          float s = 0.f;
#pragma unroll
          for (int v = 0; v < VW; ++v) s = fmaf(hv[r][v], w[o][v], s);
          part[((lane * R + r) * OT + o) * pad + q + q / 32] = s;
        }
      }
      const int gn = g + GR + lane * R;  // in flight during the reduce
      if (g + GR < nr)
        load_rows<R, VW>(hv, h, H, j, r0 + gn, act ? nr - gn : 0);
      __syncthreads();
      // one thread per (row, member): the member's slots in order
      for (int p = tid; p < GR * nb; p += T) {
        const int i = p % nb, r = p / nb;
        const int a = max(mstart[i], u0), e = min(mstart[i + 1], u1);
        if (g + r >= nr || a >= e) continue;
        float s[OT];
#pragma unroll
        for (int o = 0; o < OT; ++o) s[o] = 0.f;
        for (int t = (a - u0) / VW; t < (e - u0 + VW - 1) / VW; ++t) {
#pragma unroll
          for (int o = 0; o < OT; ++o)
            s[o] += part[(r * OT + o) * pad + t + t / 32];
        }
        float* zr = z + ((g + r) * mb_cap + i) * OT;
#pragma unroll
        for (int o = 0; o < OT; ++o) zr[o] += s[o];
      }
      __syncthreads();
    }
  }
}

// A streaming head forward's member loop: this CTA's members
// (cta_members) mb_cap at a time, the rows fwd_rows_held at a time; z from
// stream_logits, then one thread per (row, member), consecutive members on
// consecutive threads, hands its O ≤ OT finished dot products (zeros past
// O) to the kernel's epilogue, epi(acc, b, m).  Shared memory (dynamic,
// head_launch_shape's size): stream_logits' partials, z [rows held][mb_cap]
// [OT], mstart [mb_cap + 1].  Every thread must call it; it may be called
// again in the same launch (its first barrier comes before its first
// shared-memory write).
template <int OT, int VW, class W, class Epi, typename HT>
__device__ __forceinline__ void stream_members(
    const HT* __restrict__ h, const W& wl,
    const int* __restrict__ member_ptr, int B, int H, int O, int P,
    int block, int n_tiles, int lanes, int mb_cap, const Epi& epi) {
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int TQ = T / lanes;
  const int RB = fwd_rows_held<OT>(lanes);
  extern __shared__ float smem[];
  float* part = smem;  // [R · lanes][OT][pad], stream_logits' partials
  float* z = part + rows_in_flight<OT>() * lanes * OT * (TQ + TQ / 32);
  // z: [RB][mb_cap][OT]
  int* mstart = reinterpret_cast<int*>(z + RB * mb_cap * OT);  // [mb_cap + 1]

  int m0, m1;
  cta_members(member_ptr, P, block, VW * TQ, n_tiles, m0, m1);

  for (int mb0 = m0; mb0 < m1; mb0 += mb_cap) {
    const int nb = min(mb_cap, m1 - mb0);
    __syncthreads();  // the previous batch is done with its shared arrays
    for (int i = tid; i <= nb; i += T) mstart[i] = member_ptr[mb0 + i] * block;
    for (int r0 = 0; r0 < B; r0 += RB) {
      const int nr = min(RB, B - r0);
      __syncthreads();  // the previous chunk's epilogue is done
      for (int i = tid; i < RB * mb_cap * OT; i += T) z[i] = 0.f;
      __syncthreads();

      stream_logits<OT, VW>(h, wl, H, O, r0, nr, mstart, nb, mb_cap, lanes,
                            part, z);

      // one thread per (row, member), consecutive members on consecutive
      // threads (their output rows are contiguous)
      for (int p = tid; p < nr * nb; p += T) {
        const int i = p % nb, rr = p / nb;
        const float* zr = z + (rr * mb_cap + i) * OT;
        float acc[OT];
#pragma unroll
        for (int o = 0; o < OT; ++o) acc[o] = zr[o];
        epi(acc, r0 + rr, mb0 + i);
      }
    }
  }
}

// kernel_path() in infer_head.py: VW = 4 needs a block of a multiple of 4
// units (so a thread's 4 units share a member and a scale), rows of a
// multiple of 4 units and every tensor walked 4 units at a time aligned to
// 4 of its elements: the f32 ones (ptrs) to 16 bytes, the int8 ones (ptrs8)
// to 4
inline bool takes_vec4(int block, long long H, const void* const* ptrs,
                       int n, const void* const* ptrs8 = nullptr,
                       int n8 = 0) {
  if (block % 4 != 0 || H % 4 != 0) return false;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  for (int i = 0; i < n8; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs8[i]) % 4 != 0) return false;
  return true;
}

// the same rule over bf16 tensors: aligned to 4 of their elements, 8 bytes
inline bool takes_vec4_bf16(int block, long long H, const void* const* ptrs,
                            int n) {
  if (block % 4 != 0 || H % 4 != 0) return false;
  for (int i = 0; i < n; ++i)
    if (!bf16x::aligned8(ptrs[i])) return false;
  return true;
}

// Row lanes a CTA splits into: the fewest of 1, 2, 4, 8 whose tiles of
// vw · MAX_THREADS / lanes units still give the grid two CTAs an SM.
inline int cta_lanes(int H, int vw) {
  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const long long want = 2LL * (n_sm > 0 ? n_sm : 1);
  int lanes = 1;
  while (lanes < MAX_LANES) {
    const long long tile = (long long)vw * (MAX_THREADS / lanes);
    if (((long long)H + tile - 1) / tile >= want) break;
    lanes *= 2;
  }
  return lanes;
}

// A forward launch's shape: the instance (vec4 or scalar, by takes_vec4),
// the lanes, the tile of units, the CTAs (one if H is 0: it owns every
// member) and the members a CTA holds at once.
struct FwdShape {
  bool vec;
  int lanes, tile, mb_cap;
  long long n_tiles;
};

inline FwdShape fwd_shape(int H, int block, bool vec) {
  FwdShape s;
  s.vec = vec;
  s.lanes = cta_lanes(H, s.vec ? 4 : 1);
  s.tile = (s.vec ? 4 : 1) * (MAX_THREADS / s.lanes);
  s.n_tiles = H > 0 ? ((long long)H + s.tile - 1) / s.tile : 1;
  s.mb_cap = (s.tile + block - 1) / block < FWD_MAX_MEMBERS
                 ? (s.tile + block - 1) / block : FWD_MAX_MEMBERS;
  return s;
}

// floats of shared memory stream_logits uses at a shape: the partials
// ([R · lanes][OT][pad]), then z ([rows held][mb_cap][OT])
template <int OT>
size_t stream_smem_floats(const FwdShape& s) {
  const int tq = MAX_THREADS / s.lanes;
  return (size_t)rows_in_flight<OT>() * s.lanes * OT * (tq + tq / 32) +
         (size_t)fwd_rows_held<OT>(s.lanes) * s.mb_cap * OT;
}

// A stream_members launch's shape: fwd_shape, and the shared memory of the
// streaming core's partials and z, then mstart; false where the grid or
// the shared memory is out of range.
template <int OT>
bool head_launch_shape(int H, int block, bool vec, FwdShape& sh,
                       size_t& smem) {
  sh = fwd_shape(H, block, vec);
  smem = sizeof(float) * stream_smem_floats<OT>(sh) +
         sizeof(int) * (sh.mb_cap + 1);
  return sh.n_tiles <= INT_MAX && smem <= SMEM_LIMIT;
}

}  // namespace head
