// Forward-only output head: per-member M3 projection + member bias
// (+ optional stable log-softmax over the classes):
//   y[b, m, :] = Σ_{j in member m} h[b, j] · w2[:, j] + b2[m, :]
//
// Replaces the TPU kernel repro/kernels/infer_head.py::infer_head_fwd,
// reached through repro/kernels/ops.py::infer_head.
//
// h (B, H), w2 (O, H), b2 (P, O) f32 and the members' hidden-block ranges in
// CSR form, member_ptr (P + 1,) int32 in units of `block` hidden units →
// y (B, P, O) f32.  O ≤ 16.
//
// The TPU kernel finds member edges from neighbouring segment ids and
// rewrites its member's output block once per hidden tile (the last write
// wins, on a sequential grid).  Here every output has one owner that
// writes it once.
//
// What bounds it: bytes.  At the paper's 10,000-member width and B = 32 it
// reads h (164 MB) and w2 (10 MB) for 10 MFLOP — about 0.05 ms at 3.35 TB/s.
// So it is the training loss head's forward without the loss: the
// streaming core of head_stream.cuh (16-byte loads of h, or 4-byte ones in
// the scalar instance where kernel_path() in infer_head.py says so; w2 in
// registers; 16 / OT rows in flight; 256-thread CTAs in lanes of rows; a
// member owned by the CTA whose tile holds its first unit; partial logits
// added in unit order in shared memory), then one thread per (row,
// member), consecutive members on consecutive threads, adds the bias,
// applies the optional log-softmax and stores y[b, m, :] once
// (head_epilogue, the int8 kernel's epilogue too).
//
// infer_head_i8 replaces repro/kernels/infer_head.py::infer_head_int8_fwd
// (the int8 serve copy, ops.py::infer_head_int8): w2 is (O, H) int8 with one
// f32 scale per hidden tile of `block` units (H / block,).  JAX pads O to
// 128 with zero rows and −1e30 bias columns; here, as in the f32 kernel,
// O ≤ 16 is used as it is and members are CSR ranges.  One CTA owns one
// (32-row batch tile, member) pair and walks the member's hidden range in
// chunks of 256 units: each chunk's int8 weights are read from device
// memory once, converted to f32 and multiplied by their tile's scale as
// they are staged in shared memory (q·s, then the dot, as in JAX), then
// every warp reads them there for its 4 batch rows.  Lanes stride the chunk
// (coalesced reads of h); a shuffle reduction finishes the O dot products
// and lane 0 runs the f32 kernel's epilogue.  What bounds it: bytes, as
// for the f32 head (h is 164 MB at full width and B = 32; w2 shrinks from
// 10 MB to 2.6 MB).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

#include "head_stream.cuh"

namespace {

using namespace head;

// the int8 kernel's CTAs
constexpr int BM = 32;          // batch rows per CTA
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RPW = BM / WARPS;  // batch rows per warp
constexpr int CH = 256;          // hidden units staged per chunk

// The epilogue of one (row, member): the member bias, the optional stable
// log-softmax, the store.  acc holds the row's O ≤ N finished dot products.
template <int N>
__device__ __forceinline__ void head_epilogue(float (&acc)[N],
                                              const float* __restrict__ b2,
                                              float* __restrict__ y, int b,
                                              int m, int O, int P,
                                              int log_probs) {
  float mx = -INFINITY;
#pragma unroll
  for (int o = 0; o < N; ++o) {
    if (o < O) {
      acc[o] += b2[(size_t)m * O + o];
      mx = fmaxf(mx, acc[o]);
    }
  }
  if (log_probs) {
    float s = 0.f;
#pragma unroll
    for (int o = 0; o < N; ++o)
      if (o < O) s += expf(acc[o] - mx);
    const float lse = logf(s) + mx;
#pragma unroll
    for (int o = 0; o < N; ++o)
      if (o < O) acc[o] -= lse;
  }
  float* yr = y + ((size_t)b * P + m) * O;
#pragma unroll
  for (int o = 0; o < N; ++o)
    if (o < O) yr[o] = acc[o];
}

template <int OT, int VW>
__device__ __forceinline__ void infer_body(
    const float* __restrict__ h, const float* __restrict__ w2,
    const float* __restrict__ b2, const int* __restrict__ member_ptr,
    float* __restrict__ y, int B, int H, int O, int P, int block,
    int log_probs, int n_tiles, int lanes, int mb_cap) {
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

      stream_logits<OT, VW>(h, w2, H, O, r0, nr, mstart, nb, mb_cap, lanes,
                            part, z);

      // one thread per (row, member), consecutive members on consecutive
      // threads (their y rows are contiguous)
      for (int p = tid; p < nr * nb; p += T) {
        const int i = p % nb, rr = p / nb;
        const float* zr = z + (rr * mb_cap + i) * OT;
        float acc[OT];
#pragma unroll
        for (int o = 0; o < OT; ++o) acc[o] = zr[o];
        head_epilogue(acc, b2, y, r0 + rr, mb0 + i, O, P, log_probs);
      }
    }
  }
}

// The two designs, one name each, so that a profiler trace says which ran.
#define INFER_HEAD_PARAMS                                                   \
  const float *__restrict__ h, const float *__restrict__ w2,                \
      const float *__restrict__ b2, const int *__restrict__ member_ptr,     \
      float *__restrict__ y, int B, int H, int O, int P, int block,         \
      int log_probs, int n_tiles, int lanes, int mb_cap
#define INFER_HEAD_ARGS                                                   \
  h, w2, b2, member_ptr, y, B, H, O, P, block, log_probs, n_tiles, lanes,  \
      mb_cap

template <int OT>
__global__ void __launch_bounds__(MAX_THREADS)
infer_head_kernel_vec4(INFER_HEAD_PARAMS) {
  infer_body<OT, 4>(INFER_HEAD_ARGS);
}
template <int OT>
__global__ void __launch_bounds__(MAX_THREADS)
infer_head_kernel_scalar(INFER_HEAD_PARAMS) {
  infer_body<OT, 1>(INFER_HEAD_ARGS);
}

template <int OT>
int launch_f32(const float* h, const float* w2, const float* b2,
               const int* member_ptr, float* y, int B, int H, int O, int P,
               int block, int log_probs, cudaStream_t stream) {
  const void* ptrs[] = {h, w2};
  const FwdShape sh = fwd_shape(H, block, ptrs, 2);
  // the streaming core's partials and z, then mstart
  const size_t smem = sizeof(float) * stream_smem_floats<OT>(sh) +
                      sizeof(int) * (sh.mb_cap + 1);
  if (sh.n_tiles > INT_MAX || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)sh.n_tiles, lanes = sh.lanes, mb_cap = sh.mb_cap;
  if (sh.vec)
    infer_head_kernel_vec4<OT><<<(unsigned)n_tiles, MAX_THREADS, smem,
                                 stream>>>(INFER_HEAD_ARGS);
  else
    infer_head_kernel_scalar<OT><<<(unsigned)n_tiles, MAX_THREADS, smem,
                                   stream>>>(INFER_HEAD_ARGS);
  return (int)cudaGetLastError();
}

// OT: the class count the registers are sized for (O ≤ OT); the launch
// picks the smallest of 2, 4, 8, 16 that holds O, since RPW × OT
// accumulators per thread would otherwise cut the CTAs an SM can hold.
template <int OT>
__global__ void __launch_bounds__(THREADS)
infer_head_i8_kernel(const float* __restrict__ h,
                     const int8_t* __restrict__ w2q,
                     const float* __restrict__ w2_scale,
                     const float* __restrict__ b2,
                     const int* __restrict__ member_ptr,
                     float* __restrict__ y, int B, int H, int O, int P,
                     int block, int log_probs, int n_btiles) {
  __shared__ float ws[OT][CH];  // one chunk's dequantized weights

  const int bt = blockIdx.x % n_btiles;
  const int m = blockIdx.x / n_btiles;
  const int j0 = member_ptr[m] * block;
  const int j1 = member_ptr[m + 1] * block;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float acc[RPW][OT];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int o = 0; o < OT; ++o) acc[r][o] = 0.f;

  for (int c0 = j0; c0 < j1; c0 += CH) {
    const int n = min(CH, j1 - c0);
    __syncthreads();  // the previous chunk's reads are done
    for (int i = threadIdx.x; i < O * n; i += THREADS) {
      const int o = i / n, jj = i % n, j = c0 + jj;
      ws[o][jj] = (float)w2q[(size_t)o * H + j] * w2_scale[j / block];
    }
    __syncthreads();
    for (int jj = lane; jj < n; jj += 32) {
      float wv[OT];
#pragma unroll
      for (int o = 0; o < OT; ++o) wv[o] = o < O ? ws[o][jj] : 0.f;
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int b = bt * BM + warp + r * WARPS;
        if (b < B) {
          const float hv = h[(size_t)b * H + c0 + jj];
#pragma unroll
          for (int o = 0; o < OT; ++o)
            if (o < O) acc[r][o] = fmaf(hv, wv[o], acc[r][o]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int b = bt * BM + warp + r * WARPS;
    if (b >= B) continue;  // uniform across the warp
#pragma unroll
    for (int o = 0; o < OT; ++o) {
      if (o < O) {
        float v = acc[r][o];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        acc[r][o] = v;
      }
    }
    if (lane == 0) head_epilogue(acc[r], b2, y, b, m, O, P, log_probs);
  }
}

template <int OT>
void launch_i8(const float* h, const int8_t* w2_q, const float* w2_scale,
               const float* b2, const int* member_ptr, float* y, int B,
               int H, int O, int P, int block, int log_probs, int n_btiles,
               unsigned n_tiles, void* stream) {
  infer_head_i8_kernel<OT><<<n_tiles, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      h, w2_q, w2_scale, b2, member_ptr, y, B, H, O, P, block, log_probs,
      n_btiles);
}

}  // namespace

extern "C" int infer_head_f32(const float* h, const float* w2,
                              const float* b2, const int* member_ptr,
                              float* y, int B, int H, int O, int P,
                              int block, int log_probs, void* stream) {
  if (B <= 0 || P <= 0) return 0;
  if (H < 0 || O <= 0 || O > MAX_O || block <= 0)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (classes_tile(O)) {
    case 2: return launch_f32<2>(h, w2, b2, member_ptr, y, B, H, O, P, block,
                                 log_probs, s);
    case 4: return launch_f32<4>(h, w2, b2, member_ptr, y, B, H, O, P, block,
                                 log_probs, s);
    case 8: return launch_f32<8>(h, w2, b2, member_ptr, y, B, H, O, P, block,
                                 log_probs, s);
    default: return launch_f32<16>(h, w2, b2, member_ptr, y, B, H, O, P,
                                   block, log_probs, s);
  }
}

// h (B, H) f32, w2_q (O, H) int8, w2_scale (H / block,) f32.
extern "C" int infer_head_i8(const float* h, const int8_t* w2_q,
                             const float* w2_scale, const float* b2,
                             const int* member_ptr, float* y, int B, int H,
                             int O, int P, int block, int log_probs,
                             void* stream) {
  if (B <= 0 || P <= 0) return 0;
  if (O <= 0 || O > MAX_O || block <= 0) return (int)cudaErrorInvalidValue;
  const long long n_btiles = (B + BM - 1) / BM;
  const long long n_tiles = n_btiles * P;
  if (n_tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  auto* fn = O <= 2 ? launch_i8<2> : O <= 4 ? launch_i8<4>
           : O <= 8 ? launch_i8<8> : launch_i8<MAX_O>;
  fn(h, w2_q, w2_scale, b2, member_ptr, y, B, H, O, P, block, log_probs,
     (int)n_btiles, (unsigned)n_tiles, stream);
  return (int)cudaGetLastError();
}
