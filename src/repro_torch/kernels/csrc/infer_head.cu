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
// added in unit order in shared memory; its member loop stream_members,
// which the M3 forward of m3_matmul.cu runs too), then one thread per
// (row, member), consecutive members on consecutive threads, adds the
// bias, applies the optional log-softmax and stores y[b, m, :] once
// (HeadEpilogue, the int8 kernel's epilogue too).
//
// infer_head_i8 replaces repro/kernels/infer_head.py::infer_head_int8_fwd
// (the int8 serve copy, ops.py::infer_head_int8): w2 is (O, H) int8 with one
// f32 scale per hidden tile of `block` units (H / block,).  JAX pads O to
// 128 with zero rows and −1e30 bias columns and dequantizes each weight
// tile (q·s) before its dot; here O ≤ 16 is used as it is, members are CSR
// ranges, and the kernel is the f32 kernel with another weight policy
// (head_stream.cuh's I8Weights): a thread's 4 units of a class come in one
// 4-byte load and are dequantized in registers, once a tile, with the
// scale of the block that holds them (q·s, then the dot, as in JAX).  The
// rest (h streamed with 16-byte loads, rows in flight, members owned by
// the CTA that holds their first unit, partials added in unit order,
// HeadEpilogue) is the f32 kernel's, so where both take the same instance
// its output is bitwise the f32 kernel's on the dequantized weight.  Its
// own alignment rule (kernel_path() in infer_head.py): h 16-byte aligned,
// w2_q 4-byte aligned, block and H multiples of 4 for the vec4 instance,
// else the scalar one.  What bounds it: bytes, as for the f32 head (h is
// 164 MB at full width and B = 32; w2 shrinks from 10 MB to 2.6 MB).
//
// infer_head_bf16 is the same kernel under the bf16 compute policy (the
// bf16 instance of infer_head_fwd: h and w2 bf16, cast by the policy
// before the kernel): head_stream.cuh's BF16Weights and bf16 h loads,
// widened to f32; the logits, the bias and the log-softmax stay f32
// (repro/kernels/infer_head.py:100).  h shrinks to 82 MB at full width.
//
// infer_head_i8_bf16 is the int8 kernel under the bf16 compute policy
// (JAX's infer_head_int8_fwd on bf16 h, repro/kernels/infer_head.py:
// 131-150, f32 logits at :176): I8Weights with bf16 h loads (8 bytes a
// row of a thread's 4 units, widened); the logits stay f32.  Its vec4
// instance takes h on an 8-byte boundary and w2_q on a 4-byte one.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

#include "head_stream.cuh"

namespace {

using namespace head;

// The epilogue of one (row, member), stream_members' epilogue functor: the
// member bias, the optional stable log-softmax, the store.  acc holds the
// row's O ≤ N finished dot products.
struct HeadEpilogue {
  const float* __restrict__ b2;
  float* __restrict__ y;
  int O, P, log_probs;
  template <int N>
  __device__ __forceinline__ void operator()(float (&acc)[N], int b,
                                             int m) const {
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
};

// The designs, one name each, so that a profiler trace says which ran.
#define INFER_HEAD_PARAMS                                                   \
  const float *__restrict__ h, const float *__restrict__ w2,                \
      const float *__restrict__ b2, const int *__restrict__ member_ptr,     \
      float *__restrict__ y, int B, int H, int O, int P, int block,         \
      int log_probs, int n_tiles, int lanes, int mb_cap
#define INFER_HEAD_I8_PARAMS                                                \
  const float *__restrict__ h, const int8_t *__restrict__ w2q,              \
      const float *__restrict__ w2_scale, const float *__restrict__ b2,     \
      const int *__restrict__ member_ptr, float *__restrict__ y, int B,     \
      int H, int O, int P, int block, int log_probs, int n_tiles,           \
      int lanes, int mb_cap
#define INFER_HEAD_BF16_PARAMS                                              \
  const bf16 *__restrict__ h, const bf16 *__restrict__ w2,                  \
      const float *__restrict__ b2, const int *__restrict__ member_ptr,     \
      float *__restrict__ y, int B, int H, int O, int P, int block,         \
      int log_probs, int n_tiles, int lanes, int mb_cap
#define INFER_HEAD_I8_BF16_PARAMS                                           \
  const bf16 *__restrict__ h, const int8_t *__restrict__ w2q,               \
      const float *__restrict__ w2_scale, const float *__restrict__ b2,     \
      const int *__restrict__ member_ptr, float *__restrict__ y, int B,     \
      int H, int O, int P, int block, int log_probs, int n_tiles,           \
      int lanes, int mb_cap
#define INFER_HEAD_BODY_ARGS                                                \
  member_ptr, B, H, O, P, block, n_tiles, lanes, mb_cap,                    \
      HeadEpilogue{b2, y, O, P, log_probs}
#define INFER_HEAD_LAUNCH_ARGS                                              \
  b2, member_ptr, y, B, H, O, P, block, log_probs, n_tiles, lanes, mb_cap

template <int OT>
__global__ void __launch_bounds__(MAX_THREADS)
infer_head_kernel_vec4(INFER_HEAD_PARAMS) {
  stream_members<OT, 4>(h, F32Weights{w2, H}, INFER_HEAD_BODY_ARGS);
}
template <int OT>
__global__ void __launch_bounds__(MAX_THREADS)
infer_head_kernel_scalar(INFER_HEAD_PARAMS) {
  stream_members<OT, 1>(h, F32Weights{w2, H}, INFER_HEAD_BODY_ARGS);
}
template <int OT>
__global__ void __launch_bounds__(MAX_THREADS)
infer_head_i8_kernel_vec4(INFER_HEAD_I8_PARAMS) {
  stream_members<OT, 4>(h, I8Weights{w2q, w2_scale, H, block},
                        INFER_HEAD_BODY_ARGS);
}
template <int OT>
__global__ void __launch_bounds__(MAX_THREADS)
infer_head_i8_kernel_scalar(INFER_HEAD_I8_PARAMS) {
  stream_members<OT, 1>(h, I8Weights{w2q, w2_scale, H, block},
                        INFER_HEAD_BODY_ARGS);
}

template <int OT>
__global__ void __launch_bounds__(MAX_THREADS)
infer_head_bf16_kernel_vec4(INFER_HEAD_BF16_PARAMS) {
  stream_members<OT, 4>(h, BF16Weights{w2, H}, INFER_HEAD_BODY_ARGS);
}
template <int OT>
__global__ void __launch_bounds__(MAX_THREADS)
infer_head_bf16_kernel_scalar(INFER_HEAD_BF16_PARAMS) {
  stream_members<OT, 1>(h, BF16Weights{w2, H}, INFER_HEAD_BODY_ARGS);
}

template <int OT>
__global__ void __launch_bounds__(MAX_THREADS)
infer_head_i8_bf16_kernel_vec4(INFER_HEAD_I8_BF16_PARAMS) {
  stream_members<OT, 4>(h, I8Weights{w2q, w2_scale, H, block},
                        INFER_HEAD_BODY_ARGS);
}
template <int OT>
__global__ void __launch_bounds__(MAX_THREADS)
infer_head_i8_bf16_kernel_scalar(INFER_HEAD_I8_BF16_PARAMS) {
  stream_members<OT, 1>(h, I8Weights{w2q, w2_scale, H, block},
                        INFER_HEAD_BODY_ARGS);
}

template <int OT>
int launch_bf16(const bf16* h, const bf16* w2, const float* b2,
                const int* member_ptr, float* y, int B, int H, int O, int P,
                int block, int log_probs, cudaStream_t stream) {
  const void* ptrs[] = {h, w2};
  FwdShape sh;
  size_t smem;
  if (!head_launch_shape<OT>(H, block, takes_vec4_bf16(block, H, ptrs, 2),
                             sh, smem))
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)sh.n_tiles, lanes = sh.lanes, mb_cap = sh.mb_cap;
  if (sh.vec)
    infer_head_bf16_kernel_vec4<OT><<<(unsigned)n_tiles, MAX_THREADS, smem,
                                      stream>>>(
        h, w2, INFER_HEAD_LAUNCH_ARGS);
  else
    infer_head_bf16_kernel_scalar<OT><<<(unsigned)n_tiles, MAX_THREADS,
                                        smem, stream>>>(
        h, w2, INFER_HEAD_LAUNCH_ARGS);
  return (int)cudaGetLastError();
}

template <int OT>
int launch_f32(const float* h, const float* w2, const float* b2,
               const int* member_ptr, float* y, int B, int H, int O, int P,
               int block, int log_probs, cudaStream_t stream) {
  const void* ptrs[] = {h, w2};
  FwdShape sh;
  size_t smem;
  if (!head_launch_shape<OT>(H, block, takes_vec4(block, H, ptrs, 2), sh,
                             smem))
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)sh.n_tiles, lanes = sh.lanes, mb_cap = sh.mb_cap;
  if (sh.vec)
    infer_head_kernel_vec4<OT><<<(unsigned)n_tiles, MAX_THREADS, smem,
                                 stream>>>(
        h, w2, INFER_HEAD_LAUNCH_ARGS);
  else
    infer_head_kernel_scalar<OT><<<(unsigned)n_tiles, MAX_THREADS, smem,
                                   stream>>>(
        h, w2, INFER_HEAD_LAUNCH_ARGS);
  return (int)cudaGetLastError();
}

template <int OT>
int launch_i8(const float* h, const int8_t* w2q, const float* w2_scale,
              const float* b2, const int* member_ptr, float* y, int B, int H,
              int O, int P, int block, int log_probs, cudaStream_t stream) {
  const void* ptrs[] = {h};
  const void* ptrs8[] = {w2q};
  FwdShape sh;
  size_t smem;
  if (!head_launch_shape<OT>(H, block,
                             takes_vec4(block, H, ptrs, 1, ptrs8, 1), sh,
                             smem))
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)sh.n_tiles, lanes = sh.lanes, mb_cap = sh.mb_cap;
  if (sh.vec)
    infer_head_i8_kernel_vec4<OT><<<(unsigned)n_tiles, MAX_THREADS, smem,
                                    stream>>>(
        h, w2q, w2_scale, INFER_HEAD_LAUNCH_ARGS);
  else
    infer_head_i8_kernel_scalar<OT><<<(unsigned)n_tiles, MAX_THREADS, smem,
                                      stream>>>(
        h, w2q, w2_scale, INFER_HEAD_LAUNCH_ARGS);
  return (int)cudaGetLastError();
}

template <int OT>
int launch_i8_bf16(const bf16* h, const int8_t* w2q, const float* w2_scale,
                   const float* b2, const int* member_ptr, float* y, int B,
                   int H, int O, int P, int block, int log_probs,
                   cudaStream_t stream) {
  const void* ptrs[] = {h};
  FwdShape sh;
  size_t smem;
  if (!head_launch_shape<OT>(
          H, block,
          takes_vec4_bf16(block, H, ptrs, 1) &&
              reinterpret_cast<uintptr_t>(w2q) % 4 == 0,
          sh, smem))
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)sh.n_tiles, lanes = sh.lanes, mb_cap = sh.mb_cap;
  if (sh.vec)
    infer_head_i8_bf16_kernel_vec4<OT><<<(unsigned)n_tiles, MAX_THREADS,
                                         smem, stream>>>(
        h, w2q, w2_scale, INFER_HEAD_LAUNCH_ARGS);
  else
    infer_head_i8_bf16_kernel_scalar<OT><<<(unsigned)n_tiles, MAX_THREADS,
                                           smem, stream>>>(
        h, w2q, w2_scale, INFER_HEAD_LAUNCH_ARGS);
  return (int)cudaGetLastError();
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
  if (H < 0 || O <= 0 || O > MAX_O || block <= 0 || H % block)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (classes_tile(O)) {
    case 2: return launch_i8<2>(h, w2_q, w2_scale, b2, member_ptr, y, B, H,
                                O, P, block, log_probs, s);
    case 4: return launch_i8<4>(h, w2_q, w2_scale, b2, member_ptr, y, B, H,
                                O, P, block, log_probs, s);
    case 8: return launch_i8<8>(h, w2_q, w2_scale, b2, member_ptr, y, B, H,
                                O, P, block, log_probs, s);
    default: return launch_i8<16>(h, w2_q, w2_scale, b2, member_ptr, y, B,
                                  H, O, P, block, log_probs, s);
  }
}

// The bf16 compute policy: h (B, H) and w2 (O, H) bf16, b2 f32 → y
// (B, P, O) f32.
extern "C" int infer_head_bf16(const bf16* h, const bf16* w2,
                               const float* b2, const int* member_ptr,
                               float* y, int B, int H, int O, int P,
                               int block, int log_probs, void* stream) {
  if (B <= 0 || P <= 0) return 0;
  if (H < 0 || O <= 0 || O > MAX_O || block <= 0)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (classes_tile(O)) {
    case 2: return launch_bf16<2>(h, w2, b2, member_ptr, y, B, H, O, P,
                                  block, log_probs, s);
    case 4: return launch_bf16<4>(h, w2, b2, member_ptr, y, B, H, O, P,
                                  block, log_probs, s);
    case 8: return launch_bf16<8>(h, w2, b2, member_ptr, y, B, H, O, P,
                                  block, log_probs, s);
    default: return launch_bf16<16>(h, w2, b2, member_ptr, y, B, H, O, P,
                                    block, log_probs, s);
  }
}

// The int8 serve copy under the bf16 compute policy: h (B, H) bf16, w2_q
// (O, H) int8, w2_scale (H / block,) f32 → y (B, P, O) f32.
extern "C" int infer_head_i8_bf16(const bf16* h, const int8_t* w2_q,
                                  const float* w2_scale, const float* b2,
                                  const int* member_ptr, float* y, int B,
                                  int H, int O, int P, int block,
                                  int log_probs, void* stream) {
  if (B <= 0 || P <= 0) return 0;
  if (H < 0 || O <= 0 || O > MAX_O || block <= 0 || H % block)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (classes_tile(O)) {
    case 2: return launch_i8_bf16<2>(h, w2_q, w2_scale, b2, member_ptr, y, B,
                                     H, O, P, block, log_probs, s);
    case 4: return launch_i8_bf16<4>(h, w2_q, w2_scale, b2, member_ptr, y, B,
                                     H, O, P, block, log_probs, s);
    case 8: return launch_i8_bf16<8>(h, w2_q, w2_scale, b2, member_ptr, y, B,
                                     H, O, P, block, log_probs, s);
    default: return launch_i8_bf16<16>(h, w2_q, w2_scale, b2, member_ptr, y,
                                       B, H, O, P, block, log_probs, s);
  }
}
