// Fused training loss head: M3 projection + per-member bias + softmax
// cross-entropy, forward and backward, the logits never in device memory.
//
//   forward   z[b, m, :] = Σ_{j in member m} h[b, j] · w2[:, j] + b2[m, :]
//             per[m] = Σ_b valid_b · (lse(z[b, m]) − z[b, m, t_b]) / B_real
//             dl[b, m, :] = valid_b · (softmax(z[b, m]) − onehot(t_b))
//                           / B_real
//   backward  dh[b, j]    = Σ_o dl[b, m(j), o] · d_per[m(j)] · w2[o, j]
//             dW[o, j]    = Σ_b dl[b, m(j), o] · d_per[m(j)] · h[b, j]
//
// Replaces the TPU kernels repro/kernels/loss_head.py::loss_head_fwd
// (with_dl=True, the forward of ops.py::loss_head's custom VJP) and
// ::loss_head_bwd (its backward).  h (B, H), w2 (O, H), b2 (P, O), targets
// (B,) int32 (−1 marks a pad row: zero loss, zero dl), member hidden ranges
// in CSR form over blocks (forward) or one member id per block (backward).
// O ≤ 16.  The bias cotangent d_per ⊙ Σ_b dl stays a plain tensor op
// outside, as the JAX package leaves it to XLA.
//
// What bounds them: bytes.  At the paper's 10,000-member width and B = 32
// the forward reads h (164 MB) and w2 (10 MB) for 20 MFLOP, the backward
// reads them again and writes dh (164 MB) and dW (10 MB): 0.053 ms and
// 0.105 ms at 3.35 TB/s, two orders of magnitude below the FMA units'
// line.  So the design is about bytes in flight and latency, nothing else:
//   * every thread owns VW consecutive hidden units (VW = 4: one 16-byte
//     load or store per row; VW = 1, the scalar instance of the same
//     code, where a block is not a multiple of 4 or a pointer is not
//     16-byte aligned: kernel_path() in loss_head.py holds the same rule)
//     and keeps its w2 columns in registers, loaded once;
//   * it streams h rows with R of them in flight (R · OT = 16 floats),
//     and the forward issues the next R rows before it reduces these;
//   * a CTA is 256 threads in 1, 2, 4 or 8 lanes of rows over one tile of
//     units, the fewest lanes that still give the grid two CTAs an SM: at
//     block 128 one lane over 1024 units, at the depth-3 head (H 32,000)
//     eight over 128, so a narrow layer fills the card without long
//     serial loops in a few threads;
//   * what a CTA needs besides h and w2 (its members' starts and biases,
//     the targets, the blocks' member ids and d_per) is loaded once into
//     shared memory, and the forward finds its members with a k-ary search
//     over member_ptr (two rounds at P = 10,000), so no schedule is built
//     on the host and no loop waits on one global load after another.
// The TPU forward sums per-member losses into a (1, P) scratch across its
// sequential grid, and the backward accumulates dW over batch tiles in
// VMEM.  A GPU grid has no order, so every output has exactly one owner
// that writes it once, and every sum runs in a fixed order (no
// floating-point atomics: a step is bitwise reproducible):
//   * forward: member m belongs to the CTA whose tile holds its first unit
//     (the last CTA also takes members that start at or past its tile's
//     end; fwd_cta_members() in loss_head.py is the same rule).  A CTA
//     walks its members' units a tile at a time (a member wider than a
//     tile spans several), writes each thread's partial logits to shared
//     memory, and one thread per (row, member) sums them in unit order;
//     after the last tile one thread per (row, member) runs the softmax
//     cross-entropy (expf once a class) and writes dl, consecutive
//     members' rows side by side, and one thread per member sums its
//     losses over the rows in order.
//   * backward, one role (head_bwd.cuh's stream_bwd, with dh; the M3 dW of
//     m3_matmul.cu runs it without dh and d_per): a CTA takes a tile of
//     units (not aligned to members), stages dl · d_per of the blocks the
//     tile touches in shared memory, a chunk of rows at a time (dl is read
//     once a block, not once a unit), then streams h and writes dh row by
//     row while it accumulates dW in registers; the lanes' dW sums are
//     added in lane order and written once: one pass over exactly the
//     bound's bytes.
// The forward's streaming core (stream_logits), the member rule and the
// helpers both kernels use live in head_stream.cuh, which infer_head.cu's
// kernels (f32 and int8 weights) and the M3 forward instantiate with their
// own epilogue (stream_members).
//
// loss_head_fwd_bf16 and loss_head_bwd_bf16 are the same two kernels under
// the bf16 compute policy (h and w2 bf16, cast before the kernels): the
// forward widens them (BF16Weights, bf16 h loads) and its logits, per and
// dl stay f32 (repro/kernels/loss_head.py:111-114); the backward rounds
// dl · d_per to bf16 before its products (:157, :166) and stores dh and
// dW in bf16, each rounded once from its f32 sum (:204-205).  h, dh and w2
// halve: at full width the forward reads 87 MB, the backward 92 MB and
// writes 87 MB.
#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "head_bwd.cuh"
#include "head_stream.cuh"

namespace {

using namespace head;

template <int OT, int VW, typename E>
__device__ __forceinline__ void fwd_body(
    const E* __restrict__ h, const E* __restrict__ w2,
    const float* __restrict__ b2, const int* __restrict__ targets,
    const int* __restrict__ member_ptr, float* __restrict__ per,
    float* __restrict__ dl, int B, int H, int O, int P, int block,
    float inv_b, int n_tiles, int lanes, int mb_cap) {
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int TQ = T / lanes;
  const int RB = fwd_rows_held<OT>(lanes);
  extern __shared__ float smem[];
  float* part = smem;  // [R · lanes][OT][pad], stream_logits' partials
  float* z = part + rows_in_flight<OT>() * lanes * OT * (TQ + TQ / 32);
  // z: [RB][mb_cap][OT]
  float* nll = z + RB * mb_cap * OT;             // [RB][mb_cap]
  float* nll_acc = nll + RB * mb_cap;            // [mb_cap]
  float* bias = nll_acc + mb_cap;                // [mb_cap][OT]
  int* mstart = reinterpret_cast<int*>(bias + mb_cap * OT);  // [mb_cap + 1]
  int* tgt = mstart + mb_cap + 1;                // [RB]

  int m0, m1;
  cta_members(member_ptr, P, block, VW * TQ, n_tiles, m0, m1);

  for (int mb0 = m0; mb0 < m1; mb0 += mb_cap) {
    const int nb = min(mb_cap, m1 - mb0);
    __syncthreads();  // the previous batch is done with its shared arrays
    for (int i = tid; i <= nb; i += T) mstart[i] = member_ptr[mb0 + i] * block;
    for (int i = tid; i < nb * OT; i += T) {
      const int o = i % OT;
      bias[i] = o < O ? b2[(size_t)(mb0 + i / OT) * O + o] : 0.f;
    }
    for (int i = tid; i < nb; i += T) nll_acc[i] = 0.f;
    __syncthreads();
    for (int r0 = 0; r0 < B; r0 += RB) {
      const int nr = min(RB, B - r0);
      __syncthreads();  // the previous chunk's epilogue and sums are done
      for (int i = tid; i < RB * mb_cap * OT; i += T) z[i] = 0.f;
      for (int i = tid; i < nr; i += T) tgt[i] = targets[r0 + i];
      __syncthreads();

      stream_logits<OT, VW>(h, DenseWeights<E>{w2, H}, H, O, r0, nr, mstart,
                            nb, mb_cap, lanes, part, z);

      // epilogue: one thread per (row, member), consecutive members on
      // consecutive threads (their dl rows are contiguous)
      for (int p = tid; p < nr * nb; p += T) {
        const int i = p % nb, rr = p / nb;
        const int m = mb0 + i, b = r0 + rr;
        const float* zr = z + (rr * mb_cap + i) * OT;
        float zz[OT], ex[OT];
        float mx = -INFINITY;
#pragma unroll
        for (int o = 0; o < OT; ++o) {
          if (o < O) {
            zz[o] = zr[o] + bias[i * OT + o];
            mx = fmaxf(mx, zz[o]);
          }
        }
        float den = 0.f;
#pragma unroll
        for (int o = 0; o < OT; ++o) {
          if (o < O) {
            ex[o] = expf(zz[o] - mx);
            den += ex[o];
          }
        }
        const float lse = logf(den) + mx;
        const int t_b = tgt[rr];
        const float valid = t_b >= 0 ? 1.f : 0.f;
        float zt = 0.f;
#pragma unroll
        for (int o = 0; o < OT; ++o)
          if (o < O && o == t_b) zt = zz[o];
        nll[rr * mb_cap + i] = (lse - zt) * valid;
        const float scale = valid * inv_b;
        float* dr = dl + ((size_t)b * P + m) * O;
#pragma unroll
        for (int o = 0; o < OT; ++o)
          if (o < O) dr[o] = (ex[o] / den - (o == t_b ? 1.f : 0.f)) * scale;
      }
      __syncthreads();
      for (int i = tid; i < nb; i += T) {
        float s = nll_acc[i];
        for (int rr = 0; rr < nr; ++rr) s += nll[rr * mb_cap + i];
        nll_acc[i] = s;
      }
    }
    __syncthreads();
    for (int i = tid; i < nb; i += T) per[mb0 + i] = nll_acc[i] * inv_b;
  }
}

// The two designs of each kernel, one name each, so that a profiler trace
// says which ran.
#define LOSS_HEAD_FWD_PARAMS                                                \
  const float *__restrict__ h, const float *__restrict__ w2,                \
      const float *__restrict__ b2, const int *__restrict__ targets,        \
      const int *__restrict__ member_ptr, float *__restrict__ per,          \
      float *__restrict__ dl, int B, int H, int O, int P, int block,        \
      float inv_b, int n_tiles, int lanes, int mb_cap
#define LOSS_HEAD_FWD_ARGS                                                  \
  h, w2, b2, targets, member_ptr, per, dl, B, H, O, P, block, inv_b,       \
      n_tiles, lanes, mb_cap
#define LOSS_HEAD_BWD_PARAMS                                                \
  const float *__restrict__ dper, const float *__restrict__ dl,             \
      const float *__restrict__ h, const float *__restrict__ w2,            \
      const int *__restrict__ block_seg, float *__restrict__ dh,            \
      float *__restrict__ dw, int B, int H, int O, int P, int block,         \
      int lanes, int rows
#define LOSS_HEAD_BWD_ARGS \
  dper, dl, O, h, w2, block_seg, dh, dw, B, H, O, P, block, lanes, rows

template <int OT>
__global__ void __launch_bounds__(MAX_THREADS)
loss_head_fwd_kernel_vec4(LOSS_HEAD_FWD_PARAMS) {
  fwd_body<OT, 4>(LOSS_HEAD_FWD_ARGS);
}
template <int OT>
__global__ void __launch_bounds__(MAX_THREADS)
loss_head_fwd_kernel_scalar(LOSS_HEAD_FWD_PARAMS) {
  fwd_body<OT, 1>(LOSS_HEAD_FWD_ARGS);
}
template <int OT>
__global__ void __launch_bounds__(MAX_THREADS)
loss_head_bwd_kernel_vec4(LOSS_HEAD_BWD_PARAMS) {
  stream_bwd<OT, 4, true>(LOSS_HEAD_BWD_ARGS);
}
template <int OT>
__global__ void __launch_bounds__(MAX_THREADS)
loss_head_bwd_kernel_scalar(LOSS_HEAD_BWD_PARAMS) {
  stream_bwd<OT, 1, true>(LOSS_HEAD_BWD_ARGS);
}

#define LOSS_HEAD_FWD_BF16_PARAMS                                           \
  const bf16 *__restrict__ h, const bf16 *__restrict__ w2,                  \
      const float *__restrict__ b2, const int *__restrict__ targets,        \
      const int *__restrict__ member_ptr, float *__restrict__ per,          \
      float *__restrict__ dl, int B, int H, int O, int P, int block,        \
      float inv_b, int n_tiles, int lanes, int mb_cap
#define LOSS_HEAD_BWD_BF16_PARAMS                                           \
  const float *__restrict__ dper, const float *__restrict__ dl,             \
      const bf16 *__restrict__ h, const bf16 *__restrict__ w2,              \
      const int *__restrict__ block_seg, bf16 *__restrict__ dh,             \
      bf16 *__restrict__ dw, int B, int H, int O, int P, int block,          \
      int lanes, int rows

template <int OT>
__global__ void __launch_bounds__(MAX_THREADS)
loss_head_fwd_bf16_kernel_vec4(LOSS_HEAD_FWD_BF16_PARAMS) {
  fwd_body<OT, 4>(LOSS_HEAD_FWD_ARGS);
}
template <int OT>
__global__ void __launch_bounds__(MAX_THREADS)
loss_head_fwd_bf16_kernel_scalar(LOSS_HEAD_FWD_BF16_PARAMS) {
  fwd_body<OT, 1>(LOSS_HEAD_FWD_ARGS);
}
template <int OT>
__global__ void __launch_bounds__(MAX_THREADS)
loss_head_bwd_bf16_kernel_vec4(LOSS_HEAD_BWD_BF16_PARAMS) {
  stream_bwd<OT, 4, true, bf16>(LOSS_HEAD_BWD_ARGS);
}
template <int OT>
__global__ void __launch_bounds__(MAX_THREADS)
loss_head_bwd_bf16_kernel_scalar(LOSS_HEAD_BWD_BF16_PARAMS) {
  stream_bwd<OT, 1, true, bf16>(LOSS_HEAD_BWD_ARGS);
}

// a forward launch, f32 or bf16 operands (T): the instance by takes_vec4
// (bf16: takes_vec4_bf16)
template <int OT, typename T>
int launch_fwd(const T* h, const T* w2, const float* b2, const int* targets,
               const int* member_ptr, float* per, float* dl, int B, int H,
               int O, int P, int block, float inv_b, cudaStream_t stream) {
  constexpr bool BF = sizeof(T) == 2;
  const void* ptrs[] = {h, w2};
  const FwdShape sh = fwd_shape(
      H, block, BF ? takes_vec4_bf16(block, H, ptrs, 2)
                   : takes_vec4(block, H, ptrs, 2));
  const int rb = fwd_rows_held<OT>(sh.lanes), mb_cap = sh.mb_cap;
  // the streaming core's partials and z, then nll, nll_acc, bias, mstart,
  // tgt
  const size_t smem =
      sizeof(float) * (stream_smem_floats<OT>(sh) + (size_t)rb * mb_cap +
                       mb_cap + (size_t)mb_cap * OT) +
      sizeof(int) * (mb_cap + 1 + rb);
  if (sh.n_tiles > INT_MAX || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)sh.n_tiles, lanes = sh.lanes;
  if constexpr (BF) {
    auto* kernel = sh.vec ? loss_head_fwd_bf16_kernel_vec4<OT>
                          : loss_head_fwd_bf16_kernel_scalar<OT>;
    kernel<<<(unsigned)n_tiles, MAX_THREADS, smem, stream>>>(
        h, w2, b2, targets, member_ptr, per, dl, B, H, O, P, block, inv_b,
        n_tiles, lanes, mb_cap);
  } else {
    auto* kernel = sh.vec ? loss_head_fwd_kernel_vec4<OT>
                          : loss_head_fwd_kernel_scalar<OT>;
    kernel<<<(unsigned)n_tiles, MAX_THREADS, smem, stream>>>(
        h, w2, b2, targets, member_ptr, per, dl, B, H, O, P, block, inv_b,
        n_tiles, lanes, mb_cap);
  }
  return (int)cudaGetLastError();
}

// a backward launch, f32 or bf16 h, w2, dh and dW (T)
template <int OT, typename T>
int launch_bwd(const float* dper, const float* dl, const T* h, const T* w2,
               const int* block_seg, T* dh, T* dw, int B, int H, int O, int P,
               int block, cudaStream_t stream) {
  constexpr bool BF = sizeof(T) == 2;
  const void* ptrs[] = {h, w2, dh, dw};
  BwdShape sh;
  if (!bwd_shape<OT>(B, H, block,
                     BF ? takes_vec4_bf16(block, H, ptrs, 4)
                        : takes_vec4(block, H, ptrs, 4),
                     sh))
    return (int)cudaErrorInvalidValue;
  const int lanes = sh.lanes, rows = sh.rows;
  if constexpr (BF) {
    auto* kernel = sh.vec ? loss_head_bwd_bf16_kernel_vec4<OT>
                          : loss_head_bwd_bf16_kernel_scalar<OT>;
    kernel<<<(unsigned)sh.n_tiles, MAX_THREADS, sh.smem, stream>>>(
        dper, dl, h, w2, block_seg, dh, dw, B, H, O, P, block, lanes, rows);
  } else {
    auto* kernel = sh.vec ? loss_head_bwd_kernel_vec4<OT>
                          : loss_head_bwd_kernel_scalar<OT>;
    kernel<<<(unsigned)sh.n_tiles, MAX_THREADS, sh.smem, stream>>>(
        dper, dl, h, w2, block_seg, dh, dw, B, H, O, P, block, lanes, rows);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int loss_head_fwd_f32(const float* h, const float* w2,
                                 const float* b2, const int* targets,
                                 const int* member_ptr, float* per, float* dl,
                                 int B, int H, int O, int P, int block,
                                 float inv_b, void* stream) {
  if (P <= 0) return 0;
  if (B <= 0 || H < 0 || O <= 0 || O > MAX_O || block <= 0)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (classes_tile(O)) {
    case 2: return launch_fwd<2>(h, w2, b2, targets, member_ptr, per, dl, B,
                                 H, O, P, block, inv_b, s);
    case 4: return launch_fwd<4>(h, w2, b2, targets, member_ptr, per, dl, B,
                                 H, O, P, block, inv_b, s);
    case 8: return launch_fwd<8>(h, w2, b2, targets, member_ptr, per, dl, B,
                                 H, O, P, block, inv_b, s);
    default: return launch_fwd<16>(h, w2, b2, targets, member_ptr, per, dl,
                                   B, H, O, P, block, inv_b, s);
  }
}

extern "C" int loss_head_bwd_f32(const float* dper, const float* dl,
                                 const float* h, const float* w2,
                                 const int* block_seg, float* dh, float* dw,
                                 int B, int H, int O, int P, int block,
                                 void* stream) {
  if (H <= 0) return 0;
  if (B <= 0 || O <= 0 || O > MAX_O || block <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (classes_tile(O)) {
    case 2: return launch_bwd<2>(dper, dl, h, w2, block_seg, dh, dw, B, H, O,
                                 P, block, s);
    case 4: return launch_bwd<4>(dper, dl, h, w2, block_seg, dh, dw, B, H, O,
                                 P, block, s);
    case 8: return launch_bwd<8>(dper, dl, h, w2, block_seg, dh, dw, B, H, O,
                                 P, block, s);
    default: return launch_bwd<16>(dper, dl, h, w2, block_seg, dh, dw, B, H,
                                   O, P, block, s);
  }
}

// The bf16 compute policy: h (B, H) and w2 (O, H) bf16, b2 f32 → per (P,)
// and dl (B, P, O) f32.
extern "C" int loss_head_fwd_bf16(const bf16* h, const bf16* w2,
                                  const float* b2, const int* targets,
                                  const int* member_ptr, float* per,
                                  float* dl, int B, int H, int O, int P,
                                  int block, float inv_b, void* stream) {
  if (P <= 0) return 0;
  if (B <= 0 || H < 0 || O <= 0 || O > MAX_O || block <= 0)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (classes_tile(O)) {
    case 2: return launch_fwd<2>(h, w2, b2, targets, member_ptr, per, dl, B,
                                 H, O, P, block, inv_b, s);
    case 4: return launch_fwd<4>(h, w2, b2, targets, member_ptr, per, dl, B,
                                 H, O, P, block, inv_b, s);
    case 8: return launch_fwd<8>(h, w2, b2, targets, member_ptr, per, dl, B,
                                 H, O, P, block, inv_b, s);
    default: return launch_fwd<16>(h, w2, b2, targets, member_ptr, per, dl,
                                   B, H, O, P, block, inv_b, s);
  }
}

// d_per (P,), dl (B, P, O) f32, h (B, H) and w2 (O, H) bf16 → dh (B, H)
// and dW (O, H) bf16.
extern "C" int loss_head_bwd_bf16(const float* dper, const float* dl,
                                  const bf16* h, const bf16* w2,
                                  const int* block_seg, bf16* dh, bf16* dw,
                                  int B, int H, int O, int P, int block,
                                  void* stream) {
  if (H <= 0) return 0;
  if (B <= 0 || O <= 0 || O > MAX_O || block <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (classes_tile(O)) {
    case 2: return launch_bwd<2>(dper, dl, h, w2, block_seg, dh, dw, B, H, O,
                                 P, block, s);
    case 4: return launch_bwd<4>(dper, dl, h, w2, block_seg, dh, dw, B, H, O,
                                 P, block, s);
    case 8: return launch_bwd<8>(dper, dl, h, w2, block_seg, dh, dw, B, H, O,
                                 P, block, s);
    default: return launch_bwd<16>(dper, dl, h, w2, block_seg, dh, dw, B, H,
                                   O, P, block, s);
  }
}
