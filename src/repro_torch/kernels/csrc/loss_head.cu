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
// The TPU forward sums per-member losses into a (1, P) scratch across its
// whole sequential grid, and the backward accumulates dW over batch tiles
// in VMEM.  A GPU grid has no order, so every output has exactly one owner
// CTA that loops privately and writes it once:
//   * forward: one CTA per member loops over the member's contiguous hidden
//     range (lanes stride the units, a shuffle finishes the O dot
//     products) and over every batch row (warps take rows); lane 0 runs the
//     softmax-XE epilogue on the logits in registers and writes dl; the
//     member's loss is summed over warps in a fixed order and written once.
//   * backward, one grid of two roles split by blockIdx: role A, a CTA per
//     (32-row batch tile, 256-unit hidden tile), writes dh (each thread one
//     unit, its O weights in registers); role B, a CTA per 256-unit hidden
//     tile, loops over every batch row for dW.
// No floating-point atomics: a step is bitwise reproducible.
//
// What bounds it: bytes.  At the paper's 10,000-member width and B = 32 the
// forward reads h (164 MB) and w2 (10 MB) for 20 MFLOP; the backward reads
// h and w2 again and writes dh (164 MB) and dW (10 MB): about 0.05 ms and
// 0.1 ms at 3.35 TB/s.  Both kernels stream h once, in rows, coalesced.
//
// Left for later: w2 is re-read per batch row in the forward (from L1/L2);
// a member narrower than 32 units leaves lanes idle; one CTA per member
// means B rows run on one SM (B = 32 on the training path).
#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_O = 16;
constexpr int BWD_BM = 32;      // batch rows per dh CTA
constexpr int BWD_BN = THREADS; // hidden units per backward CTA

__global__ void __launch_bounds__(THREADS)
loss_head_fwd_kernel(const float* __restrict__ h, const float* __restrict__ w2,
                     const float* __restrict__ b2,
                     const int* __restrict__ targets,
                     const int* __restrict__ member_ptr,
                     float* __restrict__ per, float* __restrict__ dl, int B,
                     int H, int O, int P, int block, float inv_b) {
  __shared__ float warp_nll[WARPS];
  const int m = blockIdx.x;
  const int j0 = member_ptr[m] * block;
  const int j1 = member_ptr[m + 1] * block;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float nll_sum = 0.f;  // this warp's rows, meaningful in lane 0
  for (int b = warp; b < B; b += WARPS) {
    float acc[MAX_O];
#pragma unroll
    for (int o = 0; o < MAX_O; ++o) acc[o] = 0.f;
    const float* hr = h + (size_t)b * H;
    for (int j = j0 + lane; j < j1; j += 32) {
      const float hv = hr[j];
#pragma unroll
      for (int o = 0; o < MAX_O; ++o)
        if (o < O) acc[o] = fmaf(hv, w2[(size_t)o * H + j], acc[o]);
    }
#pragma unroll
    for (int o = 0; o < MAX_O; ++o) {
      if (o < O) {
        float v = acc[o];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        acc[o] = v;
      }
    }
    if (lane == 0) {
      float mx = -INFINITY;
#pragma unroll
      for (int o = 0; o < MAX_O; ++o) {
        if (o < O) {
          acc[o] += b2[(size_t)m * O + o];
          mx = fmaxf(mx, acc[o]);
        }
      }
      float den = 0.f;
#pragma unroll
      for (int o = 0; o < MAX_O; ++o)
        if (o < O) den += expf(acc[o] - mx);
      const float lse = logf(den) + mx;
      const int tgt = targets[b];
      const float valid = tgt >= 0 ? 1.f : 0.f;
      float zt = 0.f;
#pragma unroll
      for (int o = 0; o < MAX_O; ++o)
        if (o < O && o == tgt) zt = acc[o];
      nll_sum += (lse - zt) * valid;
      float* dr = dl + ((size_t)b * P + m) * O;
      const float scale = valid * inv_b;
#pragma unroll
      for (int o = 0; o < MAX_O; ++o)
        if (o < O)
          dr[o] = (expf(acc[o] - mx) / den - (o == tgt ? 1.f : 0.f)) * scale;
    }
  }
  if (lane == 0) warp_nll[warp] = nll_sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += warp_nll[w];  // fixed order
    per[m] = s * inv_b;
  }
}

__global__ void __launch_bounds__(THREADS)
loss_head_bwd_kernel(const float* __restrict__ dper,
                     const float* __restrict__ dl, const float* __restrict__ h,
                     const float* __restrict__ w2,
                     const int* __restrict__ block_seg,
                     float* __restrict__ dh, float* __restrict__ dw, int B,
                     int H, int O, int P, int block, int n_dh_ctas,
                     int n_btiles) {
  if ((int)blockIdx.x < n_dh_ctas) {
    // role A: dh for one (batch tile, hidden tile)
    const int bt = blockIdx.x % n_btiles;
    const int j = (blockIdx.x / n_btiles) * BWD_BN + threadIdx.x;
    if (j >= H) return;
    const int m = block_seg[j / block];
    const float s = dper[m];
    float wj[MAX_O];
#pragma unroll
    for (int o = 0; o < MAX_O; ++o)
      wj[o] = o < O ? w2[(size_t)o * H + j] : 0.f;
    const int b1 = min(B, (bt + 1) * BWD_BM);
    for (int b = bt * BWD_BM; b < b1; ++b) {
      const float* dr = dl + ((size_t)b * P + m) * O;
      float v = 0.f;
#pragma unroll
      for (int o = 0; o < MAX_O; ++o)
        if (o < O) v = fmaf(dr[o] * s, wj[o], v);
      dh[(size_t)b * H + j] = v;
    }
    return;
  }
  // role B: dW for one hidden tile, over every batch row
  const int j = (blockIdx.x - n_dh_ctas) * BWD_BN + threadIdx.x;
  if (j >= H) return;
  const int m = block_seg[j / block];
  const float s = dper[m];
  float acc[MAX_O];
#pragma unroll
  for (int o = 0; o < MAX_O; ++o) acc[o] = 0.f;
  for (int b = 0; b < B; ++b) {
    const float hv = h[(size_t)b * H + j];
    const float* dr = dl + ((size_t)b * P + m) * O;
#pragma unroll
    for (int o = 0; o < MAX_O; ++o)
      if (o < O) acc[o] = fmaf(dr[o] * s, hv, acc[o]);
  }
#pragma unroll
  for (int o = 0; o < MAX_O; ++o)
    if (o < O) dw[(size_t)o * H + j] = acc[o];
}

}  // namespace

extern "C" int loss_head_fwd_f32(const float* h, const float* w2,
                                 const float* b2, const int* targets,
                                 const int* member_ptr, float* per, float* dl,
                                 int B, int H, int O, int P, int block,
                                 float inv_b, void* stream) {
  if (P <= 0) return 0;
  if (B <= 0 || O <= 0 || O > MAX_O || block <= 0)
    return (int)cudaErrorInvalidValue;
  loss_head_fwd_kernel<<<P, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      h, w2, b2, targets, member_ptr, per, dl, B, H, O, P, block, inv_b);
  return (int)cudaGetLastError();
}

extern "C" int loss_head_bwd_f32(const float* dper, const float* dl,
                                 const float* h, const float* w2,
                                 const int* block_seg, float* dh, float* dw,
                                 int B, int H, int O, int P, int block,
                                 void* stream) {
  if (H <= 0) return 0;
  if (B <= 0 || O <= 0 || O > MAX_O || block <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  const long long n_htiles = (H + BWD_BN - 1) / BWD_BN;
  const long long n_btiles = (B + BWD_BM - 1) / BWD_BM;
  const long long n_dh = n_btiles * n_htiles;
  if (n_dh + n_htiles > INT_MAX) return (int)cudaErrorInvalidValue;
  loss_head_bwd_kernel<<<(unsigned)(n_dh + n_htiles), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      dper, dl, h, w2, block_seg, dh, dw, B, H, O, P, block, (int)n_dh,
      (int)n_btiles);
  return (int)cudaGetLastError();
}
