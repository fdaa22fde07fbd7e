// Fused input layer, backward:  du = dy ⊙ g'  (in registers, never stored)
//   dW[h, f] = Σ_b du[b, h] · x[b, f]        (always)
//   dx[b, f] = Σ_h du[b, h] · W[h, f]        (only when asked for)
//
// Replaces the TPU kernel repro/kernels/fused_input.py::fused_input_bwd, the
// backward of repro/kernels/ops.py::fused_input's custom VJP.  dy, g' (B, H),
// x (B, F), W (H, F) f32 → dW (H, F) [, dx (B, F)] f32.  The bias
// cotangent Σ_b du stays a plain tensor op outside, as the JAX package
// leaves it to XLA.
//
// The TPU kernel accumulates dW over batch tiles and dx over hidden tiles
// across its sequential grid.  A GPU grid has no order, so one launch runs
// two roles split by blockIdx, every output with one owner:
//   * role A, a CTA per (32 hidden units × 128 features) dW tile, loops
//     privately over the whole batch in chunks of 32 rows staged in shared
//     memory (du formed from dy and g' as it is staged);
//   * role B (dx only): dx sums over all H = 1,280,000 units, so one owner
//     would leave the card idle.  H is cut into at most 256 fixed chunks;
//     a CTA per (chunk, 32-row batch tile, 128-feature tile) writes its
//     partial sum to a workspace the wrapper allocates, and the last CTA of
//     each (batch tile, feature tile) to finish — an integer ticket taken
//     after __threadfence, the only atomic — adds the partials in chunk
//     order.  The tickets are zeroed by the wrapper for every launch.
// No floating-point atomics: a step is bitwise reproducible.
//
// What bounds it: bytes.  At the paper's 10,000-member width (H = 1,280,000,
// F = 100) and B = 32 the training step (no dx) reads dy and g' (328 MB)
// and writes dW (512 MB) against 8.2 GFLOP: about 0.25 ms at 3.35 TB/s;
// with dx it also reads W (512 MB).  Role A reads dy and g' exactly once
// (a tile spans all of F when F ≤ 128) and writes each dW row coalesced.
//
// Left for later: plain FMA on shared-memory tiles (no tensor cores, no
// cp.async/TMA double buffering); the final dx reduction runs on one CTA
// per (batch tile, feature tile).
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
// role A (dW)
constexpr int AH = 32;    // hidden rows per tile
constexpr int AF = 128;   // features per tile
constexpr int AK = 32;    // batch rows staged per chunk
// role B (dx)
constexpr int BB = 32;    // batch rows per tile
constexpr int BF = 128;   // features per tile
constexpr int BK = 16;    // hidden units staged per step
constexpr int MAX_CHUNKS = 256;
constexpr int SMEM_A = AK * (AH + 1) + AK * (AF + 1);
constexpr int SMEM_B = BB * (BK + 1) + BK * (BF + 1);
constexpr int SMEM = SMEM_A > SMEM_B ? SMEM_A : SMEM_B;

__global__ void __launch_bounds__(THREADS)
fused_input_bwd_kernel(const float* __restrict__ dy,
                       const float* __restrict__ g,
                       const float* __restrict__ x,
                       const float* __restrict__ w, float* __restrict__ dw,
                       float* __restrict__ dx, float* __restrict__ ws,
                       int* __restrict__ tickets, int B, int F, int H,
                       int n_ftiles, int n_dw_ctas, int n_chunks,
                       int chunk_h) {
  __shared__ float smem[SMEM];
  __shared__ int is_last;
  const int t = threadIdx.x;
  const int tx = t % 32;
  const int ty = t / 32;

  if ((int)blockIdx.x < n_dw_ctas) {
    // ---- role A: dW tile (h0 .. h0+32, f0 .. f0+128) over the batch
    float(*du_s)[AH + 1] = reinterpret_cast<float(*)[AH + 1]>(smem);
    float(*x_s)[AF + 1] =
        reinterpret_cast<float(*)[AF + 1]>(smem + AK * (AH + 1));
    const int h0 = (blockIdx.x / n_ftiles) * AH;
    const int f0 = (blockIdx.x % n_ftiles) * AF;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int b0 = 0; b0 < B; b0 += AK) {
      for (int i = t; i < AK * AH; i += THREADS) {
        const int k = i / AH, r = i % AH;
        const int b = b0 + k, hh = h0 + r;
        const size_t at = (size_t)b * H + hh;
        du_s[k][r] = (b < B && hh < H) ? dy[at] * g[at] : 0.f;
      }
      for (int i = t; i < AK * AF; i += THREADS) {
        const int k = i / AF, c = i % AF;
        const int b = b0 + k, f = f0 + c;
        x_s[k][c] = (b < B && f < F) ? x[(size_t)b * F + f] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < AK; ++k) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = du_s[k][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = x_s[k][tx + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int hh = h0 + ty * 4 + i;
      if (hh >= H) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = f0 + tx + 32 * j;
        if (f < F) dw[(size_t)hh * F + f] = acc[i][j];
      }
    }
    return;
  }

  // ---- role B: partial dx of one hidden chunk, then the ordered reduction
  float(*du_s)[BK + 1] = reinterpret_cast<float(*)[BK + 1]>(smem);
  float(*w_s)[BF + 1] =
      reinterpret_cast<float(*)[BF + 1]>(smem + BB * (BK + 1));
  const int r = blockIdx.x - n_dw_ctas;
  const int chunk = r % n_chunks;
  const int group = r / n_chunks;          // (batch tile, feature tile)
  const int b0 = (group / n_ftiles) * BB;
  const int f0 = (group % n_ftiles) * BF;
  const int hs = chunk * chunk_h;
  const int he = min(H, hs + chunk_h);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int hk = hs; hk < he; hk += BK) {
    for (int i = t; i < BB * BK; i += THREADS) {
      const int bb = i / BK, k = i % BK;
      const int b = b0 + bb, hh = hk + k;
      const size_t at = (size_t)b * H + hh;
      du_s[bb][k] = (b < B && hh < he) ? dy[at] * g[at] : 0.f;
    }
    for (int i = t; i < BK * BF; i += THREADS) {
      const int k = i / BF, c = i % BF;
      const int hh = hk + k, f = f0 + c;
      w_s[k][c] = (hh < he && f < F) ? w[(size_t)hh * F + f] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = du_s[ty * 4 + i][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = w_s[k][tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + ty * 4 + i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tx + 32 * j;
      if (f < F) ws[((size_t)chunk * B + b) * F + f] = acc[i][j];
    }
  }
  __threadfence();
  __syncthreads();
  if (t == 0) is_last = atomicAdd(&tickets[group], 1) == n_chunks - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {  // chunk order: deterministic
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = b0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = f0 + tx + 32 * j;
        if (b < B && f < F)
          s[i][j] += __ldcg(&ws[((size_t)c * B + b) * F + f]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tx + 32 * j;
      if (b < B && f < F) dx[(size_t)b * F + f] = s[i][j];
    }
  }
}

}  // namespace

// The dx chunking the wrapper sizes its workspace by: n_chunks chunks of
// chunk_h hidden units (at most MAX_CHUNKS, each a multiple of BK).
extern "C" int fused_input_bwd_chunks(int H, int* chunk_h) {
  int c = (H + MAX_CHUNKS - 1) / MAX_CHUNKS;
  c = ((c + BK - 1) / BK) * BK;
  if (c < BK) c = BK;
  *chunk_h = c;
  return (H + c - 1) / c;
}

// dx, ws, tickets may be null when dx is not wanted (with_dx = 0).  ws holds
// n_chunks · B · F floats, tickets n_btiles · n_ftiles zeroed ints.
extern "C" int fused_input_bwd_f32(const float* dy, const float* g,
                                   const float* x, const float* w, float* dw,
                                   float* dx, float* ws, int* tickets, int B,
                                   int F, int H, int with_dx, void* stream) {
  if (H <= 0 || F <= 0) return 0;
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const long long n_ftiles = (F + AF - 1) / AF;
  const long long n_dw = ((H + AH - 1) / AH) * n_ftiles;
  int chunk_h = 0;
  const int n_chunks = fused_input_bwd_chunks(H, &chunk_h);
  const long long n_dx =
      with_dx ? (long long)n_chunks * ((B + BB - 1) / BB) * n_ftiles : 0;
  if (n_dw + n_dx > INT_MAX) return (int)cudaErrorInvalidValue;
  fused_input_bwd_kernel<<<(unsigned)(n_dw + n_dx), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      dy, g, x, w, dw, dx, ws, tickets, B, F, H, (int)n_ftiles, (int)n_dw,
      n_chunks, chunk_h);
  return (int)cudaGetLastError();
}
