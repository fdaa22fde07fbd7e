// Fused input layer, backward:  du = dy ⊙ g'  (in shared memory, not stored)
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
//   * role A (dW), a store stream.  What bounds it: bytes.  At the paper's
//     10,000-member width (H = 1,280,000, F = 100) and B = 32 it reads dy
//     and g' (328 MB) and writes dW (512 MB), 0.25 ms at 3.35 TB/s; its
//     4.1 G FMA take half of that at the f32 FMA peak, so the inner loop
//     must be FMA-dense too (no tensor cores: TF32 would change the
//     numbers).  A persistent grid, sized by the SM count and the CTAs
//     that fit one (two), walks tasks of `rows` consecutive hidden rows
//     (80 at F = 100; a task's dW is one contiguous span of rows · F
//     floats).  A task's dy and g' come by 16-byte cp.async along H into a
//     ring of STAGES stage buffers, AB batch rows a stage, three stages'
//     copies in flight; each stage is formed once into du = dy · g' in
//     shared memory, transposed to du[row][b], while the other warps sum
//     the stage before (one barrier a stage).  A thread owns FPT = 2
//     consecutive features of ROWS_PER_LANE rows of the task and holds x
//     at its features for the stage's AB batch rows in registers (loaded
//     once where B ≤ AB and F ≤ 2 · THREADS, else again each stage: no
//     shared-memory copy of x, so no limit on B × F); a float4 of du (4
//     batch rows of one row, the same address for the lanes of a row)
//     feeds 8 FMAs, ROWS_AT_ONCE rows side by side.  dW goes out in 8-byte
//     evict-first stores (st.global.cs), so the stream does not push dy
//     and g' out of L2.  Each dW element has one thread that sums over b
//     in ascending order; past AB batch rows it adds each chunk's sum to
//     what it stored for the chunks before (its own store, read back), in
//     chunk order.  Where F % 4 ≠ 0, H % 4 ≠ 0 or a pointer is not 16-byte
//     aligned, a scalar instance does the same work with 4-byte copies,
//     loads and stores (bwd_path() in fused_input.py holds the rule).
//   * role B (dx only): dx sums over all H = 1,280,000 units, so one owner
//     would leave the card idle.  H is cut into at most 256 fixed chunks;
//     a CTA per (chunk, 32-row batch tile, 128-feature tile) writes its
//     partial sum to a workspace the wrapper allocates, and the last CTA of
//     each (batch tile, feature tile) to finish — an integer ticket taken
//     after __threadfence, the only atomic — adds the partials in chunk
//     order.  The tickets are zeroed by the wrapper for every launch.
//     Its CTAs follow role A's in the grid.
// No floating-point atomics: a step is bitwise reproducible.
//
// Under the bf16 compute policy the same body replaces fused_input_bwd on
// bf16 operands (fused_input_bwd_bf16 here, kernel fused_input_bwd_bf16_
// kernel): dy, g', x and W bf16; du = dy · g' rounded to bf16, as the TPU
// kernel multiplies two bf16 tiles; dW (and dx) rounded once from their
// f32 sums.  A stage holds dy and g' as bf16 (4 values an 8-byte
// cp.async); past one 32-row batch chunk dW's running sums live in an f32
// scratch the wrapper allocates.  Bound at 10k, B 32: 420 MB, 0.125 ms.
//
// Left for later: role A reaches about two thirds of its byte bound at F =
// 100.  Its registers are held to 128 (two CTAs an SM, which role B's 256
// CTAs need for one wave in the same launch), so a thread takes 2 features
// and its loop has one shared-memory load per 8 FMAs.  Role B is plain FMA
// on shared-memory tiles (no cp.async double buffering) and its final
// reduction runs on one CTA per (batch tile, feature tile).
#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "bf16.cuh"

namespace {

using bf16x::bf16;

constexpr int THREADS = 256;
// role A (dW)
constexpr int AB = 32;              // batch rows a stage (a chunk of the sum)
constexpr int FPT = 2;              // features a thread owns, x in registers
constexpr int ROWS_PER_LANE = 16;   // rows of a task a thread takes
constexpr int ROWS_AT_ONCE = 4;     // of them summed side by side
constexpr int MAX_ROW_LANES = 5;    // a task is at most 80 rows
constexpr int STAGES = 4;           // the stage ring: 3 stages in flight
constexpr int DU_LD = AB + 4;       // du's row stride: float4 rows
// role B (dx)
constexpr int BB = 32;    // batch rows per tile
constexpr int BF = 128;   // features per tile
constexpr int BK = 16;    // hidden units staged per step
constexpr int MAX_CHUNKS = 256;
constexpr int SMEM_B = BB * (BK + 1) + BK * (BF + 1);

// Role A's task shape: a thread is (row lane, feature group of FPT); nfgt
// groups side by side (a thread takes groups fgi, fgi + nfgt, ... where F
// has more than THREADS of them), nrl row lanes, `rows` = nrl ·
// ROWS_PER_LANE rows a task (a multiple of 4, so 16-byte copies along H
// stay in a task).
struct DwShape {
  int nfg, nfgt, nrl, rows, n_chunks;
  long long n_tasks;
};

__host__ __device__ inline DwShape dw_shape(int B, int F, int H) {
  DwShape s;
  s.nfg = (F + FPT - 1) / FPT;
  s.nfgt = s.nfg < THREADS ? s.nfg : THREADS;
  s.nrl = THREADS / s.nfgt < MAX_ROW_LANES ? THREADS / s.nfgt
                                           : MAX_ROW_LANES;
  s.rows = s.nrl * ROWS_PER_LANE;
  s.n_chunks = (B + AB - 1) / AB;
  s.n_tasks = ((long long)H + s.rows - 1) / s.rows;
  return s;
}

// floats of dynamic shared memory: role A's stage ring (STAGES buffers of
// dy and g', AB × rows each) and two du buffers (rows × DU_LD), or role B's
// tiles
__host__ __device__ inline int smem_floats(int rows) {
  const int a = STAGES * 2 * AB * rows + 2 * rows * DU_LD;
  return a > SMEM_B ? a : SMEM_B;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src) : "memory");
  else if constexpr (BYTES == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src) : "memory");
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

// du = dy · g' as the replaced kernel forms it: f32 as it is; from bf16
// tiles the product of two bf16 values, itself a bf16 value (rounded to
// nearest even; repro/kernels/fused_input.py:216)
__device__ __forceinline__ float du_of(float d, float g) { return d * g; }
__device__ __forceinline__ float du_of(bf16 d, bf16 g) {
  return bf16x::round_bf16(__bfloat162float(d) * __bfloat162float(g));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most STAGES − 2 of this thread's commit groups are pending:
// with the groups of stages up to s + STAGES − 1 committed, stage s + 1's
// has landed
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
}

// A thread's FPT = 2 features f0, f0 + 1 of a row: one 8-byte access at
// VEC = 4 (F and the row starts then multiples of 4 floats), else two
// 4-byte ones, masked at F
static_assert(FPT == 2, "load_f and store_f move float2");

template <int VEC>
__device__ __forceinline__ void load_f(float (&v)[FPT],
                                       const float* __restrict__ p, int n) {
  if constexpr (VEC == 4) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < FPT; ++i) v[i] = i < n ? __ldg(p + i) : 0.f;
  }
}

// bf16 x: one 4-byte load of the pair at VEC = 4, else two 2-byte ones
template <int VEC>
__device__ __forceinline__ void load_f(float (&v)[FPT],
                                       const bf16* __restrict__ p, int n) {
  if constexpr (VEC == 4) {
    const float2 t = bf16x::load2(p);
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < FPT; ++i) v[i] = i < n ? widen(p[i]) : 0.f;
  }
}

// a dW store that is not read again here: evict-first; past the first
// batch chunk the chunk's sum is added to the thread's own earlier store
template <int VEC>
__device__ __forceinline__ void store_f(float* __restrict__ p,
                                        float (&v)[FPT], int n, bool add) {
  if constexpr (VEC == 4) {
    if (add) {
      const float2 o = __ldcg(reinterpret_cast<const float2*>(p));
      v[0] = o.x + v[0]; v[1] = o.y + v[1];
    }
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int i = 0; i < FPT; ++i)
      if (i < n) __stcs(p + i, add ? __ldcg(p + i) + v[i] : v[i]);
  }
}

// bf16 dW: the f32 sum rounded once.  Past one batch chunk the chunks'
// sums run in the f32 scratch dws as the f32 instance runs them in dW
// (each added to the thread's own earlier store, in chunk order), and the
// last chunk's total is rounded into dW.
template <int VEC>
__device__ __forceinline__ void store_f(bf16* __restrict__ p,
                                        float* __restrict__ ws,
                                        float (&v)[FPT], int n, bool add,
                                        bool last) {
  if (!last) {
    store_f<VEC>(ws, v, n, add);
    return;
  }
  if (add) {
#pragma unroll
    for (int i = 0; i < FPT; ++i)
      if (i < n) v[i] = __ldcg(ws + i) + v[i];
  }
  if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<unsigned*>(p), bf16x::pack2(v[0], v[1]));
  } else {
#pragma unroll
    for (int i = 0; i < FPT; ++i)
      if (i < n) bf16x::store1<true>(p + i, v[i]);
  }
}

// A thread's ROWS_PER_LANE rows rl, rl + nrl, ... of a stage at features
// f0 … f0 + FPT − 1: each sum over the stage's nb batch rows in ascending
// order (FULL: nb == AB, no check), ROWS_AT_ONCE rows side by side, then
// stored (added to the earlier chunks' sum where `add`; a bf16 dW through
// its f32 scratch dws until the `last` chunk).
template <bool FULL, int VEC, typename T>
__device__ __forceinline__ void row_sums(const float* du_cur,
                                         const float (&xr)[AB][FPT], int rl,
                                         int nrl, int nb, int nr,
                                         long long h0, T* __restrict__ dw,
                                         float* __restrict__ dws, int F,
                                         int f0, bool add, bool last) {
#pragma unroll 1
  for (int k = 0; k < ROWS_PER_LANE; k += ROWS_AT_ONCE) {
    const float* d[ROWS_AT_ONCE];
    float acc[ROWS_AT_ONCE][FPT];
#pragma unroll
    for (int j = 0; j < ROWS_AT_ONCE; ++j) {
      d[j] = du_cur + (rl + (k + j) * nrl) * DU_LD;
#pragma unroll
      for (int e = 0; e < FPT; ++e) acc[j][e] = 0.f;
    }
#pragma unroll
    for (int b = 0; b < AB; b += 4) {
      if (FULL || b < nb) {
        float4 u[ROWS_AT_ONCE];
#pragma unroll
        for (int j = 0; j < ROWS_AT_ONCE; ++j)
          u[j] = *reinterpret_cast<const float4*>(d[j] + b);
#pragma unroll
        for (int j = 0; j < ROWS_AT_ONCE; ++j)
#pragma unroll
          for (int e = 0; e < FPT; ++e)
            acc[j][e] = fmaf(u[j].x, xr[b][e], acc[j][e]);
#pragma unroll
        for (int j = 0; j < ROWS_AT_ONCE; ++j)
#pragma unroll
          for (int e = 0; e < FPT; ++e)
            acc[j][e] = fmaf(u[j].y, xr[b + 1][e], acc[j][e]);
#pragma unroll
        for (int j = 0; j < ROWS_AT_ONCE; ++j)
#pragma unroll
          for (int e = 0; e < FPT; ++e)
            acc[j][e] = fmaf(u[j].z, xr[b + 2][e], acc[j][e]);
#pragma unroll
        for (int j = 0; j < ROWS_AT_ONCE; ++j)
#pragma unroll
          for (int e = 0; e < FPT; ++e)
            acc[j][e] = fmaf(u[j].w, xr[b + 3][e], acc[j][e]);
      }
    }
#pragma unroll
    for (int j = 0; j < ROWS_AT_ONCE; ++j) {
      const int r = rl + (k + j) * nrl;
      if (r < nr) {
        const size_t at = (size_t)(h0 + r) * F + f0;
        if constexpr (std::is_same<T, bf16>::value)
          store_f<VEC>(dw + at, dws + at, acc[j], F - f0, add, last);
        else
          store_f<VEC>(dw + at, acc[j], F - f0, add);
      }
    }
  }
}

// Role A: this CTA's tasks blockIdx.x, blockIdx.x + n_ctas, ..., each in
// n_chunks stages of AB batch rows.
// T: the operands' type, float or bf16 (a bf16 stage holds dy and g' as
// they are, in the first half of its f32 buffer: 4 values an 8-byte copy).
template <int VEC, typename T>
__device__ __forceinline__ void dw_role(const T* __restrict__ dy,
                                        const T* __restrict__ g,
                                        const T* __restrict__ x,
                                        T* __restrict__ dw,
                                        float* __restrict__ dws, int B, int F,
                                        int H, int n_ctas, float* smem) {
  const DwShape sh = dw_shape(B, F, H);
  const int rows = sh.rows;
  float* du_s = smem + STAGES * 2 * AB * rows;  // [2][rows][DU_LD]
  const int t = threadIdx.x;
  const int fgi = t % sh.nfgt, rl = t / sh.nfgt;  // rl ≥ nrl: no rows
  const bool reload_x = sh.n_chunks > 1 || sh.nfg > sh.nfgt;
  float xr[AB][FPT];
  const int cta = blockIdx.x;
  const long long n_stages =
      cta < sh.n_tasks ? ((sh.n_tasks - 1 - cta) / n_ctas + 1) * sh.n_chunks
                       : 0;

  // the stage's copies of dy and g' rows b0 … b0 + nb − 1, units h0 … h0 +
  // nr − 1, into buffer s % STAGES ([dy | g'][AB][rows]); one commit group
  // each, an empty one past the last stage.  Item i is vector v of stage
  // row q = i / per_b (dy's rows, then those of g'), stepped without a
  // division.
  auto issue = [&](long long s) {
    if (s < n_stages) {
      const long long h0 = (cta + s / sh.n_chunks * n_ctas) * rows;
      const int b0 = (int)(s % sh.n_chunks) * AB;
      const int nb = min(AB, B - b0);
      const int per_b = (int)min((long long)rows, H - h0) / VEC;
      const int dq = THREADS / per_b, dv = THREADS - dq * per_b;
      T* dst = reinterpret_cast<T*>(smem + (s % STAGES) * 2 * AB * rows);
      int q = t / per_b, v = t - q * per_b;
      while (q < 2 * nb) {
        const int which = q >= nb, b = q - which * nb;
        T* to = dst + (which * AB + b) * rows + v * VEC;
        const T* from =
            (which ? g : dy) + (size_t)(b0 + b) * H + h0 + v * VEC;
        if constexpr (sizeof(T) * VEC >= 4)
          cp_async<(int)sizeof(T) * VEC>(to, from);
        else
          *to = *from;  // one bf16: a load and a store
        q += dq;
        v += dv;
        if (v >= per_b) { v -= per_b; ++q; }
      }
    }
    cp_async_commit();
  };

  // du of stage s into du buffer s % 2, from its stage buffer: dy · g'
  // transposed to [row][b], zeros past the stage's rows and batch rows.
  // Item i is row r = i % rows, batch rows b4 … b4 + 3 with b4 = 4 ·
  // (i / rows), stepped from (r_t, b4_t) without a division.
  const int r_t = t % rows, b4_t = t / rows * 4;
  const int d_r = THREADS % rows, d_b4 = THREADS / rows * 4;
  auto form_du = [&](long long s) {
    const long long h0 = (cta + s / sh.n_chunks * n_ctas) * rows;
    const int nb = min(AB, B - (int)(s % sh.n_chunks) * AB);
    const int nr = (int)min((long long)rows, H - h0);
    const T* sdy = reinterpret_cast<const T*>(smem +
                                              (s % STAGES) * 2 * AB * rows);
    const T* sg = sdy + AB * rows;
    float* du = du_s + (s & 1) * rows * DU_LD;
    for (int r = r_t, b4 = b4_t; b4 < AB;) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int b = b4 + k;
        v[k] = b < nb && r < nr ? du_of(sdy[b * rows + r], sg[b * rows + r])
                                : 0.f;
      }
      *reinterpret_cast<float4*>(du + r * DU_LD + b4) =
          make_float4(v[0], v[1], v[2], v[3]);
      r += d_r;
      b4 += d_b4;
      if (r >= rows) { r -= rows; b4 += 4; }
    }
  };

  for (int j = 0; j < STAGES - 1; ++j) issue(j);
  cp_async_wait_ring();
  __syncthreads();  // stage 0 landed
  if (n_stages > 0) form_du(0);
  for (long long s = 0; s < n_stages; ++s) {
    const long long h0 = (cta + s / sh.n_chunks * n_ctas) * rows;
    const int c = (int)(s % sh.n_chunks), b0 = c * AB;
    const int nb = min(AB, B - b0);
    const int nr = (int)min((long long)rows, H - h0);
    issue(s + STAGES - 1);  // into the buffer stage s − 1 was read from
    cp_async_wait_ring();
    // stage s + 1 landed; du of stage s is formed; every thread is done
    // with stage s − 1's du, which stage s + 1's takes the place of
    __syncthreads();
    if (s + 1 < n_stages) form_du(s + 1);  // beside the other warps' sums
    if (rl >= sh.nrl) continue;
    const float* du_cur = du_s + (s & 1) * rows * DU_LD;
    for (int fg = fgi; fg < sh.nfg; fg += sh.nfgt) {
      const int f0 = fg * FPT;
      // x of the chunk's AB batch rows at this thread's features, in
      // registers: loaded once where one chunk and one group are all there
      // is, else again each stage
      if (s == 0 || reload_x) {
#pragma unroll
        for (int b = 0; b < AB; ++b) {
          if (b0 + b < B) {
            load_f<VEC>(xr[b], x + (size_t)(b0 + b) * F + f0, F - f0);
          } else {
#pragma unroll
            for (int e = 0; e < FPT; ++e) xr[b][e] = 0.f;
          }
        }
      }
      const bool last = c == sh.n_chunks - 1;
      if (nb == AB)
        row_sums<true, VEC>(du_cur, xr, rl, sh.nrl, nb, nr, h0, dw, dws, F,
                            f0, c > 0, last);
      else
        row_sums<false, VEC>(du_cur, xr, rl, sh.nrl, nb, nr, h0, dw, dws, F,
                             f0, c > 0, last);
    }
  }
}

// The kernel's body.  T float, or bf16 under the compute policy: dy, g', x
// and W bf16, du rounded to bf16, dW and dx rounded once from their f32
// sums (dws: dW's f32 scratch past one batch chunk; ws holds dx's f32
// partials either way)
template <int VEC, typename T>
__device__ __forceinline__ void bwd_body(
    const T* __restrict__ dy, const T* __restrict__ g,
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ dw,
    float* __restrict__ dws, T* __restrict__ dx, float* __restrict__ ws,
    int* __restrict__ tickets, int B, int F, int H, int n_ftiles,
    int n_dw_ctas, int n_chunks, int chunk_h) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int is_last;
  const int t = threadIdx.x;
  const int tx = t % 32;
  const int ty = t / 32;

  if ((int)blockIdx.x < n_dw_ctas) {
    dw_role<VEC, T>(dy, g, x, dw, dws, B, F, H, n_dw_ctas, smem);
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
      du_s[bb][k] = (b < B && hh < he) ? du_of(dy[at], g[at]) : 0.f;
    }
    for (int i = t; i < BK * BF; i += THREADS) {
      const int k = i / BF, c = i % BF;
      const int hh = hk + k, f = f0 + c;
      w_s[k][c] = (hh < he && f < F) ? widen(w[(size_t)hh * F + f]) : 0.f;
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
      if (b < B && f < F) {
        if constexpr (std::is_same<T, bf16>::value)
          dx[(size_t)b * F + f] = __float2bfloat16_rn(s[i][j]);
        else
          dx[(size_t)b * F + f] = s[i][j];
      }
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(THREADS, 2)
fused_input_bwd_kernel(const float* __restrict__ dy,
                       const float* __restrict__ g,
                       const float* __restrict__ x,
                       const float* __restrict__ w, float* __restrict__ dw,
                       float* __restrict__ dx, float* __restrict__ ws,
                       int* __restrict__ tickets, int B, int F, int H,
                       int n_ftiles, int n_dw_ctas, int n_chunks,
                       int chunk_h) {
  bwd_body<VEC, float>(dy, g, x, w, dw, nullptr, dx, ws, tickets, B, F, H,
                       n_ftiles, n_dw_ctas, n_chunks, chunk_h);
}

template <int VEC>
__global__ void __launch_bounds__(THREADS, 2)
fused_input_bwd_bf16_kernel(const bf16* __restrict__ dy,
                            const bf16* __restrict__ g,
                            const bf16* __restrict__ x,
                            const bf16* __restrict__ w, bf16* __restrict__ dw,
                            float* __restrict__ dws, bf16* __restrict__ dx,
                            float* __restrict__ ws, int* __restrict__ tickets,
                            int B, int F, int H, int n_ftiles, int n_dw_ctas,
                            int n_chunks, int chunk_h) {
  bwd_body<VEC, bf16>(dy, g, x, w, dw, dws, dx, ws, tickets, B, F, H,
                      n_ftiles, n_dw_ctas, n_chunks, chunk_h);
}

// the kernel of an instance, as the runtime API's function handle
template <int VEC, typename T>
const void* bwd_kernel() {
  if constexpr (std::is_same<T, bf16>::value)
    return reinterpret_cast<const void*>(fused_input_bwd_bf16_kernel<VEC>);
  else
    return reinterpret_cast<const void*>(fused_input_bwd_kernel<VEC>);
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

namespace {

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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// one launch of either instance: role A's persistent CTAs (the SMs times
// the CTAs that fit one, at most one a task), then role B's
template <int VEC, typename T>
int launch(const T* dy, const T* g, const T* x, const T* w, T* dw,
           float* dws, T* dx, float* ws, int* tickets, int B, int F, int H,
           int with_dx, cudaStream_t stream) {
  const DwShape sh = dw_shape(B, F, H);
  const size_t smem = sizeof(float) * smem_floats(sh.rows);
  static size_t allowed = 0;   // the kernel's dynamic shared-memory limit
  static size_t at_smem = 0;   // per_sm is the occupancy at this smem
  static int per_sm = 0;
  if (allowed == 0) {
    const size_t most =
        sizeof(float) * smem_floats(MAX_ROW_LANES * ROWS_PER_LANE);
    if (cudaFuncSetAttribute(bwd_kernel<VEC, T>(),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)most) != cudaSuccess)
      return (int)cudaGetLastError();
    allowed = most;
  }
  if (smem > allowed) return (int)cudaErrorInvalidValue;
  if (smem != at_smem) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, bwd_kernel<VEC, T>(), THREADS, smem) !=
        cudaSuccess)
      return (int)cudaGetLastError();
    at_smem = smem;
  }
  const long long n_ftiles = (F + BF - 1) / BF;
  const long long n_dw = std::min<long long>(
      sh.n_tasks, (long long)sm_count() * std::max(per_sm, 1));
  int chunk_h = 0;
  const int n_chunks = fused_input_bwd_chunks(H, &chunk_h);
  const long long n_dx =
      with_dx ? (long long)n_chunks * ((B + BB - 1) / BB) * n_ftiles : 0;
  if (n_dw + n_dx > INT_MAX) return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<T, bf16>::value)
    fused_input_bwd_bf16_kernel<VEC><<<(unsigned)(n_dw + n_dx), THREADS,
                                       smem, stream>>>(
        dy, g, x, w, dw, dws, dx, ws, tickets, B, F, H, (int)n_ftiles,
        (int)n_dw, n_chunks, chunk_h);
  else
    fused_input_bwd_kernel<VEC><<<(unsigned)(n_dw + n_dx), THREADS, smem,
                                  stream>>>(
        dy, g, x, w, dw, dx, ws, tickets, B, F, H, (int)n_ftiles, (int)n_dw,
        n_chunks, chunk_h);
  return (int)cudaGetLastError();
}

}  // namespace

// dx, ws, tickets may be null when dx is not wanted (with_dx = 0).  ws holds
// n_chunks · B · F floats, tickets n_btiles · n_ftiles zeroed ints.  The
// vec4 instance where F and H are multiples of 4 and dy, g', x and dW are
// 16-byte aligned, else the scalar one.
extern "C" int fused_input_bwd_f32(const float* dy, const float* g,
                                   const float* x, const float* w, float* dw,
                                   float* dx, float* ws, int* tickets, int B,
                                   int F, int H, int with_dx, void* stream) {
  if (H <= 0 || F <= 0) return 0;
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = F % 4 == 0 && H % 4 == 0 && aligned16(dy) &&
                   aligned16(g) && aligned16(x) && aligned16(dw);
  return (vec ? launch<4, float> : launch<1, float>)(
      dy, g, x, w, dw, nullptr, dx, ws, tickets, B, F, H, with_dx, s);
}

// The bf16 compute policy: dy, g', x, W bf16 → dW [, dx] bf16.  dws holds
// H · F floats (dW's f32 sums, allocated by the wrapper) where B > 32,
// else may be null.  The vec4 instance where
// F and H are multiples of 4 and dy, g', x and dW are 8-byte aligned (4
// values a copy), else the scalar one.
extern "C" int fused_input_bwd_bf16(const bf16* dy, const bf16* g,
                                    const bf16* x, const bf16* w, bf16* dw,
                                    float* dws, bf16* dx, float* ws,
                                    int* tickets, int B, int F, int H,
                                    int with_dx, void* stream) {
  if (H <= 0 || F <= 0) return 0;
  if (B <= 0 || (B > AB && dws == nullptr)) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = F % 4 == 0 && H % 4 == 0 && bf16x::aligned8(dy) &&
                   bf16x::aligned8(g) && bf16x::aligned8(x) &&
                   bf16x::aligned8(dw);
  return (vec ? launch<4, bf16> : launch<1, bf16>)(
      dy, g, x, w, dw, dws, dx, ws, tickets, B, F, H, with_dx, s);
}
