// Fused input layer, forward:  y = act(x · Wᵀ + b) · mask
//                    training:  also g' = act'(x · Wᵀ + b) · mask
//
// Replaces the TPU kernel repro/kernels/fused_input.py::fused_input_fwd,
// with_deriv=False (serving, repro/kernels/ops.py::fused_input_infer:
// fused_input_infer_f32 here) and with_deriv=True (training, the forward of
// ops.py::fused_input's custom VJP: fused_input_train_f32 here).  One kernel
// template, the flag DERIV selecting the second output.
//
// The same template, with int8 weights, replaces
// repro/kernels/fused_input.py::fused_input_int8_fwd (the int8 serve copy,
// ops.py::fused_input_infer_int8: fused_input_infer_i8 here).  W_q is
// (H, F_pad) int8, stored pre-padded to F_pad (104 for F = 100); x stays
// (B, F) and the kernel reads only the first F bytes of each weight row.
// Each hidden row block of `block` rows has one f32 scale (H / block,).
//
// The int8 serve copy under the bf16 compute policy (fused_input_infer_i8_bf16
// here, kernel fused_input_i8_bf16_kernel; JAX's fused_input_int8_fwd on
// bf16 x, repro/kernels/fused_input.py:146-158, out dtype x's at :189): the
// int8 weight policy with bf16 activations — x widened into the same f32
// shared rows, y stored in bf16, rounded once.  The weights' type and the
// activations' type are separate parameters of the kernel body
// (fused_input_body<VEC, W, X, ...>); fused_input_kernel keeps X = Act<W>.
//
// Under the bf16 compute policy (DESIGN.md §7) the same template with bf16
// weights replaces fused_input_fwd on bf16 operands (fused_input_infer_bf16
// and fused_input_train_bf16 here): x and W bf16, y and g' bf16, each
// rounded once from its f32 value; the bias, the mask and every sum f32.
// x is widened into the same f32 shared rows; W crosses memory and the
// ring as bf16 (half the bytes), 4 values an 8-byte cp.async, widened in
// registers as a thread loads its 8 units' weights (a bf16 row of F = 100
// is 200 bytes, 8-byte aligned, so the vec4 instance takes it without a
// padded copy); y and g' leave 4 values an 8-byte store.  Bound at 10k,
// B 32: 348 MB of bytes, 0.10 ms (g' 0.13); the FMA loop, unchanged, is
// what sets its time.
//
// x (B, F), W (H, F), b and mask (H,) f32, act ids one per population block
// (H / block,) int32 → y (B, H) f32 [and g' (B, H) f32].  The
// pre-activation z never reaches device memory: the bias, the block's
// activation (and its derivative) and the padding mask are applied on chip,
// in registers and shared memory.
//
// What bounds it.  At the paper's 10,000-member width (H = 1,280,000, F =
// 100) and a flush of B = 32, one launch must read W (512 MB) and write y
// (164 MB; g' 164 MB more): 0.20 ms (0.25) at 3.35 TB/s, against 4.1 G FMA,
// 0.12 ms at the f32 FMA peak, and 41 M activations (82 M with g').  Bytes
// bound it, but only just, so the FMA loop and the epilogue must run beside
// the stream.  With int8 weights W is 133 MB and the FMA work is the bound.
//
// The design: a W-streaming persistent kernel.
//   * One 256-thread CTA an SM (its shared memory), each warp its own
//     pipeline: it walks warp tiles of 64 hidden units in grid-stride order,
//     a tile's W in chunks of kc features (28 at F = 100), and copies the
//     next chunk by cp.async (16 bytes a copy; 4 int8 weights a copy) into
//     a two-stage ring while it computes this one.  No block-wide barrier
//     in the loop.
//   * x stays resident: staged once per CTA (all B rows, zeros past B) and
//     shared by the warps.  For B > 32 a warp loops over its batch tiles
//     against the W in its stage, so W is read from device memory once
//     whatever B is.  Where x does not fit beside the ring (large B · F),
//     a stage holds a chunk of the tile's W and of one batch tile's x.
//   * A lane is (batch group bg of 4, unit group ug of 8): it holds 8 batch
//     rows bg, bg + 4, … (RB = 8 at B > 16; 4, 2 or 1 below, so no FMAs go
//     to a batch tile larger than B needs) for 8 units, 64 accumulators.
//     Every 4 features it loads its 8 units' weights (one 16-byte load
//     each; over int8 one 4-byte load, converted in registers) and 8 float4
//     of x: 16 loads for 256 FMAs.  A thread's unit j sits in shared row
//     8j + ug, at a row stride of an odd number of 16-byte groups (4-byte
//     words over int8), so each load's 8 unit groups, and the x loads' 4
//     batch groups, fall in distinct banks.  The units are consecutive
//     (8 · ug + j) where a block holds the whole tile, else 8 apart
//     (ug + 8j), so that each of a thread's units shares one block with the
//     same unit of the warp's other lanes wherever block ≥ 8.
//   * One FMA chain per output, in k order: acc = 0, then fmaf(x[b, k],
//     w[h, k], acc) for k = 0 … F − 1 (a tail of F % 4 single steps), no
//     split-K, no tensor cores.  This is the chain the TPU port's first
//     CUDA kernel ran (its zero padding of F added exactly nothing), so the
//     outputs keep its bits.
//   * int8 is a weight policy of the same core: the ring holds int8 bytes
//     (a quarter of the f32 bytes and of the shared memory), and a thread
//     forms each weight as (float)q · s, s its row block's scale: an exact
//     integer (q + 128 byte-permuted into the float 2^23 + q + 128, minus
//     2^23 + 128, on the FMA pipe: the integer-to-float converter runs at
//     an eighth of the FMA rate) and one rounded product, what the plain
//     version computes.  So the int8 kernel is bitwise the f32 kernel on
//     the dequantized weight.
//   * Epilogue: the bias, scale, mask and activation ids are looked up once
//     per unit per tile.  z = acc + b goes to the warp's z tile in shared
//     memory, and each row's activation (and derivative) runs in a loop over
//     its units that is unrolled twice only: one activation's code, chosen
//     once where the warp tile's units share one, instead of 64 inlined
//     copies of all ten (which stalled on instruction fetch).  Each lane
//     then reads back 8 consecutive units of its row, applies the mask and
//     stores them as two evict-first (st.global.cs) 16-byte stores.
// Where F, H or the weight row stride is not a multiple of 4, or x, W, y or
// g' does not start on a 16-byte boundary, a scalar instance does the same
// work with 4-byte copies (int8: 1-byte loads) and 4-byte stores;
// fwd_path() in fused_input.py holds the rule.
//
// Left for later: the FMA loop, 256 FMAs and 16 shared loads a step, runs
// at about half the f32 FMA peak with nothing else in the kernel, and with
// two warps a scheduler the stream does not fully hide behind it.  Four
// threads (batch groups) convert each int8 weight.
#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "activations.cuh"
#include "bf16.cuh"

namespace {

using bf16x::bf16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int U = 8;               // hidden units a thread
constexpr int UNITS = 8 * U;       // hidden units a warp tile
constexpr int STAGES = 2;          // a warp's ring: 1 stage in flight
constexpr int ZLD = UNITS + 8;     // a row of a warp's z tile (floats)
// a warp's epilogue scratch: its z tile (32 rows), a row of g' for each
// batch group, and each lane's U activation ids
constexpr int WARP_SCRATCH = (32 + 4) * ZLD * 4 + 32 * U * 4;
constexpr int SCRATCH = WARPS * WARP_SCRATCH;
constexpr int SMEM_MAX = 232448;   // the dynamic shared memory a block may use
// a plan that does not hold x resident fits at kc = 4 whatever B: f32 W and
// 32 rows of x a stage, and the epilogue scratch
static_assert(SCRATCH + WARPS * STAGES * (UNITS + 32) * 4 * 4 <= SMEM_MAX,
              "the smallest stage must fit every warp's ring");

// the largest multiple of 4 not above n whose quarter is odd (0 if none): a
// row stride whose 16-byte groups, or 4-byte words, spread 8 consecutive
// rows over distinct banks
inline int odd_quads_below(int n) {
  const int s = n / 4 * 4;
  return s <= 0 ? 0 : (s / 4) % 2 ? s : s - 4;
}
// the same, rounded up
inline int odd_quads(int n) {
  const int s = (n + 3) / 4 * 4;
  return (s / 4) % 2 ? s : s + 4;
}

// A launch's shape.  A stage holds kc features of a warp tile's W and, where
// x is not resident, of one batch tile's x; F is cut into n_kc chunks of
// about equal size.  A tile is one item (its W stays in its stage for every
// batch tile) where one stage holds all of F, else n_bt · n_kc items in
// (batch tile, chunk) order.
struct Plan {
  int rb, bt, n_bt;   // batch rows a thread, a batch tile (4 · rb), tiles
  int resident;       // x staged once per CTA (x_bytes)
  int kc, n_kc;       // features a stage, stages a (tile, batch tile)
  int per_tile;       // items a tile
  int sx;             // x's shared row stride (floats); W's is kc
  int w_bytes, stage_bytes, x_bytes, smem;
  int n_tiles;        // warp tiles
  int contig;         // a thread's units consecutive (a tile in one block)
};

inline Plan make_plan(int B, int F, int H, int block, int w_size) {
  Plan p;
  p.rb = B <= 4 ? 1 : B <= 8 ? 2 : B <= 16 ? 4 : 8;
  p.bt = 4 * p.rb;
  p.n_bt = (B + p.bt - 1) / p.bt;
  p.n_tiles = (H + UNITS - 1) / UNITS;
  p.contig = block % UNITS == 0;
  const int ring_k = WARPS * STAGES * UNITS * w_size;  // a feature's bytes
  p.sx = odd_quads(F);
  const long long xb = (long long)p.n_bt * p.bt * p.sx * 4;
  p.resident = xb + SCRATCH + 4LL * ring_k <= SMEM_MAX;
  p.x_bytes = p.resident ? (int)xb : 0;
  const int kc_max =
      p.resident
          ? odd_quads_below((SMEM_MAX - SCRATCH - p.x_bytes) / ring_k)
          : odd_quads_below((SMEM_MAX - SCRATCH) /
                            (WARPS * STAGES * (UNITS * w_size + p.bt * 4)));
  const int n_kc = (F + kc_max - 1) / kc_max;
  p.kc = std::min(kc_max, odd_quads((F + n_kc - 1) / n_kc));
  p.n_kc = (F + p.kc - 1) / p.kc;
  p.per_tile = p.resident && p.n_kc == 1 ? 1 : p.n_bt * p.n_kc;
  if (!p.resident) p.sx = p.kc;
  p.w_bytes = UNITS * p.kc * w_size;   // a multiple of 16: kc % 4 == 0
  p.stage_bytes = p.w_bytes + (p.resident ? 0 : p.bt * p.kc * 4);
  p.smem = p.x_bytes + SCRATCH + WARPS * STAGES * p.stage_bytes;
  return p;
}

// The activations' type of an instance: bf16 with bf16 weights (the
// compute policy casts both operands), else f32
template <typename W>
using Act = typename std::conditional<std::is_same<W, bf16>::value, bf16,
                                      float>::type;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

// ---- copies ------------------------------------------------------------

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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// this thread's copies of all but the newest STAGES − 2 commit groups have
// landed
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
}

// VEC elements from global to shared memory: a cp.async of 16, 8 or 4
// bytes, or (one int8, one bf16) a load and a store
template <int VEC, typename W>
__device__ __forceinline__ void copy_elems(W* dst, const W* src) {
  constexpr int BYTES = VEC * (int)sizeof(W);
  if constexpr (BYTES == 16 || BYTES == 8 || BYTES == 4)
    cp_async<BYTES>(dst, src);
  else if constexpr (std::is_same<W, bf16>::value)
    *dst = *src;
  else
    *dst = __ldg(src);
}

// VEC bf16 activations from global memory, widened into f32 shared slots
// (a load and a store: the stage holds x as f32 whatever its type)
template <int VEC>
__device__ __forceinline__ void copy_elems_widened(float* dst,
                                                   const bf16* src) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(dst) = bf16x::ldg4(src);
  } else {
    *dst = __bfloat162float(*src);
  }
}

// A warp's copy of rows 0 … nr − 1 of per_row groups of VEC elements:
// lane `lane` takes groups lane, lane + 32, …, each (r, c) stepped without
// a division; dst_row and src_row map a row to its pointers.
template <int VEC, typename W, class Dst, class Src>
__device__ __forceinline__ void copy_rows(int nr, int per_row, int lane,
                                          Dst dst_row, Src src_row) {
  int r = lane / per_row, c = lane - r * per_row;
  const int dr = 32 / per_row, dc = 32 - dr * per_row;
  while (r < nr) {
    copy_elems<VEC, W>(dst_row(r) + c * VEC, src_row(r) + c * VEC);
    r += dr;
    c += dc;
    if (c >= per_row) { c -= per_row; ++r; }
  }
}

// ---- the weight policies ----------------------------------------------

// a thread's U units' weights at features k … k + 3 (row[j] the unit's
// shared row), as f32: stored f32 as they are; bf16 widened (one 8-byte
// load); int8 as (float)q · s[j]
__device__ __forceinline__ void weights4(float (&wv)[U][4],
                                         const float* const (&row)[U],
                                         const float (&)[U], int k) {
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const float4 t = *reinterpret_cast<const float4*>(row[j] + k);
    wv[j][0] = t.x; wv[j][1] = t.y; wv[j][2] = t.z; wv[j][3] = t.w;
  }
}

__device__ __forceinline__ void weights4(float (&wv)[U][4],
                                         const bf16* const (&row)[U],
                                         const float (&)[U], int k) {
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const float4 t = bf16x::load4(row[j] + k);
    wv[j][0] = t.x; wv[j][1] = t.y; wv[j][2] = t.z; wv[j][3] = t.w;
  }
}

__device__ __forceinline__ void weights4(float (&wv)[U][4],
                                         const int8_t* const (&row)[U],
                                         const float (&s)[U], int k) {
#pragma unroll
  for (int j = 0; j < U; ++j) {
    // q + 128 in each byte, then 0x4B0000(q + 128) = 2^23 + q + 128 as a
    // float: minus 2^23 + 128 it is q, exactly
    const unsigned q =
        *reinterpret_cast<const unsigned*>(row[j] + k) ^ 0x80808080u;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      wv[j][e] = (__uint_as_float(__byte_perm(q, 0x4B000000u, 0x7540 | e)) -
                  8388736.f) * s[j];
  }
}

__device__ __forceinline__ float weight1(const float* row, float, int k) {
  return row[k];
}
__device__ __forceinline__ float weight1(const int8_t* row, float s, int k) {
  return (float)row[k] * s;
}
__device__ __forceinline__ float weight1(const bf16* row, float, int k) {
  return __bfloat162float(row[k]);
}

// acc[i][j] += Σ_k x[row 4i, k] · w[unit j, k] over the span's nk
// features, each output's chain in k order: xr is the thread's first x row
// at the span's first feature (rows 4 · sx floats apart: sx4), row[j] unit
// j's shared W row.
template <int RB, typename W>
__device__ __forceinline__ void fma_span(float (&acc)[RB][U],
                                         const W* const (&row)[U],
                                         const float (&s)[U],
                                         const float* xr, int sx4, int nk) {
  int k = 0;
#pragma unroll 1
  for (; k + 4 <= nk; k += 4) {
    float wv[U][4];
    weights4(wv, row, s, k);
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const float4 xv = *reinterpret_cast<const float4*>(xr + i * sx4 + k);
#pragma unroll
      for (int j = 0; j < U; ++j) acc[i][j] = fmaf(xv.x, wv[j][0], acc[i][j]);
#pragma unroll
      for (int j = 0; j < U; ++j) acc[i][j] = fmaf(xv.y, wv[j][1], acc[i][j]);
#pragma unroll
      for (int j = 0; j < U; ++j) acc[i][j] = fmaf(xv.z, wv[j][2], acc[i][j]);
#pragma unroll
      for (int j = 0; j < U; ++j) acc[i][j] = fmaf(xv.w, wv[j][3], acc[i][j]);
    }
  }
  for (; k < nk; ++k) {  // the F % 4 tail
    float wv[U];
#pragma unroll
    for (int j = 0; j < U; ++j) wv[j] = weight1(row[j], s[j], k);
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const float xv = xr[i * sx4 + k];
#pragma unroll
      for (int j = 0; j < U; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
    }
  }
}

// ---- the epilogue -------------------------------------------------------
//
// A warp's z = acc + b goes to its z tile in shared memory, a thread's unit
// j in column 8j + ug (conflict-free), and the activation runs over each
// row's U units in a loop unrolled twice only: one activation's code, not
// U · RB inlined copies of all ten.  Then each lane reads back U
// consecutive units of its row, applies their mask and stores them, U / 4
// 16-byte stores at VEC = 4.

// a tile's per-unit values, looked up once: bias and (int8) scale of a
// thread's units, the mask of the U consecutive units it stores
struct Units {
  float b[U], s[U], mo[U];
  int id0;          // the activation of unit 0 of the tile
};

// y (and g') of a batch tile's rows (this thread's bt0 + bg, + 4, … < B) at
// the warp tile's units h0 … < H.  ID ≥ 0: every unit takes activation ID;
// else each its own (ids[32 · j]: this lane's unit j).  Every lane of the
// warp calls it.
template <int ID, int VEC, bool DERIV, typename X>
__device__ __forceinline__ void out_rows(int n, const Units& un, float* zb,
                                         float* dz, const int* ids,
                                         X* __restrict__ y,
                                         X* __restrict__ g, int b0,
                                         int B, int H, int h0, int ug,
                                         bool contig) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    float* zr = zb + 4 * i * ZLD;  // this lane's row i
#pragma unroll 2
    for (int j = 0; j < U; ++j) {
      const float u = zr[8 * j + ug];
      const int id = ID >= 0 ? ID : ids[32 * j];
      zr[8 * j + ug] = apply_act(id, u);
      if constexpr (DERIV) dz[8 * j + ug] = apply_act_deriv(id, u);
    }
    __syncwarp();
    const int b = b0 + 4 * i;
    const size_t at = (size_t)b * H + h0 + U * ug;  // U consecutive units
    const int left = H - h0 - U * ug;
#pragma unroll
    for (int pass = 0; pass < (DERIV ? 2 : 1); ++pass) {
      const float* src = pass ? dz : zr;
      X* out = pass ? g : y;
      float v[U];
#pragma unroll
      for (int e = 0; e < U; ++e)  // unit U · ug + e of the tile
        v[e] = (contig ? src[8 * e + ug] : src[8 * ug + e]) * un.mo[e];
      if (b < B) {
        if constexpr (VEC == 4 && std::is_same<X, bf16>::value) {
          // bf16: 4 values packed in an 8-byte store
#pragma unroll
          for (int c = 0; c < U / 4; ++c)
            if (4 * c < left)
              bf16x::store4<true>(out + at + 4 * c, v[4 * c], v[4 * c + 1],
                                  v[4 * c + 2], v[4 * c + 3]);
        } else if constexpr (VEC == 4) {
#pragma unroll
          for (int c = 0; c < U / 4; ++c)
            if (4 * c < left)
              __stcs(reinterpret_cast<float4*>(out + at + 4 * c),
                     make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2],
                                 v[4 * c + 3]));
        } else if constexpr (std::is_same<X, bf16>::value) {
#pragma unroll
          for (int e = 0; e < U; ++e)
            if (e < left) bf16x::store1<true>(out + at + e, v[e]);
        } else {
#pragma unroll
          for (int e = 0; e < U; ++e)
            if (e < left) __stcs(out + at + e, v[e]);
        }
      }
    }
    __syncwarp();
  }
}

// The epilogue of a batch tile: z to the warp's z tile, then out_rows with
// the activation chosen once where all the warp's units share one.
template <int VEC, bool DERIV, int RB, typename X>
__device__ __forceinline__ void epilogue(const float (&acc)[RB][U],
                                         const Units& un, bool one_id,
                                         float* zb, float* dz,
                                         const int* ids,
                                         X* __restrict__ y,
                                         X* __restrict__ g, int bt0,
                                         int bg, int B, int H, int h0,
                                         int ug, bool contig) {
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int j = 0; j < U; ++j)
      zb[4 * i * ZLD + 8 * j + ug] = acc[i][j] + un.b[j];
  __syncwarp();
  // rows for the warp: the most any of its batch groups has
  const int n = min(RB, (B - bt0 + 3) / 4);
  const int b0 = bt0 + bg;
  if (one_id) {
    switch (un.id0) {
#define FI_ROWS(K)                                                       \
  case K:                                                                \
    out_rows<K, VEC, DERIV>(n, un, zb, dz, ids, y, g, b0, B, H, h0, ug,  \
                            contig);                                     \
    return;
      FI_ROWS(0) FI_ROWS(1) FI_ROWS(2) FI_ROWS(3) FI_ROWS(4)
      FI_ROWS(5) FI_ROWS(6) FI_ROWS(7) FI_ROWS(8) FI_ROWS(9)
#undef FI_ROWS
      default:
        break;
    }
  }
  out_rows<-1, VEC, DERIV>(n, un, zb, dz, ids, y, g, b0, B, H, h0, ug,
                           contig);
}

// W is float (w_scale unused, ldw = F), bf16 (the compute policy: x, y
// and g' bf16 too, Act<W>; w_scale unused, ldw = F) or int8_t (w_scale one
// f32 per row block, ldw = F_pad the row stride); X, the activations' type
// (x, y, g'), is f32, or bf16 under the compute policy.
template <int VEC, typename W, typename X, bool DERIV, int RB>
__device__ __forceinline__ void fused_input_body(
    const X* __restrict__ x, const W* __restrict__ w,
    const float* __restrict__ w_scale, int ldw,
    const float* __restrict__ bias, const float* __restrict__ mask,
    const int* __restrict__ act_ids, X* __restrict__ y, X* __restrict__ g,
    int B, int F, int H, int block, const Plan& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool INT8 = std::is_same<W, int8_t>::value;
  constexpr bool BF16 = std::is_same<X, bf16>::value;  // x widened
  const int t = threadIdx.x;
  const int lane = t % 32, warp = t / 32;
  const int bg = lane / 8, ug = lane % 8;  // batch group, unit group
  const bool contig = p.contig;

  float* xres = reinterpret_cast<float*>(smem);
  if (p.resident) {  // every row of x, once, zeros past B
    const int n = p.n_bt * p.bt * F;
    for (int i = t; i < n; i += THREADS) {
      const int b = i / F, k = i - b * F;
      xres[b * p.sx + k] = b < B ? widen(x[(size_t)b * F + k]) : 0.f;
    }
    __syncthreads();
  }
  // this lane's row 0 of its warp's z tile, its batch group's g' row and
  // its activation ids
  float* wsc = reinterpret_cast<float*>(smem + p.x_bytes +
                                        warp * WARP_SCRATCH);
  float* zb = wsc + bg * ZLD;
  float* dz = wsc + (32 + bg) * ZLD;
  int* ids = reinterpret_cast<int*>(wsc + 36 * ZLD) + lane;
  unsigned char* ring =
      smem + p.x_bytes + SCRATCH + warp * STAGES * p.stage_bytes;

  // this warp's items: its tiles gw, gw + nw, …, each per_tile items
  const int gw = blockIdx.x * WARPS + warp, nw = gridDim.x * WARPS;
  const int n_mine = gw < p.n_tiles ? (p.n_tiles - 1 - gw) / nw + 1 : 0;
  const int n_items = n_mine * p.per_tile;

  // item s → (tile, batch tile, chunk)
  auto locate = [&](int s, int& tile, int& bt, int& kc) {
    const int q = p.per_tile == 1 ? s : s / p.per_tile;
    const int r = s - q * p.per_tile;
    tile = gw + q * nw;
    bt = r / p.n_kc;
    kc = r - bt * p.n_kc;
  };

  // item s's copies into stage s % STAGES; one commit group each, an empty
  // one past the last item.  A thread's unit j sits in shared row j · 8 +
  // ug: tile unit r = U · ug + j (contig) or ug + 8 · j.
  auto issue = [&](int s) {
    if (s < n_items) {
      int tile, bt, kc;
      locate(s, tile, bt, kc);
      const int h0 = tile * UNITS, k0 = kc * p.kc;
      const int nk = min(p.kc, F - k0);
      const int per_row = VEC == 4 ? nk / 4 : nk;
      unsigned char* st = ring + (s % STAGES) * p.stage_bytes;
      W* ws = reinterpret_cast<W*>(st);
      copy_rows<VEC, W>(
          min(UNITS, H - h0), per_row, lane,
          [&](int r) {
            return ws + (contig ? (r % U) * 8 + r / U : r) * p.kc;
          },
          [&](int r) { return w + (size_t)(h0 + r) * ldw + k0; });
      if (!p.resident) {
        float* xs = reinterpret_cast<float*>(st + p.w_bytes);
        const int b0 = bt * p.bt;
        if constexpr (BF16) {  // widened on the way: loads and stores
          int r = lane / per_row, c = lane - r * per_row;
          const int nr = min(p.bt, B - b0);
          const int dr = 32 / per_row, dc = 32 - dr * per_row;
          while (r < nr) {
            copy_elems_widened<VEC>(xs + r * p.sx + c * VEC,
                                    x + (size_t)(b0 + r) * F + k0 + c * VEC);
            r += dr;
            c += dc;
            if (c >= per_row) { c -= per_row; ++r; }
          }
        } else {
          copy_rows<VEC, float>(
              min(p.bt, B - b0), per_row, lane,
              [&](int r) { return xs + r * p.sx; },
              [&](int r) { return x + (size_t)(b0 + r) * F + k0; });
        }
      }
    }
    cp_async_commit();
  };

  float acc[RB][U];
  Units un;
  bool one_id = false;
  for (int s = 0; s + 1 < STAGES; ++s) issue(s);
  for (int s = 0; s < n_items; ++s) {
    cp_async_wait_ring();
    // every lane's copies of item s have landed, and every lane is done
    // with item s − 1, whose stage item s + STAGES − 1 takes
    __syncwarp();
    issue(s + STAGES - 1);
    int tile, bt, kc;
    locate(s, tile, bt, kc);
    const int h0 = tile * UNITS;
    if (bt == 0 && kc == 0) {  // the tile's per-unit values, once
      bool same = true;
      un.id0 = act_ids[h0 / block];
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int h = h0 + (contig ? U * ug + j : ug + 8 * j);
        const bool ok = h < H;
        un.b[j] = ok ? bias[h] : 0.f;
        un.s[j] = INT8 && ok ? w_scale[h / block] : 0.f;
        ids[32 * j] = ok ? act_ids[h / block] : -1;
        same &= ok && ids[32 * j] == un.id0;
        const int ho = h0 + U * ug + j;  // the units this lane stores
        un.mo[j] = ho < H ? mask[ho] : 0.f;
      }
      one_id = __all_sync(0xffffffffu, same);
    }
    const int k0 = kc * p.kc;
    const unsigned char* st = ring + (s % STAGES) * p.stage_bytes;
    const W* row[U];
#pragma unroll
    for (int j = 0; j < U; ++j)
      row[j] = reinterpret_cast<const W*>(st) + (j * 8 + ug) * p.kc;
    const int b_end = p.per_tile == 1 ? p.n_bt : bt + 1;
    for (int b_t = p.per_tile == 1 ? 0 : bt; b_t < b_end; ++b_t) {
      if (kc == 0) {
#pragma unroll
        for (int i = 0; i < RB; ++i)
#pragma unroll
          for (int j = 0; j < U; ++j) acc[i][j] = 0.f;
      }
      const float* xr =
          p.resident ? xres + (b_t * p.bt + bg) * p.sx + k0
                     : reinterpret_cast<const float*>(st + p.w_bytes) +
                           bg * p.sx;
      fma_span<RB, W>(acc, row, un.s, xr, 4 * p.sx, min(p.kc, F - k0));
      if (kc == p.n_kc - 1)
        epilogue<VEC, DERIV, RB>(acc, un, one_id, zb, dz, ids, y, g,
                                 b_t * p.bt, bg, B, H, h0, ug, contig);
    }
  }
}

// The kernels.  VEC first, so the name the profiler records begins with
// the instance: fused_input_kernel<4, …> or <1, …>.
template <int VEC, typename W, bool DERIV, int RB>
__global__ void __launch_bounds__(THREADS, 1)
fused_input_kernel(const Act<W>* __restrict__ x, const W* __restrict__ w,
                   const float* __restrict__ w_scale, int ldw,
                   const float* __restrict__ bias,
                   const float* __restrict__ mask,
                   const int* __restrict__ act_ids, Act<W>* __restrict__ y,
                   Act<W>* __restrict__ g, int B, int F, int H, int block,
                   Plan p) {
  fused_input_body<VEC, W, Act<W>, DERIV, RB>(x, w, w_scale, ldw, bias, mask,
                                              act_ids, y, g, B, F, H, block,
                                              p);
}

// int8 weights, bf16 activations (the int8 serve copy under the bf16
// compute policy; serving only)
template <int VEC, int RB>
__global__ void __launch_bounds__(THREADS, 1)
fused_input_i8_bf16_kernel(const bf16* __restrict__ x,
                           const int8_t* __restrict__ w,
                           const float* __restrict__ w_scale, int ldw,
                           const float* __restrict__ bias,
                           const float* __restrict__ mask,
                           const int* __restrict__ act_ids,
                           bf16* __restrict__ y, bf16* __restrict__ g, int B,
                           int F, int H, int block, Plan p) {
  fused_input_body<VEC, int8_t, bf16, false, RB>(x, w, w_scale, ldw, bias,
                                                 mask, act_ids, y, g, B, F,
                                                 H, block, p);
}

// the kernel of an instance: fused_input_kernel where the activations'
// type is the weights' Act<W>, else (int8 weights, bf16 activations)
// fused_input_i8_bf16_kernel
template <int VEC, typename W, typename X, bool DERIV, int RB>
constexpr auto kernel_of() {
  if constexpr (std::is_same<X, Act<W>>::value)
    return fused_input_kernel<VEC, W, DERIV, RB>;
  else
    return fused_input_i8_bf16_kernel<VEC, RB>;
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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// one instance's launch: as many CTAs as fit the card at once, at most one
// per 8 warp tiles
template <int VEC, typename W, typename X, bool DERIV, int RB>
int launch_instance(const Plan& p, const X* x, const W* w,
                    const float* w_scale, int ldw, const float* bias,
                    const float* mask, const int* act_ids, X* y, X* g, int B,
                    int F, int H, int block, cudaStream_t stream) {
  static_assert(!DERIV || std::is_same<X, Act<W>>::value,
                "int8 weights with bf16 activations: serving only");
  auto kernel = kernel_of<VEC, W, X, DERIV, RB>();
  static bool opted_in = false;
  static int at_smem = -1;   // per_sm is the occupancy at this smem
  static int per_sm = 0;
  if (!opted_in) {
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX) != cudaSuccess)
      return (int)cudaGetLastError();
    opted_in = true;
  }
  if (p.smem != at_smem) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, p.smem) !=
        cudaSuccess)
      return (int)cudaGetLastError();
    at_smem = p.smem;
  }
  const long long n_ctas =
      std::min<long long>((p.n_tiles + WARPS - 1) / WARPS,
                          (long long)sm_count() * std::max(per_sm, 1));
  kernel<<<(unsigned)n_ctas, THREADS, p.smem, stream>>>(
      x, w, w_scale, ldw, bias, mask, act_ids, y, g, B, F, H, block, p);
  return (int)cudaGetLastError();
}

template <int VEC, typename W, typename X, bool DERIV>
int launch_rows(const Plan& p, const X* x, const W* w, const float* w_scale,
                int ldw, const float* bias, const float* mask,
                const int* act_ids, X* y, X* g, int B, int F, int H,
                int block, cudaStream_t stream) {
  switch (p.rb) {
    case 1:
      return launch_instance<VEC, W, X, DERIV, 1>(p, x, w, w_scale, ldw,
                                                  bias, mask, act_ids, y, g,
                                                  B, F, H, block, stream);
    case 2:
      return launch_instance<VEC, W, X, DERIV, 2>(p, x, w, w_scale, ldw,
                                                  bias, mask, act_ids, y, g,
                                                  B, F, H, block, stream);
    case 4:
      return launch_instance<VEC, W, X, DERIV, 4>(p, x, w, w_scale, ldw,
                                                  bias, mask, act_ids, y, g,
                                                  B, F, H, block, stream);
    default:
      return launch_instance<VEC, W, X, DERIV, 8>(p, x, w, w_scale, ldw,
                                                  bias, mask, act_ids, y, g,
                                                  B, F, H, block, stream);
  }
}

// The vec4 instance where F, H and the weight row stride are multiples of
// 4 and x, W, y and g' start on a 16-byte boundary — an 8-byte one for
// bf16 tensors, whose 4 values a copy are 8 bytes (fwd_path() in
// fused_input.py) — else the scalar one.
template <typename W, typename X, bool DERIV>
int launch(const X* x, const W* w, const float* w_scale, int ldw,
           const float* bias, const float* mask, const int* act_ids, X* y,
           X* g, int B, int F, int H, int block, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (F <= 0 || block <= 0 || ldw < F) return (int)cudaErrorInvalidValue;
  if ((long long)B * F > INT_MAX) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(B, F, H, block, (int)sizeof(W));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto ax = std::is_same<X, bf16>::value ? bf16x::aligned8
                                               : aligned16;
  const auto aw = std::is_same<W, bf16>::value ? bf16x::aligned8
                                               : aligned16;
  const bool vec = F % 4 == 0 && H % 4 == 0 && ldw % 4 == 0 && ax(x) &&
                   aw(w) && ax(y) && (g == nullptr || ax(g));
  return (vec ? launch_rows<4, W, X, DERIV> : launch_rows<1, W, X, DERIV>)(
      p, x, w, w_scale, ldw, bias, mask, act_ids, y, g, B, F, H, block, s);
}

}  // namespace

extern "C" int fused_input_infer_f32(const float* x, const float* w,
                                     const float* bias, const float* mask,
                                     const int* act_ids, float* y, int B,
                                     int F, int H, int block, void* stream) {
  return launch<float, float, false>(x, w, nullptr, F, bias, mask, act_ids, y,
                              nullptr, B, F, H, block, stream);
}

extern "C" int fused_input_train_f32(const float* x, const float* w,
                                     const float* bias, const float* mask,
                                     const int* act_ids, float* y, float* g,
                                     int B, int F, int H, int block,
                                     void* stream) {
  return launch<float, float, true>(x, w, nullptr, F, bias, mask, act_ids, y, g, B,
                             F, H, block, stream);
}

// The bf16 compute policy: x (B, F), w (H, F) bf16, bias and mask f32 →
// y [and g'] (B, H) bf16, each rounded once from its f32 value.
extern "C" int fused_input_infer_bf16(const bf16* x, const bf16* w,
                                      const float* bias, const float* mask,
                                      const int* act_ids, bf16* y, int B,
                                      int F, int H, int block, void* stream) {
  return launch<bf16, bf16, false>(x, w, nullptr, F, bias, mask, act_ids, y,
                             nullptr, B, F, H, block, stream);
}

extern "C" int fused_input_train_bf16(const bf16* x, const bf16* w,
                                      const float* bias, const float* mask,
                                      const int* act_ids, bf16* y, bf16* g,
                                      int B, int F, int H, int block,
                                      void* stream) {
  return launch<bf16, bf16, true>(x, w, nullptr, F, bias, mask, act_ids, y, g, B,
                            F, H, block, stream);
}

// x (B, F) f32, w_q (H, F_pad) int8, w_scale (H / block,) f32.
extern "C" int fused_input_infer_i8(const float* x, const int8_t* w_q,
                                    const float* w_scale, const float* bias,
                                    const float* mask, const int* act_ids,
                                    float* y, int B, int F, int F_pad, int H,
                                    int block, void* stream) {
  return launch<int8_t, float, false>(x, w_q, w_scale, F_pad, bias, mask, act_ids,
                               y, nullptr, B, F, H, block, stream);
}

// The int8 serve copy under the bf16 compute policy: x (B, F) bf16, w_q
// (H, F_pad) int8, w_scale (H / block,) f32 → y (B, H) bf16, rounded once
// from its f32 value.
extern "C" int fused_input_infer_i8_bf16(const bf16* x, const int8_t* w_q,
                                         const float* w_scale,
                                         const float* bias,
                                         const float* mask,
                                         const int* act_ids, bf16* y, int B,
                                         int F, int F_pad, int H, int block,
                                         void* stream) {
  return launch<int8_t, bf16, false>(x, w_q, w_scale, F_pad, bias, mask,
                                     act_ids, y, nullptr, B, F, H, block,
                                     stream);
}
