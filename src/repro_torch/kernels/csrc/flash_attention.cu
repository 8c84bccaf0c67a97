// Flash attention on Hopper (sm_90a), the float32 route: every product on
// the tensor cores as 3xTF32, forward and backward.  bf16 operands take
// flash_attention_sm90.cu (wgmma on bf16 tiles).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (body `_kernel`): softmax(q k^T * scale) v with
// causal, sliding-window and prefix-LM masks, logit soft-capping, a query
// offset, and grouped-query attention, in one pass that keeps the logits
// out of device memory (the online softmax: a running row max m, row sum l
// and output accumulator acc, rescaled as each key tile arrives); and the
// recompute backward of repro/kernels/flash_xla.py (`_bwd`).
//
// Layout: q [B, Hq, Tq, D], k and v [B, Hkv, Tk, D], o like q, all dense
// row-major float32 (the wrapper makes them contiguous and 16-byte
// aligned).  Query head h reads key/value head h / (Hq / Hkv): the grouped
// heads are never repeated in memory.  Any D <= 256 with D % 8 == 0 (rows
// are copied 16 bytes at a time; the mma's k and n steps are 8 wide).  The
// tiles are laid out for kD = 64, 128 or 256 columns (the smallest that
// holds D); the columns past D hold zeros, so every product runs over kD
// at compile time and only the stores look at D.
//
// The split.  Every product (S = Q K^T, O += P V; in the backward S, dP =
// dO V^T, dV += P^T dO, dK += dS^T Q, dQ += dS K) runs as
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.  Each operand
// element a is split into hi = tf32(a) and lo = tf32(a - hi), both rounded
// to nearest with ties away from zero (cvt.rna.tf32.f32's rounding, done on
// the integer pipe), and a product is accumulated in float32 as lo.hi,
// then hi.lo, then hi.hi (the lo.lo term, ~2^-22 relative, is dropped), as
// ssd_scan.cu does.  The tensor core truncates what it accumulates, so
// the sums over D (S, dP) keep the small terms in an accumulator of their
// own, and the sums over tiles (O, dK, dV, dQ) take each 8-deep step in a
// fresh accumulator added to them in float32 (mma3_split, mma3_add).  That
// holds float32's tolerances, which one TF32 pass misses
// (tests/test_torch_flash_tf32.py), and keeps the error near float32's.
// The scale, the softcap's tanh, the masks, exp, the online softmax, lse,
// delta and dS stay float32 on the CUDA cores.  Fragment coordinates (PTX
// ISA, m16n8k8 .tf32), g = lane / 4, t = lane % 4: A (16 x 8) a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8) b0 (k = t,
// n = g), b1 (k = t + 4, n = g); C (16 x 8) c0 (g, 2t), c1 (g, 2t + 1), c2
// (g + 8, 2t), c3 (g + 8, 2t + 1).
// Every tile's row pitch is kD + 4 floats (4 mod 32 banks), so that a
// warp's fragment loads from a row-major tile, along its rows or down its
// columns, hit 32 distinct banks.
//
// Copies.  Tiles go into shared memory as float32 by cp.async 16-byte
// copies (rows past T zero-filled, columns past D zeroed once), in two
// stages: the next tile is in flight while this one multiplies.
//
// Forward (flash_tf32_fwd_kernel): one CTA per (b * Hq + h, query tile),
// tiles on grid axis x from the last one down (the longest causal tiles
// start first), b * Hq on axis y.  Up to kD = 128 the CTA holds 64 queries
// in 8 warps: two warps on each 16 rows, each taking one half of every key
// tile (64 keys at kD = 64, 32 at 128) with its own online softmax, the
// pair's (m, l, O) merged through shared memory at the end, so that each
// warp's chain of dependent products is half as long; at kD = 256 it holds
// 32 queries in 4 warps, two on each 16 rows, each computing S over the
// whole tile and O for half of the columns (128 registers of O a thread
// otherwise).  S stays in the mma accumulator's layout; each thread holds
// two rows' entries, whose row max and row sum four lanes share (quad
// shuffles).  P enters P V from those registers: with the k index of the
// product taken as keys 2t and 2t + 1 in place of t and t + 4 (in both
// operands: a sum does not depend on its order), the C fragment of S is
// the A fragment of P.  Key tiles that the masks hide from every query of
// the tile are never loaded: above the causal diagonal (past the last
// query, or past the prefix when a query lies in it) and before the window
// of the first query; a tile the masks do not cut skips them.  Masked
// logits are -inf, so their p is exactly 0 (m starts at the TPU kernel's
// finite -1e30, so m - m_new never meets inf - inf).  A row that sees no
// key ends with l = 0 and writes 0 and lse = -inf.
//
// Backward (flash_xla.py's `_bwd`), from the saved (q, k, v, o, lse) and
// dO: delta = rowsum(dO * O) (flash_tf32_bwd_delta_kernel, a warp a row),
// then two kernels that each own their outputs, so nothing is summed with
// atomics and two calls give the same bits:
//   dK/dV (flash_tf32_bwd_dkdv_kernel): one CTA of 8 warps per (key tile,
//     b * Hq + h): per visible query tile, the S^T and dP^T blocks of the
//     tile (phase A: warps on 16 keys x a share of the queries), P^T and
//     dS^T written split into shared memory, then dV += P^T dO and dK +=
//     dS^T Q (phase B: warps on 16 keys x a share of D's columns).  Where
//     Hq > Hkv each CTA writes its head's float32 partials into a scratch
//     [B, Hq, Tk, D] and flash_tf32_bwd_gqa_sum_kernel adds each group's
//     heads in order (h = 0, 1, ..); where Hq = Hkv the CTAs write dK/dV.
//   dQ (flash_tf32_bwd_dq_kernel): one CTA of 8 warps per (query tile,
//     b * Hq + h), longest first: per visible key tile, S and dP (phase A),
//     dS split into shared memory, dQ += dS K (phase B).
// S and dP are computed once per (query tile, key tile) at every D: the
// tiles are 64 keys x 32 queries (dK/dV) or 64 queries x 32 keys (dQ) up
// to kD = 128, two CTAs an SM at 64, and 32 x 32 at 256, so that each
// warp's accumulators (16 rows x D / 2 or D / 4 columns of dK and dV, or
// of dQ) stay in registers.  Rows with lse = -inf see no key: P = 0 there.
//
// What bounds it on this card.  3xTF32 runs three products for each of
// the function's, at most at TF32's 495 TFLOP/s (wgmma's rate): at the
// float32 training shape (q [1, 14, 2048, 64], k and v [1, 2, 2048, 64],
// causal) the forward needs 0.0456 ms of them and the backward 0.114 ms,
// against 0.0055 and 0.0101 ms of bytes.  The kernels do not come near
// that: mma.sync runs a 16 x 8 x 8 product where wgmma runs 64 x N x 8,
// and each operand is split by the integer pipe where a warp loads it (a
// K/V fragment by every warp that multiplies it): the built kernels hold
// ~22 other instructions for each mma (static SASS at kD = 64,
// experiments/sass_count.py) and are bound by issue and by latency, with
// 8-16 warps an SM.  Splitting each tile once for the
// CTA, into (hi, lo) pairs in shared memory, was slower: twice the bytes
// halve the CTAs an SM, and the extra barrier serialises the warps.
//
// The build turns off multiply-add contraction (-fmad=false, _build.py);
// the arithmetic on the CUDA cores rounds as written.

#include <cuda_runtime.h>

#include "kernel_info.cuh"
#include <math_constants.h>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;     // the TPU kernel's NEG_INF

// The masks and the sizes every kernel reads.
struct Masks {
  int tq, tk;
  float scale;
  int causal;
  int window;        // < 0: none
  int prefix;        // < 0: none
  int use_softcap;
  float softcap;
  int q_offset;
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;        // [b, hq, tq]: m + log l, -inf where l = 0
  int hq, hkv, d;
  Masks m;
};

struct BwdParams {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;
  const float* delta;
  float* dq;
  float* dk;         // dk and dv, or the GQA partials [2][b, hq, tk, d]
  float* dv;
  int hq, hkv, d;
  Masks m;
};

__device__ __forceinline__ bool sees(const Masks& m, int qpos, int kpos) {
  bool ok = kpos < m.tk;
  if (m.causal)
    ok = ok && (kpos <= qpos ||
                (m.prefix >= 0 && kpos < m.prefix && qpos < m.prefix));
  if (m.window >= 0) ok = ok && kpos > qpos - m.window;
  return ok;
}

// The tiles of `tile`-key blocks that some query of rows [q0, q1) can see:
// [first, first + count).
__device__ __forceinline__ void key_tiles(const Masks& m, int q0, int q1,
                                          int tile, int& first, int& count) {
  const long long qmin = static_cast<long long>(q0) + m.q_offset;
  const long long qmax = static_cast<long long>(q1) - 1 + m.q_offset;
  long long hi = m.tk;
  if (m.causal) {
    hi = min(hi, qmax + 1);
    if (m.prefix >= 0 && qmin < m.prefix)
      hi = max(hi, static_cast<long long>(min(m.prefix, m.tk)));
  }
  const long long lo = m.window >= 0 ? max(0LL, qmin - m.window + 1) : 0LL;
  first = static_cast<int>(lo / tile);
  count = hi > lo ? static_cast<int>((hi + tile - 1) / tile) - first : 0;
}

// The tiles of `tile`-query blocks whose rows see some key of [k0, k1).
__device__ __forceinline__ void query_tiles(const Masks& m, int k0, int k1,
                                            int tile, int& first,
                                            int& count) {
  long long lo = 0;
  if (m.causal && !(m.prefix >= 0 && k0 < m.prefix))
    lo = max(0LL, static_cast<long long>(k0) - m.q_offset);
  long long hi = m.tq;
  if (m.window >= 0)
    hi = min(hi, static_cast<long long>(k1) - 1 + m.window - m.q_offset);
  first = static_cast<int>(lo / tile);
  count = hi > lo ? static_cast<int>((hi + tile - 1) / tile) - first : 0;
}

// -- copies ------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the last `kPending` committed has landed
template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Rows row0 .. row0 + kRows - 1 of a [rows_total, d] array into dst[r * (kD
// + 4) + c] for c < d, zero past rows_total; every thread of the CTA issues
// its share of 16-byte copies (kD / 4 a row, those past d skipped).
template <int kRows, int kD, int kThreads>
__device__ __forceinline__ void load_rows(const float* src, int row0,
                                          int rows_total, int d, float* dst) {
  constexpr int kChunks = kD / 4;
  static_assert(kRows * kChunks % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    if (c >= d) continue;
    const bool ok = row0 + r < rows_total;
    cp_async16(dst + r * (kD + 4) + c,
               ok ? src + (static_cast<long long>(row0) + r) * d + c : src,
               ok);
  }
}

// Columns d .. kD - 1 of `rows` rows of pitch kD + 4 set to 0 (no copy
// writes them): the products then run over whole 8-column steps up to kD
// and add nothing there.
template <int kD, int kThreads>
__device__ __forceinline__ void zero_cols(float* base, int rows, int d) {
  const int w = kD - d;
  for (int i = threadIdx.x; i < rows * w; i += kThreads)
    base[(i / w) * (kD + 4) + d + i % w] = 0.0f;
}

// True when every (query, key) pair of rows [q0, q0 + rows) and keys [k0,
// k0 + keys) is visible, so the tile needs no mask: the keys lie below Tk,
// below the causal diagonal (or all in a prefix the queries lie in too),
// and inside every query's window.  Rows past Tq count as queries here;
// their results are dropped or add zeros.
__device__ __forceinline__ bool tile_full(const Masks& m, int q0, int rows,
                                          int k0, int keys) {
  const long long qlo = static_cast<long long>(q0) + m.q_offset;
  const long long qhi = qlo + rows - 1;
  const long long klast = static_cast<long long>(k0) + keys - 1;
  bool full = klast < m.tk;
  if (m.causal)
    full = full && (klast <= qlo ||
                    (m.prefix >= 0 && klast < m.prefix && qhi < m.prefix));
  if (m.window >= 0) full = full && k0 > qhi - m.window;
  return full;
}

// kRows entries row0.. of a [rows_total] array, zero past rows_total
template <int kRows>
__device__ __forceinline__ void load_vec(const float* src, int row0,
                                         int rows_total, float* dst) {
  for (int i = threadIdx.x; i < kRows; i += blockDim.x) {
    const bool ok = row0 + i < rows_total;
    cp_async4(dst + i, ok ? src + row0 + i : src, ok);
  }
}

// -- 3xTF32 ------------------------------------------------------------------

// An mma operand fragment, split: the tf32 hi part and the remainder's.
struct FragA { uint32_t hi[4], lo[4]; };
struct FragB { uint32_t hi[2], lo[2]; };

// cvt.rna.tf32.f32 on the integer pipe: add half of the 13 dropped bits'
// unit to the magnitude and clear them (round to nearest, ties away from
// zero; the operands here are finite).
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

__device__ __forceinline__ uint2 split2(float v) {
  uint2 r;
  split(v, r.x, r.y);
  return r;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: the small terms first, then hi.hi
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// The tensor core truncates each sum it accumulates, so a chain of
// mma.sync on one accumulator drifts from float32 a fraction of an ulp a
// step.  The sums over one tile's D (S, dP) keep the small terms in an
// accumulator of their own, so that the large one takes one truncation a
// step, not three (added together once the tile is done):
__device__ __forceinline__ void mma3_split(float (&d)[4], float (&small)[4],
                                           const FragA& a, const FragB& b) {
  mma(small, a.lo, b.hi);
  mma(small, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// and the sums over every key or query tile (O, dK, dV, dQ) take each
// step in a fresh accumulator, added to d in float32 (rounded to nearest).
__device__ __forceinline__ void mma3_add(float (&d)[4], const FragA& a,
                                         const FragB& b) {
  float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma3(c, a, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += c[e];
}

// The fragment loaders take a tile of float32 values, split as they are
// loaded, or a tile of split (hi, lo) pairs (uint2), loaded as they are.
__device__ __forceinline__ void take(float v, uint32_t& hi, uint32_t& lo) {
  split(v, hi, lo);
}

__device__ __forceinline__ void take(uint2 v, uint32_t& hi, uint32_t& lo) {
  hi = v.x;
  lo = v.y;
}

// A from a row-major [m][k] tile at p (its (0, 0))
template <typename E>
__device__ __forceinline__ FragA load_a(const E* p, int ld, int g, int t) {
  FragA f;
  take(p[g * ld + t], f.hi[0], f.lo[0]);
  take(p[(g + 8) * ld + t], f.hi[1], f.lo[1]);
  take(p[g * ld + t + 4], f.hi[2], f.lo[2]);
  take(p[(g + 8) * ld + t + 4], f.hi[3], f.lo[3]);
  return f;
}

// B from an [n][k] tile (B^T row-major)
template <typename E>
__device__ __forceinline__ FragB load_b_nk(const E* p, int ld, int g, int t) {
  FragB f;
  take(p[g * ld + t], f.hi[0], f.lo[0]);
  take(p[g * ld + t + 4], f.hi[1], f.lo[1]);
  return f;
}

// B from a row-major [k][n] tile
template <typename E>
__device__ __forceinline__ FragB load_b_kn(const E* p, int ld, int g, int t) {
  FragB f;
  take(p[t * ld + g], f.hi[0], f.lo[0]);
  take(p[(t + 4) * ld + g], f.hi[1], f.lo[1]);
  return f;
}

// B from a row-major [k][n] tile with the k index permuted (instruction
// k = t, t + 4 <-> rows 2t, 2t + 1), to meet an A taken from a C fragment
template <typename E>
__device__ __forceinline__ FragB load_b_kn_perm(const E* p, int ld, int g,
                                                int t) {
  FragB f;
  take(p[2 * t * ld + g], f.hi[0], f.lo[0]);
  take(p[(2 * t + 1) * ld + g], f.hi[1], f.lo[1]);
  return f;
}

// The A fragment of a C fragment c (16 x 8, rows x k) under that
// permutation: a0 (g, 2t) = c0, a1 (g + 8, 2t) = c2, a2 (g, 2t + 1) = c1,
// a3 (g + 8, 2t + 1) = c3.
__device__ __forceinline__ FragA a_of_c(const float (&c)[4]) {
  FragA f;
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// -- forward -----------------------------------------------------------------

// 8 warps as kRW row groups of 16 queries x kCW column groups x kKW = 2
// key groups: a warp computes S for its 16 rows over its half of each key
// tile, with its own online softmax, and O for its kD / kCW columns; the
// two key groups merge their (m, l, O) at the end.  Halving the keys
// halves each warp's chain of dependent products.  Up to kD = 128 a CTA
// holds 64 queries; at 256 32, with O's columns split in two (128
// registers of O a thread otherwise).
template <int kD>
struct FwdTiles {
  static constexpr int kCW = kD == 256 ? 2 : 1;    // column groups
  static constexpr int kKW = 2;                    // key groups
  static constexpr int kRW = kD == 256 ? 2 : 4;    // row groups
  static constexpr int kBQ = 16 * kRW;             // queries a CTA
  static constexpr int kBK = kD == 64 ? 64 : 32;   // keys a tile
  static constexpr int kLD = kD + 4;               // row pitch (floats)
  static constexpr int kThreads = 32 * kRW * kCW * kKW;
  // Q, then two stages of K and of V
  static constexpr int kSmem = 4 * (kBQ * kLD + 2 * 2 * kBK * kLD);
};

template <int kD>
__global__ void __launch_bounds__(FwdTiles<kD>::kThreads, kD == 256 ? 1 : 2)
flash_tf32_fwd_kernel(Params p) {
  using Tl = FwdTiles<kD>;
  constexpr int BQ = Tl::kBQ, BK = Tl::kBK, LD = Tl::kLD, CW = Tl::kCW;
  constexpr int KW = Tl::kKW, NT = Tl::kThreads;
  constexpr int NS = BK / KW / 8;     // n tiles of S (this warp's keys)
  constexpr int NO = kD / CW / 8;     // n tiles of O (this warp's columns)
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [BQ][LD]
  float* ks = qs + BQ * LD;                      // [2][BK][LD]
  float* vs = ks + 2 * BK * LD;                  // [2][BK][LD]
  const Masks& m = p.m;
  const int d = p.d;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / p.hq;
  const int h = bh - b * p.hq;
  const long long hk = static_cast<long long>(b) * p.hkv + h / (p.hq / p.hkv);
  const float* qg = p.q + static_cast<long long>(bh) * m.tq * d;
  const float* kg = p.k + hk * m.tk * d;
  const float* vg = p.v + hk * m.tk * d;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int wk = warp % KW;           // keys wk BK / KW .. of each tile
  const int wc = (warp / KW) % CW;
  const int wr = warp / (KW * CW);    // rows 16 wr ..
  const int c0 = wc * (kD / CW);      // O's columns c0 ..
  const int kw0 = wk * (BK / KW);

  int kt0, nt;
  key_tiles(m, q0, min(q0 + BQ, m.tq), BK, kt0, nt);
  if (d < kD) zero_cols<kD, NT>(qs, BQ + 4 * BK, d);
  if (nt > 0) {
    load_rows<BQ, kD, NT>(qg, q0, m.tq, d, qs);
    load_rows<BK, kD, NT>(kg, kt0 * BK, m.tk, d, ks);
    load_rows<BK, kD, NT>(vg, kt0 * BK, m.tk, d, vs);
  }
  cp_commit();

  // this thread's rows: 16 wr + g + 8 r
  const int row0 = q0 + 16 * wr + g;
  float mrow[2] = {kNegInf, kNegInf};
  float lrow[2] = {0.0f, 0.0f};       // this thread's columns' share
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  const float* qw = qs + 16 * wr * LD;

  for (int i = 0; i < nt; ++i) {
    const int st = i & 1;
    if (i + 1 < nt) {
      const int k1 = (kt0 + i + 1) * BK;
      load_rows<BK, kD, NT>(kg, k1, m.tk, d, ks + (st ^ 1) * BK * LD);
      load_rows<BK, kD, NT>(vg, k1, m.tk, d, vs + (st ^ 1) * BK * LD);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* kt = ks + (st * BK + kw0) * LD;
    const float* vt = vs + (st * BK + kw0) * LD;
    const int k0 = (kt0 + i) * BK + kw0;

    // S = Q K^T over this warp's keys
    float s[NS][4], sl[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = sl[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kD / 8; ++kk) {
      const FragA a = load_a(qw + 8 * kk, LD, g, t);
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mma3_split(s[j], sl[j], a,
                   load_b_nk(kt + 8 * j * LD + 8 * kk, LD, g, t));
    }

    // scale, softcap and, on a tile the masks cut, the masks (-inf)
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = (s[j][e] + sl[j][e]) * m.scale;
        if (m.use_softcap) x = m.softcap * tanhf(x / m.softcap);
        s[j][e] = x;
      }
    if (!tile_full(m, q0, BQ, k0, BK / KW)) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!sees(m, row0 + 8 * (e >> 1) + m.q_offset,
                    k0 + 8 * j + 2 * t + (e & 1)))
            s[j][e] = -CUDART_INF_F;
    }

    // the online softmax, rows r = 0 (g) and 1 (g + 8); the row max and
    // sum over the quad that holds the row
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(mrow[r], quad_max(mx[r]));
      alpha[r] = expf(mrow[r] - m_new);
      mrow[r] = m_new;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - mrow[e >> 1]);   // -inf: exactly 0
        rs[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) lrow[r] = lrow[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

    // O += P V over this warp's keys, P from the S registers
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      const FragA a = a_of_c(s[kk]);
#pragma unroll
      for (int n = 0; n < NO; ++n)
        mma3_add(o[n], a,
                 load_b_kn_perm(vt + 8 * kk * LD + c0 + 8 * n, LD, g, t));
    }
    __syncthreads();                  // the stage is free for tile i + 2
  }

  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(lrow[r]);
  // the second key group's (m, l, O) through shared memory, once every
  // warp is done with the tiles, into the first's
  constexpr int kW = 4 * NO + 4;    // floats a thread hands over
  float* x = qs + ((warp / KW) * 32 + (threadIdx.x & 31)) * kW;
  __syncthreads();
  if (wk == 1) {
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[4 * n + e] = o[n][e];
    x[4 * NO] = mrow[0];
    x[4 * NO + 1] = mrow[1];
    x[4 * NO + 2] = l[0];
    x[4 * NO + 3] = l[1];
  }
  __syncthreads();
  if (wk == 1) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = x[4 * NO + r];
    const float mm = fmaxf(mrow[r], m1);
    const float a0 = expf(mrow[r] - mm);
    const float a1 = expf(m1 - mm);
    l[r] = l[r] * a0 + x[4 * NO + 2 + r] * a1;
    mrow[r] = mm;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        o[n][2 * r + c] = o[n][2 * r + c] * a0 + x[4 * n + 2 * r + c] * a1;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= m.tq) continue;
    if (t == 0 && c0 == 0)
      p.lse[static_cast<long long>(bh) * m.tq + row] =
          l[r] > 0.0f ? mrow[r] + logf(l[r]) : -CUDART_INF_F;
    const float denom = fmaxf(l[r], 1e-37f);
    float* out = p.o + (static_cast<long long>(bh) * m.tq + row) * d + c0;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      if (c0 + 8 * n < d)
        *reinterpret_cast<float2*>(out + 8 * n + 2 * t) =
            make_float2(o[n][2 * r] / denom, o[n][2 * r + 1] / denom);
  }
}

// -- backward ----------------------------------------------------------------

// delta[row] = sum_d dO[row, d] * O[row, d] in float32, one warp a row
__global__ void __launch_bounds__(256)
flash_tf32_bwd_delta_kernel(const float* __restrict__ o,
                            const float* __restrict__ dout,
                            float* __restrict__ delta, long long rows,
                            int d) {
  const long long row =
      static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* a = o + row * d;
  const float* gr = dout + row * d;
  float s = 0.0f;
  for (int c = lane; c < d; c += 32) s += gr[c] * a[c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// P and dS of one (query, key) pair from its logit s (q . k) and dp (dO .
// v): P = exp(capped logit - lse) where the pair is live, else 0; dS = P
// (dp - delta) [(1 - tanh^2)] scale
__device__ __forceinline__ void prob_and_ds(const Masks& m, bool live,
                                            float s, float dp, float lse,
                                            float dl, float& pv, float& ds) {
  const float raw = s * m.scale;
  float th = 0.0f;
  float capped = raw;
  if (m.use_softcap) {
    th = tanhf(raw / m.softcap);
    capped = m.softcap * th;
  }
  pv = live ? expf(capped - lse) : 0.0f;
  float x = pv * (dp - dl);
  if (m.use_softcap) x = x * (1.0f - th * th);
  ds = x * m.scale;
}

// The dK/dV kernel's tiles: kBK keys a CTA, kBQ queries a step; 8 warps as
// kR row groups of 16 keys x kC column groups.  Up to kD = 128 a CTA takes
// 64 keys and 32 queries a step (two CTAs an SM at kD = 64), at 256 32 x
// 32.  Q, dO, lse and delta land in two stages.
template <int kD>
struct DkdvTiles {
  static constexpr int kBK = kD <= 128 ? 64 : 32;
  static constexpr int kBQ = 32;
  static constexpr int kLD = kD + 4;
  static constexpr int kLP = kBQ + 4;              // pitch of P^T, dS^T
  static constexpr int kR = kBK / 16;
  static constexpr int kC = 8 / kR;
  static constexpr int kNA = kBQ / (8 * kC);       // phase A: query n tiles
  static constexpr int kNB = kD / (8 * kC);        // phase B: column tiles
  // K and V; two stages of Q, dO, lse and delta; P^T and dS^T split
  static constexpr int kSmem =
      4 * (2 * kBK * kLD + 2 * 2 * kBQ * kLD + 2 * 2 * kBQ) +
      8 * 2 * kBK * kLP;
};

template <int kD>
__global__ void __launch_bounds__(256, kD == 64 ? 2 : 1)
flash_tf32_bwd_dkdv_kernel(BwdParams p) {
  using Tl = DkdvTiles<kD>;
  constexpr int BK = Tl::kBK, BQ = Tl::kBQ, LD = Tl::kLD, LP = Tl::kLP;
  constexpr int C = Tl::kC, NA = Tl::kNA, NB = Tl::kNB;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // [BK][LD]
  float* vs = ks + BK * LD;                      // [BK][LD]
  float* qs = vs + BK * LD;                      // [2][BQ][LD]
  float* dos = qs + 2 * BQ * LD;                 // [2][BQ][LD]
  float* lses = dos + 2 * BQ * LD;               // [2][BQ]
  float* dls = lses + 2 * BQ;                    // [2][BQ]
  uint2* pt = reinterpret_cast<uint2*>(dls + 2 * BQ);    // [BK][LP]
  uint2* dst = pt + BK * LP;                             // [BK][LP]
  const Masks& m = p.m;
  const int d = p.d;
  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  const int b = bh / p.hq;
  const int h = bh - b * p.hq;
  const long long hk = static_cast<long long>(b) * p.hkv + h / (p.hq / p.hkv);
  const float* kg = p.k + hk * m.tk * d;
  const float* vg = p.v + hk * m.tk * d;
  const float* qg = p.q + static_cast<long long>(bh) * m.tq * d;
  const float* og = p.dout + static_cast<long long>(bh) * m.tq * d;
  const float* lg = p.lse + static_cast<long long>(bh) * m.tq;
  const float* dg = p.delta + static_cast<long long>(bh) * m.tq;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int wr = warp / C;            // keys 16 wr ..
  const int wc = warp - wr * C;
  const int na0 = wc * (BQ / C);      // phase A: queries na0 ..
  const int nb0 = wc * (kD / C);      // phase B: columns nb0 ..

  int qt0, nt;
  query_tiles(m, k0, min(k0 + BK, m.tk), BQ, qt0, nt);
  if (d < kD) zero_cols<kD, 256>(ks, 2 * BK + 4 * BQ, d);
  if (nt > 0) {
    load_rows<BK, kD, 256>(kg, k0, m.tk, d, ks);
    load_rows<BK, kD, 256>(vg, k0, m.tk, d, vs);
    load_rows<BQ, kD, 256>(qg, qt0 * BQ, m.tq, d, qs);
    load_rows<BQ, kD, 256>(og, qt0 * BQ, m.tq, d, dos);
    load_vec<BQ>(lg, qt0 * BQ, m.tq, lses);
    load_vec<BQ>(dg, qt0 * BQ, m.tq, dls);
  }
  cp_commit();

  float dk[NB][4], dv[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.0f;
  const float* kw = ks + 16 * wr * LD;
  const float* vw = vs + 16 * wr * LD;

  for (int i = 0; i < nt; ++i) {
    const int st = i & 1;
    if (i + 1 < nt) {
      const int r1 = (qt0 + i + 1) * BQ;
      const int so = (st ^ 1) * BQ;
      load_rows<BQ, kD, 256>(qg, r1, m.tq, d, qs + so * LD);
      load_rows<BQ, kD, 256>(og, r1, m.tq, d, dos + so * LD);
      load_vec<BQ>(lg, r1, m.tq, lses + so);
      load_vec<BQ>(dg, r1, m.tq, dls + so);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int row0 = (qt0 + i) * BQ;
    const float* qt = qs + st * BQ * LD;
    const float* ot = dos + st * BQ * LD;
    const float* lt = lses + st * BQ;
    const float* dlt = dls + st * BQ;

    // phase A: S^T = K Q^T and dP^T = V dO^T on keys 16 wr.., queries na0..
    float s[NA][4], dp[NA][4], sl[NA][4], dpl[NA][4];
#pragma unroll
    for (int j = 0; j < NA; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = dp[j][e] = sl[j][e] = dpl[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kD / 8; ++kk) {
      const FragA ka = load_a(kw + 8 * kk, LD, g, t);
      const FragA va = load_a(vw + 8 * kk, LD, g, t);
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        const int n = (na0 + 8 * j) * LD + 8 * kk;
        mma3_split(s[j], sl[j], ka, load_b_nk(qt + n, LD, g, t));
        mma3_split(dp[j], dpl[j], va, load_b_nk(ot + n, LD, g, t));
      }
    }
#pragma unroll
    for (int j = 0; j < NA; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] += sl[j][e];
        dp[j][e] += dpl[j][e];
      }
    // P^T and dS^T (rows past Tq hold zeros: they add nothing), split
    const bool full = tile_full(m, row0, BQ, k0, BK);
#pragma unroll
    for (int j = 0; j < NA; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int key = 16 * wr + g + 8 * hr;
        uint4 pp, dd;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * hr + c;
          const int qi = na0 + 8 * j + 2 * t + c;
          const float lse = lt[qi];
          bool live = true;
          if (!full) {
            const int row = row0 + qi;
            live = row < m.tq && lse > -CUDART_INF_F &&
                   sees(m, row + m.q_offset, k0 + key);
          }
          float pv, ds;
          prob_and_ds(m, live, s[j][e], dp[j][e], lse, dlt[qi], pv, ds);
          const uint2 ps = split2(pv), dsp = split2(ds);
          if (c == 0) {
            pp.x = ps.x; pp.y = ps.y; dd.x = dsp.x; dd.y = dsp.y;
          } else {
            pp.z = ps.x; pp.w = ps.y; dd.z = dsp.x; dd.w = dsp.y;
          }
        }
        const int at = key * LP + na0 + 8 * j + 2 * t;
        *reinterpret_cast<uint4*>(pt + at) = pp;
        *reinterpret_cast<uint4*>(dst + at) = dd;
      }
    __syncthreads();

    // phase B: dV += P^T dO and dK += dS^T Q on keys 16 wr.., columns nb0..
#pragma unroll
    for (int kk = 0; kk < BQ / 8; ++kk) {
      const FragA pa = load_a(pt + 16 * wr * LP + 8 * kk, LP, g, t);
      const FragA da = load_a(dst + 16 * wr * LP + 8 * kk, LP, g, t);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int n = 8 * kk * LD + nb0 + 8 * j;
        mma3_add(dv[j], pa, load_b_kn(ot + n, LD, g, t));
        mma3_add(dk[j], da, load_b_kn(qt + n, LD, g, t));
      }
    }
    __syncthreads();                  // P^T, dS^T and the stage are free
  }

  // this head's dK and dV, or its partials of the group's
  const long long head = p.hq == p.hkv ? hk : static_cast<long long>(bh);
  float* dko = p.dk + head * m.tk * d;
  float* dvo = p.dv + head * m.tk * d;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = k0 + 16 * wr + g + 8 * hr;
    if (key >= m.tk) continue;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int col = nb0 + 8 * j + 2 * t;
      if (col >= d) continue;
      const long long at = static_cast<long long>(key) * d + col;
      *reinterpret_cast<float2*>(dko + at) =
          make_float2(dk[j][2 * hr], dk[j][2 * hr + 1]);
      *reinterpret_cast<float2*>(dvo + at) =
          make_float2(dv[j][2 * hr], dv[j][2 * hr + 1]);
    }
  }
}

// dK and dV of each KV head: its group's query-head partials added in
// order (h = 0, 1, ..), four floats a thread; blockIdx.y 0: dK, 1: dV
__global__ void __launch_bounds__(256)
flash_tf32_bwd_gqa_sum_kernel(const float* __restrict__ part,
                              float* __restrict__ dk, float* __restrict__ dv,
                              long long head4, long long total4,
                              long long part_stride, int hq, int hkv) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total4) return;
  const int rep = hq / hkv;
  const long long bk = i / head4;               // b * hkv + kv head
  const long long off = i - bk * head4;
  const long long b = bk / hkv;
  const long long first = b * hq + (bk - b * hkv) * rep;
  const float4* src = reinterpret_cast<const float4*>(
                          part + blockIdx.y * part_stride) +
                      first * head4 + off;
  float4 acc = src[0];
  for (int r = 1; r < rep; ++r) {
    const float4 x = src[r * head4];
    acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
  }
  reinterpret_cast<float4*>(blockIdx.y ? dv : dk)[i] = acc;
}

// The dQ kernel's tiles: kBQ queries a CTA, kBK keys a step; 8 warps as kR
// row groups of 16 queries x kC column groups.  Up to kD = 128 a CTA takes
// 64 queries and 32 keys a step (two CTAs an SM at kD = 64), at 256 32 x
// 32.  K and V land in two stages.
template <int kD>
struct DqTiles {
  static constexpr int kBQ = kD <= 128 ? 64 : 32;
  static constexpr int kBK = 32;
  static constexpr int kLD = kD + 4;
  static constexpr int kLS = kBK + 4;              // pitch of dS
  static constexpr int kR = kBQ / 16;
  static constexpr int kC = 8 / kR;
  static constexpr int kNA = kBK / (8 * kC);       // phase A: key n tiles
  static constexpr int kNB = kD / (8 * kC);        // phase B: column tiles
  // Q and dO; two stages of K and V; dS split
  static constexpr int kSmem =
      4 * (2 * kBQ * kLD + 2 * 2 * kBK * kLD) + 8 * kBQ * kLS;
};

template <int kD>
__global__ void __launch_bounds__(256, kD == 64 ? 2 : 1)
flash_tf32_bwd_dq_kernel(BwdParams p) {
  using Tl = DqTiles<kD>;
  constexpr int BQ = Tl::kBQ, BK = Tl::kBK, LD = Tl::kLD, LS = Tl::kLS;
  constexpr int C = Tl::kC, NA = Tl::kNA, NB = Tl::kNB;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [BQ][LD]
  float* dos = qs + BQ * LD;                     // [BQ][LD]
  float* ks = dos + BQ * LD;                     // [2][BK][LD]
  float* vs = ks + 2 * BK * LD;                  // [2][BK][LD]
  uint2* dss = reinterpret_cast<uint2*>(vs + 2 * BK * LD);   // [BQ][LS]
  const Masks& m = p.m;
  const int d = p.d;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest first
  const int bh = blockIdx.y;
  const int b = bh / p.hq;
  const int h = bh - b * p.hq;
  const long long hk = static_cast<long long>(b) * p.hkv + h / (p.hq / p.hkv);
  const float* qg = p.q + static_cast<long long>(bh) * m.tq * d;
  const float* og = p.dout + static_cast<long long>(bh) * m.tq * d;
  const float* kg = p.k + hk * m.tk * d;
  const float* vg = p.v + hk * m.tk * d;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int wr = warp / C;            // queries 16 wr ..
  const int wc = warp - wr * C;
  const int na0 = wc * (BK / C);      // phase A: keys na0 ..
  const int nb0 = wc * (kD / C);      // phase B: columns nb0 ..

  int kt0, nt;
  key_tiles(m, q0, min(q0 + BQ, m.tq), BK, kt0, nt);
  if (d < kD) zero_cols<kD, 256>(qs, 2 * BQ + 4 * BK, d);
  if (nt > 0) {
    load_rows<BQ, kD, 256>(qg, q0, m.tq, d, qs);
    load_rows<BQ, kD, 256>(og, q0, m.tq, d, dos);
    load_rows<BK, kD, 256>(kg, kt0 * BK, m.tk, d, ks);
    load_rows<BK, kD, 256>(vg, kt0 * BK, m.tk, d, vs);
  }
  cp_commit();

  // this thread's rows (g, g + 8 of the warp's 16): lse and delta (0 past
  // Tq, where Q and dO are 0 too)
  float lse[2], dl[2];
  bool row_ok[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + 16 * wr + g + 8 * hr;
    const long long at = static_cast<long long>(bh) * m.tq + row;
    const bool in = row < m.tq;
    lse[hr] = in ? p.lse[at] : 0.0f;
    dl[hr] = in ? p.delta[at] : 0.0f;
    row_ok[hr] = in && lse[hr] > -CUDART_INF_F;
  }
  float dq[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.0f;
  const float* qw = qs + 16 * wr * LD;
  const float* ow = dos + 16 * wr * LD;

  for (int i = 0; i < nt; ++i) {
    const int st = i & 1;
    if (i + 1 < nt) {
      const int k1 = (kt0 + i + 1) * BK;
      load_rows<BK, kD, 256>(kg, k1, m.tk, d, ks + (st ^ 1) * BK * LD);
      load_rows<BK, kD, 256>(vg, k1, m.tk, d, vs + (st ^ 1) * BK * LD);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int k0 = (kt0 + i) * BK;
    const float* kt = ks + st * BK * LD;
    const float* vt = vs + st * BK * LD;

    // phase A: S = Q K^T and dP = dO V^T on queries 16 wr.., keys na0..
    float s[NA][4], dp[NA][4], sl[NA][4], dpl[NA][4];
#pragma unroll
    for (int j = 0; j < NA; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = dp[j][e] = sl[j][e] = dpl[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kD / 8; ++kk) {
      const FragA qa = load_a(qw + 8 * kk, LD, g, t);
      const FragA oa = load_a(ow + 8 * kk, LD, g, t);
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        const int n = (na0 + 8 * j) * LD + 8 * kk;
        mma3_split(s[j], sl[j], qa, load_b_nk(kt + n, LD, g, t));
        mma3_split(dp[j], dpl[j], oa, load_b_nk(vt + n, LD, g, t));
      }
    }
#pragma unroll
    for (int j = 0; j < NA; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] += sl[j][e];
        dp[j][e] += dpl[j][e];
      }
    const bool full = tile_full(m, q0, BQ, k0, BK);
#pragma unroll
    for (int j = 0; j < NA; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int qi = 16 * wr + g + 8 * hr;
        uint4 dd;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * hr + c;
          const int key = na0 + 8 * j + 2 * t + c;
          const bool live =
              full || (row_ok[hr] && sees(m, q0 + qi + m.q_offset, k0 + key));
          float pv, ds;
          prob_and_ds(m, live, s[j][e], dp[j][e], lse[hr], dl[hr], pv, ds);
          const uint2 dsp = split2(ds);
          if (c == 0) {
            dd.x = dsp.x; dd.y = dsp.y;
          } else {
            dd.z = dsp.x; dd.w = dsp.y;
          }
        }
        *reinterpret_cast<uint4*>(dss + qi * LS + na0 + 8 * j + 2 * t) = dd;
      }
    __syncthreads();

    // phase B: dQ += dS K on queries 16 wr.., columns nb0..
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const FragA da = load_a(dss + 16 * wr * LS + 8 * kk, LS, g, t);
#pragma unroll
      for (int j = 0; j < NB; ++j)
        mma3_add(dq[j], da,
                 load_b_kn(kt + 8 * kk * LD + nb0 + 8 * j, LD, g, t));
    }
    __syncthreads();                  // dS and the stage are free
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + 16 * wr + g + 8 * hr;
    if (row >= m.tq) continue;
    float* out = p.dq + (static_cast<long long>(bh) * m.tq + row) * d;
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (nb0 + 8 * j < d)
        *reinterpret_cast<float2*>(out + nb0 + 8 * j + 2 * t) =
            make_float2(dq[j][2 * hr], dq[j][2 * hr + 1]);
  }
}

// -- launches ----------------------------------------------------------------

// The column width the tiles are laid out for: 64, 128 or 256.
int tile_width(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 256; }

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int kD>
cudaError_t launch_fwd(const Params& p, int batch, int smem,
                       cudaStream_t stream) {
  using Tl = FwdTiles<kD>;
  if (smem != Tl::kSmem) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(flash_tf32_fwd_kernel<kD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.m.tq + Tl::kBQ - 1) / Tl::kBQ, batch * p.hq);
  flash_tf32_fwd_kernel<kD><<<grid, Tl::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int kD>
cudaError_t launch_bwd(BwdParams p, const float* o, float* delta, float* part,
                       int batch, int dkdv_smem, int dq_smem,
                       cudaStream_t stream) {
  using Kv = DkdvTiles<kD>;
  using Qt = DqTiles<kD>;
  if (dkdv_smem != Kv::kSmem || dq_smem != Qt::kSmem)
    return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(batch) * p.hq * p.m.tq;
  flash_tf32_bwd_delta_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                                stream>>>(o, p.dout, delta, rows, p.d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  float* dk = p.dk;
  float* dv = p.dv;
  const long long part_stride =
      static_cast<long long>(batch) * p.hq * p.m.tk * p.d;
  if (p.hq != p.hkv) {                // each query head's partials
    p.dk = part;
    p.dv = part + part_stride;
  }
  err = set_smem(flash_tf32_bwd_dkdv_kernel<kD>, dkdv_smem);
  if (err != cudaSuccess) return err;
  flash_tf32_bwd_dkdv_kernel<kD>
      <<<dim3((p.m.tk + Kv::kBK - 1) / Kv::kBK, batch * p.hq), 256,
         dkdv_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.hq != p.hkv) {
    const long long head4 = static_cast<long long>(p.m.tk) * p.d / 4;
    const long long total4 = static_cast<long long>(batch) * p.hkv * head4;
    flash_tf32_bwd_gqa_sum_kernel<<<
        dim3(static_cast<unsigned>((total4 + 255) / 256), 2), 256, 0,
        stream>>>(part, dk, dv, head4, total4, part_stride, p.hq, p.hkv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  err = set_smem(flash_tf32_bwd_dq_kernel<kD>, dq_smem);
  if (err != cudaSuccess) return err;
  flash_tf32_bwd_dq_kernel<kD>
      <<<dim3((p.m.tq + Qt::kBQ - 1) / Qt::kBQ, batch * p.hq), 256, dq_smem,
         stream>>>(p);
  return cudaGetLastError();
}

bool bad_shape(int batch, int hq, int hkv, int tq, int tk, int d) {
  return d <= 0 || d > 256 || d % 8 != 0 || hkv <= 0 || hq % hkv != 0 ||
         batch <= 0 || tq < 0 || tk < 0;
}

}  // namespace

// dtype: 0 float32 (bfloat16 is flash_attention_sm90.cu's).  `smem` is the
// wrapper's launch plan (repro_torch.kernels.flash_attention.launch_plan:
// the forward's "smem"), refused unless it equals the layout's.  Returns
// the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int dtype, int batch,
                                   int hq, int hkv, int tq, int tk, int d,
                                   float scale, int causal, int window,
                                   int prefix, int use_softcap, float softcap,
                                   int q_offset, int smem, void* stream) {
  if (dtype != 0 || bad_shape(batch, hq, hkv, tq, tk, d))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<float*>(o), lse,
                 hq, hkv, d,
                 Masks{tq, tk, scale, causal, window, prefix, use_softcap,
                       softcap, q_offset}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (tile_width(d)) {
    case 64: err = launch_fwd<64>(p, batch, smem, s); break;
    case 128: err = launch_fwd<128>(p, batch, smem, s); break;
    default: err = launch_fwd<256>(p, batch, smem, s); break;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The gradients (dq like q; dk, dv like k) from the saved forward (o, lse)
// and dout; delta is float32 scratch [batch, hq, tq]; `part` float32
// scratch [2, batch, hq, tk, d] where hq > hkv (the query heads' dK and dV
// partials), else unused.  dtype: 0 float32.  dkdv_smem and dq_smem are
// the launch plan's, refused unless they equal the layouts'.  Returns the
// first failing launch's cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, float* part, int dtype,
                                   int batch, int hq, int hkv, int tq, int tk,
                                   int d, float scale, int causal, int window,
                                   int prefix, int use_softcap, float softcap,
                                   int q_offset, int dkdv_smem, int dq_smem,
                                   void* stream) {
  if (dtype != 0 || bad_shape(batch, hq, hkv, tq, tk, d) ||
      (hq != hkv && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdParams p{static_cast<const float*>(q),
                    static_cast<const float*>(k),
                    static_cast<const float*>(v),
                    static_cast<const float*>(dout), lse, delta,
                    static_cast<float*>(dq), static_cast<float*>(dk),
                    static_cast<float*>(dv), hq, hkv, d,
                    Masks{tq, tk, scale, causal, window, prefix, use_softcap,
                          softcap, q_offset}};
  const float* of = static_cast<const float*>(o);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (tile_width(d)) {
    case 64:
      err = launch_bwd<64>(p, of, delta, part, batch, dkdv_smem, dq_smem, s);
      break;
    case 128:
      err = launch_bwd<128>(p, of, delta, part, batch, dkdv_smem, dq_smem, s);
      break;
    default:
      err = launch_bwd<256>(p, of, delta, part, batch, dkdv_smem, dq_smem, s);
      break;
  }
  return static_cast<int>(err);
}

KINFO_NAMES(flash_attention, "flash_tf32_fwd<64>", "flash_tf32_fwd<128>",
            "flash_tf32_fwd<256>", "flash_tf32_bwd_delta",
            "flash_tf32_bwd_dkdv<64>", "flash_tf32_bwd_dkdv<128>",
            "flash_tf32_bwd_dkdv<256>", "flash_tf32_bwd_dq<64>",
            "flash_tf32_bwd_dq<128>", "flash_tf32_bwd_dq<256>",
            "flash_tf32_bwd_gqa_sum")

// kernels.autotune.kernel_attributes.  which: 0-2 flash_tf32_fwd_kernel
// <kD> for kD = 64, 128, 256, 3 the delta pre-pass, 4-6
// flash_tf32_bwd_dkdv_kernel<kD>, 7-9 flash_tf32_bwd_dq_kernel<kD>, 10 the
// GQA sum (all 256 threads).  dyn_smem < 0: the kernel's launch's (its
// layout's).  The runtime's occupancy is asked at query_block (the
// kernel's threads when <= 0).
extern "C" int flash_attention_kernel_info(int which, int block,
                                           int query_block, int dyn_smem,
                                           int* out) {
  (void)block;
  const int threads = 256;
  const int q = query_block > 0 ? query_block : threads;
  auto own = [dyn_smem](int layout) {
    return dyn_smem >= 0 ? dyn_smem : layout;
  };
  switch (which) {
    case 0: return kinfo::kernel_info(flash_tf32_fwd_kernel<64>, q,
                                      own(FwdTiles<64>::kSmem), out);
    case 1: return kinfo::kernel_info(flash_tf32_fwd_kernel<128>, q,
                                      own(FwdTiles<128>::kSmem), out);
    case 2: return kinfo::kernel_info(flash_tf32_fwd_kernel<256>, q,
                                      own(FwdTiles<256>::kSmem), out);
    case 3: return kinfo::kernel_info(flash_tf32_bwd_delta_kernel, q, own(0),
                                      out);
    case 4: return kinfo::kernel_info(flash_tf32_bwd_dkdv_kernel<64>, q,
                                      own(DkdvTiles<64>::kSmem), out);
    case 5: return kinfo::kernel_info(flash_tf32_bwd_dkdv_kernel<128>, q,
                                      own(DkdvTiles<128>::kSmem), out);
    case 6: return kinfo::kernel_info(flash_tf32_bwd_dkdv_kernel<256>, q,
                                      own(DkdvTiles<256>::kSmem), out);
    case 7: return kinfo::kernel_info(flash_tf32_bwd_dq_kernel<64>, q,
                                      own(DqTiles<64>::kSmem), out);
    case 8: return kinfo::kernel_info(flash_tf32_bwd_dq_kernel<128>, q,
                                      own(DqTiles<128>::kSmem), out);
    case 9: return kinfo::kernel_info(flash_tf32_bwd_dq_kernel<256>, q,
                                      own(DqTiles<256>::kSmem), out);
    case 10: return kinfo::kernel_info(flash_tf32_bwd_gqa_sum_kernel, q,
                                       own(0), out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
