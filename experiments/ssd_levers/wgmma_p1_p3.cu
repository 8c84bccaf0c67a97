// A design of the SSD scan kept for measurement (experiments/
// ssd_kernel_times.py --kernel), not built by the package: mma_sync.cu
// with P1 (y^T = S^T C^T) and P3 (the state update) moved to wgmma
// m64nNk8 (a head's warpgroup, A from registers, B from shared memory),
// P2 still on mma.sync; the tree's kernel moves P2 too.  The text below is
// this design's own (its header still describes mma_sync.cu); its launch
// takes its Layout's bytes, whatever shared memory the wrapper asks.
//
// Mamba2 SSD chunked scan on Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan_pallas
// (repro/kernels/ssd_scan.py:76, body `_kernel`), and for prefill the JAX
// package's XLA ssd_chunked(..., return_final_state=True): the chunked
// state-space-dual form of the Mamba2 recurrence,
//   within a chunk   att[i, j] = (C_i . B_j) exp(cum_i - cum_j) dt_j, j <= i
//                    y_intra   = att x
//   across chunks    y_inter_i = exp(cum_i) C_i . S
//                    y         = y_intra + y_inter + D x
//   state update     S <- exp(total) S + sum_j exp(total - cum_j) dt_j B_j x_j^T
// where cum is the within-chunk cumulative sum of dt A and total its last
// entry.  Only n_groups == 1: B and C are shared by every head.
//
// Layout: x [b, t, h, dh] and y like it, dt [b, t, h], A and D [h],
// B and C [b, t, ds], all float32, dense row-major (the wrapper makes them
// contiguous).  dh <= 64 and ds <= 128, both multiples of 4 (rows are
// copied 16 bytes at a time); the tiles are padded with zeros up to 64
// rows of dh and NS = 64 or 128 columns of ds (the instantiation: ds <= 64
// takes NS = 64), which adds nothing to any sum.
//
// The state transposed.  Each warp carries S^T [16 rows of dh][NS] of one
// head in the accumulator registers of the state product (NS / 2 floats a
// thread), and computes the chunk's y^T [its 16 dh rows][Q] itself:
//   P1  y^T  = S^T C^T                  [16, Q]  over ds  (A: S^T's own
//       registers, B: C)
//       y^T *= exp(cum_i)  (column i)
//   P2  y^T += x^T (G o decay o dt)^T   [16, Q]  over j <= i
//   P3  S^T  = exp(total) S^T + (w x)^T B   [16, NS] over j
// An mma.m16n8k8 accumulator holds, for a thread, columns 2q and 2q + 1 of
// each 8-column block; its A operand wants columns q and q + 4.  Every
// product permutes its k block the same way in both operands (instruction
// k = q <-> element 2q, k = q + 4 <-> element 2q + 1: a sum over k does not
// depend on its order), so S^T's accumulator registers are P1's A
// fragments as they stand, and each thread splits only its own state: no
// copy of S goes through shared memory, and no warp waits on another for
// y.  The four warps of a head, and the heads of a CTA, share nothing but
// the chunk's B, C, G = C B^T and dt.
//
// The split.  The products run on the tensor cores as 3xTF32 with
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32: each operand element
// a is split into hi = tf32(a) and lo = tf32(a - hi), both rounded to
// nearest with ties away from zero (cvt.rna.tf32.f32's rounding, done on
// the integer pipe), and a product accumulates lo.hi, then hi.lo, then
// hi.hi in float32 (lo.lo, ~2^-22 relative, is dropped).  One TF32 pass
// misses the SSD tolerance (2e-4) by ~17x.  C and B^T are split once a
// chunk by the whole CTA into shared memory, as (hi, lo) pairs in the
// layout their B fragments are read in (one 16-byte load a fragment); G o
// decay o dt once a chunk by each head's four warps, likewise; S^T and x by
// the one thread that holds them.  Everything else stays float32 on the
// CUDA cores: the cumulative sum of dt A (a shuffle scan each warp runs
// for itself, a lane per row of the chunk), the decays, the dt and w
// weights, exp(cum_i) on P1's columns, S and the D skip.  The upper
// triangle is set to 0 before any exp: there cum_i - cum_j > 0 and can
// overflow (inf * 0 would give NaN).
//
// Two passes.  Pass 1 (ssd_scan_kernel_cb) computes G = C B^T once for each
// (batch, chunk), the same for every head, into a float32 scratch [b,
// chunks, Q, Q] (the two tiles above the diagonal are not written).  Pass 2
// (ssd_scan_kernel<NS>): one CTA of 128 `heads` threads takes `heads`
// heads of one batch (the last group of a batch may hold fewer; its idle
// warps still copy and split), warp 4k + m on head k's dh rows 16m..16m +
// 15, and walks the chunks of Q = 32 rows in turn:
//   A. wait for chunk c's copies; barrier (every warp has left chunk c - 1);
//   B. split C into [i][s] and B^T into [s][j] (every thread), scan dt A
//      and split head k's G o decay o dt into [i][j] (its four warps);
//      barrier;
//   C. start chunk c + 1's copies (cp.async: B, C, G and dt into the raw
//      tiles, which B has read), then P1, P2 and P3 on chunk c, with x read
//      from global memory into registers at the start of P1 and first used
//      after it.
// The copies of chunk c + 1 run under chunk c's products.  The chunk is the
// kernel's own: the function does not depend on it (up to rounding); a t
// that 32 does not divide is masked by index (rows past t read as x = B =
// C = dt = 0, so they decay nothing and add nothing).  Prefill asks for the
// final state too (`fs`, not null): after the last chunk each warp stores
// its S^T rows into fs[b, h, :, its rows] ([b, h, ds, dh] float32); the
// padded rows of the last chunk left S as it was.
//
// What bounds it.  At mamba2's prefill (x [8, 2048, 80, 64], ds 128) the
// function moves 693 MB (0.207 ms at 3.35 TB/s) and needs 45.7 GFLOP at Q
// = 32: 3 x that at the 495 TFLOP/s of TF32 is 0.277 ms, so the split's
// operations bound it.  The kernel reaches the tensor cores through
// mma.sync, whose TF32 rate on this card is ~335 TFLOP/s (0.41 ms for the
// same work).  A head's walk is serial and its S (32 KB) lives in
// registers, so an SM holds 3 heads (NS = 128) or 4 (NS = 64): mamba2's 640
// heads take two rounds of the card, zamba2's 896 (ds 64) two.  The
// launch plan chooses `heads` a CTA from the rounds each choice takes
// (kernels/ssd_scan.py: launch_plan).  wgmma (m64nNk8, B from shared memory
// K-major) would fit P1 and P3 of a head's four warps, but its A operand
// read from registers must stay unchanged until the product completes,
// which for P1 holds S^T's split hi and lo (NS registers a thread) over
// the whole product beside the state itself; mma.sync consumes a fragment
// as it issues it.
//
// The build turns off multiply-add contraction (-fmad=false, _build.py);
// the products on the CUDA cores round as written.

#include <cuda_runtime.h>

#include "kernel_info.cuh"
#include <cstdint>

namespace {

constexpr int kQ = 32;                // rows of a chunk
constexpr int kDH = 64;               // largest head dim
constexpr int kDS = 128;              // largest state dim
constexpr int kHeadThreads = 128;     // 4 warps a head, 16 dh rows each
constexpr int kCbThreads = 256;       // pass 1
constexpr int kLCB = kDS + 8;         // pass 1's pitch of B and C rows
constexpr int kLG = kQ + 8;           // pitch of the split G rows (uint2)
constexpr int kLBT = kQ + 8;          // pitch of the split B^T rows (uint2)
constexpr int kLX = kDH + 4;          // pitch of the x rows (float)

// Pass 2's dynamic shared memory for NS columns of ds, in bytes: the raw
// tiles the copies land in, the CTA's split C and B^T as wgmma operands
// (hi and lo apart, float32 bits of tf32 values, K-major 8 x 16-byte core
// matrices without swizzle), then per head the split G o decay o dt, dt and
// x in two buffers.  The raw pitches keep the splitting reads free of bank
// conflicts (pitch mod 32 words 4), the uint2 tile's fragment loads too
// (16).
template <int NS>
struct Layout {
  static constexpr int kLr = NS + 4;                  // raw B, C rows
  static constexpr int kRawB = 0;                     // float [Q][kLr]
  static constexpr int kRawC = kRawB + 4 * kQ * kLr;  // float [Q][kLr]
  static constexpr int kRawG = kRawC + 4 * kQ * kLr;  // float [Q][Q]
  static constexpr int kTile = 4 * kQ * NS;           // one split tile
  static constexpr int kCh = kRawG + 4 * kQ * kQ;     // C [i][s], hi
  static constexpr int kCl = kCh + kTile;             //   lo
  static constexpr int kBh = kCl + kTile;             // B^T [s][j], hi
  static constexpr int kBl = kBh + kTile;             //   lo
  static constexpr int kHeads = kBl + kTile;
  static constexpr int kGsp = 0;                      // uint2 [Q][kLG]
  static constexpr int kDt = 8 * kQ * kLG;            // float [Q]
  static constexpr int kX = kDt + 4 * kQ;             // float [2][Q][kLX]
  static constexpr int kPerHead = kX + 2 * 4 * kQ * kLX;
  // heads a CTA may take: the registers of 128 threads a head at the
  // __launch_bounds__ below (S^T alone is NS / 2 a thread)
  static constexpr int kMaxHeads = NS == 128 ? 3 : 4;
  static constexpr int bytes(int heads) { return kHeads + heads * kPerHead; }
  static_assert(kCh % 128 == 0 && kPerHead % 128 == 0, "tile alignment");
};

struct Params {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  const float* D;    // nullptr: no skip term
  float* y;
  float* cb;         // C B^T of every chunk: [batch, chunks, Q, Q]
  float* fs;         // nullptr, or the final state [batch, h, ds, dh]
  int t, h, dh, ds;
  int heads;         // heads a CTA (pass 2)
};

// An mma operand fragment, split: the tf32 hi part and the remainder's.
struct FragA { uint32_t hi[4], lo[4]; };
struct FragB { uint32_t hi[2], lo[2]; };

// cvt.rna.tf32.f32 on the integer pipe: add half of the 13 dropped bits'
// unit to the magnitude and clear them (round to nearest, ties away from
// zero; the operands here are finite).  The cvt instruction itself
// compiles to four instructions with NaN handling.
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

// Fragment coordinates (PTX ISA, m16n8k8 .tf32), g = lane / 4, q = lane % 4:
// A (16 x 8): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4);
// B (8 x 8):  b0 (k = q, n = g), b1 (k = q + 4, n = g);
// C (16 x 8): c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8, 2q + 1).
// With the k permutation (k = q <-> element 2q, k = q + 4 <-> 2q + 1) a B
// fragment of a split [n][k] tile is one 16-byte load: (hi, lo) of
// elements 2q and 2q + 1 of row g.
__device__ __forceinline__ FragB load_b_split(const uint2* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  FragB f;
  f.hi[0] = v.x;
  f.lo[0] = v.y;
  f.hi[1] = v.z;
  f.lo[1] = v.w;
  return f;
}

// A from four float32 values in fragment order (a0 .. a3), split
__device__ __forceinline__ FragA split_a(float a0, float a1, float a2,
                                         float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

// -- wgmma (m64nNk8, tf32): A from registers, B K-major in shared memory --

// Shared-memory matrix descriptor of a K-major operand without swizzle:
// 8-row x 16-byte core matrices, `lbo` bytes apart along K and `sbo` bytes
// apart along N.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// shared-memory writes by the threads, then read by wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+f"(d[i][r])::"memory");
}

// d (64 x 32 of a warpgroup; a warp's 16 rows x 4 blocks of 8) += a b
__device__ __forceinline__ void wgmma_n32(float (&d)[4][4],
                                          const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[16][4],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (N columns) += a b in 3xTF32 on wgmma: lo.hi, hi.lo, then hi.hi
template <int N>
__device__ __forceinline__ void wgmma3(float (&d)[N / 8][4], const FragA& a,
                                       uint64_t bhi, uint64_t blo) {
  if constexpr (N == 32) {
    wgmma_n32(d, a.lo, bhi);
    wgmma_n32(d, a.hi, blo);
    wgmma_n32(d, a.hi, bhi);
  } else if constexpr (N == 64) {
    wgmma_n64(d, a.lo, bhi);
    wgmma_n64(d, a.hi, blo);
    wgmma_n64(d, a.hi, bhi);
  } else {
    wgmma_n128(d, a.lo, bhi);
    wgmma_n128(d, a.hi, blo);
    wgmma_n128(d, a.hi, bhi);
  }
}

// A from a row-major [m][k] tile at p (its (0, 0)), pass 1
__device__ __forceinline__ FragA load_a(const float* p, int ld, int g, int q) {
  const float2 r0 = *reinterpret_cast<const float2*>(p + g * ld + 2 * q);
  const float2 r1 = *reinterpret_cast<const float2*>(p + (g + 8) * ld + 2 * q);
  return split_a(r0.x, r1.x, r0.y, r1.y);
}

// B from an [n][k] tile, pass 1
__device__ __forceinline__ FragB load_b_nk(const float* p, int ld, int g,
                                           int q) {
  const float2 r = *reinterpret_cast<const float2*>(p + g * ld + 2 * q);
  FragB f;
  split(r.x, f.hi[0], f.lo[0]);
  split(r.y, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void cp_async16(void* dst, const float* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const float* src,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Pass 1: G = C B^T of one chunk (the same for every head, g = 1), one
// CTA per (batch, chunk), warp w on the 16 x 8 tile (w / 4, w % 4) of
// the lower triangle's tiles; the two tiles above it are skipped.
__global__ void __launch_bounds__(kCbThreads)
ssd_scan_kernel_cb(Params p) {
  __shared__ __align__(16) float bs[kQ * kLCB];
  __shared__ __align__(16) float cs[kQ * kLCB];
  const int nc = (p.t + kQ - 1) / kQ;
  const int b = blockIdx.x / nc;
  const int c0 = (blockIdx.x - b * nc) * kQ;
  const int rows = min(kQ, p.t - c0);
  const long long row0 = static_cast<long long>(b) * p.t + c0;
  const int tid = threadIdx.x;
  for (int i = tid; i < kQ * (kDS / 4); i += kCbThreads) {
    const int j = i / (kDS / 4);
    const int s = (i % (kDS / 4)) * 4;
    float4 vb = make_float4(0.f, 0.f, 0.f, 0.f), vc = vb;
    if (j < rows && s < p.ds) {
      const long long off = (row0 + j) * p.ds + s;
      vb = *reinterpret_cast<const float4*>(p.B + off);
      vc = *reinterpret_cast<const float4*>(p.C + off);
    }
    *reinterpret_cast<float4*>(&bs[j * kLCB + s]) = vb;
    *reinterpret_cast<float4*>(&cs[j * kLCB + s]) = vc;
  }
  __syncthreads();
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int q = tid & 3;
  const int mt = warp >> 2;
  const int nt = warp & 3;
  if (mt == 0 && nt >= 2) return;     // above the diagonal
  float acc[4] = {};
#pragma unroll
  for (int ks = 0; ks < kDS / 8; ++ks)
    mma3(acc, load_a(cs + 16 * mt * kLCB + 8 * ks, kLCB, g, q),
         load_b_nk(bs + 8 * nt * kLCB + 8 * ks, kLCB, g, q));
  float* out = p.cb + static_cast<long long>(blockIdx.x) * kQ * kQ;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
    *reinterpret_cast<float2*>(out + (16 * mt + g + 8 * hr) * kQ + 8 * nt +
                               2 * q) = make_float2(acc[2 * hr],
                                                    acc[2 * hr + 1]);
}

// Pass 2: the scan, one CTA per (batch, group of p.heads heads).
template <int NS>
__global__ void __launch_bounds__(kHeadThreads * Layout<NS>::kMaxHeads, 1)
ssd_scan_kernel(Params p) {
  using L = Layout<NS>;
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  float* raw_b = reinterpret_cast<float*>(sm + L::kRawB);
  float* raw_c = reinterpret_cast<float*>(sm + L::kRawC);
  float* raw_g = reinterpret_cast<float*>(sm + L::kRawG);
  float* ch = reinterpret_cast<float*>(sm + L::kCh);
  float* cl = reinterpret_cast<float*>(sm + L::kCl);
  float* bh = reinterpret_cast<float*>(sm + L::kBh);
  float* bl = reinterpret_cast<float*>(sm + L::kBl);

  const int groups = (p.h + p.heads - 1) / p.heads;
  const int b = blockIdx.x / groups;
  const int hd0 = (blockIdx.x - b * groups) * p.heads;
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int k = warp >> 2;            // this warp's head in the CTA
  const int d0 = 16 * (warp & 3);     // its dh rows d0 .. d0 + 15
  const int hd = hd0 + k;
  // a warpgroup computes for its head as one (wgmma); rows past dh are x
  // = 0 and store nothing
  const bool live = hd < p.h;
  char* mine = sm + L::kHeads + k * L::kPerHead;
  uint2* gsp = reinterpret_cast<uint2*>(mine + L::kGsp);
  const float* dts = reinterpret_cast<const float*>(mine + L::kDt);
  const int nc = (p.t + kQ - 1) / kQ;
  const float a = hd < p.h ? p.A[hd] : 0.0f;
  const float dskip = hd < p.h && p.D ? p.D[hd] : 0.0f;
  const long long xrow = static_cast<long long>(p.h) * p.dh;

  // chunk c's B, C, G and dt into the raw tiles (zero past t, ds and h)
  auto copy = [&](int c) {
    const int rows = min(kQ, p.t - c * kQ);
    const long long row0 = static_cast<long long>(b) * p.t + c * kQ;
    for (int u = tid; u < kQ * (NS / 4); u += nthreads) {
      const int j = u / (NS / 4);
      const int s = (u % (NS / 4)) * 4;
      const bool ok = j < rows && s < p.ds;
      const long long off = (row0 + j) * p.ds + s;
      cp_async16(raw_b + j * L::kLr + s, ok ? p.B + off : p.B, ok);
      cp_async16(raw_c + j * L::kLr + s, ok ? p.C + off : p.C, ok);
    }
    const float* gsrc = p.cb + (static_cast<long long>(b) * nc + c) * kQ * kQ;
    for (int u = tid; u < kQ * kQ / 4; u += nthreads)
      cp_async16(raw_g + 4 * u, gsrc + 4 * u, true);
    for (int u = tid; u < p.heads * kQ; u += nthreads) {
      const int kk = u / kQ;
      const int j = u - kk * kQ;
      const bool ok = j < rows && hd0 + kk < p.h;
      float* dst = reinterpret_cast<float*>(sm + L::kHeads +
                                            kk * L::kPerHead + L::kDt) + j;
      cp_async4(dst, ok ? p.dt + (row0 + j) * p.h + hd0 + kk : p.dt, ok);
    }
    // x of every head, into the buffer c & 1 (zero past t, dh and h)
    for (int u = tid; u < p.heads * kQ * (kDH / 4); u += nthreads) {
      const int kk = u / (kQ * (kDH / 4));
      const int j = (u / (kDH / 4)) % kQ;
      const int d = (u % (kDH / 4)) * 4;
      const bool ok = j < rows && d < p.dh && hd0 + kk < p.h;
      float* dst = reinterpret_cast<float*>(sm + L::kHeads +
                                            kk * L::kPerHead + L::kX) +
                   ((c & 1) * kQ + j) * kLX + d;
      cp_async16(dst,
                 ok ? p.x + (row0 + j) * xrow +
                          static_cast<long long>(hd0 + kk) * p.dh + d
                    : p.x,
                 ok);
    }
    cp_commit();
  };

  float st[NS / 8][4];                // S^T rows d0 + g (+8), cols 8n + 2q
#pragma unroll
  for (int n = 0; n < NS / 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) st[n][r] = 0.0f;

  copy(0);
  for (int c = 0; c < nc; ++c) {
    const int rows = min(kQ, p.t - c * kQ);
    const long long row0 = static_cast<long long>(b) * p.t + c * kQ;
    // A. chunk c's tiles have landed, and every warp has left chunk c - 1
    cp_wait_all();
    __syncthreads();

    // B. C and B^T split into hi and lo, in the wgmma operands' core
    // matrices.  C [i][s] (K = s), k permuted within each 8: position kk of
    // block n holds s = 8n + 2kk (kk < 4) or 8n + 2(kk - 4) + 1, the order
    // of S^T's accumulator registers (P1's A); a thread writes one row's
    // two 16-byte chunks of a block.
    for (int u = tid; u < kQ * (NS / 8); u += nthreads) {
      const int i = u % kQ;
      const int n = u / kQ;
      const float4 v0 =
          *reinterpret_cast<const float4*>(raw_c + i * L::kLr + 8 * n);
      const float4 v1 =
          *reinterpret_cast<const float4*>(raw_c + i * L::kLr + 8 * n + 4);
      const int off = ((i >> 3) * (NS / 4) + 2 * n) * 32 + (i & 7) * 4;
      uint2 e[8];
      e[0] = split2(v0.x); e[1] = split2(v0.z); e[2] = split2(v1.x);
      e[3] = split2(v1.z); e[4] = split2(v0.y); e[5] = split2(v0.w);
      e[6] = split2(v1.y); e[7] = split2(v1.w);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint2* f = e + 4 * half;
        *reinterpret_cast<uint4*>(ch + off + 32 * half) =
            make_uint4(f[0].x, f[1].x, f[2].x, f[3].x);
        *reinterpret_cast<uint4*>(cl + off + 32 * half) =
            make_uint4(f[0].y, f[1].y, f[2].y, f[3].y);
      }
    }
    // B^T [s][j] (K = j): a thread writes row s's 16-byte chunk jc (j =
    // 4jc .. 4jc + 3), neighbouring lanes neighbouring rows
    for (int u = tid; u < NS * 8; u += nthreads) {
      const int sr = u % NS;
      const int jc = u / NS;
      uint2 f[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        f[r] = split2(raw_b[(4 * jc + r) * L::kLr + sr]);
      const int off = ((sr >> 3) * 8 + jc) * 32 + (sr & 7) * 4;
      *reinterpret_cast<uint4*>(bh + off) =
          make_uint4(f[0].x, f[1].x, f[2].x, f[3].x);
      *reinterpret_cast<uint4*>(bl + off) =
          make_uint4(f[0].y, f[1].y, f[2].y, f[3].y);
    }
    // every warp scans its head's dt A itself, lane j holding row j
    const float dtj = dts[lane];
    float cum = dtj * a;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, cum, off);
      if (lane >= off) cum += o;
    }
    const float total = __shfl_sync(0xffffffffu, cum, 31);
    {
      // G[i][j] exp(cum_i - cum_j) dt_j on the lower triangle, split: warp
      // m of the head on rows 8m.., lane on row 8m + g, columns 8q..8q + 7.
      // The upper triangle (never written by pass 1) is zeroed before the
      // exp sees it.
      const int i = 8 * (warp & 3) + g;
      const int j0 = 8 * q;
      const float ci = __shfl_sync(0xffffffffu, cum, i);
      const float4 g0 = *reinterpret_cast<const float4*>(raw_g + i * kQ + j0);
      const float4 g1 =
          *reinterpret_cast<const float4*>(raw_g + i * kQ + j0 + 4);
      const float gin[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      uint2 e[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int j = j0 + x;
        const float cj = __shfl_sync(0xffffffffu, cum, j);
        const float dj = __shfl_sync(0xffffffffu, dtj, j);
        const float dec = expf(j <= i ? ci - cj : 0.0f);
        e[x] = split2(j <= i ? gin[x] * dec * dj : 0.0f);
      }
#pragma unroll
      for (int x = 0; x < 8; x += 2)
        *reinterpret_cast<uint4*>(gsp + i * kLG + j0 + x) =
            make_uint4(e[x].x, e[x].y, e[x + 1].x, e[x + 1].y);
    }
    const float ecum = expf(cum);                 // y_inter's decay, row j
    const float w = expf(total - cum) * dtj;      // the state's weight
    fence_proxy_async();                          // the tiles wgmma reads
    __syncthreads();

    // C. the next chunk's copies run under this chunk's products
    if (c + 1 < nc) copy(c + 1);
    if (!live) continue;

    // P1: y^T = S^T C^T on wgmma (m64n32k8, the head's four warps), A
    // straight from the state's registers; in groups of four k steps, each
    // group's A registers held until it completes
    float acc[kQ / 8][4];
#pragma unroll
    for (int ni = 0; ni < kQ / 8; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[ni][r] = 0.0f;
#pragma unroll
    for (int k0 = 0; k0 < NS / 8; k0 += 4) {
      FragA fa[4];
#pragma unroll
      for (int kb = 0; kb < 4; ++kb)
        fa[kb] = split_a(st[k0 + kb][0], st[k0 + kb][2], st[k0 + kb][1],
                         st[k0 + kb][3]);
      reg_fence(acc);
      wg_fence();
#pragma unroll
      for (int kb = 0; kb < 4; ++kb)
        wgmma3<kQ>(acc, fa[kb], desc(ch + (k0 + kb) * 64, 128, NS * 32),
                   desc(cl + (k0 + kb) * 64, 128, NS * 32));
      wg_commit();
      wg_wait_all();
      reg_fence(acc);
    }
    // x^T in mma.sync's A-fragment order: xa[kb] = x at (d0 + g, 8kb + 2q),
    // (d0 + g + 8, 8kb + 2q), (d0 + g, 8kb + 2q + 1), (d0 + g + 8, 8kb + 2q
    // + 1)
    const float* xs = reinterpret_cast<const float*>(mine + L::kX) +
                      (c & 1) * kQ * kLX;
    float xa[kQ / 8][4];
#pragma unroll
    for (int kb = 0; kb < kQ / 8; ++kb)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        xa[kb][r] =
            xs[(8 * kb + 2 * q + (r >> 1)) * kLX + d0 + g + 8 * (r & 1)];
    // column i by exp(cum_i)
#pragma unroll
    for (int ni = 0; ni < kQ / 8; ++ni) {
      const float e0 = __shfl_sync(0xffffffffu, ecum, 8 * ni + 2 * q);
      const float e1 = __shfl_sync(0xffffffffu, ecum, 8 * ni + 2 * q + 1);
      acc[ni][0] *= e0;
      acc[ni][1] *= e1;
      acc[ni][2] *= e0;
      acc[ni][3] *= e1;
    }
    // P2: y^T += x^T (G o decay o dt)^T over the lower triangle's blocks
#pragma unroll
    for (int kb = 0; kb < kQ / 8; ++kb) {
      const FragA fx = split_a(xa[kb][0], xa[kb][1], xa[kb][2], xa[kb][3]);
#pragma unroll
      for (int ni = 0; ni < kQ / 8; ++ni)
        if (ni >= kb)
          mma3(acc[ni], fx,
               load_b_split(gsp + (8 * ni + g) * kLG + 8 * kb + 2 * q));
    }
    // D x (y^T's (d, i) is x^T's fragment element at (d, j = i)) and y
#pragma unroll
    for (int ni = 0; ni < kQ / 8; ++ni) {
      acc[ni][0] += dskip * xa[ni][0];
      acc[ni][1] += dskip * xa[ni][2];
      acc[ni][2] += dskip * xa[ni][1];
      acc[ni][3] += dskip * xa[ni][3];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * ni + 2 * q + (r & 1);
        const int d = d0 + g + 8 * (r >> 1);
        if (i < rows && d < p.dh)
          p.y[(row0 + i) * xrow + static_cast<long long>(hd) * p.dh + d] =
              acc[ni][r];
      }
    }

    // P3: S^T = exp(total) S^T + (w x)^T B
    const float etot = expf(total);
#pragma unroll
    for (int n = 0; n < NS / 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) st[n][r] *= etot;
    // (w x)^T's A fragments in wgmma's k order: (d0 + g (+8), 8kb + q
    // (+4)), x read from its tile
    const float* xq = reinterpret_cast<const float*>(mine + L::kX) +
                      ((c & 1) * kQ + q) * kLX + d0 + g;
    FragA fw[kQ / 8];
#pragma unroll
    for (int kb = 0; kb < kQ / 8; ++kb) {
      const float w0 = __shfl_sync(0xffffffffu, w, 8 * kb + q);
      const float w1 = __shfl_sync(0xffffffffu, w, 8 * kb + q + 4);
      const float* xk = xq + 8 * kb * kLX;
      fw[kb] = split_a(xk[0] * w0, xk[8] * w0, xk[4 * kLX] * w1,
                       xk[4 * kLX + 8] * w1);
    }
    reg_fence(st);
    wg_fence();
#pragma unroll
    for (int kb = 0; kb < kQ / 8; ++kb)
      wgmma3<NS>(st, fw[kb], desc(bh + kb * 64, 128, 1024),
                 desc(bl + kb * 64, 128, 1024));
    wg_commit();
    wg_wait_all();
    reg_fence(st);
  }
  if (p.fs == nullptr || !live) return;
  // the state after the last chunk: fs[b, hd, s, d] for this warp's rows d
  float* out =
      p.fs + (static_cast<long long>(b) * p.h + hd) * p.ds * p.dh;
#pragma unroll
  for (int n = 0; n < NS / 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int s = 8 * n + 2 * q + (r & 1);
      const int d = d0 + g + 8 * (r >> 1);
      if (s < p.ds && d < p.dh)
        out[static_cast<long long>(s) * p.dh + d] = st[n][r];
    }
}

template <int NS>
int launch_scan(const Params& p, int batch, int smem, cudaStream_t s) {
  using L = Layout<NS>;
  if (p.heads < 1 || p.heads > L::kMaxHeads)
    return static_cast<int>(cudaErrorInvalidValue);
  smem = L::bytes(p.heads);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long groups = (p.h + p.heads - 1) / p.heads;
  ssd_scan_kernel<NS><<<static_cast<unsigned>(batch * groups),
                        kHeadThreads * p.heads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the first failing launch's cudaError_t.  D may be null; `cb` is
// float32 scratch of batch * ceil(t / 32) * 32 * 32 entries; `fs` null or
// the final state's [batch, h, ds, dh] float32; `heads` (heads a CTA) and
// `smem` are the wrapper's launch plan (repro_torch.kernels.ssd_scan.
// launch_plan: the scan's "heads" and "smem"), refused unless `heads` is
// one the instantiation takes and `smem` equals its Layout's bytes.
// Pass 1's grid is batch * chunks; pass 2's batch * ceil(h / heads), of
// 128 heads threads, NS = 64 where ds <= 64, else 128.
extern "C" int ssd_scan_fwd(const float* x, const float* dt, const float* A,
                            const float* B, const float* C, const float* D,
                            float* y, float* cb, float* fs, int batch,
                            int t, int h, int dh, int ds, int heads,
                            int smem, void* stream) {
  if (dh <= 0 || dh > kDH || dh % 4 || ds <= 0 || ds > kDS || ds % 4 ||
      t <= 0 || h <= 0 || batch <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params p{x, dt, A, B, C, D, y, cb, fs, t, h, dh, ds, heads};
  const long long nc = (t + kQ - 1) / kQ;
  ssd_scan_kernel_cb<<<static_cast<unsigned>(batch * nc), kCbThreads, 0,
                       s>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return ds <= 64 ? launch_scan<64>(p, batch, smem, s)
                  : launch_scan<128>(p, batch, smem, s);
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

KINFO_NAMES(ssd_scan, "ssd_scan_cb", "ssd_scan", "ssd_scan_ds64")

// kernels.autotune.kernel_attributes.  which: 0 ssd_scan_kernel_cb (static
// shared memory, 256 threads), 1 ssd_scan_kernel<128> (384 threads: 3
// heads), 2 ssd_scan_kernel<64> (512 threads: 4 heads); dyn_smem < 0: the
// instantiation's Layout at its most heads.  The runtime's occupancy is
// asked at query_block (the kernel's own block when <= 0).
extern "C" int ssd_scan_kernel_info(int which, int block, int query_block,
                                    int dyn_smem, int* out) {
  (void)block;
  if (which == 0)
    return kinfo::kernel_info(ssd_scan_kernel_cb,
                              query_block > 0 ? query_block : kCbThreads,
                              dyn_smem >= 0 ? dyn_smem : 0, out);
  if (which == 1) {
    using L = Layout<128>;
    return kinfo::kernel_info(
        ssd_scan_kernel<128>,
        query_block > 0 ? query_block : kHeadThreads * L::kMaxHeads,
        dyn_smem >= 0 ? dyn_smem : L::bytes(L::kMaxHeads), out);
  }
  if (which == 2) {
    using L = Layout<64>;
    return kinfo::kernel_info(
        ssd_scan_kernel<64>,
        query_block > 0 ? query_block : kHeadThreads * L::kMaxHeads,
        dyn_smem >= 0 ? dyn_smem : L::bytes(L::kMaxHeads), out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
