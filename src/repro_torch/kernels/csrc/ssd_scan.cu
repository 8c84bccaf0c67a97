// Mamba2 SSD chunked scan on Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan_pallas
// (repro/kernels/ssd_scan.py:76, body `_kernel`): the chunked
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
// contiguous).  dh <= 64 and ds <= 128, both multiples of 4 (rows are read
// 16 bytes at a time); the tiles are padded with zeros up to 32 columns of
// dh and 128 of ds (multiples of the mma's 8), which adds nothing to any
// sum.
//
// The split.  The four products run on the tensor cores as 3xTF32:
//   G       = C B^T                [Q, Q]   over ds
//   y_intra = (G o decay o dt) x   [Q, dh]  over j <= i
//   y_inter = C S                  [Q, dh]  over ds
//   S      += B^T (w x)            [ds, dh] over j
// with mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.  Each operand
// element a is split into hi = tf32(a) and lo = tf32(a - hi), both rounded
// to nearest with ties away from zero (cvt.rna.tf32.f32's rounding, done
// on the integer pipe: cvt itself compiles to four instructions), where
// it is loaded from shared memory into registers (w x once, when it is
// stored; every other operand by each warp that loads it).  A product is
// accumulated in float32 as lo.hi, then hi.lo, then hi.hi (the lo.lo term,
// ~2^-22 relative, is dropped).  That is as exact as float32: one TF32
// pass, rounded to nearest, misses the SSD tolerance (2e-4) by ~17x at
// Mamba2's widths, and raw float32 bits fed to a tf32 mma are truncated,
// which is worse.  Everything else stays float32 on the CUDA cores: the
// cumulative sum of dt A (a shuffle scan each warp runs for itself, a lane
// per row of the chunk), the decay exp(cum_i - cum_j), the dt and w
// weights, the exp(cum_i) that scales C's rows, the state S (in the state
// product's accumulator registers) and the D skip.  The upper triangle is set to 0 before any exp: there
// cum_i - cum_j > 0 and can overflow (inf * 0 would give NaN).
//
// Why mma.sync and not wgmma: wgmma's tf32 form takes only K-major
// operands from shared memory (the transpose bit is for 16-bit types), so
// x (in G x) and B (in the state update) would have to be staged
// transposed, and the split operands would double the tiles; mma.sync
// takes its operands from registers, loaded from shared memory in any
// layout.  It is the simpler instruction; the card's 495 TFLOP/s of TF32
// is wgmma's rate, and mma.sync reaches a part of it.
//
// Two passes.  Pass 1 (ssd_scan_kernel_cb) computes C B^T once for each
// (batch, chunk), the same for every head, into a float32 scratch [b,
// chunks, Q, Q] (the two tiles above the diagonal are not written).  Pass 2
// (ssd_scan_kernel): one CTA of 256 threads (8 warps) takes one (batch,
// head, block of 32 head-dim columns), since the columns of S and y are
// independent, and walks its chunks of Q = 32 rows in turn, carrying its
// S [ds, 32] in registers (16 floats a thread: warp w holds rows
// 16w..16w+15) with a copy in shared memory that the next chunk's C S
// reads.  Per chunk:
//   0. load x (its columns), B, C, the chunk's C B^T block and dt (all
//      started before any is used); scan; store C with row i scaled by
//      exp(cum_i) (y_inter's decay, carried into C S), C B^T scaled by
//      exp(cum_i - cum_j) dt_j on the lower triangle, and w x split;
//      barrier;
//   1. y = G x + (exp(cum) C) S + D x in 16 x 16 tiles, warp w = 4 kh +
//      2 mt + nh on rows 16mt.., columns 16nh..: the four kh = 0 warps
//      take D x, G x (stopping at the tile's last row) and the first half
//      of C S over s, the four kh = 1 warps the second half, which they
//      leave in shared memory (each C and S fragment is split by two
//      warps, not four);
//   2. S = exp(total) S + B^T (w x) in registers; barrier; the kh = 0
//      warps add the second half and store y; S to shared memory.
// The chunk is the kernel's own: the function does not depend on it (up
// to rounding); a t that 32 does not divide is masked by index (rows past
// t load as x = B = C = dt = 0, so they decay nothing and add nothing).
// Prefill asks for the final state too (`fs`, not null): after its last
// chunk each scan CTA stores the S [ds, 32 columns] it carries in
// registers into fs[b, h, :, its columns] ([b, h, ds, dh] float32, rows
// past ds not written); the padded rows of the last chunk left it as it
// was, so neither t nor the chunk changes it.  It adds b h ds dh floats of
// stores (21 MB at mamba2's prefill [8, 2048, 80, 64] / ds 128, beside
// the 693 MB of x, B, C, dt and y) and no other work.
//
// Grid at the training shape (x [2, 2048, 80, 64], ds 128): pass 1 is
// 128 CTAs (2 x 64 chunks); pass 2 is 320 CTAs of 75,776 bytes of shared
// memory and at most 80 registers a thread (__launch_bounds__(256, 3)), so
// three CTAs fit on an SM: one wave on 132 SMs (396 slots), with every SM
// holding two or three.  Q = 32 and blocks of 32 columns keep a CTA's
// tiles small enough for three an SM; a CTA per (batch, head) would leave
// 160 CTAs on 132 SMs, some SMs with two and most with one.
//
// What bounds it on this card.  The function moves 173 MB (0.052 ms at
// 3.35 TB/s; the C B^T scratch adds 1 MB) and, at Q = 32 and counting
// C B^T once a chunk and the triangles only, needs 11.4 GFLOP: 3 x that
// at the 495 TFLOP/s of TF32 is 0.069 ms, so the split's operations bound
// it, just ahead of the bytes.  The kernel does not come near either: it
// is bound by instruction throughput, the split's integer and float
// instructions (two warps split each C and S fragment they load; shared
// memory has no room left for split copies at three CTAs an SM) beside
// mma.sync's own rate, which runs a 16 x 8 x 8 product where wgmma runs
// 64 x N x 8.
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
constexpr int kCols = 32;             // head-dim columns of one CTA
constexpr int kThreads = 256;         // 8 warps
constexpr int kLX = kCols + 4;        // pitch of x and S rows
constexpr int kLW = kCols + 2;        // pitch of the split w x (uint2)
constexpr int kLB = kDS + 4;          // pitch of B rows
constexpr int kLC = kDS + 8;          // pitch of C rows
constexpr int kLG = kQ + 8;           // pitch of the scaled G
constexpr int kLoads = kQ / (kThreads / 32);  // B and C rows a warp loads

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
};

struct Smem {
  float xs[kQ * kLX];                 // x[j][d], this CTA's columns
  uint2 xw[kQ * kLW];                 // w_j x[j][d], split (hi, lo)
  float bs[kQ * kLB];                 // B[j][s]
  float cs[kQ * kLC];                 // C[i][s]
  float ss[kDS * kLX];                // S[s][d] entering the chunk
  float gs[kQ * kLG];                 // G[i][j] exp(cum_i - cum_j) dt_j
  float yb[kQ * kLX];                 // the second half-sum of C S
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
// Every product here permutes its 8-wide k block the same way in both
// operands, instruction k = q <-> element 2q and k = q + 4 <-> 2q + 1 (a
// sum over k does not depend on its order), so that a thread's two k
// elements of a row-major A (or an [n][k] B) are adjacent: one 8-byte load.

// A from a row-major [m][k] tile at p (its (0, 0))
__device__ __forceinline__ FragA load_a(const float* p, int ld, int g, int q) {
  const float2 r0 = *reinterpret_cast<const float2*>(p + g * ld + 2 * q);
  const float2 r1 = *reinterpret_cast<const float2*>(p + (g + 8) * ld + 2 * q);
  FragA f;
  split(r0.x, f.hi[0], f.lo[0]);
  split(r1.x, f.hi[1], f.lo[1]);
  split(r0.y, f.hi[2], f.lo[2]);
  split(r1.y, f.hi[3], f.lo[3]);
  return f;
}

// A from a [k][m] tile (A^T row-major)
__device__ __forceinline__ FragA load_at(const float* p, int ld, int g,
                                         int q) {
  FragA f;
  split(p[2 * q * ld + g], f.hi[0], f.lo[0]);
  split(p[2 * q * ld + g + 8], f.hi[1], f.lo[1]);
  split(p[(2 * q + 1) * ld + g], f.hi[2], f.lo[2]);
  split(p[(2 * q + 1) * ld + g + 8], f.hi[3], f.lo[3]);
  return f;
}

// B from a row-major [k][n] tile, its k rows scaled by s0 (2q) and s1
// (2q + 1)
__device__ __forceinline__ FragB load_b_kn(const float* p, int ld, int g,
                                           int q, float s0 = 1.0f,
                                           float s1 = 1.0f) {
  FragB f;
  split(p[2 * q * ld + g] * s0, f.hi[0], f.lo[0]);
  split(p[(2 * q + 1) * ld + g] * s1, f.hi[1], f.lo[1]);
  return f;
}

// B from an [n][k] tile
__device__ __forceinline__ FragB load_b_nk(const float* p, int ld, int g,
                                           int q) {
  const float2 r = *reinterpret_cast<const float2*>(p + g * ld + 2 * q);
  FragB f;
  split(r.x, f.hi[0], f.lo[0]);
  split(r.y, f.hi[1], f.lo[1]);
  return f;
}

// Pass 1: G = C B^T of one chunk (the same for every head, g = 1), one
// CTA per (batch, chunk), warp w on the 16 x 8 tile (w / 4, w % 4) of
// the lower triangle's tiles; the two tiles above it are skipped.
// B from a row-major [k][n] tile of split (hi, lo) pairs
__device__ __forceinline__ FragB load_b_split(const uint2* p, int g, int q) {
  const uint2 r0 = p[2 * q * kLW + g];
  const uint2 r1 = p[(2 * q + 1) * kLW + g];
  FragB f;
  f.hi[0] = r0.x;
  f.lo[0] = r0.y;
  f.hi[1] = r1.x;
  f.lo[1] = r1.y;
  return f;
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel_cb(Params p) {
  __shared__ __align__(16) float bs[kQ * kLC];
  __shared__ __align__(16) float cs[kQ * kLC];
  const int nc = (p.t + kQ - 1) / kQ;
  const int b = blockIdx.x / nc;
  const int c0 = (blockIdx.x - b * nc) * kQ;
  const int rows = min(kQ, p.t - c0);
  const long long row0 = static_cast<long long>(b) * p.t + c0;
  const int tid = threadIdx.x;
  for (int i = tid; i < kQ * (kDS / 4); i += kThreads) {
    const int j = i / (kDS / 4);
    const int s = (i % (kDS / 4)) * 4;
    float4 vb = make_float4(0.f, 0.f, 0.f, 0.f), vc = vb;
    if (j < rows && s < p.ds) {
      const long long off = (row0 + j) * p.ds + s;
      vb = *reinterpret_cast<const float4*>(p.B + off);
      vc = *reinterpret_cast<const float4*>(p.C + off);
    }
    *reinterpret_cast<float4*>(&bs[j * kLC + s]) = vb;
    *reinterpret_cast<float4*>(&cs[j * kLC + s]) = vc;
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
    mma3(acc, load_a(cs + 16 * mt * kLC + 8 * ks, kLC, g, q),
         load_b_nk(bs + 8 * nt * kLC + 8 * ks, kLC, g, q));
  float* out = p.cb + static_cast<long long>(blockIdx.x) * kQ * kQ;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
    *reinterpret_cast<float2*>(out + (16 * mt + g + 8 * hr) * kQ + 8 * nt +
                               2 * q) = make_float2(acc[2 * hr],
                                                    acc[2 * hr + 1]);
}

// Pass 2: the scan, one CTA per (batch, head, block of 32 head-dim
// columns).
__global__ void __launch_bounds__(kThreads, 3)
ssd_scan_kernel(Params p) {
  extern __shared__ float4 smem4[];
  Smem& sm = *reinterpret_cast<Smem*>(smem4);
  const int bh = blockIdx.x;
  const int b = bh / p.h;
  const int hd = bh - b * p.h;
  const int col0 = kCols * blockIdx.y;        // this CTA's head-dim columns
  const int ncols = min(kCols, p.dh - col0);
  const int nc = (p.t + kQ - 1) / kQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const float a = p.A[hd];
  const float dskip = p.D ? p.D[hd] : 0.0f;
  // y = G x + (exp(cum) C) S + D x in 16 x 16 tiles: warp w on rows
  // 16 mt.., columns 16 nh.. (two n tiles), the k half kh of C S (s in
  // 64 kh..); the kh = 1 warps hand their half-sum over in yb
  const int kh = warp >> 2;
  const int mt = (warp >> 1) & 1;
  const int nh = warp & 1;
  // the G element block this thread scales: row gi, columns gj..gj+3
  const int gi = tid >> 3;
  const int gj = (tid & 7) * 4;
  // the x element block this thread loads: row xj, columns xd..xd+3
  const int xj = tid / (kCols / 4);
  const int xd = (tid % (kCols / 4)) * 4;

  float st[4][4];                     // S rows 16warp + g (+8), cols 8n + 2q
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) st[n][r] = 0.0f;
  for (int i = tid; i < kDS * kLX; i += kThreads) sm.ss[i] = 0.0f;

  for (int c = 0; c < nc; ++c) {
    const int c0 = c * kQ;
    const int rows = min(kQ, p.t - c0);
    const long long row0 = static_cast<long long>(b) * p.t + c0;
    // every reader of the last chunk's tiles passed the barrier before
    // its S store.  The loads, all started before any is used: x rows
    // [Q][32] of this CTA's columns, B and C rows [Q][128] (zero past
    // rows, dh and ds), the chunk's C B^T block and dt
    float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (xj < rows && xd < ncols)
      xv = *reinterpret_cast<const float4*>(
          p.x + ((row0 + xj) * p.h + hd) * p.dh + col0 + xd);
    float4 vb[kLoads], vc[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int j = warp + (kThreads / 32) * k;   // a row a warp
      const int s = lane * 4;
      vb[k] = vc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < rows && s < p.ds) {
        const long long off = (row0 + j) * p.ds + s;
        vb[k] = *reinterpret_cast<const float4*>(p.B + off);
        vc[k] = *reinterpret_cast<const float4*>(p.C + off);
      }
    }
    const float4 gv = *reinterpret_cast<const float4*>(
        p.cb + (static_cast<long long>(b) * nc + c) * kQ * kQ + gi * kQ + gj);
    // every warp scans the chunk's dt A itself, lane j holding row j
    const float dtj = lane < rows ? p.dt[(row0 + lane) * p.h + hd] : 0.0f;
    float cum = dtj * a;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, cum, off);
      if (lane >= off) cum += o;
    }
    const float total = __shfl_sync(0xffffffffu, cum, 31);
    const float wj = expf(total - cum) * dtj;     // the state's weight
    const float ecum = expf(cum);
    // B as loaded; C with row i scaled by exp(cum_i), which carries
    // y_inter's decay into C S
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int j = warp + (kThreads / 32) * k;
      const float e = __shfl_sync(0xffffffffu, ecum, j);
      *reinterpret_cast<float4*>(&sm.bs[j * kLB + lane * 4]) = vb[k];
      *reinterpret_cast<float4*>(&sm.cs[j * kLC + lane * 4]) = make_float4(
          vc[k].x * e, vc[k].y * e, vc[k].z * e, vc[k].w * e);
    }
    {
      // x, and w x split once for every warp's state product
      *reinterpret_cast<float4*>(&sm.xs[xj * kLX + xd]) = xv;
      const float w = __shfl_sync(0xffffffffu, wj, xj);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint2 hl;
        split(xa[e] * w, hl.x, hl.y);
        sm.xw[xj * kLW + xd + e] = hl;
      }
    }
    {
      // G[i][j] exp(cum_i - cum_j) dt_j on the lower triangle; the upper
      // triangle (never written by pass 1) is zeroed before the exp sees it
      const float ci = __shfl_sync(0xffffffffu, cum, gi);
      const float gin[4] = {gv.x, gv.y, gv.z, gv.w};
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = gj + e;
        const float cj = __shfl_sync(0xffffffffu, cum, j);
        const float dj = __shfl_sync(0xffffffffu, dtj, j);
        const float dec = expf(j <= gi ? ci - cj : 0.0f);
        out[e] = j <= gi ? gin[e] * dec * dj : 0.0f;
      }
      *reinterpret_cast<float4*>(&sm.gs[gi * kLG + gj]) =
          make_float4(out[0], out[1], out[2], out[3]);
    }
    __syncthreads();

    // 1. the kh = 0 warps: D x + G x + the first half of C S; the kh = 1
    // warps: the second half of C S, into yb
    float acc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 16 * mt + g + 8 * (r >> 1);
        const int d = 16 * nh + 8 * n + 2 * q + (r & 1);
        acc[n][r] = kh == 0 ? sm.xs[i * kLX + d] * dskip : 0.0f;
      }
    if (kh == 0) {
#pragma unroll
      for (int ks = 0; ks < kQ / 8; ++ks) {
        if (ks >= 2 * (mt + 1)) break;  // G = 0 past the tile's last row
        const FragA fg = load_a(sm.gs + 16 * mt * kLG + 8 * ks, kLG, g, q);
#pragma unroll
        for (int n = 0; n < 2; ++n)
          mma3(acc[n], fg,
               load_b_kn(sm.xs + 8 * ks * kLX + 16 * nh + 8 * n, kLX, g, q));
      }
    }
    const float* crow = sm.cs + 16 * mt * kLC + 64 * kh;
    const float* srow = sm.ss + 64 * kh * kLX + 16 * nh;
#pragma unroll
    for (int ks = 0; ks < kDS / 16; ++ks) {
      const FragA fc = load_a(crow + 8 * ks, kLC, g, q);
#pragma unroll
      for (int n = 0; n < 2; ++n)
        mma3(acc[n], fc, load_b_kn(srow + 8 * ks * kLX + 8 * n, kLX, g, q));
    }
    if (kh == 1) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<float2*>(
              &sm.yb[(16 * mt + g + 8 * hr) * kLX + 16 * nh + 8 * n + 2 * q]) =
              make_float2(acc[n][2 * hr], acc[n][2 * hr + 1]);
    }

    // 2. S = exp(total) S + B^T (w x) on rows 16 warp.. (in registers)
    const float etot = expf(total);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) st[n][r] *= etot;
#pragma unroll
    for (int ks = 0; ks < kQ / 8; ++ks) {
      const FragA fb = load_at(sm.bs + 8 * ks * kLB + 16 * warp, kLB, g, q);
#pragma unroll
      for (int n = 0; n < 4; ++n)
        mma3(st[n], fb, load_b_split(sm.xw + 8 * ks * kLW + 8 * n, g, q));
    }
    // 3. once every warp has read the old S (step 1), this chunk's tiles
    // and written its half-sum: y from the kh = 0 warps, S to shared
    // memory for the next chunk
    __syncthreads();
    if (kh == 0) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = 16 * mt + g + 8 * hr;
        if (i >= rows) continue;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int d = 16 * nh + 8 * n + 2 * q;
          if (d >= ncols) continue;
          const float2 o = *reinterpret_cast<const float2*>(
              &sm.yb[i * kLX + d]);
          *reinterpret_cast<float2*>(p.y + ((row0 + i) * p.h + hd) * p.dh +
                                     col0 + d) =
              make_float2(acc[n][2 * hr] + o.x, acc[n][2 * hr + 1] + o.y);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int s = 16 * warp + g;
      const int d = 8 * n + 2 * q;
      *reinterpret_cast<float2*>(&sm.ss[s * kLX + d]) =
          make_float2(st[n][0], st[n][1]);
      *reinterpret_cast<float2*>(&sm.ss[(s + 8) * kLX + d]) =
          make_float2(st[n][2], st[n][3]);
    }
  }
  if (p.fs == nullptr) return;
  // the state after the last chunk, rows 16 warp + g (+ 8), this CTA's
  // columns 8 n + 2 q (+ 1)
  float* out = p.fs + static_cast<long long>(bh) * p.ds * p.dh + col0;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int d = 8 * n + 2 * q;
    if (d >= ncols) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int s = 16 * warp + g + 8 * hr;
      if (s < p.ds)
        *reinterpret_cast<float2*>(out + static_cast<long long>(s) * p.dh +
                                   d) =
            make_float2(st[n][2 * hr], st[n][2 * hr + 1]);
    }
  }
}

}  // namespace

// Returns the first failing launch's cudaError_t.  D may be null; `cb` is
// float32 scratch of batch * ceil(t / 32) * 32 * 32 entries; `fs` null or
// the final state's [batch, h, ds, dh] float32; `smem` is the
// wrapper's launch plan (repro_torch.kernels.ssd_scan.launch_plan: the
// scan's "smem"), refused unless it equals sizeof(Smem).
// Pass 1's grid is batch * chunks; pass 2's (batch * h, the head dim's
// blocks of 32 columns).
extern "C" int ssd_scan_fwd(const float* x, const float* dt, const float* A,
                            const float* B, const float* C, const float* D,
                            float* y, float* cb, float* fs, int batch,
                            int t, int h, int dh, int ds, int smem,
                            void* stream) {
  if (dh <= 0 || dh > kDH || dh % 4 || ds <= 0 || ds > kDS || ds % 4 ||
      t <= 0 || h <= 0 || batch <= 0 ||
      smem != static_cast<int>(sizeof(Smem)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params p{x, dt, A, B, C, D, y, cb, fs, t, h, dh, ds};
  const long long nc = (t + kQ - 1) / kQ;
  ssd_scan_kernel_cb<<<static_cast<unsigned>(batch * nc), kThreads, 0, s>>>(
      p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * h, (dh + kCols - 1) / kCols);
  ssd_scan_kernel<<<grid, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

KINFO_NAMES(ssd_scan, "ssd_scan_cb", "ssd_scan")

// kernels.autotune.kernel_attributes.  which: 0 ssd_scan_kernel_cb (static
// shared memory), 1 ssd_scan_kernel (dyn_smem < 0: sizeof(Smem), its
// launch's); both kThreads threads, the runtime's occupancy asked at
// query_block (kThreads when <= 0).
extern "C" int ssd_scan_kernel_info(int which, int block, int query_block,
                                    int dyn_smem, int* out) {
  (void)block;
  const int q = query_block > 0 ? query_block : kThreads;
  if (which == 0)
    return kinfo::kernel_info(ssd_scan_kernel_cb, q,
                              dyn_smem >= 0 ? dyn_smem : 0, out);
  if (which == 1)
    return kinfo::kernel_info(
        ssd_scan_kernel, q,
        dyn_smem >= 0 ? dyn_smem : static_cast<int>(sizeof(Smem)), out);
  return static_cast<int>(cudaErrorInvalidValue);
}
