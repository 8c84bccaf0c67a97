// Flash attention forward and backward in bf16 on Hopper's tensor cores
// (sm_90a): wgmma on bf16 tiles with float32 accumulators, K/V (forward)
// and Q/dO (backward) fed by TMA into a ring of shared-memory stages that
// mbarriers guard.  The float32 route stays on the CUDA cores
// (flash_attention.cu): float32 on the tensor cores would be TF32.
//
// Replaces, for bf16 operands, the TPU kernel
// repro/kernels/flash_attention.py::flash_attention_pallas (the forward:
// softmax(q k^T * scale) v with causal, sliding-window and prefix-LM
// masks, logit soft-capping, a query offset and grouped-query attention,
// the online softmax carrying (m, l, acc) across key tiles) and the
// recompute backward of repro/kernels/flash_xla.py:121 (`_bwd`).
//
// Layout: q [B, Hq, Tq, D], k and v [B, Hkv, Tk, D], o like q, dense
// row-major bf16 (the wrapper makes them so); lse and delta [B, Hq, Tq]
// float32.  Each operand is a 3-D TMA tensor map (D, T, B * H), so a tile
// that runs past T or D is filled with zeros by the TMA unit, never with
// the next head's rows.  Any D <= 256 with D % 8 == 0: rows are loaded in
// 64-column boxes (128 bytes, the 128-byte swizzle of the wgmma operands),
// ceil(D / 64) panels; the contraction over D runs over whole panels, the
// columns past D being the zeros the TMA unit filled in (so no product
// depends on D at run time).
//
// Forward (flash_fwd_wgmma_kernel): one CTA per (b * Hq + h, 128-query
// tile), the tiles taken from the last one down on grid axis y (every
// head's longest causal tiles start first).  Two consumer warpgroups own
// 64 query rows each (registers taken from the producer by setmaxnreg);
// one thread of the producer warpgroup loads the Q tile once and then K
// and V tiles (128 keys for D <= 128, 64 above) into a ring of 2-3 stages
// (as many as fit 232,448 bytes at this D).  Per key tile a warpgroup
// runs
//   S = Q K^T       wgmma m64n64k16, both operands K-major in shared memory;
//   the softmax on the accumulator fragment in registers: 2^x on the
//                   special-function unit (ex2.approx) with scale * log2(e)
//                   folded into one multiply-add, masked entries p = 0
//                   exactly, the row sum kept per thread and reduced over
//                   the quad once at the end;
//   O += P V        P rounded to bf16 in registers as the A operand, V
//                   row-major [keys, D] read as an MN-major B operand (the
//                   transpose bit), one n64 product per 64-column panel.
// Key tiles that the masks hide from every query of the CTA are never
// loaded (above the causal diagonal, before the window), and tiles that
// every query sees fully skip the per-element mask (and soft-capping runs
// only when asked for).  lse = m ln 2 + ln l.
//
// Backward: delta = rowsum(dO * O) (flash_bwd_rowsum_kernel), then two
// kernels that each own their outputs, so nothing is summed with atomics.
//   flash_bwd_dkdv_wgmma_kernel: one CTA per (b * Hkv + kv head, 64-key
//   tile, column block), the key tiles that see the most queries launched
//   first; K and V stay in shared memory, and the producer streams Q and
//   dO tiles of 64 queries (with their lse and delta) through the ring,
//   over every query head of the GQA group and every query tile the masks
//   leave visible.  Under a causal mask the first key tile sees every
//   query tile and the last one few; at D <= 64 two consumer warpgroups
//   take alternate items of the CTA (and add their sums in shared memory
//   at the end), so the longest CTA takes half as long.  A consumer
//   warpgroup computes
//     S^T = K Q^T, dP^T = V dO^T          (the accumulator has P^T's layout)
//     P^T = exp2(S^T scale log2 e - lse log2 e), dS^T = P^T (dP^T - delta)
//                                          [(1 - tanh^2) under softcap] scale
//     dV += P^T dO,  dK += dS^T Q          (A from registers, B MN-major).
//   At D > 128 the 64 x D float32 accumulators of dK and dV do not fit one
//   warpgroup's registers: the CTA owns one 128-column block of them
//   (grid axis z, 2 blocks at D = 256), so the logits are computed twice
//   there, not four times as the CUDA-core kernels do.
//   flash_bwd_dq_wgmma_kernel: one CTA per (b * Hq + h, 64-query tile),
//   the longest first; Q and dO stay in shared memory, K and V tiles
//   stream through the ring:
//   S = Q K^T, dP = dO V^T, dS as above, dQ += dS K (K as MN-major B).
//
// What is rounded to bf16: the operands (as given), P before P V and P^T
// dO, dS before dS K and dS^T Q, and the outputs.  Every sum (the
// products' accumulators, m, l, the row sums, delta) is float32.  The TPU
// kernel keeps P in float32; this kernel's bf16 P and dS differ from the
// plain versions by ~2^-9 relative per entry, inside the bf16 tolerances.
//
// What bounds them on this card: operations.  At the serving prefill's
// shape (q [8, 14, 2048, 64], k and v [8, 2, 2048, 64], causal) the
// visible pairs need 60.1 GFLOP against 67.1 MB of operands: 0.061 ms at
// 989 TFLOP/s (bf16 dense), 0.020 ms at 3.35 TB/s.  The backward at
// qwen2's training shape needs 75.2 GFLOP by the 5-product count (0.076
// ms); the split into dK/dV and dQ kernels runs 7 products (~105 GFLOP),
// the price of needing no atomics.  The design keeps the tensor cores fed
// (TMA loads run ahead by the ring's depth, two warpgroups per SM
// alternate between products and softmax); at D = 64 the softmax's
// exponentials and the per-element arithmetic are as costly as the
// products, which is why the mask test is done once per tile.
//
// The build turns off multiply-add contraction (-fmad=false, _build.py);
// the softmax's fused multiply-adds here are explicit fmaf.

#include <cuda.h>           // CUtensorMap; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "kernel_info.cuh"
#include <math_constants.h>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPanel = 64;              // columns a TMA box / swizzle panel
constexpr int kRowBytes = 128;          // bytes of one panel row
constexpr int kSmemMax = 232448;        // dynamic shared memory a CTA may use
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// PTX: mbarriers, TMA, wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// until the phase of parity `parity` has completed; a wait of more than
// ~10 s (a lost arrival) traps, so the launch fails instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    if (clock64() - t0 > (1ll << 34)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one 64-column box of a 3-D tensor map (col, row, b * h) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(bh)
      : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand whose
// 8-row groups lie 1024 bytes apart (rows of 128 bytes, as TMA writes a
// 64-column box).  K-major: the leading offset is unused (1).  MN-major:
// every product here is one 64-wide panel, so the offset between panels is
// unused too; it is set to 1024 like the stride between 8-row groups.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return desc_sw128(addr, 16);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return desc_sw128(addr, 1024);
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

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

#define WG_REGS32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (64 x 64, float32) (+)= A B: A 64 x 16 and B 16 x 64, both K-major bf16
// in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, float32) += A B: A 64 x 16 bf16 in registers (the
// accumulator fragment's layout, two values a register), B 16 x 64
// MN-major bf16 in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WG_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The A fragments of a 64 x 64 accumulator (k16 step kk: its columns
// 16kk .. 16kk+15), rounded to bf16.
__device__ __forceinline__ void to_a_frags(const float (&d)[32],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// 2^x on the special-function unit (2^-inf = +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void zero(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.0f;
}

// ---------------------------------------------------------------------------
// Masks and the tiles they leave visible

struct Opts {
  int hq, hkv, tq, tk, d;
  float scale;
  int causal;
  int window;        // < 0: none
  int prefix;        // < 0: none
  int use_softcap;
  float softcap;
  int q_offset;
  int stages;
};

__device__ __forceinline__ bool sees(const Opts& o, int qpos, int kpos) {
  bool ok = kpos < o.tk;
  if (o.causal)
    ok = ok && (kpos <= qpos ||
                (o.prefix >= 0 && kpos < o.prefix && qpos < o.prefix));
  if (o.window >= 0) ok = ok && kpos > qpos - o.window;
  return ok;
}

// Every (query, key) with query position in [qmin, qmax] and key in
// [k0, k1) visible (prefix-LM visibility beyond the diagonal is left to
// the per-element mask).
__device__ __forceinline__ bool all_visible(const Opts& o, int qmin, int qmax,
                                            int k0, int k1) {
  return k1 <= o.tk && (!o.causal || k1 - 1 <= qmin) &&
         (o.window < 0 || k0 > qmax - o.window);
}

// The keys [k_lo, k_hi) some query position in [qmin, qmax] sees.
__device__ __forceinline__ void key_range(const Opts& o, int qmin, int qmax,
                                          int& k_lo, int& k_hi) {
  k_hi = o.tk;
  if (o.causal) {
    k_hi = min(k_hi, qmax + 1);
    if (o.prefix >= 0 && qmin < o.prefix)
      k_hi = max(k_hi, min(o.prefix, o.tk));
  }
  k_lo = o.window >= 0 ? max(0, qmin - o.window + 1) : 0;
}


// ---------------------------------------------------------------------------
// Forward

constexpr int kFwdBQ = 128;             // two consumer warpgroups of 64 rows
constexpr int kFwdThreads = 384;        // + a producer warpgroup

template <int NP>
struct FwdShape {
  static constexpr int BK = NP <= 2 ? 128 : 64;
  static constexpr int NH = BK / 64;               // 64-key halves a tile
  static constexpr int kQBytes = NP * kFwdBQ * kRowBytes;
  static constexpr int kKBytes = NP * BK * kRowBytes;   // K or V of a stage
  static int smem(int stages) {
    return 1024 + kQBytes + stages * 2 * kKBytes + 8 * (2 * stages + 1);
  }
};

template <int NP>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, bf16* out,
                       float* lse, const Opts o) {
  using S = FwdShape<NP>;
  constexpr int BK = S::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* qs = base;
  uint8_t* ks = qs + S::kQBytes;                   // [stages][NP][BK][64]
  uint8_t* vs = ks + o.stages * S::kKBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + o.stages * S::kKBytes);
  uint64_t* empty = full + o.stages;
  uint64_t* qbar = empty + o.stages;

  // query tiles from the last one down on grid axis y: every head's
  // longest causal tile is launched before any shorter one
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdBQ;
  const int bh = blockIdx.x;
  const int b = bh / o.hq;
  const int hk = b * o.hkv + (bh - b * o.hq) / (o.hq / o.hkv);
  int k_lo, k_hi;
  key_range(o, q0 + o.q_offset, min(q0 + kFwdBQ, o.tq) - 1 + o.q_offset,
            k_lo, k_hi);
  const int t0 = k_lo / BK;
  const int ntiles = max(0, (k_hi + BK - 1) / BK - t0);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < o.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // producer warpgroup: one thread loads the Q tile, then K and V tiles
    // into the ring.  The warpgroup gives its registers up to the
    // consumers (128 x 24 + 256 x 240 fit the SM's 65,536; the launch
    // bound alone caps every thread at 168).  It is a whole warpgroup, so
    // that what it releases covers what the consumers take.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(qbar, S::kQBytes);
      for (int p = 0; p < NP; ++p)
        tma_load(qs + p * kFwdBQ * kRowBytes, &qmap, qbar, kPanel * p, q0, bh);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % o.stages;
        if (it >= o.stages) mbar_wait(&empty[s], ((it / o.stages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * S::kKBytes);
        const int k0 = (t0 + it) * BK;
        for (int p = 0; p < NP; ++p) {
          tma_load(ks + s * S::kKBytes + p * BK * kRowBytes, &kmap, &full[s],
                   kPanel * p, k0, hk);
          tma_load(vs + s * S::kKBytes + p * BK * kRowBytes, &vmap, &full[s],
                   kPanel * p, k0, hk);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63; this thread
  // rows r0 and r0 + 8 of them, columns 8j + 2 (lane % 4) + {0, 1}
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
  const int wg = warp / 4;
  const int r0 = 16 * (warp % 4) + lane / 4;
  const int c0 = 2 * (lane % 4);
  const int qrow0 = q0 + 64 * wg;
  const int qpos[2] = {qrow0 + r0 + o.q_offset, qrow0 + r0 + 8 + o.q_offset};
  const int wg_qmin = qrow0 + o.q_offset;
  const int wg_qmax = min(qrow0 + 64, o.tq) - 1 + o.q_offset;
  const float scale2 = (o.use_softcap ? 1.0f : o.scale) * kLog2e;
  const uint32_t qa = smem_u32(qs) + 64 * wg * kRowBytes;

  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p) zero(acc[p]);
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};   // in log2 units
  float l[2] = {0.0f, 0.0f};                     // this thread's part

  mbar_wait(qbar, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % o.stages;
    const int k0 = (t0 + it) * BK;
    const uint32_t kb = smem_u32(ks) + s * S::kKBytes;
    const uint32_t vb = smem_u32(vs) + s * S::kKBytes;
    mbar_wait(&full[s], (it / o.stages) & 1);

    float sc[S::NH][32];
#pragma unroll
    for (int h = 0; h < S::NH; ++h) reg_fence(sc[h]);
    wg_fence();
#pragma unroll
    for (int h = 0; h < S::NH; ++h)
#pragma unroll
      for (int kk = 0; kk < 4 * NP; ++kk)
        wgmma_ss(sc[h],
                 desc_k(qa + (kk / 4) * kFwdBQ * kRowBytes + (kk % 4) * 32),
                 desc_k(kb + (kk / 4) * BK * kRowBytes + 64 * h * kRowBytes +
                        (kk % 4) * 32),
                 kk > 0);
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int h = 0; h < S::NH; ++h) reg_fence(sc[h]);

    // softmax on the fragment: entry i of half h is row r0 + 8 ((i / 2) % 2),
    // key k0 + 64 h + 8 (i / 4) + c0 + i % 2.  Soft-capping and the mask
    // run as passes of their own, only where they apply.
    if (o.use_softcap) {
      const float to_tanh = o.scale / o.softcap;
#pragma unroll
      for (int h = 0; h < S::NH; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i)
          sc[h][i] = o.softcap * tanhf(sc[h][i] * to_tanh);
    }
    if (!all_visible(o, wg_qmin, wg_qmax, k0, k0 + BK))
#pragma unroll
      for (int h = 0; h < S::NH; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (!sees(o, qpos[(i / 2) % 2],
                    k0 + 64 * h + 8 * (i / 4) + c0 + i % 2))
            sc[h][i] = -CUDART_INF_F;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int h = 0; h < S::NH; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[h][i] * scale2);
    float alpha[2], mneg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row that has seen no key yet keeps 0 as its reference, so that
      // exp2(-inf - ref) = 0 and never NaN
      const float ref = mx[r] == -CUDART_INF_F ? 0.0f : mx[r];
      alpha[r] = ex2(m[r] - ref);
      mneg[r] = -ref;
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    uint32_t pa[S::NH][4][4];
#pragma unroll
    for (int h = 0; h < S::NH; ++h) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i / 2) % 2;
        const float pv = ex2(fmaf(sc[h][i], scale2, mneg[r]));
        sc[h][i] = pv;
        l[r] += pv;
      }
      to_a_frags(sc[h], pa[h]);
    }
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] *= alpha[(i / 2) % 2];

#pragma unroll
    for (int p = 0; p < NP; ++p) reg_fence(acc[p]);
    wg_fence();
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(acc[p], pa[kk / 4][kk % 4],
                 desc_mn(vb + p * BK * kRowBytes + 16 * kk * kRowBytes));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int p = 0; p < NP; ++p) reg_fence(acc[p]);
    mbar_arrive(&empty[s]);
  }

  const long long bh_row = static_cast<long long>(bh) * o.tq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = qrow0 + r0 + 8 * r;
    if (row >= o.tq) continue;
    if (c0 == 0)
      lse[bh_row + row] =
          l[r] > 0.0f ? m[r] * kLn2 + logf(l[r]) : -CUDART_INF_F;
    // a row that sees no key writes 0, as the TPU kernel does
    const float inv = 1.0f / fmaxf(l[r], 1e-37f);
    bf16* orow = out + (bh_row + row) * o.d;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = kPanel * p + 8 * j + c0;
        if (col < o.d)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[p][4 * j + 2 * r] * inv,
                                    acc[p][4 * j + 2 * r + 1] * inv);
      }
  }
}

// ---------------------------------------------------------------------------
// Backward

constexpr int kBwdThreads = 160;        // one consumer warpgroup + a producer
constexpr int kBwdTile = 64;            // keys (dK/dV) or queries (dQ) a CTA
constexpr int kTileBytes = kBwdTile * kRowBytes;      // one 64 x 64 panel

// delta[row] = sum_d dO[row, d] * O[row, d] in float32, one warp a row
__global__ void __launch_bounds__(256)
flash_bwd_rowsum_kernel(const bf16* __restrict__ o, const bf16* __restrict__ g,
                        float* __restrict__ delta, long long rows, int d) {
  const long long row =
      static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.0f;
  for (int c = lane; c < d; c += 32)
    s = fmaf(__bfloat162float(g[row * d + c]),
             __bfloat162float(o[row * d + c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// In place of the logit s and dP of one fragment entry: P = exp(capped
// logit - lse) and dS = P (dP - delta) [(1 - tanh^2)] scale.  `lse2` is
// lse log2(e), +inf for a row that sees no key (so P = 0 there).
template <bool kCap>
__device__ __forceinline__ void p_and_ds(const Opts& o, float& s, float& dp,
                                         float lse2, float dl) {
  float x = s * o.scale, f = o.scale;
  if (kCap) {
    const float th = tanhf(s * (o.scale / o.softcap));
    x = o.softcap * th;
    f *= 1.0f - th * th;
  }
  const float p = ex2(fmaf(x, kLog2e, -lse2));
  s = p;
  dp = p * (dp - dl) * f;
}

// P and dS over a dK/dV fragment: entry i is key row kpos[(i / 2) % 2] and
// query q0 + c, c = 8 (i / 4) + c0 + i % 2, whose lse2 and delta are
// lq[c], dlq[c]
template <bool kCap, bool kMask>
__device__ __forceinline__ void dkdv_tile(const Opts& o, float (&s)[32],
                                          float (&dp)[32], const float* lq,
                                          const float* dlq, int q0,
                                          const int (&kpos)[2], int c0) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = 8 * (i / 4) + c0 + i % 2;
    p_and_ds<kCap>(o, s[i], dp[i], lq[c], dlq[c]);
    if (kMask && !sees(o, q0 + c + o.q_offset, kpos[(i / 2) % 2]))
      s[i] = dp[i] = 0.0f;
  }
}

// P and dS over a dQ fragment: entry i is query row r = (i / 2) % 2 (at
// qpos[r]) and key k0 + 8 (i / 4) + c0 + i % 2
template <bool kCap, bool kMask>
__device__ __forceinline__ void dq_tile(const Opts& o, float (&s)[32],
                                        float (&dp)[32],
                                        const float (&lse2)[2],
                                        const float (&dl)[2],
                                        const int (&qpos)[2], int k0, int c0) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i / 2) % 2;
    p_and_ds<kCap>(o, s[i], dp[i], lse2[r], dl[r]);
    if (kMask && !sees(o, qpos[r], k0 + 8 * (i / 4) + c0 + i % 2))
      s[i] = dp[i] = 0.0f;
  }
}

// TILE<softcap, mask>(ARGS) with both chosen at run time, once a tile
#define CAP_MASK_DISPATCH(TILE, cap, mask, ...)        \
  do {                                                  \
    if (cap) {                                          \
      if (mask) TILE<true, true>(__VA_ARGS__);          \
      else TILE<true, false>(__VA_ARGS__);              \
    } else {                                            \
      if (mask) TILE<false, true>(__VA_ARGS__);         \
      else TILE<false, false>(__VA_ARGS__);             \
    }                                                   \
  } while (0)

// lse log2(e) of a row, +inf where the row is past tq or sees no key
__device__ __forceinline__ float lse2_of(const float* lse, long long at,
                                         bool in_range) {
  const float l = in_range ? lse[at] : -CUDART_INF_F;
  return l == -CUDART_INF_F ? CUDART_INF_F : l * kLog2e;
}

struct BwdArgs {
  const float* lse;
  const float* delta;
  bf16* dq;
  bf16* dk;
  bf16* dv;
};

template <int NP>
struct BwdShape {
  static constexpr int kFixed = 2 * NP * kTileBytes;    // the resident pair
  static constexpr int kStage = 2 * NP * kTileBytes;    // the streamed pair
  static constexpr int CBP = NP < 2 ? NP : 2;           // dK/dV panels a CTA
  static int smem(int stages) {
    return 1024 + kFixed + stages * kStage + stages * 2 * kBwdTile * 4 +
           8 * (2 * stages + 1);
  }
};

// The dK/dV CTA: at D <= 64 two consumer warpgroups (240 registers a
// thread) take alternate (head, query tile) items, with a producer
// warpgroup; above, where 240 registers would not hold a warpgroup's
// products in flight, one consumer warpgroup and a producer warp.
template <int NP>
struct DkdvShape {
  static constexpr int NWG = NP == 1 ? 2 : 1;
  static constexpr int kThreads = NWG == 2 ? 384 : kBwdThreads;
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// one CTA per (b * Hkv + kv head, 64-key tile, 128-column block of dK/dV);
// the key tiles that see the most queries (the first, under causal masks)
// are launched first
template <int NP>
__global__ void __launch_bounds__(DkdvShape<NP>::kThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap gmap,
                            const BwdArgs a, const Opts o) {
  using S = BwdShape<NP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* ks = base;                              // [NP][64][64]
  uint8_t* vs = ks + NP * kTileBytes;
  uint8_t* qs = vs + NP * kTileBytes;              // [stages][NP][64][64]
  uint8_t* gs = qs + o.stages * NP * kTileBytes;   // dO, as qs
  float* lses = reinterpret_cast<float*>(gs + o.stages * NP * kTileBytes);
  float* dls = lses + o.stages * kBwdTile;         // [stages][64] each
  uint64_t* full = reinterpret_cast<uint64_t*>(dls + o.stages * kBwdTile);
  uint64_t* empty = full + o.stages;
  uint64_t* kvbar = empty + o.stages;

  constexpr int NWG = DkdvShape<NP>::NWG;
  const int k0 = blockIdx.y * kBwdTile;
  const int hk = blockIdx.x;                       // b * hkv + kv head
  // first panel of the block (0 when one block covers D)
  const int p0 = NP <= 2 ? 0 : blockIdx.z * S::CBP;
  const int b = hk / o.hkv;
  const int rep = o.hq / o.hkv;
  const int h0 = b * o.hq + (hk - b * o.hkv) * rep;
  // the query rows that see some key of this tile
  const int k_last = min(k0 + kBwdTile, o.tk) - 1;
  int row_lo = 0;
  if (o.causal && !(o.prefix >= 0 && k0 < o.prefix))
    row_lo = max(0, k0 - o.q_offset);
  int row_hi = o.tq;
  if (o.window >= 0) row_hi = min(row_hi, k_last + o.window - o.q_offset);
  const int qt0 = row_lo / kBwdTile;
  const int nq = max(0, (row_hi + kBwdTile - 1) / kBwdTile - qt0);
  const int ntiles = rep * nq;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < o.stages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 128);
    }
    mbar_init(kvbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // producer: K and V once, then (Q, dO, lse, delta) tile after tile,
    // head after head; every lane of its first warp arrives after storing
    // its lse / delta.  A producer warpgroup gives its registers up to the
    // two consumer warpgroups (as in the forward).
    if (NWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (warp > 4 * NWG) return;
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * NP * kTileBytes);
      for (int p = 0; p < NP; ++p) {
        tma_load(ks + p * kTileBytes, &kmap, kvbar, kPanel * p, k0, hk);
        tma_load(vs + p * kTileBytes, &vmap, kvbar, kPanel * p, k0, hk);
      }
    }
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % o.stages;
      const int bh = h0 + it / nq;
      const int q0 = (qt0 + it % nq) * kBwdTile;
      if (it >= o.stages) mbar_wait(&empty[s], ((it / o.stages) & 1) ^ 1);
      for (int i = lane; i < kBwdTile; i += 32) {
        const int row = q0 + i;
        const long long at = static_cast<long long>(bh) * o.tq + row;
        lses[s * kBwdTile + i] = lse2_of(a.lse, at, row < o.tq);
        dls[s * kBwdTile + i] = row < o.tq ? a.delta[at] : 0.0f;
      }
      if (lane == 0) {
        mbar_expect_tx(&full[s], S::kStage);
        for (int p = 0; p < NP; ++p) {
          const int off = (s * NP + p) * kTileBytes;
          tma_load(qs + off, &qmap, &full[s], kPanel * p, q0, bh);
          tma_load(gs + off, &gmap, &full[s], kPanel * p, q0, bh);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumer warpgroup wg takes items wg, wg + NWG, ...: key rows k0 + r0
  // and + 8; query columns 8j + c0 + {0, 1}
  if (NWG == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
  const int wg = warp / 4;
  const int r0 = 16 * (warp % 4) + lane / 4;
  const int c0 = 2 * (lane % 4);
  const int kpos[2] = {k0 + r0, k0 + r0 + 8};
  const uint32_t kb = smem_u32(ks);
  const uint32_t vb = smem_u32(vs);

  float dk[S::CBP][32], dv[S::CBP][32];
#pragma unroll
  for (int p = 0; p < S::CBP; ++p) {
    zero(dk[p]);
    zero(dv[p]);
  }
  mbar_wait(kvbar, 0);
  for (int it = wg; it < ntiles; it += NWG) {
    const int s = it % o.stages;
    const int q0 = (qt0 + it % nq) * kBwdTile;
    const uint32_t qb = smem_u32(qs) + s * NP * kTileBytes;
    const uint32_t gb = smem_u32(gs) + s * NP * kTileBytes;
    mbar_wait(&full[s], (it / o.stages) & 1);

    float sc[32], dp[32];
    reg_fence(sc);
    reg_fence(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NP; ++kk) {
      const uint32_t off = (kk / 4) * kTileBytes + (kk % 4) * 32;
      wgmma_ss(sc, desc_k(kb + off), desc_k(qb + off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < 4 * NP; ++kk) {
      const uint32_t off = (kk / 4) * kTileBytes + (kk % 4) * 32;
      wgmma_ss(dp, desc_k(vb + off), desc_k(gb + off), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    reg_fence(sc);
    reg_fence(dp);

    const bool mask = !all_visible(o, q0 + o.q_offset,
                                   min(q0 + kBwdTile, o.tq) - 1 + o.q_offset,
                                   k0, k0 + kBwdTile);
    CAP_MASK_DISPATCH(dkdv_tile, o.use_softcap, mask, o, sc, dp,
                      lses + s * kBwdTile, dls + s * kBwdTile, q0, kpos, c0);
    uint32_t pa[4][4], da[4][4];
    to_a_frags(sc, pa);
    to_a_frags(dp, da);

#pragma unroll
    for (int p = 0; p < S::CBP; ++p) {
      reg_fence(dv[p]);
      reg_fence(dk[p]);
    }
    wg_fence();
#pragma unroll
    for (int p = 0; p < S::CBP; ++p)
      if (p0 + p < NP)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t off = (p0 + p) * kTileBytes + 16 * kk * kRowBytes;
          wgmma_rs(dv[p], pa[kk], desc_mn(gb + off));
          wgmma_rs(dk[p], da[kk], desc_mn(qb + off));
        }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int p = 0; p < S::CBP; ++p) {
      reg_fence(dv[p]);
      reg_fence(dk[p]);
    }
    mbar_arrive(&empty[s]);
  }

  if (NWG == 2) {
    // the second warpgroup's sums join the first's through the Q / dO
    // rings, which every load has left once both are past their loops
    float* xs = reinterpret_cast<float*>(qs);
    const int t = threadIdx.x % 128;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    consumers_sync();
    if (wg == 1) {
#pragma unroll
      for (int p = 0; p < S::CBP; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          xs[((2 * p) * 32 + i) * 128 + t] = dk[p][i];
          xs[((2 * p + 1) * 32 + i) * 128 + t] = dv[p][i];
        }
    }
    consumers_sync();
    if (wg == 1) return;
#pragma unroll
    for (int p = 0; p < S::CBP; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        dk[p][i] += xs[((2 * p) * 32 + i) * 128 + t];
        dv[p][i] += xs[((2 * p + 1) * 32 + i) * 128 + t];
      }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] >= o.tk) continue;
    const long long at = (static_cast<long long>(hk) * o.tk + kpos[r]) * o.d;
#pragma unroll
    for (int p = 0; p < S::CBP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = kPanel * (p0 + p) + 8 * j + c0;
        if (p0 + p < NP && col < o.d) {
          *reinterpret_cast<__nv_bfloat162*>(a.dk + at + col) =
              __floats2bfloat162_rn(dk[p][4 * j + 2 * r],
                                    dk[p][4 * j + 2 * r + 1]);
          *reinterpret_cast<__nv_bfloat162*>(a.dv + at + col) =
              __floats2bfloat162_rn(dv[p][4 * j + 2 * r],
                                    dv[p][4 * j + 2 * r + 1]);
        }
      }
  }
}

// one CTA per (b * Hq + h, 64-query tile)
template <int NP>
__global__ void __launch_bounds__(kBwdThreads, NP == 1 ? 2 : 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap gmap,
                          const BwdArgs a, const Opts o) {
  using S = BwdShape<NP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* qs = base;                              // [NP][64][64]
  uint8_t* gs = qs + NP * kTileBytes;
  uint8_t* ks = gs + NP * kTileBytes;              // [stages][NP][64][64]
  uint8_t* vs = ks + o.stages * NP * kTileBytes;
  // (the lse / delta slots of the layout stay unused here)
  uint64_t* full = reinterpret_cast<uint64_t*>(
      vs + o.stages * NP * kTileBytes + o.stages * 2 * kBwdTile * 4);
  uint64_t* empty = full + o.stages;
  uint64_t* qbar = empty + o.stages;

  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBwdTile;   // longest first
  const int bh = blockIdx.x;
  const int b = bh / o.hq;
  const int hk = b * o.hkv + (bh - b * o.hq) / (o.hq / o.hkv);
  int k_lo, k_hi;
  key_range(o, q0 + o.q_offset, min(q0 + kBwdTile, o.tq) - 1 + o.q_offset,
            k_lo, k_hi);
  const int t0 = k_lo / kBwdTile;
  const int ntiles = max(0, (k_hi + kBwdTile - 1) / kBwdTile - t0);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < o.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {
    if (lane == 0) {
      mbar_expect_tx(qbar, 2 * NP * kTileBytes);
      for (int p = 0; p < NP; ++p) {
        tma_load(qs + p * kTileBytes, &qmap, qbar, kPanel * p, q0, bh);
        tma_load(gs + p * kTileBytes, &gmap, qbar, kPanel * p, q0, bh);
      }
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % o.stages;
        if (it >= o.stages) mbar_wait(&empty[s], ((it / o.stages) & 1) ^ 1);
        mbar_expect_tx(&full[s], S::kStage);
        const int k0 = (t0 + it) * kBwdTile;
        for (int p = 0; p < NP; ++p) {
          const int off = (s * NP + p) * kTileBytes;
          tma_load(ks + off, &kmap, &full[s], kPanel * p, k0, hk);
          tma_load(vs + off, &vmap, &full[s], kPanel * p, k0, hk);
        }
      }
    }
    return;
  }

  // consumer: query rows q0 + r0 and + 8; key columns 8j + c0 + {0, 1}
  const int r0 = 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);
  const long long bh_row = static_cast<long long>(bh) * o.tq;
  int qpos[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    qpos[r] = row + o.q_offset;
    lse2[r] = lse2_of(a.lse, bh_row + row, row < o.tq);
    dl[r] = row < o.tq ? a.delta[bh_row + row] : 0.0f;
  }
  const int qmin = q0 + o.q_offset;
  const int qmax = min(q0 + kBwdTile, o.tq) - 1 + o.q_offset;
  const uint32_t qb = smem_u32(qs);
  const uint32_t gb = smem_u32(gs);

  float dq[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p) zero(dq[p]);
  mbar_wait(qbar, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % o.stages;
    const int k0 = (t0 + it) * kBwdTile;
    const uint32_t kb = smem_u32(ks) + s * NP * kTileBytes;
    const uint32_t vb = smem_u32(vs) + s * NP * kTileBytes;
    mbar_wait(&full[s], (it / o.stages) & 1);

    float sc[32], dp[32];
    reg_fence(sc);
    reg_fence(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NP; ++kk) {
      const uint32_t off = (kk / 4) * kTileBytes + (kk % 4) * 32;
      wgmma_ss(sc, desc_k(qb + off), desc_k(kb + off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < 4 * NP; ++kk) {
      const uint32_t off = (kk / 4) * kTileBytes + (kk % 4) * 32;
      wgmma_ss(dp, desc_k(gb + off), desc_k(vb + off), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    reg_fence(sc);
    reg_fence(dp);

    const bool mask = !all_visible(o, qmin, qmax, k0, k0 + kBwdTile);
    CAP_MASK_DISPATCH(dq_tile, o.use_softcap, mask, o, sc, dp, lse2, dl, qpos,
                      k0, c0);
    uint32_t da[4][4];
    to_a_frags(dp, da);

#pragma unroll
    for (int p = 0; p < NP; ++p) reg_fence(dq[p]);
    wg_fence();
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dq[p], da[kk],
                 desc_mn(kb + p * kTileBytes + 16 * kk * kRowBytes));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int p = 0; p < NP; ++p) reg_fence(dq[p]);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= o.tq) continue;
    bf16* drow = a.dq + (bh_row + row) * o.d;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = kPanel * p + 8 * j + c0;
        if (col < o.d)
          *reinterpret_cast<__nv_bfloat162*>(drow + col) =
              __floats2bfloat162_rn(dq[p][4 * j + 2 * r],
                                    dq[p][4 * j + 2 * r + 1]);
      }
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and launches

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library links no libcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [bh, t, d] bf16 as a 3-D tensor map with 64-column, `rows`-row boxes,
// 128-byte swizzle, zeros outside
bool make_map(CUtensorMap* map, const void* ptr, int bh, int t, int d,
              int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(t) * d * 2};
  const cuuint32_t box[3] = {kPanel, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int NP>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out,
                       float* lse, int batch, const Opts& o, int smem,
                       cudaStream_t stream) {
  if (smem != FwdShape<NP>::smem(o.stages) || smem > kSmemMax)
    return cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, batch * o.hq, o.tq, o.d, kFwdBQ) ||
      !make_map(&km, k, batch * o.hkv, o.tk, o.d, FwdShape<NP>::BK) ||
      !make_map(&vm, v, batch * o.hkv, o.tk, o.d, FwdShape<NP>::BK))
    return cudaErrorInvalidValue;
  cudaError_t err = set_smem(flash_fwd_wgmma_kernel<NP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * o.hq, (o.tq + kFwdBQ - 1) / kFwdBQ);
  flash_fwd_wgmma_kernel<NP><<<grid, kFwdThreads, smem, stream>>>(
      qm, km, vm, static_cast<bf16*>(out), lse, o);
  return cudaGetLastError();
}

template <int NP>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const BwdArgs& a, int batch,
                       const Opts& o_kv, int smem_kv, const Opts& o_q,
                       int smem_q, cudaStream_t stream) {
  using S = BwdShape<NP>;
  if (smem_kv != S::smem(o_kv.stages) || smem_q != S::smem(o_q.stages) ||
      max(smem_kv, smem_q) > kSmemMax)
    return cudaErrorInvalidValue;
  CUtensorMap qm, km, vm, gm;
  if (!make_map(&qm, q, batch * o_kv.hq, o_kv.tq, o_kv.d, kBwdTile) ||
      !make_map(&gm, dout, batch * o_kv.hq, o_kv.tq, o_kv.d, kBwdTile) ||
      !make_map(&km, k, batch * o_kv.hkv, o_kv.tk, o_kv.d, kBwdTile) ||
      !make_map(&vm, v, batch * o_kv.hkv, o_kv.tk, o_kv.d, kBwdTile))
    return cudaErrorInvalidValue;
  cudaError_t err = set_smem(flash_bwd_dkdv_wgmma_kernel<NP>, smem_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(batch * o_kv.hkv, (o_kv.tk + kBwdTile - 1) / kBwdTile,
                     (NP + S::CBP - 1) / S::CBP);
  flash_bwd_dkdv_wgmma_kernel<NP>
      <<<grid_kv, DkdvShape<NP>::kThreads, smem_kv, stream>>>(qm, km, vm, gm,
                                                              a, o_kv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = set_smem(flash_bwd_dq_wgmma_kernel<NP>, smem_q);
  if (err != cudaSuccess) return err;
  const dim3 grid_q(batch * o_q.hq, (o_q.tq + kBwdTile - 1) / kBwdTile);
  flash_bwd_dq_wgmma_kernel<NP><<<grid_q, kBwdThreads, smem_q, stream>>>(
      qm, km, vm, gm, a, o_q);
  return cudaGetLastError();
}

bool valid(int d, int hq, int hkv, int stages) {
  return d > 0 && d <= 256 && d % 8 == 0 && hkv > 0 && hq % hkv == 0 &&
         stages >= 2 && stages <= 4;
}

}  // namespace

// The bf16 forward.  `stages` and `smem` are the wrapper's launch plan
// (repro_torch.kernels.flash_attention.launch_plan); a plan that does not
// match this file's layout is refused.  Returns the launch's cudaError_t.
extern "C" int flash_attention_sm90_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int batch, int hq, int hkv, int tq, int tk, int d, float scale,
    int causal, int window, int prefix, int use_softcap, float softcap,
    int q_offset, int stages, int smem, void* stream) {
  if (!valid(d, hq, hkv, stages))
    return static_cast<int>(cudaErrorInvalidValue);
  const Opts opts{hq,     hkv,    tq,          tk,      d,
                  scale,  causal, window,      prefix,  use_softcap,
                  softcap, q_offset, stages};
  // one instantiation per number of 64-column panels of D
  constexpr decltype(&launch_fwd<1>) by_panels[4] = {
      launch_fwd<1>, launch_fwd<2>, launch_fwd<3>, launch_fwd<4>};
  return static_cast<int>(by_panels[(d + kPanel - 1) / kPanel - 1](
      q, k, v, o, lse, batch, opts, smem, static_cast<cudaStream_t>(stream)));
}

// The bf16 gradients (dq like q; dk, dv like k) from the saved forward
// (o, lse) and dout; delta is float32 scratch [batch, hq, tq].  The two
// (stages, smem) pairs are the plan of the dK/dV and the dQ kernel.
// Returns the first failing launch's cudaError_t.
extern "C" int flash_attention_sm90_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int batch, int hq, int hkv, int tq, int tk, int d, float scale,
    int causal, int window, int prefix, int use_softcap, float softcap,
    int q_offset, int stages_kv, int smem_kv, int stages_q, int smem_q,
    void* stream) {
  if (!valid(d, hq, hkv, stages_kv) || !valid(d, hq, hkv, stages_q))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(batch) * hq * tq;
  flash_bwd_rowsum_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                            s>>>(static_cast<const bf16*>(o),
                                 static_cast<const bf16*>(dout), delta, rows,
                                 d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Opts okv{hq,     hkv,    tq,          tk,      d,
                 scale,  causal, window,      prefix,  use_softcap,
                 softcap, q_offset, stages_kv};
  Opts oq = okv;
  oq.stages = stages_q;
  const BwdArgs a{lse, delta, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                  static_cast<bf16*>(dv)};
  constexpr decltype(&launch_bwd<1>) by_panels[4] = {
      launch_bwd<1>, launch_bwd<2>, launch_bwd<3>, launch_bwd<4>};
  return static_cast<int>(by_panels[(d + kPanel - 1) / kPanel - 1](
      q, k, v, dout, a, batch, okv, smem_kv, oq, smem_q, s));
}

extern "C" const char* flash_attention_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

KINFO_NAMES(flash_attention_sm90, "flash_bwd_rowsum",
            "flash_fwd_wgmma<1>", "flash_fwd_wgmma<2>", "flash_fwd_wgmma<3>",
            "flash_fwd_wgmma<4>", "flash_bwd_dkdv_wgmma<1>",
            "flash_bwd_dkdv_wgmma<2>", "flash_bwd_dkdv_wgmma<3>",
            "flash_bwd_dkdv_wgmma<4>", "flash_bwd_dq_wgmma<1>",
            "flash_bwd_dq_wgmma<2>", "flash_bwd_dq_wgmma<3>",
            "flash_bwd_dq_wgmma<4>")

// kernels.autotune.kernel_attributes.  which: 0 flash_bwd_rowsum_kernel
// (256 threads), 1-4 flash_fwd_wgmma_kernel<NP>, 5-8
// flash_bwd_dkdv_wgmma_kernel<NP>, 9-12 flash_bwd_dq_wgmma_kernel<NP> for
// NP = 1..4 panels, each at its launch's threads; dyn_smem is the plan's
// (kernels.flash_attention.launch_plan).  The runtime's occupancy is asked
// at query_block (the launch's threads when <= 0).
extern "C" int flash_attention_sm90_kernel_info(int which, int block,
                                                int query_block, int dyn_smem,
                                                int* out) {
  (void)block;
  if (dyn_smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto at = [&](int threads) {
    return query_block > 0 ? query_block : threads;
  };
  if (which == 0)
    return kinfo::kernel_info(flash_bwd_rowsum_kernel, at(256), dyn_smem,
                              out);
  switch (which) {
    case 1: return kinfo::kernel_info(flash_fwd_wgmma_kernel<1>,
                                      at(kFwdThreads), dyn_smem, out);
    case 2: return kinfo::kernel_info(flash_fwd_wgmma_kernel<2>,
                                      at(kFwdThreads), dyn_smem, out);
    case 3: return kinfo::kernel_info(flash_fwd_wgmma_kernel<3>,
                                      at(kFwdThreads), dyn_smem, out);
    case 4: return kinfo::kernel_info(flash_fwd_wgmma_kernel<4>,
                                      at(kFwdThreads), dyn_smem, out);
    case 5: return kinfo::kernel_info(flash_bwd_dkdv_wgmma_kernel<1>,
                                      at(DkdvShape<1>::kThreads), dyn_smem,
                                      out);
    case 6: return kinfo::kernel_info(flash_bwd_dkdv_wgmma_kernel<2>,
                                      at(DkdvShape<2>::kThreads), dyn_smem,
                                      out);
    case 7: return kinfo::kernel_info(flash_bwd_dkdv_wgmma_kernel<3>,
                                      at(DkdvShape<3>::kThreads), dyn_smem,
                                      out);
    case 8: return kinfo::kernel_info(flash_bwd_dkdv_wgmma_kernel<4>,
                                      at(DkdvShape<4>::kThreads), dyn_smem,
                                      out);
    case 9: return kinfo::kernel_info(flash_bwd_dq_wgmma_kernel<1>,
                                      at(kBwdThreads), dyn_smem, out);
    case 10: return kinfo::kernel_info(flash_bwd_dq_wgmma_kernel<2>,
                                       at(kBwdThreads), dyn_smem, out);
    case 11: return kinfo::kernel_info(flash_bwd_dq_wgmma_kernel<3>,
                                       at(kBwdThreads), dyn_smem, out);
    case 12: return kinfo::kernel_info(flash_bwd_dq_wgmma_kernel<4>,
                                       at(kBwdThreads), dyn_smem, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
