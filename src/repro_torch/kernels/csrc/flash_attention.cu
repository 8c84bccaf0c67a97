// Flash attention forward on Hopper (sm_90a), on the CUDA cores: the
// float32 route.  bf16 operands take the tensor-core kernels of
// flash_attention_sm90.cu; float32 stays here, because float32 on the
// tensor cores would be TF32, which cannot hold the float32 tolerances.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (body `_kernel`): softmax(q k^T * scale) v with
// causal, sliding-window and prefix-LM masks, logit soft-capping, a query
// offset, and grouped-query attention, in one pass that keeps the logits
// out of device memory (the online softmax: a running row max m, row sum l
// and output accumulator acc, rescaled as each key tile arrives).
//
// Layout: q [B, Hq, Tq, D], k and v [B, Hkv, Tk, D], o like q, all dense
// row-major (the wrapper makes them contiguous), float32; the arithmetic is
// float32 throughout.
// Query head h reads key/value head h / (Hq / Hkv): the grouped heads are
// never repeated in memory.  Any D <= 256 with D % 8 == 0 (rows are read
// 16 bytes at a time).
//
// Design.  One CTA of 256 threads per (b * Hq + h, 64-query tile); a loop
// over 64-key tiles takes the place of the TPU's sequential `ki` grid axis
// and carries (m, l, acc) in registers.  The Q tile and each K tile sit in
// shared memory d-major ([D][64]), the V tile row-major ([64][D]), all as
// float32.  Thread (ty, tx) of the 16 x 16 grid owns query rows 4ty..4ty+3:
//   S = Q K^T: keys 4tx..4tx+3, a 4 x 4 register tile, two 16-byte shared
//     loads and 16 FMAs per d;
//   softmax: the row max and row sum are reduced over the 16 lanes that
//     share ty (one half-warp) with shuffles, so m and l never leave
//     registers; masked entries keep p at exactly 0 (as the TPU kernel's
//     `jnp.where(mask, p, 0.0)`: with the finite -1e30 for masked logits,
//     exp(-1e30 - (-1e30)) = 1 would otherwise leak into l);
//   P goes through shared memory (transposed, [64 keys][64 rows]) because
//     the product P V contracts over the keys, which are spread over tx;
//   O += P V: columns 64j + 4tx..+3 for j < ceil(D / 64), 4 x 4 per j.
// Key tiles that the masks hide from every query of the tile are never
// loaded: above the causal diagonal (past the last query, or past the
// prefix when a query lies in it) and before the window of the first
// query.  That halves the causal work and makes a windowed layer
// O(Tq * window).  CTAs take their query tiles from the last one down, so
// the longest causal tiles start first.  A row that sees no key ends with
// l = 0 and writes 0 (acc / max(l, 1e-37), as the TPU kernel emits).
//
// What bounds it on this card: operations.  At the serving path's prefill
// shape (q [8, 14, 2048, 64], k and v [8, 2, 2048, 64], bf16, causal) the
// visible (query, key) pairs need 60.1 GFLOP against 67.1 MB of operands:
// 0.061 ms at the tensor cores' 989 TFLOP/s (bf16 dense), 0.020 ms at
// 3.35 TB/s.  This kernel runs on the CUDA cores in float32 (67 TFLOP/s
// counting an FMA as two), so its own ceiling is ~0.9 ms; the register
// tiles give 8 FMAs per shared-memory load to approach it.  Tensor cores
// (wgmma on bf16 tiles) and TMA-fed K/V are flash_attention_sm90.cu.
//
// The build turns off multiply-add contraction (-fmad=false, _build.py);
// the dot products here are explicit fmaf, the rest rounds as written.

#include <cuda_runtime.h>

#include "kernel_info.cuh"
#include <math_constants.h>
#include <cstdint>

namespace {

constexpr int kBQ = 64;               // queries per CTA
constexpr int kBK = 64;               // keys per tile
constexpr int kThreads = 256;         // 16 x 16
constexpr int kLD = kBQ + 4;          // pitch of the d-major tiles and of P
constexpr float kNegInf = -1e30f;     // the TPU kernel's NEG_INF

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;        // [b, hq, tq]: m + log l, -inf where l = 0
  int hq, hkv, tq, tk, d;
  float scale;
  int causal;
  int window;        // < 0: none
  int prefix;        // < 0: none
  int use_softcap;
  float softcap;
  int q_offset;
};

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;         // elements per 16-byte load
  __device__ static void load(const float* p, float* out) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  }
  __device__ static void store(float x, float* p) { *p = x; }
};

// Rows row0 .. row0+63 of a [rows_total, d] array into shared memory as
// float32, zero past the last row: d-major (dst[c * kLD + r]) or row-major
// (dst[r * pitch + c]).  Consecutive threads take consecutive rows, so the
// d-major stores hit distinct banks and the row-major ones go 16 bytes at
// a time.
template <typename T, bool kDMajor>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int row0,
                                          int rows_total, int d, float* dst,
                                          int pitch) {
  constexpr int N = Vec<T>::N;
  const int total = kBK * (d / N);
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int r = i % kBK;
    const int c = (i / kBK) * N;
    float x[N];
    if (row0 + r < rows_total) {
      Vec<T>::load(src + (static_cast<long long>(row0) + r) * d + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) x[e] = 0.0f;
    }
    if (kDMajor) {
#pragma unroll
      for (int e = 0; e < N; ++e) dst[(c + e) * kLD + r] = x[e];
    } else {
#pragma unroll
      for (int e = 0; e < N; e += 4)
        *reinterpret_cast<float4*>(&dst[r * pitch + c + e]) =
            make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
    }
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(Params p) {
  extern __shared__ float4 smem4[];
  constexpr int kPV = 64 * NJ + 4;    // pitch of the row-major V tile
  const int d = p.d;
  float* qs = reinterpret_cast<float*>(smem4);   // [d][kLD]
  float* ks = qs + d * kLD;                      // [d][kLD]
  float* vs = ks + d * kLD;                      // [kBK][kPV]
  float* ps = vs + kBK * kPV;                    // [kBK][kLD]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / p.hq;
  const int h = bh - b * p.hq;
  const int hk = b * p.hkv + h / (p.hq / p.hkv);
  const T* qg = static_cast<const T*>(p.q) +
                static_cast<long long>(bh) * p.tq * d;
  const T* kg = static_cast<const T*>(p.k) +
                static_cast<long long>(hk) * p.tk * d;
  const T* vg = static_cast<const T*>(p.v) +
                static_cast<long long>(hk) * p.tk * d;
  T* og = static_cast<T*>(p.o) + static_cast<long long>(bh) * p.tq * d;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  // V's columns past d are read by the P V loop (64-wide column groups)
  // and never written by a tile load: zero them once.
  for (int i = tid; i < kBK * (kPV - d); i += kThreads)
    vs[(i / (kPV - d)) * kPV + d + i % (kPV - d)] = 0.0f;
  load_tile<T, true>(qg, q0, p.tq, d, qs, 0);

  // the keys that some query of this tile can see
  const int qmin = q0 + p.q_offset;
  const int qmax = min(q0 + kBQ, p.tq) - 1 + p.q_offset;
  int k_hi = p.tk;
  if (p.causal) {
    k_hi = min(k_hi, qmax + 1);
    if (p.prefix >= 0 && qmin < p.prefix)
      k_hi = max(k_hi, min(p.prefix, p.tk));
  }
  const int k_lo = p.window >= 0 ? max(0, qmin - p.window + 1) : 0;

  float m[4], l[4], acc[4][NJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;
  }

  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();                  // the last tile's readers are done
    load_tile<T, true>(kg, k0, p.tk, d, ks, 0);
    load_tile<T, false>(vg, k0, p.tk, d, vs, kPV);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&qs[c * kLD + 4 * ty]);
      const float4 e = *reinterpret_cast<const float4*>(&ks[c * kLD + 4 * tx]);
      const float qa[4] = {a.x, a.y, a.z, a.w};
      const float kb[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i + p.q_offset;
      bool live[4];
      float mcur = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + 4 * tx + j;
        float x = s[i][j] * p.scale;
        if (p.use_softcap) x = p.softcap * tanhf(x / p.softcap);
        bool ok = kpos < p.tk;
        if (p.causal)
          ok = ok && (kpos <= qpos || (p.prefix >= 0 && kpos < p.prefix &&
                                       qpos < p.prefix));
        if (p.window >= 0) ok = ok && kpos > qpos - p.window;
        live[j] = ok;
        s[i][j] = ok ? x : kNegInf;
        mcur = fmaxf(mcur, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mcur));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = live[j] ? expf(s[i][j] - m_new) : 0.0f;
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&ps[(4 * tx + j) * kLD + 4 * ty]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&ps[kk * kLD + 4 * ty]);
      const float pa[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 e =
            *reinterpret_cast<const float4*>(&vs[kk * kPV + 64 * j + 4 * tx]);
        const float vb[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][j][c] = fmaf(pa[i], vb[c], acc[i][j][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= p.tq) continue;
    // m and l are the same on the 16 lanes of the row: one writes lse
    if (tx == 0)
      p.lse[static_cast<long long>(bh) * p.tq + row] =
          l[i] > 0.0f ? m[i] + logf(l[i]) : -CUDART_INF_F;
    const float denom = fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 64 * j + 4 * tx + c;
        if (col < d)
          Vec<T>::store(acc[i][j][c] / denom,
                        og + static_cast<long long>(row) * d + col);
      }
  }
}

template <typename T, int NJ>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * p.d * kLD + kBK * (64 * NJ + 4) + kBK * kLD);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, NJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.tq + kBQ - 1) / kBQ, batch * p.hq);
  flash_attention_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int batch, cudaStream_t stream) {
  switch ((p.d + 63) / 64) {
    case 1: return launch<T, 1>(p, batch, stream);
    case 2: return launch<T, 2>(p, batch, stream);
    case 3: return launch<T, 3>(p, batch, stream);
    case 4: return launch<T, 4>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Backward (flash_xla.py's `_bwd`): from the saved (q, k, v, o, lse) and
// dO, recompute P = exp(softcap'd logits - lse) tile by tile, then
//   delta = rowsum(dO * O)                      (pre-pass, one warp a row)
//   dV   += P^T dO,  dP = dO V^T,  dS = P (dP - delta) [(1 - tanh^2)] scale
//   dK   += dS^T Q                              (kernel dkdv)
//   dQ   += dS K                                (kernel dq)
// Each kernel owns its outputs, so nothing is summed with atomics: a dkdv
// CTA takes one (batch, KV head, 64-key tile) and loops over the Hq / Hkv
// query heads that read it (GQA summed in the CTA) and over the query
// tiles the masks leave visible; a dq CTA takes one (batch, query head,
// 64-query tile) and loops over its visible key tiles.  The contraction
// over D runs in 64-wide chunks (both operands d-major, as in the
// forward), and each CTA writes one 64-wide column block of its outputs
// (grid axis z: D / 64 blocks, so at D = 256 the logits are recomputed
// four times but every accumulator stays a 4 x 4 register tile).  P and dS
// pass through shared memory, row-major, for the products that contract
// over the other axis.  Rows with lse = -inf see no key: P = 0 there.

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int hq, hkv, tq, tk, d;
  float scale;
  int causal;
  int window;        // < 0: none
  int prefix;        // < 0: none
  int use_softcap;
  float softcap;
  int q_offset;
};

__device__ __forceinline__ bool sees(const BwdParams& p, int qpos, int kpos) {
  bool ok = kpos < p.tk;
  if (p.causal)
    ok = ok && (kpos <= qpos ||
                (p.prefix >= 0 && kpos < p.prefix && qpos < p.prefix));
  if (p.window >= 0) ok = ok && kpos > qpos - p.window;
  return ok;
}

// Rows row0 .. row0+63, columns col0 .. col0+63 of a [rows_total, d] array
// into shared memory as float32, zero outside it: d-major (dst[c * kLD +
// r]) or row-major (dst[r * kLD + c]).
template <typename T, bool kDMajor>
__device__ __forceinline__ void load_block(const T* __restrict__ src,
                                           int row0, int rows_total,
                                           int col0, int d, float* dst) {
  constexpr int N = Vec<T>::N;
  for (int i = threadIdx.x; i < kBK * (64 / N); i += kThreads) {
    const int r = i % kBK;
    const int c = (i / kBK) * N;
    float x[N];
    if (row0 + r < rows_total && col0 + c < d) {
      Vec<T>::load(src + (static_cast<long long>(row0) + r) * d + col0 + c,
                   x);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) x[e] = 0.0f;
    }
    if (kDMajor) {
#pragma unroll
      for (int e = 0; e < N; ++e) dst[(c + e) * kLD + r] = x[e];
    } else {
#pragma unroll
      for (int e = 0; e < N; e += 4)
        *reinterpret_cast<float4*>(&dst[r * kLD + c + e]) =
            make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
    }
  }
}

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }

// delta[row] = sum_d dO[row, d] * O[row, d] in float32, one warp a row
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, long long rows, int d) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* a = o + row * d;
  const T* g = dout + row * d;
  float s = 0.0f;
  for (int c = lane; c < d; c += 32) s += to_f(g[c]) * to_f(a[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// s[r][c] and dp[r][c] (query rows 4ty+r, keys 4tx+c) from the d-major
// chunks in shared memory
__device__ __forceinline__ void qk_and_dov(const float* qd, const float* kd,
                                           const float* dod, const float* vd,
                                           int ty, int tx, float (&s)[4][4],
                                           float (&dp)[4][4]) {
#pragma unroll 4
  for (int c = 0; c < 64; ++c) {
    const float4 a = *reinterpret_cast<const float4*>(&qd[c * kLD + 4 * ty]);
    const float4 e = *reinterpret_cast<const float4*>(&kd[c * kLD + 4 * tx]);
    const float4 g = *reinterpret_cast<const float4*>(&dod[c * kLD + 4 * ty]);
    const float4 w = *reinterpret_cast<const float4*>(&vd[c * kLD + 4 * tx]);
    const float qa[4] = {a.x, a.y, a.z, a.w};
    const float kb[4] = {e.x, e.y, e.z, e.w};
    const float ga[4] = {g.x, g.y, g.z, g.w};
    const float vb[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(ga[i], vb[j], dp[i][j]);
      }
  }
}

// P and dS in place of s and dp, for query rows q0+4ty+r, keys k0+4tx+c
__device__ __forceinline__ void probs_and_ds(const BwdParams& p, int q0,
                                             int k0, int ty, int tx,
                                             const float (&lse)[4],
                                             const float (&dl)[4],
                                             float (&s)[4][4],
                                             float (&dp)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i + p.q_offset;
    const bool live_row = q0 + 4 * ty + i < p.tq && lse[i] > -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float raw = s[i][j] * p.scale;
      float th = 0.0f;
      float capped = raw;
      if (p.use_softcap) {
        th = tanhf(raw / p.softcap);
        capped = p.softcap * th;
      }
      const bool ok = live_row && sees(p, qpos, k0 + 4 * tx + j);
      const float pv = ok ? expf(capped - lse[i]) : 0.0f;
      float ds = pv * (dp[i][j] - dl[i]);
      if (p.use_softcap) ds = ds * (1.0f - th * th);
      s[i][j] = pv;
      dp[i][j] = ds * p.scale;
    }
  }
}

struct DkdvSmem {
  float qd[64 * kLD], kd[64 * kLD], dod[64 * kLD], vd[64 * kLD];
  float qr[kBQ * kLD], dor[kBQ * kLD];   // the column block, row-major
  float ps[kBQ * kLD], dss[kBQ * kLD];   // P[i][j], dS[i][j]
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(BwdParams p) {
  extern __shared__ float4 smem4[];
  DkdvSmem& sm = *reinterpret_cast<DkdvSmem*>(smem4);
  const int d = p.d;
  const int k0 = blockIdx.x * kBK;
  const int hk = blockIdx.y;                 // b * hkv + kv head
  const int col0 = blockIdx.z * 64;
  const int b = hk / p.hkv;
  const int rep = p.hq / p.hkv;
  const int h0 = b * p.hq + (hk - b * p.hkv) * rep;
  const int nchunk = (d + 63) / 64;
  const T* kg = static_cast<const T*>(p.k) + static_cast<long long>(hk) * p.tk * d;
  const T* vg = static_cast<const T*>(p.v) + static_cast<long long>(hk) * p.tk * d;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  // the query rows that see some key of this tile
  const int k_last = min(k0 + kBK, p.tk) - 1;
  int row_lo = 0;
  if (p.causal && !(p.prefix >= 0 && k0 < p.prefix))
    row_lo = max(0, k0 - p.q_offset);
  int row_hi = p.tq;
  if (p.window >= 0)
    row_hi = min(row_hi, k_last + p.window - p.q_offset);

  if (nchunk == 1) {
    load_block<T, true>(kg, k0, p.tk, 0, d, sm.kd);
    load_block<T, true>(vg, k0, p.tk, 0, d, sm.vd);
  }
  float dk[4][4], dv[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.0f;

  for (int g = 0; g < rep; ++g) {
    const long long bh = h0 + g;
    const T* qg = static_cast<const T*>(p.q) + bh * p.tq * d;
    const T* og = static_cast<const T*>(p.dout) + bh * p.tq * d;
    for (int q0 = (row_lo / kBQ) * kBQ; q0 < row_hi; q0 += kBQ) {
      float s[4][4], dp[4][4], lse[4], dl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + 4 * ty + i;
        lse[i] = row < p.tq ? p.lse[bh * p.tq + row] : -CUDART_INF_F;
        dl[i] = row < p.tq ? p.delta[bh * p.tq + row] : 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
      }
      for (int ch = 0; ch < nchunk; ++ch) {
        __syncthreads();              // the last readers are done
        load_block<T, true>(qg, q0, p.tq, 64 * ch, d, sm.qd);
        load_block<T, true>(og, q0, p.tq, 64 * ch, d, sm.dod);
        if (nchunk > 1) {
          load_block<T, true>(kg, k0, p.tk, 64 * ch, d, sm.kd);
          load_block<T, true>(vg, k0, p.tk, 64 * ch, d, sm.vd);
        }
        __syncthreads();
        qk_and_dov(sm.qd, sm.kd, sm.dod, sm.vd, ty, tx, s, dp);
      }
      probs_and_ds(p, q0, k0, ty, tx, lse, dl, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<float4*>(&sm.ps[(4 * ty + i) * kLD + 4 * tx]) =
            make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
        *reinterpret_cast<float4*>(&sm.dss[(4 * ty + i) * kLD + 4 * tx]) =
            make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
      }
      load_block<T, false>(qg, q0, p.tq, col0, d, sm.qr);
      load_block<T, false>(og, q0, p.tq, col0, d, sm.dor);
      __syncthreads();
      // keys 4ty+r, columns col0+4tx+c
#pragma unroll 4
      for (int i = 0; i < kBQ; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(&sm.ps[i * kLD + 4 * ty]);
        const float4 e = *reinterpret_cast<const float4*>(&sm.dss[i * kLD + 4 * ty]);
        const float4 f = *reinterpret_cast<const float4*>(&sm.dor[i * kLD + 4 * tx]);
        const float4 w = *reinterpret_cast<const float4*>(&sm.qr[i * kLD + 4 * tx]);
        const float pa[4] = {a.x, a.y, a.z, a.w};
        const float da[4] = {e.x, e.y, e.z, e.w};
        const float ga[4] = {f.x, f.y, f.z, f.w};
        const float qa[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            dv[r][c] = fmaf(pa[r], ga[c], dv[r][c]);
            dk[r][c] = fmaf(da[r], qa[c], dk[r][c]);
          }
      }
    }
  }
  T* dkg = static_cast<T*>(p.dk) + static_cast<long long>(hk) * p.tk * d;
  T* dvg = static_cast<T*>(p.dv) + static_cast<long long>(hk) * p.tk * d;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = k0 + 4 * ty + r;
    if (row >= p.tk) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = col0 + 4 * tx + c;
      if (col < d) {
        Vec<T>::store(dk[r][c], dkg + static_cast<long long>(row) * d + col);
        Vec<T>::store(dv[r][c], dvg + static_cast<long long>(row) * d + col);
      }
    }
  }
}

struct DqSmem {
  float qd[64 * kLD], kd[64 * kLD], dod[64 * kLD], vd[64 * kLD];
  float kr[kBK * kLD];                   // the column block of K, row-major
  float dst[kBK * kLD];                  // dS[i][j] as [j][i]
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(BwdParams p) {
  extern __shared__ float4 smem4[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(smem4);
  const int d = p.d;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest first
  const int bh = blockIdx.y;
  const int col0 = blockIdx.z * 64;
  const int b = bh / p.hq;
  const int h = bh - b * p.hq;
  const int hk = b * p.hkv + h / (p.hq / p.hkv);
  const int nchunk = (d + 63) / 64;
  const T* qg = static_cast<const T*>(p.q) + static_cast<long long>(bh) * p.tq * d;
  const T* og = static_cast<const T*>(p.dout) + static_cast<long long>(bh) * p.tq * d;
  const T* kg = static_cast<const T*>(p.k) + static_cast<long long>(hk) * p.tk * d;
  const T* vg = static_cast<const T*>(p.v) + static_cast<long long>(hk) * p.tk * d;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  float lse[4], dl[4], dq[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    lse[i] = row < p.tq ? p.lse[static_cast<long long>(bh) * p.tq + row]
                        : -CUDART_INF_F;
    dl[i] = row < p.tq ? p.delta[static_cast<long long>(bh) * p.tq + row]
                       : 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) dq[i][j] = 0.0f;
  }
  if (nchunk == 1) {
    load_block<T, true>(qg, q0, p.tq, 0, d, sm.qd);
    load_block<T, true>(og, q0, p.tq, 0, d, sm.dod);
  }

  // the keys that some query of this tile can see (as in the forward)
  const int qmin = q0 + p.q_offset;
  const int qmax = min(q0 + kBQ, p.tq) - 1 + p.q_offset;
  int k_hi = p.tk;
  if (p.causal) {
    k_hi = min(k_hi, qmax + 1);
    if (p.prefix >= 0 && qmin < p.prefix)
      k_hi = max(k_hi, min(p.prefix, p.tk));
  }
  const int k_lo = p.window >= 0 ? max(0, qmin - p.window + 1) : 0;

  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
    for (int ch = 0; ch < nchunk; ++ch) {
      __syncthreads();                // the last readers are done
      if (nchunk > 1) {
        load_block<T, true>(qg, q0, p.tq, 64 * ch, d, sm.qd);
        load_block<T, true>(og, q0, p.tq, 64 * ch, d, sm.dod);
      }
      load_block<T, true>(kg, k0, p.tk, 64 * ch, d, sm.kd);
      load_block<T, true>(vg, k0, p.tk, 64 * ch, d, sm.vd);
      __syncthreads();
      qk_and_dov(sm.qd, sm.kd, sm.dod, sm.vd, ty, tx, s, dp);
    }
    probs_and_ds(p, q0, k0, ty, tx, lse, dl, s, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&sm.dst[(4 * tx + j) * kLD + 4 * ty]) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    load_block<T, false>(kg, k0, p.tk, col0, d, sm.kr);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(&sm.dst[j * kLD + 4 * ty]);
      const float4 e = *reinterpret_cast<const float4*>(&sm.kr[j * kLD + 4 * tx]);
      const float da[4] = {a.x, a.y, a.z, a.w};
      const float ka[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) dq[r][c] = fmaf(da[r], ka[c], dq[r][c]);
    }
  }
  T* dqg = static_cast<T*>(p.dq) + static_cast<long long>(bh) * p.tq * d;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * ty + r;
    if (row >= p.tq) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = col0 + 4 * tx + c;
      if (col < d)
        Vec<T>::store(dq[r][c], dqg + static_cast<long long>(row) * d + col);
    }
  }
}

template <typename T>
cudaError_t launch_bwd(const BwdParams& p, int batch, cudaStream_t stream) {
  const long long rows = static_cast<long long>(batch) * p.hq * p.tq;
  const int rows_per_cta = kThreads / 32;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>(
      (rows + rows_per_cta - 1) / rows_per_cta), kThreads, 0, stream>>>(
      static_cast<const T*>(p.o), static_cast<const T*>(p.dout), p.delta,
      rows, p.d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int ncb = (p.d + 63) / 64;
  const size_t smem_kv = sizeof(DkdvSmem);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T><<<dim3((p.tk + kBK - 1) / kBK, batch * p.hkv, ncb),
                             kThreads, smem_kv, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_q = sizeof(DqSmem);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T><<<dim3((p.tq + kBQ - 1) / kBQ, batch * p.hq, ncb),
                           kThreads, smem_q, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32 (bfloat16 is flash_attention_sm90.cu's).  Returns the
// launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int dtype, int batch,
                                   int hq,
                                   int hkv, int tq, int tk, int d, float scale,
                                   int causal, int window, int prefix,
                                   int use_softcap, float softcap,
                                   int q_offset, void* stream) {
  if (d <= 0 || d > 256 || d % 8 != 0 || hkv <= 0 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, o, lse, hq, hkv, tq, tk, d, scale, causal, window,
                 prefix, use_softcap, softcap, q_offset};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch<float>(p, batch, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The gradients (dq like q; dk, dv like k) from the saved forward (o, lse)
// and dout; delta is float32 scratch [batch, hq, tq].  dtype: 0 float32
// (bfloat16 is flash_attention_sm90.cu's).  Returns the first failing
// launch's cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, int dtype, int batch,
                                   int hq, int hkv, int tq, int tk, int d,
                                   float scale, int causal, int window,
                                   int prefix, int use_softcap, float softcap,
                                   int q_offset, void* stream) {
  if (d <= 0 || d > 256 || d % 8 != 0 || hkv <= 0 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdParams p{q, k, v, o, dout, lse, delta, dq, dk, dv, hq, hkv, tq,
                    tk, d, scale, causal, window, prefix, use_softcap,
                    softcap, q_offset};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_bwd<float>(p, batch, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

KINFO_NAMES(flash_attention, "flash_attention<float,1>",
            "flash_attention<float,2>", "flash_attention<float,3>",
            "flash_attention<float,4>", "flash_bwd_delta<float>",
            "flash_bwd_dkdv<float>", "flash_bwd_dq<float>")

// kernels.autotune.kernel_attributes.  which: 0-3 flash_attention_kernel
// <float, NJ> for NJ = 1..4 (dyn_smem < 0: its launch's, at D = 64 NJ),
// 4 flash_bwd_delta_kernel, 5 flash_bwd_dkdv_kernel, 6 flash_bwd_dq_kernel
// (dyn_smem < 0: their launches').  Every kernel has kThreads threads;
// the runtime's occupancy is asked at query_block (kThreads when <= 0).
extern "C" int flash_attention_kernel_info(int which, int block,
                                           int query_block, int dyn_smem,
                                           int* out) {
  (void)block;
  const int q = query_block > 0 ? query_block : kThreads;
  auto fwd_smem = [](int nj) {
    const int d = 64 * nj;
    return static_cast<int>(sizeof(float) * (2 * d * kLD + kBK * (64 * nj + 4)
                                              + kBK * kLD));
  };
  switch (which) {
    case 0:
      return kinfo::kernel_info(flash_attention_kernel<float, 1>, q,
                                dyn_smem >= 0 ? dyn_smem : fwd_smem(1), out);
    case 1:
      return kinfo::kernel_info(flash_attention_kernel<float, 2>, q,
                                dyn_smem >= 0 ? dyn_smem : fwd_smem(2), out);
    case 2:
      return kinfo::kernel_info(flash_attention_kernel<float, 3>, q,
                                dyn_smem >= 0 ? dyn_smem : fwd_smem(3), out);
    case 3:
      return kinfo::kernel_info(flash_attention_kernel<float, 4>, q,
                                dyn_smem >= 0 ? dyn_smem : fwd_smem(4), out);
    case 4:
      return kinfo::kernel_info(flash_bwd_delta_kernel<float>, q,
                                dyn_smem >= 0 ? dyn_smem : 0, out);
    case 5:
      return kinfo::kernel_info(
          flash_bwd_dkdv_kernel<float>, q,
          dyn_smem >= 0 ? dyn_smem : static_cast<int>(sizeof(DkdvSmem)), out);
    case 6:
      return kinfo::kernel_info(
          flash_bwd_dq_kernel<float>, q,
          dyn_smem >= 0 ? dyn_smem : static_cast<int>(sizeof(DqSmem)), out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
