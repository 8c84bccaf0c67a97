// Flash attention forward on Hopper (sm_90a), on the CUDA cores.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (body `_kernel`): softmax(q k^T * scale) v with
// causal, sliding-window and prefix-LM masks, logit soft-capping, a query
// offset, and grouped-query attention, in one pass that keeps the logits
// out of device memory (the online softmax: a running row max m, row sum l
// and output accumulator acc, rescaled as each key tile arrives).
//
// Layout: q [B, Hq, Tq, D], k and v [B, Hkv, Tk, D], o like q, all dense
// row-major (the wrapper makes them contiguous), float32 or bfloat16; the
// arithmetic is float32 throughout and o is rounded to q's type at the end.
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
// (mma.sync or wgmma on bf16 tiles) and TMA-fed K/V are the next step.
//
// The build turns off multiply-add contraction (-fmad=false, _build.py);
// the dot products here are explicit fmaf, the rest rounds as written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(float x, __nv_bfloat16* p) {
    *p = __float2bfloat16(x);         // round to nearest even, as .to()
  }
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

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int batch, int hq,
                                   int hkv, int tq, int tk, int d, float scale,
                                   int causal, int window, int prefix,
                                   int use_softcap, float softcap,
                                   int q_offset, void* stream) {
  if (d <= 0 || d > 256 || d % 8 != 0 || hkv <= 0 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, o, hq, hkv, tq, tk, d, scale, causal, window,
                 prefix, use_softcap, softcap, q_offset};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch<float>(p, batch, s));
  if (dtype == 1)
    return static_cast<int>(dispatch<__nv_bfloat16>(p, batch, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
