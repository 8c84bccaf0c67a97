// Mamba2 SSD chunked scan on Hopper (sm_90a), on the CUDA cores.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan_pallas (body
// `_kernel`): the chunked state-space-dual form of the Mamba2 recurrence,
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
// 16 bytes at a time); the tiles are padded with zeros up to 64 and 128,
// which adds nothing to any sum.
//
// Design.  The TPU walks the chunks as the sequential minor axis of its
// grid, carrying the state in VMEM scratch.  Here one CTA of 256 threads
// takes one (batch, head) and loops over the chunks itself, carrying the
// state S [ds, dh] in registers (32 floats a thread) with a copy in shared
// memory that the next chunk's y_inter reads.  The chunk is this kernel's
// own, Q = 64 rows, whatever chunk the plain version uses: the function
// does not depend on it (up to rounding), and the last chunk of a t that
// 64 does not divide is masked by index (its rows past t load as x = B =
// C = dt = 0, so they decay nothing and add nothing).  At the training
// shape (b 2, h 80) that is 160 CTAs for 132 SMs.  C B^T is the same for
// every head of a chunk (g = 1), but a CTA that took a block of heads to
// share it would halve the grid below the SM count, so each head
// recomputes it (64 x 64 x 128 FMAs a chunk, a third of the CTA's work).
// Per chunk, with thread (ty, tx) of the 16 x 16 grid owning a 4 x 4
// register tile:
//   1. y_inter[i, d] = sum_s C[i, s] S[s, d] and G[i, j] = sum_s C[i, s]
//      B[j, s] in one loop over s (C and B held s-major in shared memory,
//      so each s is three 16-byte loads for 32 FMAs);
//   2. G[i, j] *= exp(cum_i - cum_j) dt_j for j <= i; the upper triangle
//      is set to 0 and never exponentiated (cum_i - cum_j > 0 there and
//      can overflow: inf * 0 would give NaN);
//   3. y[i, d] = exp(cum_i) y_inter + sum_{j <= i} G[i, j] x[j, d] + D x,
//      the j loop stopping at the thread's last row;
//   4. S[s, d] = exp(total) S + sum_j B[j, s] (w_j x[j, d]), w_j =
//      exp(total - cum_j) dt_j, on the thread's 8 x 4 state tile.
// cum is a warp's shuffle scan of the chunk's 64 values of dt A.
//
// What bounds it on this card: operations.  At the training shape (x
// [2, 2048, 80, 64], ds 128) the function moves 173 MB (0.052 ms at
// 3.35 TB/s) and, counting C B^T once a chunk and the triangles only,
// needs 12.1 GFLOP at Q = 64 (0.18 ms at the 67 TFLOP/s of float32 on the
// CUDA cores); this kernel does ~17 GFLOP of FMAs, as it recomputes C B^T
// per head and runs whole 4 x 4 tiles on the diagonal.  Tensor cores
// (TF32 or bf16 mma on the four products) and a head block sharing C B^T
// across a thread-block cluster are the next step.
//
// The build turns off multiply-add contraction (-fmad=false, _build.py);
// the products here are explicit fmaf, the rest rounds as written.

#include <cuda_runtime.h>

namespace {

constexpr int kQ = 64;                // rows of a chunk
constexpr int kDH = 64;               // largest head dim
constexpr int kDS = 128;              // largest state dim
constexpr int kThreads = 256;         // 16 x 16
constexpr int kLQ = kQ + 4;           // pitch of the s-major B, C and of G
constexpr int kLH = kDH + 4;          // pitch of x and S rows
constexpr int kLS = kDS + 4;          // pitch of the row-major B

struct Params {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  const float* D;    // nullptr: no skip term
  float* y;
  int t, h, dh, ds;
};

struct Smem {
  float xs[kQ * kLH];                 // x[j][d]
  float bt[kDS * kLQ];                // B[j][s] as [s][j]
  float ct[kDS * kLQ];                // C[i][s] as [s][i]
  float br[kQ * kLS];                 // B[j][s]
  float ss[kDS * kLH];                // S[s][d] entering the chunk
  float gt[kQ * kLQ];                 // G[i][j] as [j][i]
  float dtv[kQ];
  float cum[kQ];
  float ecum[kQ];                     // exp(cum_i)
  float w[kQ];                        // exp(total - cum_j) dt_j
};

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(Params p) {
  extern __shared__ float4 smem4[];
  Smem& sm = *reinterpret_cast<Smem*>(smem4);
  const int bh = blockIdx.x;
  const int b = bh / p.h;
  const int hd = bh - b * p.h;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const float a = p.A[hd];
  const float dskip = p.D ? p.D[hd] : 0.0f;

  float st[2][4][4];                  // S rows 4ty+r and 64+4ty+r, cols 4tx+c
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[u][r][c] = 0.0f;
  for (int i = tid; i < kDS * kLH; i += kThreads) sm.ss[i] = 0.0f;

  for (int c0 = 0; c0 < p.t; c0 += kQ) {
    const int rows = min(kQ, p.t - c0);
    __syncthreads();                  // the last chunk's readers are done
    // x rows: [Q][DH], zero past the chunk's rows and past dh
    for (int i = tid; i < kQ * (kDH / 4); i += kThreads) {
      const int j = i / (kDH / 4);
      const int d = (i % (kDH / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < rows && d < p.dh)
        v = *reinterpret_cast<const float4*>(
            p.x + ((static_cast<long long>(b) * p.t + c0 + j) * p.h + hd) *
                      p.dh + d);
      *reinterpret_cast<float4*>(&sm.xs[j * kLH + d]) = v;
    }
    // B and C rows: s-major copies of both, and B row-major; consecutive
    // threads take consecutive rows, so the s-major stores hit distinct
    // banks
    for (int i = tid; i < kQ * (kDS / 4); i += kThreads) {
      const int j = i % kQ;
      const int s = (i / kQ) * 4;
      float4 vb = make_float4(0.f, 0.f, 0.f, 0.f), vc = vb;
      if (j < rows && s < p.ds) {
        const long long off =
            (static_cast<long long>(b) * p.t + c0 + j) * p.ds + s;
        vb = *reinterpret_cast<const float4*>(p.B + off);
        vc = *reinterpret_cast<const float4*>(p.C + off);
      }
      sm.bt[(s + 0) * kLQ + j] = vb.x;
      sm.bt[(s + 1) * kLQ + j] = vb.y;
      sm.bt[(s + 2) * kLQ + j] = vb.z;
      sm.bt[(s + 3) * kLQ + j] = vb.w;
      sm.ct[(s + 0) * kLQ + j] = vc.x;
      sm.ct[(s + 1) * kLQ + j] = vc.y;
      sm.ct[(s + 2) * kLQ + j] = vc.z;
      sm.ct[(s + 3) * kLQ + j] = vc.w;
      *reinterpret_cast<float4*>(&sm.br[j * kLS + s]) = vb;
    }
    if (tid < kQ)
      sm.dtv[tid] = tid < rows
          ? p.dt[(static_cast<long long>(b) * p.t + c0 + tid) * p.h + hd]
          : 0.0f;
    __syncthreads();
    if (tid < 32) {                   // warp 0: the within-chunk cumsum
      const float l0 = sm.dtv[2 * tid] * a;
      const float l1 = sm.dtv[2 * tid + 1] * a;
      const float pair = l0 + l1;
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      const float excl = incl - pair;
      const float c_0 = excl + l0;
      const float c_1 = incl;
      const float total = __shfl_sync(0xffffffffu, incl, 31);
      sm.cum[2 * tid] = c_0;
      sm.cum[2 * tid + 1] = c_1;
      sm.ecum[2 * tid] = expf(c_0);
      sm.ecum[2 * tid + 1] = expf(c_1);
      sm.w[2 * tid] = expf(total - c_0) * sm.dtv[2 * tid];
      sm.w[2 * tid + 1] = expf(total - c_1) * sm.dtv[2 * tid + 1];
    }
    __syncthreads();

    // 1. y_inter (C S) and G (C B^T), rows i = 4ty.., cols 4tx..
    float yi[4][4], g[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) yi[r][c] = g[r][c] = 0.0f;
#pragma unroll 4
    for (int s = 0; s < kDS; ++s) {
      const float4 cv = *reinterpret_cast<const float4*>(&sm.ct[s * kLQ + 4 * ty]);
      const float4 sv = *reinterpret_cast<const float4*>(&sm.ss[s * kLH + 4 * tx]);
      const float4 bv = *reinterpret_cast<const float4*>(&sm.bt[s * kLQ + 4 * tx]);
      const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
      const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
      const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          yi[r][c] = fmaf(ca[r], sa[c], yi[r][c]);
          g[r][c] = fmaf(ca[r], ba[c], g[r][c]);
        }
    }
    // 2. the decay and dt_j on the lower triangle; G^T to shared memory
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * ty + r;
      const float ci = sm.cum[i];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = 4 * tx + c;
        g[r][c] = j <= i ? g[r][c] * expf(ci - sm.cum[j]) * sm.dtv[j] : 0.0f;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(&sm.gt[(4 * tx + c) * kLQ + 4 * ty]) =
          make_float4(g[0][c], g[1][c], g[2][c], g[3][c]);
    __syncthreads();

    // 3. y = exp(cum_i) y_inter + G x + D x, rows i = 4ty.., cols d = 4tx..
    float yo[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) yo[r][c] = 0.0f;
    const int jmax = 4 * ty + 4;      // G[i][j] = 0 for j > i
    for (int j = 0; j < jmax; ++j) {
      const float4 gv = *reinterpret_cast<const float4*>(&sm.gt[j * kLQ + 4 * ty]);
      const float4 xv = *reinterpret_cast<const float4*>(&sm.xs[j * kLH + 4 * tx]);
      const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) yo[r][c] = fmaf(ga[r], xa[c], yo[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * ty + r;
      if (i >= rows) continue;
      const float e = sm.ecum[i];
      float out[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        out[c] = (yo[r][c] + e * yi[r][c]) + sm.xs[i * kLH + 4 * tx + c] * dskip;
      const int d = 4 * tx;
      if (d < p.dh)
        *reinterpret_cast<float4*>(
            p.y + ((static_cast<long long>(b) * p.t + c0 + i) * p.h + hd) *
                      p.dh + d) = make_float4(out[0], out[1], out[2], out[3]);
    }

    // 4. the state: rows s = 4ty.. and 64 + 4ty.., cols d = 4tx..
    float dsu[2][4][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) dsu[u][r][c] = 0.0f;
#pragma unroll 2
    for (int j = 0; j < kQ; ++j) {
      const float wj = sm.w[j];
      const float4 xv = *reinterpret_cast<const float4*>(&sm.xs[j * kLH + 4 * tx]);
      const float xa[4] = {xv.x * wj, xv.y * wj, xv.z * wj, xv.w * wj};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float4 bv = *reinterpret_cast<const float4*>(
            &sm.br[j * kLS + 64 * u + 4 * ty]);
        const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            dsu[u][r][c] = fmaf(ba[r], xa[c], dsu[u][r][c]);
      }
    }
    const float etot = expf(sm.cum[kQ - 1]);
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          st[u][r][c] = st[u][r][c] * etot + dsu[u][r][c];
        // every reader of the old S (step 1) passed the barrier above
        *reinterpret_cast<float4*>(&sm.ss[(64 * u + 4 * ty + r) * kLH + 4 * tx]) =
            make_float4(st[u][r][0], st[u][r][1], st[u][r][2], st[u][r][3]);
      }
  }
}

}  // namespace

// Returns the launch's cudaError_t.  D may be null.
extern "C" int ssd_scan_fwd(const float* x, const float* dt, const float* A,
                            const float* B, const float* C, const float* D,
                            float* y, int batch, int t, int h, int dh, int ds,
                            void* stream) {
  if (dh <= 0 || dh > kDH || dh % 4 || ds <= 0 || ds > kDS || ds % 4 ||
      t <= 0 || h <= 0 || batch <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{x, dt, A, B, C, D, y, t, h, dh, ds};
  ssd_scan_kernel<<<batch * h, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
