// ELL spike propagation on Hopper (sm_90a): GeNN's sparse spike delivery.
//
// Replaces the TPU kernels repro/kernels/ell_spmv.py::ell_spmv_pallas
// (body `_kernel`) and ::ell_spmv_delay_pallas (body `_delay_kernel`):
//
//   out[b, j]    += spikes[b, i] * g[i, k]   for valid (i, k) with post_ind[i, k] == j
//   out[b, d, j] += spikes[b, i] * g[i, k]   ... and delay[i, k] == d   (delay variant)
//
// The TPU form builds a one-hot matrix per (post-block, pre-block) tile and
// contracts it on the MXU, because a TPU core has neither per-lane scatter
// nor atomics.  It touches every slot of every row, spiking or not.  The
// card has both, so this is GeNN's own form instead: read only the rows
// that spike, and scatter their valid slots with atomicAdd.
//
// What bounds it on this card.  By the bytes: memory.  Per spiking row it
// reads 9 bytes a slot (13 with a delay) and does one add per valid slot
// and spiking member, far below the ~20 flop/byte the card needs before
// arithmetic matters; at the main path's ~1% activity a launch moves ~6
// MB, which the card reads in ~2 us.  In fact: the atomics.  Every valid
// slot of a spiking row is one atomicAdd to a random post neuron (with K
// >= 1000 and ~1e5 targets they rarely collide, and resolve in L2), and
// the card retires them at a rate of its own: chip_smoke.py's phase 2
// measures ~43-84 G adds/s on an H100 (0.62 M adds in ~14 us at B = 1 and
// 1% spiking, 5.2 M in ~80 us at B = 8, 64 M in ~0.95 ms at 100%), so the
// adds, not the bytes, set the time of this kernel.  What the design
// controls is the rest: how many dependent trips to memory a row takes
// before its adds can issue, and how much of the card waits on them.
//
// ell_spmv_live_kernel (the delay-free form) answers that:
//
//   * A CTA of 256 threads covers 256 presynaptic rows and up to 8 batch
//     members (grid: rows on x, groups of 8 members on y).  Each thread
//     first reads its row's spike for every member of the group, keeps
//     the values in shared memory, and the CTA builds its list of live rows
//     (a row spiking for any member) with __ballot_sync and a prefix sum
//     over the warps: the paper's event-driven delivery.  The grid is one
//     wave at the main path's sizes (313 CTAs for 80,000 rows at B <= 8).
//   * Then all 256 threads walk the live rows' slots together, 4 slots an
//     item (16-byte loads of post_ind and g, 4 bytes of valid), 4 items a
//     thread, and issue every load of their items before their first
//     atomic: a row costs about one round trip to memory, not one per 32
//     slots as with a warp per row (the PR 11 form).
//   * A row's post_ind, valid and (when shared, g_batch_stride == 0) g are
//     read once for all members of the group; then one atomicAdd per valid
//     slot and spiking member.  Per-member weights are read per member.
//   * Spikes may be float32 or bool bytes (the simulator's spikes as they
//     are: a bool spike is 1.0).
//   * The atomics add in float64 (out is a float64 buffer that the wrapper
//     rounds to float32 once).  Float32 atomics land in an order of the
//     card's choosing, so two runs, or the kernel and the plain version,
//     round a neuron's input differently, and in a network that sits on a
//     knife edge one ulp decides a spike: on the main path, the raster of
//     one branch differs from the other's on 0.3% of 50 steps' neuron-steps
//     (experiments/raster_agreement.py).  A float64 sum of float32
//     products is exact while they span fewer than 2^29 between the
//     smallest one's ulp and the largest partial sum, so the result is the
//     correctly rounded sum whatever the order: the same on every run, and
//     bit-equal to the plain version, which sums in float64 too.
//   * kVec = 1 is the same walk one slot an item, for rows whose K is no
//     multiple of 4 or operands not 16-byte aligned.
//
// ell_spmv_delay_live_kernel is the same walk for the delay variant: 13
// bytes a slot (16-byte loads of post_ind, g and delay, 4 of valid, all
// issued before the first atomic), one float64 atomicAdd per valid slot and
// spiking member at (delay, post, b), 64-bit offsets.  Its target, a
// float64 scratch [n_slots, n_post, B], is n_slots times the delay-free
// one: 13.4 MB a member at 21 slots and 80,000 posts.  The members of a
// cell lie side by side, so members that spike together add into one
// 32-byte sector, not B sectors 13.4 MB apart.  At B = 8 the scratch is
// 107.5 MB, past the 50 MB L2, and the adds go to device memory: a
// launch takes about twice a float32 scatter's time.  Scattering and
// folding 2 members a launch keeps the scratch in L2 and cut the sweep's
// device time a step by 15%, but its 6 more launches a step cost more
// host time than that on the host-bound sweep (PERF.md), so one launch
// takes the batch.
// The simulator keeps the scratch zeroed between steps, so the path needs
// no zero fill a step.
//
// delay_ring_fold_kernel folds the scratch into the dendritic ring
// [B, S, n_post] in one pass, in place of the six eager ops that did it
// (scale, roll, add, read the cursor's slot, clear it):
//
//   new_ring[b, r, j] = ring[b, r, j]
//                       + f32(sign * gscale_b) * f32(acc[(r - cur) mod S, j, b])
//   inj[b] = new_ring[b, cur];  new_ring[b, cur] = 0;  acc = 0
//
// with exactly the roundings of those ops (IEEE products and sums, no
// contraction), so it is bit-equal to its plain version.  It reads the
// ring and the scratch once and writes the new ring, the zeros and inj:
// memory-bound, ~24 bytes an element.  A thread takes 4 posts of one ring
// row and one member, the members of a post on neighbouring threads, so a
// warp's scratch accesses are contiguous and its ring accesses 16 bytes a
// thread.
//
// Out-of-range targets (post_ind >= n_post, delay >= n_slots) are skipped
// rather than written: the containers are checked when they are built, and
// this guard only keeps a bad index from corrupting memory.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

// -- the scatter kernels -----------------------------------------------------

constexpr int kRows = 256;       // presynaptic rows (= threads) of a CTA
constexpr int kMembers = 8;      // batch members of a CTA
constexpr int kUnroll = 4;       // items a thread loads before its atomics
constexpr int kWarps = kRows / 32;

// The CTA's static shared memory: kernels.ell_spmv.launch_plan's
// "smem_bytes" must equal its size (checked at launch).
struct LiveSmem {
  float spike[kMembers][kRows];  // the group's spike values, by local row
  uint16_t rows[kRows];          // the live local rows, in order
  int warp_live[kWarps];         // live rows per warp
};

__device__ __forceinline__ float spike_value(float s) { return s; }
__device__ __forceinline__ float spike_value(uint8_t s) {
  return s ? 1.0f : 0.0f;
}

// kVec slots of one row: their targets, weights and valid bytes
template <int kVec> struct Slots;
template <> struct Slots<4> {
  int4 j;
  float4 w;
  uint32_t v;
  __device__ __forceinline__ void load(const int32_t* post_ind,
                                       const float* g, const uint8_t* valid,
                                       long long p, bool with_g) {
    j = __ldg(reinterpret_cast<const int4*>(post_ind + p));
    v = __ldg(reinterpret_cast<const unsigned int*>(valid + p));
    if (with_g) w = __ldg(reinterpret_cast<const float4*>(g + p));
  }
  __device__ __forceinline__ void load_g(const float* g, long long p) {
    w = __ldg(reinterpret_cast<const float4*>(g + p));
  }
  __device__ __forceinline__ int target(int e) const {
    return e == 0 ? j.x : e == 1 ? j.y : e == 2 ? j.z : j.w;
  }
  __device__ __forceinline__ float weight(int e) const {
    return e == 0 ? w.x : e == 1 ? w.y : e == 2 ? w.z : w.w;
  }
  __device__ __forceinline__ bool is_valid(int e) const {
    return (v >> (8 * e)) & 0xffu;
  }
};
template <> struct Slots<1> {
  int j;
  float w;
  uint8_t v;
  __device__ __forceinline__ void load(const int32_t* post_ind,
                                       const float* g, const uint8_t* valid,
                                       long long p, bool with_g) {
    j = __ldg(post_ind + p);
    v = __ldg(valid + p);
    if (with_g) w = __ldg(g + p);
  }
  __device__ __forceinline__ void load_g(const float* g, long long p) {
    w = __ldg(g + p);
  }
  __device__ __forceinline__ int target(int) const { return j; }
  __device__ __forceinline__ float weight(int) const { return w; }
  __device__ __forceinline__ bool is_valid(int) const { return v != 0; }
};

// kVec slots of one row: their delays (the delay variant only)
template <int kVec> struct Delays;
template <> struct Delays<4> {
  int4 d;
  __device__ __forceinline__ void load(const int32_t* delay, long long p) {
    d = __ldg(reinterpret_cast<const int4*>(delay + p));
  }
  __device__ __forceinline__ int slot(int e) const {
    return e == 0 ? d.x : e == 1 ? d.y : e == 2 ? d.z : d.w;
  }
};
template <> struct Delays<1> {
  int d;
  __device__ __forceinline__ void load(const int32_t* delay, long long p) {
    d = __ldg(delay + p);
  }
  __device__ __forceinline__ int slot(int) const { return d; }
};

// The walk of both kernels: out[b, d, j] += spike[b, i] * g[i, k] for the
// CTA's rows (n_slots = 1 and no delay without kDelay).
template <typename S, int kVec, bool kDelay>
__device__ __forceinline__ void live_scatter(
    LiveSmem& sm, const float* __restrict__ g, long long g_batch_stride,
    const int32_t* __restrict__ post_ind, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ delay, const S* __restrict__ spikes,
    double* __restrict__ out, int batch, int n_pre, int k, int n_post,
    int n_slots) {
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int row0 = blockIdx.x * kRows;
  const int b0 = blockIdx.y * kMembers;
  const int members = min(kMembers, batch - b0);

  // 1. which of the CTA's rows spike, for any member of the group
  const int row = row0 + t;
  bool live = false;
#pragma unroll
  for (int m = 0; m < kMembers; ++m) {
    float s = 0.0f;
    if (m < members && row < n_pre)
      s = spike_value(spikes[static_cast<long long>(b0 + m) * n_pre + row]);
    sm.spike[m][t] = s;
    live |= s != 0.0f;
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if (lane == 0) sm.warp_live[warp] = __popc(ballot);
  __syncthreads();
  int offset = 0, n_live = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = sm.warp_live[w];
    offset += w < warp ? c : 0;
    n_live += c;
  }
  if (live)
    sm.rows[offset + __popc(ballot & ((1u << lane) - 1u))] =
        static_cast<uint16_t>(t);
  __syncthreads();
  if (n_live == 0) return;                 // uniform across the CTA

  // 2. the live rows' slots, kVec to an item, all threads together;
  //    n_live * chunks < 2^31 (launch_plan bounds k)
  const bool shared_g = g_batch_stride == 0;
  const unsigned chunks = static_cast<unsigned>(k / kVec);
  const unsigned items = static_cast<unsigned>(n_live) * chunks;
  for (unsigned base = t; base < items; base += kRows * kUnroll) {
    Slots<kVec> sl[kUnroll];
    Delays<kVec> dl[kUnroll];
    int rl[kUnroll];
    long long p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned it = base + u * kRows;
      rl[u] = -1;
      if (it < items) {
        rl[u] = sm.rows[it / chunks];
        p[u] = static_cast<long long>(row0 + rl[u]) * k +
               static_cast<long long>(it % chunks) * kVec;
        sl[u].load(post_ind, g, valid, p[u], shared_g);
        if constexpr (kDelay) dl[u].load(delay, p[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (rl[u] < 0) continue;
      for (int m = 0; m < members; ++m) {
        const float s = sm.spike[m][rl[u]];
        if (s == 0.0f) continue;
        if (!shared_g) sl[u].load_g(g + (b0 + m) * g_batch_stride, p[u]);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int j = sl[u].target(e);
          if (!sl[u].is_valid(e) ||
              static_cast<unsigned>(j) >= static_cast<unsigned>(n_post))
            continue;
          long long at;
          if constexpr (kDelay) {
            // [n_slots, n_post, batch]: a cell's members side by side
            const int d = dl[u].slot(e);
            if (static_cast<unsigned>(d) >= static_cast<unsigned>(n_slots))
              continue;
            at = (static_cast<long long>(d) * n_post + j) * batch + b0 + m;
          } else {
            at = static_cast<long long>(b0 + m) * n_post + j;
          }
          atomicAdd(out + at, static_cast<double>(s * sl[u].weight(e)));
        }
      }
    }
  }
}

template <typename S, int kVec>
__global__ void __launch_bounds__(kRows)
ell_spmv_live_kernel(const float* __restrict__ g, long long g_batch_stride,
                     const int32_t* __restrict__ post_ind,
                     const uint8_t* __restrict__ valid,
                     const S* __restrict__ spikes, double* __restrict__ out,
                     int batch, int n_pre, int k, int n_post) {
  __shared__ LiveSmem sm;
  live_scatter<S, kVec, false>(sm, g, g_batch_stride, post_ind, valid,
                               nullptr, spikes, out, batch, n_pre, k, n_post,
                               1);
}

template <typename S, int kVec>
__global__ void __launch_bounds__(kRows)
ell_spmv_delay_live_kernel(const float* __restrict__ g,
                           long long g_batch_stride,
                           const int32_t* __restrict__ post_ind,
                           const uint8_t* __restrict__ valid,
                           const int32_t* __restrict__ delay,
                           const S* __restrict__ spikes,
                           double* __restrict__ out, int batch, int n_pre,
                           int k, int n_post, int n_slots) {
  __shared__ LiveSmem sm;
  live_scatter<S, kVec, true>(sm, g, g_batch_stride, post_ind, valid, delay,
                              spikes, out, batch, n_pre, k, n_post, n_slots);
}

// One launch of either scatter (the delay variant when delay is given).
template <typename S>
int launch_live(const float* g, long long g_batch_stride,
                const int32_t* post_ind, const uint8_t* valid,
                const int32_t* delay, const S* spikes, double* out,
                int batch, int n_pre, int k, int n_post, int n_slots,
                int vec, cudaStream_t stream) {
  dim3 grid((n_pre + kRows - 1) / kRows, (batch + kMembers - 1) / kMembers);
  if (delay == nullptr && vec == 4)
    ell_spmv_live_kernel<S, 4><<<grid, kRows, 0, stream>>>(
        g, g_batch_stride, post_ind, valid, spikes, out, batch, n_pre, k,
        n_post);
  else if (delay == nullptr)
    ell_spmv_live_kernel<S, 1><<<grid, kRows, 0, stream>>>(
        g, g_batch_stride, post_ind, valid, spikes, out, batch, n_pre, k,
        n_post);
  else if (vec == 4)
    ell_spmv_delay_live_kernel<S, 4><<<grid, kRows, 0, stream>>>(
        g, g_batch_stride, post_ind, valid, delay, spikes, out, batch, n_pre,
        k, n_post, n_slots);
  else
    ell_spmv_delay_live_kernel<S, 1><<<grid, kRows, 0, stream>>>(
        g, g_batch_stride, post_ind, valid, delay, spikes, out, batch, n_pre,
        k, n_post, n_slots);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Both scatters' plan check and launch.
int scatter(const float* g, long long g_batch_stride, const int32_t* post_ind,
            const uint8_t* valid, const int32_t* delay, const void* spikes,
            int spikes_bool, double* out, int batch, int n_pre, int k,
            int n_post, int n_slots, int vec, int smem_bytes, void* stream) {
  if (smem_bytes != static_cast<int>(sizeof(LiveSmem)) ||
      (vec != 1 && vec != 4) ||
      (vec == 4 && (k % 4 != 0 || !aligned(post_ind, 16) ||
                    !aligned(g, 16) || !aligned(valid, 4) ||
                    (delay != nullptr && !aligned(delay, 16)))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || n_pre == 0 || k == 0 || n_slots == 0 || n_post == 0)
    return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (spikes_bool)
    return launch_live(g, g_batch_stride, post_ind, valid, delay,
                       static_cast<const uint8_t*>(spikes), out, batch,
                       n_pre, k, n_post, n_slots, vec, s);
  return launch_live(g, g_batch_stride, post_ind, valid, delay,
                     static_cast<const float*>(spikes), out, batch, n_pre, k,
                     n_post, n_slots, vec, s);
}

// -- the ring fold ------------------------------------------------------------

constexpr int kFoldThreads = 256;

// grid: items (kVec posts x one member, members fastest) on x, ring rows r
// on y.  Ring row r takes scratch slot (r - cur) mod S, so each scratch
// element is read, and zeroed, by exactly one thread.  With the members
// on the fast axis a warp reads and zeroes contiguous runs of the
// scratch (its cells' members side by side) and reads and writes kVec
// posts of B ring rows.
template <int kVec>
__global__ void __launch_bounds__(kFoldThreads)
delay_ring_fold_kernel(const float* __restrict__ ring,
                       double* __restrict__ acc, float* __restrict__ new_ring,
                       float* __restrict__ inj,
                       const float* __restrict__ gscale, float scale,
                       float sign, int batch, int n_slots, int n_post,
                       int cur) {
  const long long item =
      static_cast<long long>(blockIdx.x) * kFoldThreads + threadIdx.x;
  const long long j = item / batch * kVec;
  if (j >= n_post) return;
  const int b = static_cast<int>(item % batch);
  const int r = blockIdx.y;
  const int src = r >= cur ? r - cur : r - cur + n_slots;
  // sign * gscale, rounded to float32 as PyTorch rounds it
  const float sc = gscale != nullptr ? __fmul_rn(sign, gscale[b]) : scale;
  const long long at = (static_cast<long long>(b) * n_slots + r) * n_post + j;
  double* a = acc + (static_cast<long long>(src) * n_post + j) * batch + b;
  float v[kVec];
  double av[kVec];
  if constexpr (kVec == 4) {
    const float4 r4 = __ldg(reinterpret_cast<const float4*>(ring + at));
    v[0] = r4.x; v[1] = r4.y; v[2] = r4.z; v[3] = r4.w;
  } else {
    v[0] = __ldg(ring + at);
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) av[e] = a[e * batch];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    a[e * batch] = 0.0;                     // leave the scratch zeroed
    v[e] = __fadd_rn(v[e], __fmul_rn(sc, __double2float_rn(av[e])));
  }
  if (r == cur) {                            // uniform across the CTA
    float* out = inj + static_cast<long long>(b) * n_post + j;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      out[e] = v[e];
      v[e] = 0.0f;
    }
  }
  if constexpr (kVec == 4)
    *reinterpret_cast<float4*>(new_ring + at) =
        make_float4(v[0], v[1], v[2], v[3]);
  else
    new_ring[at] = v[0];
}

}  // namespace

extern "C" {

// The shared memory of a scatter CTA (launch_plan's "smem_bytes").
int ell_spmv_smem_bytes() { return static_cast<int>(sizeof(LiveSmem)); }

// out: [batch, n_post] float64, zeroed by the caller.  spikes: [batch,
// n_pre], float32 (spikes_bool = 0) or bool bytes (1).  vec and smem_bytes
// come from kernels.ell_spmv.launch_plan: vec 4 needs k % 4 == 0, post_ind
// and g 16-byte aligned and valid 4-byte aligned; a plan that disagrees
// with this source is refused.
int ell_spmv_f32(const float* g, long long g_batch_stride,
                 const int32_t* post_ind, const uint8_t* valid,
                 const void* spikes, int spikes_bool, double* out, int batch,
                 int n_pre, int k, int n_post, int vec, int smem_bytes,
                 void* stream) {
  return scatter(g, g_batch_stride, post_ind, valid, nullptr, spikes,
                 spikes_bool, out, batch, n_pre, k, n_post, 1, vec,
                 smem_bytes, stream);
}

// The delay variant: adds into out [n_slots, n_post, batch] float64 (the
// caller zeroes it, or keeps it zeroed between calls).  As ell_spmv_f32,
// and vec 4 needs delay 16-byte aligned too.
int ell_spmv_delay_f32(const float* g, long long g_batch_stride,
                       const int32_t* post_ind, const uint8_t* valid,
                       const int32_t* delay, const void* spikes,
                       int spikes_bool, double* out, int batch, int n_pre,
                       int k, int n_post, int n_slots, int vec,
                       int smem_bytes, void* stream) {
  if (delay == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return scatter(g, g_batch_stride, post_ind, valid, delay, spikes,
                 spikes_bool, out, batch, n_pre, k, n_post, n_slots, vec,
                 smem_bytes, stream);
}

// ring [batch, n_slots, n_post] float32 (read), acc [n_slots, n_post,
// batch] float64 (read, then zeroed), new_ring [batch, n_slots, n_post]
// float32 and inj [batch, n_post] float32 (written).  gscale: [batch]
// float32 on the card, or null and then scale (= sign * gscale, rounded to
// float32) for every member.  vec comes from kernels.delay_ring.launch_plan:
// vec 4 needs n_post % 4 == 0 and all four arrays 16-byte aligned.
int delay_ring_fold_f32(const float* ring, double* acc, float* new_ring,
                        float* inj, const float* gscale, float scale,
                        float sign, int batch, int n_slots, int n_post,
                        int cur, int vec, void* stream) {
  if ((vec != 1 && vec != 4) ||
      (vec == 4 && (n_post % 4 != 0 || !aligned(ring, 16) ||
                    !aligned(acc, 16) || !aligned(new_ring, 16) ||
                    !aligned(inj, 16))) ||
      batch < 0 || n_post < 0 || n_slots <= 0 || n_slots > 65535 ||
      cur < 0 || cur >= n_slots)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || n_post == 0) return cudaSuccess;
  const long long items = (static_cast<long long>(n_post) / vec) * batch;
  const long long ctas = (items + kFoldThreads - 1) / kFoldThreads;
  if (ctas > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(ctas), n_slots);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    delay_ring_fold_kernel<4><<<grid, kFoldThreads, 0, s>>>(
        ring, acc, new_ring, inj, gscale, scale, sign, batch, n_slots,
        n_post, cur);
  else
    delay_ring_fold_kernel<1><<<grid, kFoldThreads, 0, s>>>(
        ring, acc, new_ring, inj, gscale, scale, sign, batch, n_slots,
        n_post, cur);
  return static_cast<int>(cudaGetLastError());
}

const char* ell_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
