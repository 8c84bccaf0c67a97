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
//   * A CTA of kRows threads covers kRows presynaptic rows and up to 8
//     batch members (grid: rows on x, groups of 8 members on y).  kRows is
//     128, 256 or 512, one instantiation each, chosen on the host by the
//     occupancy model (kernels.autotune.choose_block_spmv) from the
//     registers the runtime reports for each.  Each thread
//     first reads its row's spike for every member of the group, keeps
//     the values in shared memory, and the CTA builds its list of live rows
//     (a row spiking for any member) with __ballot_sync and a prefix sum
//     over the warps: the paper's event-driven delivery.  The grid is one
//     wave at the main path's sizes (625 CTAs of 128 rows, 7 resident an
//     SM by their registers, for 80,000 rows at B <= 8).
//   * Then all kRows threads walk the live rows' slots together, 4 slots an
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
//                       + f32(sign * gscale_b) * f32(acc[(r - cur_b) mod S, j, b])
//   inj[b] = new_ring[b, cur_b];  new_ring[b, cur_b] = 0;  acc = 0
//   new_cursor[b] = (cur_b + 1) mod S
//
// Each member has its own cursor cur_b (a served stream admitted at
// another step than its neighbours sits elsewhere in its ring; a run or a
// sweep keeps them all equal).  The cursors are read from device memory
// and the advanced ones written to other words, as the JAX package keeps
// them (an int32 a stream in the state): a CUDA graph that captured the
// step reads each replay's own cursors.  The fold rounds exactly as
// those ops do (IEEE products and sums, no contraction), so it is
// bit-equal to its plain version.  It reads the
// ring and the scratch once and writes the new ring, the zeros and inj:
// memory-bound, ~24 bytes an element.  A thread takes 4 posts of one ring
// row and one member, the members of a post on neighbouring threads, so a
// warp's scratch accesses are contiguous and its ring accesses 16 bytes a
// thread.  That holds while the members' cursors are equal (a run, a
// sweep): with a cursor a member, member b's ring row r reads scratch slot
// (r - cur_b) mod S, so a warp's members read B different slots, 8 bytes
// each, and the fold costs several times more (served streams; PERF.md).
// Each thread needs its member's cursor before its scratch address: lane
// l < B loads member l's first thing, overlapping the 64-bit index
// arithmetic, and a shuffle hands it on (a load after that arithmetic,
// the first form, cost +70% at B = 1).
//
// Out-of-range targets (post_ind >= n_post, delay >= n_slots) are skipped
// rather than written: the containers are checked when they are built, and
// this guard only keeps a bad index from corrupting memory.

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "kernel_info.cuh"

namespace {

// -- the scatter kernels -----------------------------------------------------

constexpr int kMembers = 8;      // batch members of a CTA
constexpr int kUnroll = 4;       // items a thread loads before its atomics

// The rows (= threads) a scatter CTA may cover, one instantiation each
// (kernels.autotune.SPMV_ROWS): with_rows(rows, f) calls
// f(std::integral_constant<int, R>{}) for R == rows, and refuses any other.
template <typename F>
cudaError_t with_rows(int rows, F&& f) {
  switch (rows) {
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    case 512: return f(std::integral_constant<int, 512>{});
    default: return cudaErrorInvalidValue;
  }
}

// The CTA's static shared memory: kernels.ell_spmv.launch_plan's
// "smem_bytes" must equal its size (checked at launch).
template <int kRows>
struct LiveSmem {
  float spike[kMembers][kRows];  // the group's spike values, by local row
  uint16_t rows[kRows];          // the live local rows, in order
  int warp_live[kRows / 32];     // live rows per warp
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
template <int kRows, typename S, int kVec, bool kDelay>
__device__ __forceinline__ void live_scatter(
    LiveSmem<kRows>& sm, const float* __restrict__ g, long long g_batch_stride,
    const int32_t* __restrict__ post_ind, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ delay, const S* __restrict__ spikes,
    double* __restrict__ out, int batch, int n_pre, int k, int n_post,
    int n_slots) {
  constexpr int kWarps = kRows / 32;
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

template <int kRows, typename S, int kVec>
__global__ void __launch_bounds__(kRows)
ell_spmv_live_kernel(const float* __restrict__ g, long long g_batch_stride,
                     const int32_t* __restrict__ post_ind,
                     const uint8_t* __restrict__ valid,
                     const S* __restrict__ spikes, double* __restrict__ out,
                     int batch, int n_pre, int k, int n_post) {
  __shared__ LiveSmem<kRows> sm;
  live_scatter<kRows, S, kVec, false>(sm, g, g_batch_stride, post_ind, valid,
                                      nullptr, spikes, out, batch, n_pre, k,
                                      n_post, 1);
}

template <int kRows, typename S, int kVec>
__global__ void __launch_bounds__(kRows)
ell_spmv_delay_live_kernel(const float* __restrict__ g,
                           long long g_batch_stride,
                           const int32_t* __restrict__ post_ind,
                           const uint8_t* __restrict__ valid,
                           const int32_t* __restrict__ delay,
                           const S* __restrict__ spikes,
                           double* __restrict__ out, int batch, int n_pre,
                           int k, int n_post, int n_slots) {
  __shared__ LiveSmem<kRows> sm;
  live_scatter<kRows, S, kVec, true>(sm, g, g_batch_stride, post_ind, valid,
                                     delay, spikes, out, batch, n_pre, k,
                                     n_post, n_slots);
}

// One launch of either scatter (the delay variant when delay is given).
template <int kRows, typename S>
cudaError_t launch_live(const float* g, long long g_batch_stride,
                const int32_t* post_ind, const uint8_t* valid,
                const int32_t* delay, const S* spikes, double* out,
                int batch, int n_pre, int k, int n_post, int n_slots,
                int vec, cudaStream_t stream) {
  dim3 grid((n_pre + kRows - 1) / kRows, (batch + kMembers - 1) / kMembers);
  if (delay == nullptr && vec == 4)
    ell_spmv_live_kernel<kRows, S, 4><<<grid, kRows, 0, stream>>>(
        g, g_batch_stride, post_ind, valid, spikes, out, batch, n_pre, k,
        n_post);
  else if (delay == nullptr)
    ell_spmv_live_kernel<kRows, S, 1><<<grid, kRows, 0, stream>>>(
        g, g_batch_stride, post_ind, valid, spikes, out, batch, n_pre, k,
        n_post);
  else if (vec == 4)
    ell_spmv_delay_live_kernel<kRows, S, 4><<<grid, kRows, 0, stream>>>(
        g, g_batch_stride, post_ind, valid, delay, spikes, out, batch, n_pre,
        k, n_post, n_slots);
  else
    ell_spmv_delay_live_kernel<kRows, S, 1><<<grid, kRows, 0, stream>>>(
        g, g_batch_stride, post_ind, valid, delay, spikes, out, batch, n_pre,
        k, n_post, n_slots);
  return cudaGetLastError();
}

bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Both scatters' plan check and launch.
int scatter(const float* g, long long g_batch_stride, const int32_t* post_ind,
            const uint8_t* valid, const int32_t* delay, const void* spikes,
            int spikes_bool, double* out, int batch, int n_pre, int k,
            int n_post, int n_slots, int vec, int rows, int smem_bytes,
            void* stream) {
  if ((vec != 1 && vec != 4) ||
      (vec == 4 && (k % 4 != 0 || !aligned(post_ind, 16) ||
                    !aligned(g, 16) || !aligned(valid, 4) ||
                    (delay != nullptr && !aligned(delay, 16)))))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_rows(rows, [&](auto r) {
    constexpr int R = decltype(r)::value;
    if (smem_bytes != static_cast<int>(sizeof(LiveSmem<R>)))
      return cudaErrorInvalidValue;
    if (batch == 0 || n_pre == 0 || k == 0 || n_slots == 0 || n_post == 0)
      return cudaSuccess;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (spikes_bool)
      return launch_live<R>(g, g_batch_stride, post_ind, valid, delay,
                            static_cast<const uint8_t*>(spikes), out, batch,
                            n_pre, k, n_post, n_slots, vec, s);
    return launch_live<R>(g, g_batch_stride, post_ind, valid, delay,
                          static_cast<const float*>(spikes), out, batch,
                          n_pre, k, n_post, n_slots, vec, s);
  }));
}

// -- the ring fold ------------------------------------------------------------

// a cursor taken mod n_slots (into [0, n_slots))
__device__ __forceinline__ int wrap_slot(int c, int n_slots) {
  return ((c % n_slots) + n_slots) % n_slots;
}

// grid: items (kVec posts x one member, members fastest) on x, ring rows r
// on y.  Ring row r of member b takes scratch slot (r - cur_b) mod S, so
// each scratch element is read, and zeroed, by exactly one thread.  With
// the members on the fast axis a warp reads and zeroes contiguous runs of
// the scratch (its cells' members side by side) and reads and writes kVec
// posts of B ring rows.
template <int kFoldThreads, int kVec>
__global__ void __launch_bounds__(kFoldThreads)
delay_ring_fold_kernel(const float* __restrict__ ring,
                       double* __restrict__ acc, float* __restrict__ new_ring,
                       float* __restrict__ inj,
                       const float* __restrict__ gscale, float scale,
                       float sign, int batch, int n_slots, int n_post,
                       const int* __restrict__ cursor,
                       int* __restrict__ new_cursor) {
  // member b's read row, taken mod n_slots.  Lane l < batch loads member
  // l's cursor first thing, so the load overlaps the index arithmetic
  // below, and the thread of member b takes lane b's by one shuffle (its
  // own load past 32 members); every lane shuffles before any returns.
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int mine = lane < batch ? wrap_slot(__ldg(cursor + lane), n_slots)
                                : 0;
  const long long item =
      static_cast<long long>(blockIdx.x) * kFoldThreads + threadIdx.x;
  const long long j = item / batch * kVec;
  const int b = static_cast<int>(item % batch);
  const int shuffled = __shfl_sync(0xffffffffu, mine, b & 31);
  if (j >= n_post) return;
  const int cur =
      batch <= 32 ? shuffled : wrap_slot(__ldg(cursor + b), n_slots);
  const int r = blockIdx.y;
  // the thread of member b's first posts in ring row 0 writes its
  // advanced cursor (to another word)
  if (r == 0 && j == 0) new_cursor[b] = cur + 1 == n_slots ? 0 : cur + 1;
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
  if (r == cur) {
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

// The shared memory of a scatter CTA of `rows` rows (launch_plan's
// "smem_bytes"), or -1 for rows the source is not compiled for.
int ell_spmv_smem_bytes(int rows) {
  int bytes = -1;
  with_rows(rows, [&](auto r) {
    bytes = static_cast<int>(sizeof(LiveSmem<decltype(r)::value>));
    return cudaSuccess;
  });
  return bytes;
}

// out: [batch, n_post] float64, zeroed by the caller.  spikes: [batch,
// n_pre], float32 (spikes_bool = 0) or bool bytes (1).  vec, rows and
// smem_bytes come from kernels.ell_spmv.launch_plan: vec 4 needs k % 4 ==
// 0, post_ind and g 16-byte aligned and valid 4-byte aligned; rows is one
// of with_rows's; a plan that disagrees with this source is refused.
int ell_spmv_f32(const float* g, long long g_batch_stride,
                 const int32_t* post_ind, const uint8_t* valid,
                 const void* spikes, int spikes_bool, double* out, int batch,
                 int n_pre, int k, int n_post, int vec, int rows,
                 int smem_bytes, void* stream) {
  return scatter(g, g_batch_stride, post_ind, valid, nullptr, spikes,
                 spikes_bool, out, batch, n_pre, k, n_post, 1, vec, rows,
                 smem_bytes, stream);
}

// The delay variant: adds into out [n_slots, n_post, batch] float64 (the
// caller zeroes it, or keeps it zeroed between calls).  As ell_spmv_f32,
// and vec 4 needs delay 16-byte aligned too.
int ell_spmv_delay_f32(const float* g, long long g_batch_stride,
                       const int32_t* post_ind, const uint8_t* valid,
                       const int32_t* delay, const void* spikes,
                       int spikes_bool, double* out, int batch, int n_pre,
                       int k, int n_post, int n_slots, int vec, int rows,
                       int smem_bytes, void* stream) {
  if (delay == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return scatter(g, g_batch_stride, post_ind, valid, delay, spikes,
                 spikes_bool, out, batch, n_pre, k, n_post, n_slots, vec,
                 rows, smem_bytes, stream);
}

// ring [batch, n_slots, n_post] float32 (read), acc [n_slots, n_post,
// batch] float64 (read, then zeroed), new_ring [batch, n_slots, n_post]
// float32 and inj [batch, n_post] float32 (written).  gscale: [batch]
// float32 on the card, or null and then scale (= sign * gscale, rounded to
// float32) for every member.  cursor: each member's read row, [batch] int32
// on the card (taken mod n_slots); new_cursor: another [batch], written
// with the rows after them.  vec and block come from kernels.delay_ring.launch_plan: vec 4 needs
// n_post % 4 == 0 and all four arrays 16-byte aligned; block is one of
// kinfo::with_block's.
int delay_ring_fold_f32(const float* ring, double* acc, float* new_ring,
                        float* inj, const float* gscale, float scale,
                        float sign, int batch, int n_slots, int n_post,
                        const int* cursor, int* new_cursor, int vec,
                        int block, void* stream) {
  if ((vec != 1 && vec != 4) ||
      (vec == 4 && (n_post % 4 != 0 || !aligned(ring, 16) ||
                    !aligned(acc, 16) || !aligned(new_ring, 16) ||
                    !aligned(inj, 16))) ||
      batch <= 0 || n_post <= 0 || n_slots <= 0 || n_slots > 65535 ||
      cursor == nullptr || new_cursor == nullptr || cursor == new_cursor)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(kinfo::with_block(block, [&](auto bs) {
    constexpr int B = decltype(bs)::value;
    const long long items = (static_cast<long long>(n_post) / vec) * batch;
    const long long ctas = (items + B - 1) / B;
    if (ctas > 2147483647LL) return cudaErrorInvalidValue;
    dim3 grid(static_cast<unsigned>(ctas), n_slots);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (vec == 4)
      delay_ring_fold_kernel<B, 4><<<grid, B, 0, s>>>(
          ring, acc, new_ring, inj, gscale, scale, sign, batch, n_slots,
          n_post, cursor, new_cursor);
    else
      delay_ring_fold_kernel<B, 1><<<grid, B, 0, s>>>(
          ring, acc, new_ring, inj, gscale, scale, sign, batch, n_slots,
          n_post, cursor, new_cursor);
    return cudaGetLastError();
  }));
}

KINFO_NAMES(ell_spmv, "ell_spmv_live<float,4>", "ell_spmv_live<float,1>",
            "ell_spmv_live<bool,4>", "ell_spmv_live<bool,1>",
            "ell_spmv_delay_live<float,4>", "ell_spmv_delay_live<float,1>",
            "ell_spmv_delay_live<bool,4>", "ell_spmv_delay_live<bool,1>",
            "delay_ring_fold<4>", "delay_ring_fold<1>")

// kernels.autotune.kernel_attributes.  which: 0-3 ell_spmv_live_kernel
// with <float, 4>, <float, 1>, <bool, 4>, <bool, 1> spikes and slots an
// item, 4-7 ell_spmv_delay_live_kernel likewise (block = rows: one of
// with_rows's), 8-9 delay_ring_fold_kernel with vec 4, 1 (block: one of
// kinfo::with_block's).
int ell_spmv_kernel_info(int which, int block, int query_block, int dyn_smem,
                         int* out) {
  if (which >= 8 && which <= 9)
    return static_cast<int>(kinfo::with_block(block, [&](auto bs) {
      constexpr int B = decltype(bs)::value;
      const int q = query_block > 0 ? query_block : B;
      return static_cast<cudaError_t>(
          which == 8
              ? kinfo::kernel_info(delay_ring_fold_kernel<B, 4>, q, dyn_smem,
                                   out)
              : kinfo::kernel_info(delay_ring_fold_kernel<B, 1>, q, dyn_smem,
                                   out));
    }));
  if (which < 0 || which > 7) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_rows(block, [&](auto r) {
    constexpr int R = decltype(r)::value;
    const int q = query_block > 0 ? query_block : R;
    int rc;
    switch (which) {
      case 0: rc = kinfo::kernel_info(ell_spmv_live_kernel<R, float, 4>, q,
                                      dyn_smem, out); break;
      case 1: rc = kinfo::kernel_info(ell_spmv_live_kernel<R, float, 1>, q,
                                      dyn_smem, out); break;
      case 2: rc = kinfo::kernel_info(ell_spmv_live_kernel<R, uint8_t, 4>,
                                      q, dyn_smem, out); break;
      case 3: rc = kinfo::kernel_info(ell_spmv_live_kernel<R, uint8_t, 1>,
                                      q, dyn_smem, out); break;
      case 4: rc = kinfo::kernel_info(
                  ell_spmv_delay_live_kernel<R, float, 4>, q, dyn_smem, out);
              break;
      case 5: rc = kinfo::kernel_info(
                  ell_spmv_delay_live_kernel<R, float, 1>, q, dyn_smem, out);
              break;
      case 6: rc = kinfo::kernel_info(
                  ell_spmv_delay_live_kernel<R, uint8_t, 4>, q, dyn_smem,
                  out);
              break;
      default: rc = kinfo::kernel_info(
                   ell_spmv_delay_live_kernel<R, uint8_t, 1>, q, dyn_smem,
                   out);
    }
    return static_cast<cudaError_t>(rc);
  }));
}

const char* ell_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
