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
// card has both, so this is GeNN's own form instead:
//
//   * one warp per presynaptic row, eight rows to a block, and the batch
//     index b on grid axis y;
//   * a warp whose spike value is 0 returns at once, so the work is
//     proportional to activity (the compaction that
//     repro/kernels/ops.py::ell_spmv_event does on the TPU is not needed);
//   * the 32 lanes stride over the row's K slots, so the loads of g,
//     post_ind, valid (and delay) are coalesced, and each valid slot does one
//     atomicAdd into the output row of batch member b.
//
// What bounds it on this card: memory.  Per spiking row it reads 9 bytes a
// slot (13 with a delay) and does one add per valid slot, far below the
// ~20 flop/byte the card needs before arithmetic matters.  The atomics land
// on random post neurons; with K >= 1000 and ~1e5 targets contention is low,
// and the adds resolve in L2.  The design answers the bound only by reading
// nothing for silent rows; reading a row once for all B batch members and
// packing valid into the index word are later work.
//
// Out-of-range targets (post_ind >= n_post, delay >= n_slots) are skipped
// rather than written: the containers are checked when they are built, and
// this guard only keeps a bad index from corrupting memory.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

template <bool kDelay>
__global__ void __launch_bounds__(kThreads)
ell_spmv_kernel(const float* __restrict__ g, long long g_batch_stride,
                const int32_t* __restrict__ post_ind,
                const uint8_t* __restrict__ valid,
                const int32_t* __restrict__ delay,
                const float* __restrict__ spikes,
                float* __restrict__ out,
                int n_pre, int k, int n_post, int n_slots) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const long long b = blockIdx.y;
  if (row >= n_pre) return;
  const float s = spikes[b * n_pre + row];
  if (s == 0.0f) return;
  const long long base = static_cast<long long>(row) * k;
  const float* g_row = g + b * g_batch_stride + base;
  float* out_b = out + b * n_slots * static_cast<long long>(n_post);
  for (int c = lane; c < k; c += 32) {
    if (!valid[base + c]) continue;
    const int j = post_ind[base + c];
    const int d = kDelay ? delay[base + c] : 0;
    if (static_cast<unsigned>(j) >= static_cast<unsigned>(n_post) ||
        static_cast<unsigned>(d) >= static_cast<unsigned>(n_slots))
      continue;
    atomicAdd(out_b + static_cast<long long>(d) * n_post + j, s * g_row[c]);
  }
}

template <bool kDelay>
int launch(const float* g, long long g_batch_stride, const int32_t* post_ind,
           const uint8_t* valid, const int32_t* delay, const float* spikes,
           float* out, int batch, int n_pre, int k, int n_post, int n_slots,
           cudaStream_t stream) {
  if (batch == 0 || n_pre == 0 || k == 0) return cudaSuccess;
  dim3 grid((n_pre + kWarpsPerBlock - 1) / kWarpsPerBlock, batch);
  ell_spmv_kernel<kDelay><<<grid, kThreads, 0, stream>>>(
      g, g_batch_stride, post_ind, valid, delay, spikes, out, n_pre, k,
      n_post, n_slots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out: [batch, n_post] float32, zeroed by the caller.
int ell_spmv_f32(const float* g, long long g_batch_stride,
                 const int32_t* post_ind, const uint8_t* valid,
                 const float* spikes, float* out, int batch, int n_pre, int k,
                 int n_post, void* stream) {
  return launch<false>(g, g_batch_stride, post_ind, valid, nullptr, spikes,
                       out, batch, n_pre, k, n_post, 1,
                       static_cast<cudaStream_t>(stream));
}

// out: [batch, n_slots, n_post] float32, zeroed by the caller.
int ell_spmv_delay_f32(const float* g, long long g_batch_stride,
                       const int32_t* post_ind, const uint8_t* valid,
                       const int32_t* delay, const float* spikes, float* out,
                       int batch, int n_pre, int k, int n_post, int n_slots,
                       void* stream) {
  return launch<true>(g, g_batch_stride, post_ind, valid, delay, spikes, out,
                      batch, n_pre, k, n_post, n_slots,
                      static_cast<cudaStream_t>(stream));
}

const char* ell_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
