// GeNN's 32x spike bitmask on Hopper: bool spikes [B, n] -> words [B, W].
//
// Replaces no Pallas kernel: the JAX package packs spike rows with XLA ops
// (repro/core/snn/bitmask.py: pack_spikes, a shift of each bool by its
// lane and a sum over 32 lanes), for its spike-probe rings and the sharded
// engine's exchange.  This is the paper's own packing, written for the card.
//
// Layout (repro/core/snn/bitmask.py:9-10): word w of a row holds neurons
// [32w, 32w + 32); neuron j is bit j % 32 of word j / 32, least significant
// bit first, and the trailing bits of the last word are zero.  W =
// max(1, ceil(n / 32)).  Words are stored as int32 with uint32's bit
// pattern.
//
//   spike_bitmask_kernel: one warp per word.  Lane l reads the byte of
//     neuron 32w + l (a lane past n votes 0), __ballot_sync gathers the
//     32 votes into one word, bit l from lane l, and lane 0 writes it.  A
//     warp's 32 reads are one 32-byte sector; a CTA of kThreads / 32
//     warps covers kThreads neurons of one row; the rows ride grid axis y.
//
// The ring variant writes row `slot` of a ring [cap, B, W]: the slot is a
// host int or, where `slot_ptr` is given, the int32 that it points to on
// the device, and where `active_ptr` is given the launch writes nothing
// unless the byte it points to is nonzero.  Both are read by the kernel,
// so a CUDA graph that captured the launch writes the row that the
// device's tensors name at each replay.  A slot outside [0, cap) writes
// nothing.
//
// What bounds it: bytes.  B * n bytes read and B * W * 4 written, one
// ballot a word; no shared memory, no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_info.cuh"

namespace {

// A launch's block is one of kinfo::with_block's sizes, chosen on the host
// by the occupancy model (kernels.autotune.choose_block_elementwise): a
// warp a word, kThreads / 32 words a CTA.
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
spike_bitmask_kernel(const uint8_t* __restrict__ bits, uint32_t* out,
                     long long n, long long words, int cap,
                     const int* __restrict__ slot_ptr, int slot_const,
                     const uint8_t* __restrict__ active_ptr) {
  if (active_ptr != nullptr && *active_ptr == 0) return;
  const int slot = slot_ptr != nullptr ? *slot_ptr : slot_const;
  if (slot < 0 || slot >= cap) return;
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const long long w =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (w >= words) return;                 // whole warps leave together
  const long long b = blockIdx.y;
  const long long j = w * 32 + lane;
  const bool spiked = j < n && bits[b * n + j] != 0;
  const uint32_t word = __ballot_sync(0xffffffffu, spiked);
  if (lane == 0) {
    const long long rows = gridDim.y;
    out[(static_cast<long long>(slot) * rows + b) * words + w] = word;
  }
}

}  // namespace

extern "C" {

// bits: [batch, n] bool (one byte each); out: [cap, batch, words] uint32
// (cap 1 for a plain [batch, words] result).  slot_ptr: an int32 on the
// device or null (then slot); active_ptr: a bool on the device or null.
// block: the wrapper's plan (kernels.autotune.choose_block_elementwise); a
// block the source is not compiled for is refused.
int spike_bitmask(const uint8_t* bits, uint32_t* out, int batch, long long n,
                  long long words, int cap, const int* slot_ptr, int slot,
                  const uint8_t* active_ptr, int block, void* stream) {
  if (batch < 0 || batch > 65535 || n < 0 || cap < 1 ||
      words != (n > 32 ? (n + 31) / 32 : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(kinfo::with_block(block, [&](auto bs) {
    constexpr int B = decltype(bs)::value;
    if (batch == 0) return cudaSuccess;
    const long long ctas = (words + B / 32 - 1) / (B / 32);
    if (ctas > 2147483647LL) return cudaErrorInvalidValue;
    dim3 grid(static_cast<unsigned>(ctas), batch);
    spike_bitmask_kernel<B><<<grid, B, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        bits, out, n, words, cap, slot_ptr, slot, active_ptr);
    return cudaGetLastError();
  }));
}

KINFO_NAMES(spike_bitmask, "spike_bitmask")

// kernels.autotune.kernel_attributes: which 0 spike_bitmask, compiled for
// one of the blocks of kinfo::with_block.
int spike_bitmask_kernel_info(int which, int block, int query_block,
                              int dyn_smem, int* out) {
  return static_cast<int>(kinfo::with_block(block, [&](auto bs) {
    constexpr int B = decltype(bs)::value;
    if (which != 0) return cudaErrorInvalidValue;
    return static_cast<cudaError_t>(kinfo::kernel_info(
        spike_bitmask_kernel<B>, query_block > 0 ? query_block : B,
        dyn_smem, out));
  }));
}

const char* spike_bitmask_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
