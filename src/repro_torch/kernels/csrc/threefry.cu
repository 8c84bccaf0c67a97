// JAX's threefry2x32 key schedule and draws on Hopper.
//
// Replaces no Pallas kernel: the JAX package draws every random number of a
// simulation step through jax.random, which XLA computes
// (jax/_src/prng.py: _threefry_split_foldlike, threefry_fold_in,
// _threefry_random_bits_partitionable; jax/_src/random.py: _uniform,
// _normal_real).  The port keeps its keys in device tensors, so a step's key
// schedule and draws are kernels that a CUDA graph captures like any other.
//
//   threefry_split_kernel: keys [B, 2] -> [B, num, 2]; member b's key i
//     hashes the counter (0, first + i) (split: first = 0; fold_in(k, d):
//     num = 1, first = d).
//   threefry_draw_kernel: keys [B, 2] -> [B, n]; element j of member b
//     hashes the counter (j >> 32, j & 0xffffffff) and keeps the xor of
//     the two words (the partitionable scheme's 32-bit bits), then writes
//     the bits, a uniform in [0, 1) (23 mantissa bits under 1.0's exponent,
//     minus 1) or a normal (sqrt(2) erf_inv(u), u uniform on
//     (nextafter(-1, 0), 1)), times a float32 scale, plus an offset in
//     one fused multiply-add where one is asked for (the affine weight
//     draw lo + (hi - lo) u, which XLA's CPU backend contracts; with lo
//     = 0 it drops the add, so u * hi keeps its sign at u = 0).
//     The randint draw is jax.random.randint(key, (n,), lo, lo + span)
//     for int32 (jax/_src/random.py _randint): k1, k2 = split(key) and
//     m below, made once a CTA into shared memory; element j's two words
//     are bits(k1)[j] and bits(k2)[j]; offset = ((hi mod span) * m +
//     lo_bits mod span) mod span in uint32 arithmetic, m = (2^16 mod
//     span)^2 mod span; x mod 0 is x, as XLA's remainder gives it.  The
//     on-device construction draws its targets with it
//     (repro/sparse/device_init.py _distinct_redraw).
//   threefry_fold_in_kernel: keys [B, 2] (or one key for all) and data
//     [B] (or one word for all) -> [B, 2]: fold_in(keys[b], data[b])
//     hashes the counter (0, data[b]) under keys[b].  The on-device
//     construction's per-row keys (repro/sparse/device_init.py
//     _row_keys) and its per-round keys fold_in(row key, i); unlike split
//     it takes any number of keys (grid axis x).
//
// The hash, the uniform and the normal are threefry.cuh's device
// functions, which neuron_step.cu's drawing Izhikevich kernel shares.
// erf_inv is XLA's float32 expansion (Giles' two branches on
// w = -log1p(-x*x)), written out operation by operation with round-to-
// nearest intrinsics (CUDA's erfinvf is another function); its Horner
// steps are fused multiply-adds, as XLA's CPU backend contracts them.  Keys,
// bits and uniforms equal jax.random's bit for bit; normals differ from
// XLA's CPU build by log1pf's last bits (a few ulp,
// tests/test_torch_threefry.py).
//
// What bounds it: integer operations.  A draw is 20 rounds of add, rotate
// and xor plus the key injections, ~80-120 32-bit operations for 4 bytes
// written, far past the card's integer rate against its memory rate (a
// randint element hashes twice, once for each of its words, and three
// remainders more).  A thread takes one element; in split and draw a
// member's elements are contiguous in x, the members on grid y.  No
// atomics; shared memory only for randint's two sub-keys.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_info.cuh"
#include "threefry.cuh"

namespace {

using threefry::threefry2x32;

// A launch's block is one of kinfo::with_block's sizes, chosen on the host
// by the occupancy model (kernels.autotune.choose_block_elementwise).

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
threefry_split_kernel(const uint32_t* __restrict__ keys,
                      long long key_stride, uint32_t* __restrict__ out,
                      int num, uint32_t first) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= num) return;
  const int b = blockIdx.y;
  const uint32_t* k = keys + b * key_stride;
  uint32_t x0 = 0u, x1 = first + static_cast<uint32_t>(i);
  threefry2x32(k[0], k[1], x0, x1);
  uint32_t* o = out + (static_cast<long long>(b) * num + i) * 2;
  o[0] = x0;
  o[1] = x1;
}

// x mod s in uint32, and x where s is 0 (XLA's unsigned remainder)
__device__ __forceinline__ uint32_t rem_u32(uint32_t x, uint32_t s) {
  return s != 0u ? x % s : x;
}

// dist: 0 bits, 1 uniform, 2 normal, 3 randint (lo + offset in [0, span));
// affine: out = fma(draw, scale, offset), else draw * scale
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
threefry_draw_kernel(const uint32_t* __restrict__ keys, long long key_stride,
                     uint32_t* __restrict__ out, long long n, int dist,
                     float scale, float offset, int affine, uint32_t lo,
                     uint32_t span) {
  const long long j = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int b = blockIdx.y;
  const uint32_t* k = keys + b * key_stride;
  if (dist == 3) {
    // once a CTA: k1, k2 = split(key) (the counters (0, 0) and (0, 1))
    // and the multiplier (a block has at least 128 threads)
    __shared__ uint32_t sub[5];
    if (threadIdx.x < 2) {
      uint32_t s0 = 0u, s1 = threadIdx.x;
      threefry2x32(k[0], k[1], s0, s1);
      sub[2 * threadIdx.x] = s0;
      sub[2 * threadIdx.x + 1] = s1;
    } else if (threadIdx.x == 2) {
      const uint32_t m0 = rem_u32(65536u, span);
      sub[4] = rem_u32(m0 * m0, span);
    }
    __syncthreads();
    if (j >= n) return;
    uint32_t x0 =
        static_cast<uint32_t>(static_cast<unsigned long long>(j) >> 32);
    uint32_t x1 = static_cast<uint32_t>(j);
    uint32_t y0 = x0, y1 = x1;
    threefry2x32(sub[0], sub[1], x0, x1);
    threefry2x32(sub[2], sub[3], y0, y1);
    const uint32_t off = rem_u32(
        rem_u32(x0 ^ x1, span) * sub[4] + rem_u32(y0 ^ y1, span), span);
    out[static_cast<long long>(b) * n + j] = lo + off;
    return;
  }
  if (j >= n) return;
  const uint32_t bits =
      threefry::bits(k[0], k[1], static_cast<unsigned long long>(j));
  uint32_t* o = out + static_cast<long long>(b) * n + j;
  if (dist == 0) {
    *o = bits;
    return;
  }
  const float f =
      dist == 2 ? threefry::normal(bits) : threefry::uniform(bits);
  *o = __float_as_uint(affine ? __fmaf_rn(f, scale, offset)
                              : __fmul_rn(f, scale));
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
threefry_fold_in_kernel(const uint32_t* __restrict__ keys,
                        long long key_stride,
                        const uint32_t* __restrict__ data, uint32_t data0,
                        uint32_t* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  const uint32_t* k = keys + i * key_stride;
  uint32_t x0 = 0u, x1 = data != nullptr ? data[i] : data0;
  threefry2x32(k[0], k[1], x0, x1);
  out[2 * i] = x0;
  out[2 * i + 1] = x1;
}

}  // namespace

extern "C" {

// keys: [batch] rows of 2 uint32 words, row b at keys + b * key_stride;
// out: [batch, num, 2] uint32.  block: the wrapper's plan
// (kernels.autotune.choose_block_elementwise); a block the source is not
// compiled for is refused.
int threefry_split(const uint32_t* keys, long long key_stride, uint32_t* out,
                   int batch, int num, unsigned int first, int block,
                   void* stream) {
  if (batch < 0 || num < 0 || batch > 65535 || key_stride < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(kinfo::with_block(block, [&](auto bs) {
    constexpr int B = decltype(bs)::value;
    if (batch == 0 || num == 0) return cudaSuccess;
    dim3 grid((num + B - 1) / B, batch);
    threefry_split_kernel<B><<<grid, B, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        keys, key_stride, out, num, first);
    return cudaGetLastError();
  }));
}

// out: [batch, n] uint32 bits (dist 0), float32 (dist 1 uniform, 2
// normal), each float draw times scale, or int32 (dist 3 randint: lo +
// offset, offset in [0, span), span 0 standing for 2^32).  block as above.
int threefry_draw(const uint32_t* keys, long long key_stride, void* out,
                  int batch, long long n, int dist, float scale,
                  float offset, int affine, int lo, unsigned int span,
                  int block, void* stream) {
  if (batch < 0 || n < 0 || batch > 65535 || key_stride < 2 || dist < 0 ||
      dist > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(kinfo::with_block(block, [&](auto bs) {
    constexpr int B = decltype(bs)::value;
    if (batch == 0 || n == 0) return cudaSuccess;
    const long long ctas = (n + B - 1) / B;
    if (ctas > 2147483647LL) return cudaErrorInvalidValue;
    dim3 grid(static_cast<unsigned>(ctas), batch);
    threefry_draw_kernel<B><<<grid, B, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        keys, key_stride, static_cast<uint32_t*>(out), n, dist, scale,
        offset, affine, static_cast<uint32_t>(lo), span);
    return cudaGetLastError();
  }));
}

// keys: n rows of 2 uint32 words, row i at keys + i * key_stride (stride
// 0: one key for all); data: n uint32 words, or null for data0 in every
// row; out: [n, 2] uint32.  block as above.
int threefry_fold_in(const uint32_t* keys, long long key_stride,
                     const uint32_t* data, unsigned int data0, uint32_t* out,
                     long long n, int block, void* stream) {
  if (n < 0 || key_stride < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(kinfo::with_block(block, [&](auto bs) {
    constexpr int B = decltype(bs)::value;
    if (n == 0) return cudaSuccess;
    const long long ctas = (n + B - 1) / B;
    if (ctas > 2147483647LL) return cudaErrorInvalidValue;
    threefry_fold_in_kernel<B><<<static_cast<unsigned>(ctas), B, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        keys, key_stride, data, data0, out, n);
    return cudaGetLastError();
  }));
}

KINFO_NAMES(threefry, "threefry_split", "threefry_draw", "threefry_fold_in")

// kernels.autotune.kernel_attributes: which 0 threefry_split, 1
// threefry_draw, 2 threefry_fold_in, each compiled for one of the blocks of
// kinfo::with_block.
int threefry_kernel_info(int which, int block, int query_block,
                         int dyn_smem, int* out) {
  return static_cast<int>(kinfo::with_block(block, [&](auto bs) {
    constexpr int B = decltype(bs)::value;
    const int q = query_block > 0 ? query_block : B;
    switch (which) {
      case 0:
        return static_cast<cudaError_t>(
            kinfo::kernel_info(threefry_split_kernel<B>, q, dyn_smem, out));
      case 1:
        return static_cast<cudaError_t>(
            kinfo::kernel_info(threefry_draw_kernel<B>, q, dyn_smem, out));
      case 2:
        return static_cast<cudaError_t>(
            kinfo::kernel_info(threefry_fold_in_kernel<B>, q, dyn_smem, out));
      default:
        return cudaErrorInvalidValue;
    }
  }));
}

const char* threefry_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
