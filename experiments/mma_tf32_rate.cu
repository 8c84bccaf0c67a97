// The rate of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 on the
// card: every warp issues kChains independent accumulations kIters times
// (no shared memory, no other work), so the time is the tensor pipe's.
// Built and timed by experiments/mma_tf32_rate.py.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChains = 8;

__global__ void __launch_bounds__(256)
mma_tf32_rate_kernel(float* out, int iters, uint32_t seed) {
  uint32_t a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = (seed + threadIdx.x * 7 + i) & 0x3f800000u;
#pragma unroll
  for (int i = 0; i < 2; ++i) b[i] = (seed + threadIdx.x * 3 + i) & 0x3f800000u;
  float d[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < kChains; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// ctas CTAs of 256 threads, each warp issuing iters * kChains mma.sync.
extern "C" int mma_tf32_rate(float* out, int ctas, int iters, void* stream) {
  mma_tf32_rate_kernel<<<ctas, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      out, iters, 0x3f800000u);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mma_tf32_chains() { return kChains; }
