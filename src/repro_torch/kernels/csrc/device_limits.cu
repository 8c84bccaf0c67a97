// The card's limits that kernels.autotune.H100Limits models, as the
// runtime reports them, so that every value of the model is held to the
// card (kernels.autotune.device_limits; chip_smoke.py's phase 10).
//
// Most are device attributes.  The register ceiling a thread may have is
// not: it is read off register_ceiling_probe, a kernel that keeps more
// values live than a thread can hold and that ptxas therefore compiles
// with the most registers a thread may have (spilling the rest).  It is
// never launched.  The allocation units (registers by the warp, shared
// memory by the CTA) and the register file's sub-partitions show only in
// the runtime's occupancy answers, which phase 10 holds the model to at
// every block size a kernel may have.

#include <cuda_runtime.h>

#include "kernel_info.cuh"

namespace {

constexpr int kLive = 320;       // values live at once, past any ceiling

__global__ void __launch_bounds__(32)
register_ceiling_probe(float* __restrict__ data, int rounds) {
  float v[kLive];
#pragma unroll
  for (int i = 0; i < kLive; ++i) v[i] = data[i * 32 + threadIdx.x];
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int i = 0; i < kLive; ++i)
      v[i] = __fmaf_rn(v[i], v[(i + 1) % kLive], 1.0f);
  }
#pragma unroll
  for (int i = 0; i < kLive; ++i) data[i * 32 + threadIdx.x] = v[i];
}

}  // namespace

extern "C" {

// The number of entries device_limits writes.
int device_limits_len() { return 11; }

// out: SMs, threads an SM, CTAs an SM, threads a CTA, registers an SM,
// registers a CTA, shared memory an SM, shared memory a CTA (opt-in),
// shared memory the system reserves a CTA, the warp's threads, and the
// probe's registers a thread; of the current device.
int device_limits(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaDeviceAttr attrs[10] = {
      cudaDevAttrMultiProcessorCount,
      cudaDevAttrMaxThreadsPerMultiProcessor,
      cudaDevAttrMaxBlocksPerMultiprocessor,
      cudaDevAttrMaxThreadsPerBlock,
      cudaDevAttrMaxRegistersPerMultiprocessor,
      cudaDevAttrMaxRegistersPerBlock,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrReservedSharedMemoryPerBlock,
      cudaDevAttrWarpSize};
  for (int i = 0; i < 10; ++i) {
    err = cudaDeviceGetAttribute(out + i, attrs[i], dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, register_ceiling_probe);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[10] = a.numRegs;
  return cudaSuccess;
}

KINFO_NAMES(device_limits, "register_ceiling_probe")

// kernels.autotune.kernel_attributes for the probe (which 0; 32 threads).
int device_limits_kernel_info(int which, int block, int query_block,
                              int dyn_smem, int* out) {
  (void)block;
  if (which != 0) return static_cast<int>(cudaErrorInvalidValue);
  return kinfo::kernel_info(register_ceiling_probe,
                            query_block > 0 ? query_block : 32, dyn_smem,
                            out);
}

const char* device_limits_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
