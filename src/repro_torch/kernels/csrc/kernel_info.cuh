// What every kernel library of the port shares: the block sizes an
// elementwise kernel is compiled for, and the query behind
// repro_torch.kernels.autotune.kernel_attributes (the paper's occupancy
// model reads a built kernel's registers and shared memory from the
// runtime, never from constants).
//
// Each library exports two C functions.  <library>_kernel_name(which)
// names its kernel number `which` (KINFO_NAMES below; null past the last),
// and kernels.autotune finds a kernel's number by that name, so the
// numbering lives here alone.  <library>_kernel_info(which, block,
// query_block, dyn_smem, out) fills `out` for kernel `which` compiled for
// `block` by kernel_info() below; the runtime's occupancy is asked at
// query_block threads (the compiled block when query_block <= 0), so that
// the model can be held to the runtime at every block a CTA may have.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

// <library>_kernel_name: the names of a library's kernels, in the order
// of the `which` its <library>_kernel_info takes.
#define KINFO_NAMES(library, ...)                                       \
  extern "C" const char* library##_kernel_name(int which) {             \
    static const char* const names[] = {__VA_ARGS__};                   \
    const int n = static_cast<int>(sizeof(names) / sizeof(names[0]));   \
    return which >= 0 && which < n ? names[which] : nullptr;            \
  }

namespace kinfo {

// The blocks an elementwise kernel is instantiated for, one
// __launch_bounds__ each (kernels.autotune.ELEMENTWISE_BLOCKS).
// with_block(block, f) calls f(std::integral_constant<int, B>{}) for the
// compiled B equal to block; any other block is refused, never rounded.
template <typename F>
cudaError_t with_block(int block, F&& f) {
  switch (block) {
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    case 512: return f(std::integral_constant<int, 512>{});
    case 1024: return f(std::integral_constant<int, 1024>{});
    default: return cudaErrorInvalidValue;
  }
}

// out (7 entries; kernels.autotune reads them): numRegs, sharedSizeBytes (static), maxThreadsPerBlock,
// maxDynamicSharedSizeBytes, localSizeBytes (spills), the runtime's
// cudaOccupancyMaxActiveBlocksPerMultiprocessor at (block, dyn_smem), and
// dyn_smem.
// A dyn_smem past the kernel's dynamic limit first raises the limit, as
// the kernel's own launch does.
template <typename Kernel>
int kernel_info(Kernel kernel, int block, int dyn_smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dyn_smem < 0 || block <= 0 || block > a.maxThreadsPerBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dyn_smem > a.maxDynamicSharedSizeBytes) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dyn_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncGetAttributes(&a, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, block,
                                                      dyn_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = a.maxThreadsPerBlock;
  out[3] = a.maxDynamicSharedSizeBytes;
  out[4] = static_cast<int>(a.localSizeBytes);
  out[5] = ctas;
  out[6] = dyn_smem;
  return cudaSuccess;
}

}  // namespace kinfo
