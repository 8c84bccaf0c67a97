// Fused neuron updates on Hopper (sm_90a): GeNN's generated neuron kernels.
//
// Replaces the TPU kernels repro/kernels/izhikevich_step.py::
// izhikevich_step_pallas (body `_kernel`) and repro/kernels/hh_step.py::
// hh_step_pallas (body `_kernel`).  Each is one elementwise pass that keeps
// every intermediate of the update in registers, so the state makes one
// round trip through device memory per step instead of one per statement.
//
//   izhikevich_step_f32: a population's whole step, GeNN's generated
//     neuron kernel: the input summed from the synapse groups' currents
//     (0.0f plus each in the network's order), plus the thalamic drive
//     hashed in registers where one is declared (scale * N(0, 1) of the
//     member's key, threefry.cuh: the draw kernel's own arithmetic), plus
//     the stim where one is given, each add rounded as the simulator's
//     eager adds round; then two V half-steps, the U update, V clamped at
//     30, spike = V >= 29.99, reset V = c, U += d where spiked.  One kernel
//     templated on the drive (instance "izhikevich_step.drive"), so the
//     input's ~5 elementwise passes and the draw's launch go away.
//   hh_step_f32: Traub-Miles Hodgkin-Huxley, `substeps` Euler substeps of
//     dt / substeps, guarded vtrap (x / (exp(x) - 1), Taylor 1 - x/2 for
//     |x| <= 1e-4), gates clipped to [0, 1]; it also writes above = V >= 0
//     as a byte (the threshold the simulator reads).
//
// Both also write the NaN guard's flag in their epilogue, when the caller
// passes one (`finite`, one byte per batch member): a block ANDs whether
// every state value its threads wrote is finite (__syncthreads_and), and
// one thread of a block that saw a NaN or Inf stores 0 into its member's
// byte.  Only zeros are stored, so blocks need no atomics and no order;
// the caller owns the flag (1 where its members are still finite) and
// reads it after the launch.  That replaces an isfinite fold of several
// device ops per state variable and step.
//
// Layout: the state is [batch, n] float32, row-major.  One thread per
// (batch member, neuron), neurons on grid axis x in a grid-stride loop and
// members on axis y; the tail is masked by the index, so nothing is padded
// (the TPU form pads to 128-lane rows and sets the HH tail's V to -60 to
// keep its rates finite; a masked tail needs no such value).  Izhikevich's
// a..d are [n] arrays read with a batch stride of 0, one array for every
// member; HH's seven parameters are scalars passed by value, as the TPU
// kernel's are static.
//
// Arithmetic: the statements and their order are those of the codegen'd
// models (repro_torch/core/snn/neurons.py) and of the plain versions in
// repro_torch/kernels/ref.py: expf (no __expf), constants rounded from
// their double literals as PyTorch rounds a Python float, and the build
// turns off multiply-add contraction (-fmad=false in _build.py), so each
// operation rounds as PyTorch's eager ops do.  Izhikevich divides nothing.
// HH divides as PyTorch does on the card: a tensor divided by a Python
// scalar (x / 5.0, x / C) is a product with the scalar's float32
// reciprocal (exact for 4; one more rounding than the true quotient
// elsewhere, which the CPU computes), and 4.0 / x is reciprocal(x) * 4;
// only vtrap's x / (exp(x) - 1) is an IEEE division.  (PR 12's HH divided
// truly 11 times a substep: ~30% more instructions.)  Clamps are written as
// comparisons that pass a NaN through, as torch.clamp and jnp.clip do
// (fminf/fmaxf would drop it and hide a blow-up from the NaN guard).
//
// What bounds them on this card:
//   * Izhikevich: memory.  It reads v, u and each current (8 + 4k B per
//     member for k groups; the stim 4 more) and a..d (16 B per neuron, once
//     across the batch; the other members' reads hit L2) and writes v', u'
//     and a spike byte (9 B per member): ~28 float operations against ~41
//     B at B = 1 with two groups, far below the ~20 op/B at which the
//     card's float32 rate (67 TFLOP/s) would bind before its memory (3.35
//     TB/s).  The drawing instance adds ~72 32-bit integer operations a
//     neuron (20 threefry rounds and the key schedule) and ~17 float ones
//     (the normal): at the integer rate (a quarter of the float32 lanes)
//     that is ~0.5 us at 80,000 neurons against ~1 us of bytes, so bytes
//     still bound it; both lie under the launch floor (~1.2 us), which is
//     why the drive is fused here instead of drawn by a kernel of its own.
//   * HH: by the bytes, memory (it reads v, m, h, n, isyn and writes v, m,
//     h, n and above: 37 B per member, against ~440 operations over 5
//     substeps counting an expf or a division as one); by what it issues,
//     instructions: an expf is ~10 SASS instructions and an IEEE division
//     ~10, so a 100k-neuron launch issues ~1e8 instructions, about as long
//     as its bytes take.  At 20 or 100 neurons (LHI, DN) one thread's
//     dependent chain of 5 substeps is the whole launch.  The design cuts
//     the instructions: products with reciprocals for the divisions, the
//     substep loop kept rolled (#pragma unroll 1), and above and the flag
//     written in the same pass instead of by later device ops.
// The design answers the byte bound by fusing: the inputs are read once
// and the outputs written once.  At the main path's sizes (1e5 neurons,
// 0.4-4 MB) one launch moves less than its own launch latency's worth of
// bytes, so latency, not bandwidth, sets the measured time.

#include <cuda_runtime.h>
#include <cstdint>

#include "kernel_info.cuh"
#include "threefry.cuh"

namespace {

// A launch's block is one of kinfo::with_block's sizes, chosen on the host
// by the occupancy model (kernels.autotune.choose_block_elementwise) with
// the grid: a thread an element up to GRID_STRIDE_MAX CTAs along x, a
// grid-stride loop beyond.

// Constants as PyTorch applies a Python float to a float32 tensor: the
// double literal rounded to float32.
constexpr float kHalf = 0.5;
constexpr float kIzA = 0.04;
constexpr float kIzB = 5.0;
constexpr float kIzC = 140.0;
constexpr float kVPeak = 30.0;
constexpr float kVThresh = 29.99;

constexpr float kVtrapEps = 1e-4;

__device__ __forceinline__ float clip01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

__device__ __forceinline__ float vtrap(float x) {
  return fabsf(x) > kVtrapEps ? x / (expf(x) - 1.0f) : 1.0f - x * 0.5f;
}

// The flag epilogue: every thread of the block reaches it (uniform on
// `finite`); a block where any thread wrote a non-finite value clears its
// batch member's byte (blockIdx.y).
__device__ __forceinline__ void clear_if_not_finite(uint8_t* finite,
                                                    bool ok) {
  if (finite != nullptr && !__syncthreads_and(ok) && threadIdx.x == 0)
    finite[blockIdx.y] = 0;
}

// The summed input of a population: up to kMaxCurrents [batch, n] current
// operands (the synapse groups' currents in the network's order, none for
// a population no group posts onto; one for a caller's isyn), added to
// 0.0f in that order.
constexpr int kMaxCurrents = 8;

struct Currents {
  const float* p[kMaxCurrents];
  int count;
};

// The thalamic drive: member b's normal of lane first + j, times scale,
// for the lanes j < n_real (a rank's window of the population; the lanes
// past it are padding and add 0.0f).  keys: member b's key at
// keys + b * key_stride (a strided column of the step's split).
struct Drive {
  const uint32_t* keys;
  long long key_stride;
  float scale;
  int first;
  int n_real;
};

// kDrive: the instance that hashes the drive in registers (the draw
// kernel's arithmetic, threefry.cuh), else the drive is absent.  kCount:
// the number of current operands where the launch knows it at compile
// time (2 with a drive: main's two groups a population; 1 without: one
// summed isyn), else -1 and cur.count is read (measured on the card, the
// fixed count saves ~0.2 us a call at [1, 80000]).  stim: [batch, n] with
// row stride stim_stride (0: one [n] row for every member), or null.
template <int kThreads, bool kDrive, int kCount>
__global__ void __launch_bounds__(kThreads)
izhikevich_step_kernel(const float* __restrict__ v_in,
                       const float* __restrict__ u_in, Currents cur,
                       Drive drive, const float* __restrict__ stim,
                       long long stim_stride,
                       const float* __restrict__ pa,
                       const float* __restrict__ pb,
                       const float* __restrict__ pc,
                       const float* __restrict__ pd,
                       float* __restrict__ v_out, float* __restrict__ u_out,
                       uint8_t* __restrict__ spiked_out,
                       uint8_t* __restrict__ finite, int n, float dt) {
  const long long row = static_cast<long long>(blockIdx.y) * n;
  const float hdt = kHalf * dt;
  const int count = kCount >= 0 ? kCount : cur.count;
  uint32_t k0 = 0u, k1 = 0u;
  if (kDrive) {
    const uint32_t* k = drive.keys + blockIdx.y * drive.key_stride;
    k0 = k[0];
    k1 = k[1];
  }
  const float* stim_row =
      stim != nullptr ? stim + blockIdx.y * stim_stride : nullptr;
  bool ok = true;
  for (int j = blockIdx.x * kThreads + threadIdx.x; j < n;
       j += gridDim.x * kThreads) {
    const long long i = row + j;
    // every load first, so that their latencies overlap (an add that
    // waited on one load would hold the next load back behind it)
    float v = v_in[i];
    float u = u_in[i];
    float c[kMaxCurrents];
#pragma unroll
    for (int k = 0; k < kMaxCurrents; ++k) {
      if (k == count) break;
      c[k] = __ldg(cur.p[k] + i);
    }
    const float s = stim_row != nullptr ? __ldg(stim_row + j) : 0.0f;
    // the simulator's sequence, each add rounded: zeros + each current,
    // + the drive, + the stim
    float isyn = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxCurrents; ++k) {
      if (k == count) break;
      isyn = __fadd_rn(isyn, c[k]);
    }
    if (kDrive) {
      const float noise =
          j < drive.n_real
              ? __fmul_rn(threefry::normal(threefry::bits(
                              k0, k1,
                              static_cast<unsigned long long>(drive.first) +
                                  static_cast<unsigned long long>(j))),
                          drive.scale)
              : 0.0f;
      isyn = __fadd_rn(isyn, noise);
    }
    if (stim_row != nullptr) isyn = __fadd_rn(isyn, s);
    // C and Python both group these products and sums from the left
    v = v + hdt * (kIzA * v * v + kIzB * v + kIzC - u + isyn);
    v = v + hdt * (kIzA * v * v + kIzB * v + kIzC - u + isyn);
    u = u + dt * pa[j] * (pb[j] * v - u);
    v = v > kVPeak ? kVPeak : v;
    const bool spiked = v >= kVThresh;
    v = spiked ? pc[j] : v;
    u = spiked ? u + pd[j] : u;
    v_out[i] = v;
    u_out[i] = u;
    spiked_out[i] = spiked;
    ok &= isfinite(v) & isfinite(u);
  }
  clear_if_not_finite(finite, ok);
}

// inv_c is 1 / C rounded once from double: PyTorch divides a float32
// tensor by a Python float c as x * float(1.0 / c), so the plain version's
// "/ C" is this product.
struct HHParams {
  float gNa, ENa, gK, EK, gl, El, inv_c;
};

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
hh_step_kernel(const float* __restrict__ v_in, const float* __restrict__ m_in,
               const float* __restrict__ h_in, const float* __restrict__ n_in,
               const float* __restrict__ isyn_in, float* __restrict__ v_out,
               float* __restrict__ m_out, float* __restrict__ h_out,
               float* __restrict__ n_out, uint8_t* __restrict__ above_out,
               uint8_t* __restrict__ finite, int n_neurons, float dt,
               int substeps, HHParams p) {
  constexpr float k52 = 52.0, k25 = 25.0, k48 = 48.0, k50 = 50.0, k55 = 55.0;
  constexpr float k4 = 4.0;
  // x / c for a Python scalar c, as PyTorch computes it on the card:
  // x * float(1.0 / c), the reciprocal taken in double
  constexpr float kInv4 = 1.0 / 4.0, kInv5 = 1.0 / 5.0,
                  kInv18 = 1.0 / 18.0, kInv40 = 1.0 / 40.0;
  constexpr float kAm = 1.28, kBm = 1.4, kAh = 0.128, kAn = 0.16, kBn = 0.5;
  const float hdt = dt / static_cast<float>(substeps);
  const long long row = static_cast<long long>(blockIdx.y) * n_neurons;
  bool ok = true;
  for (int j = blockIdx.x * kThreads + threadIdx.x; j < n_neurons;
       j += gridDim.x * kThreads) {
    const long long i = row + j;
    float v = v_in[i], m = m_in[i], h = h_in[i], n = n_in[i];
    const float isyn = isyn_in[i];
#pragma unroll 1
    for (int s = 0; s < substeps; ++s) {
      const float i_na = m * m * m * h * p.gNa * (v - p.ENa);
      const float i_k = n * n * n * n * p.gK * (v - p.EK);
      const float imem = -(i_na + i_k + p.gl * (v - p.El) - isyn);
      v = v + hdt * imem * p.inv_c;
      const float a_m = kAm * vtrap((-k52 - v) * kInv4);
      const float b_m = kBm * vtrap((v + k25) * kInv5);
      const float a_h = kAh * expf((-k48 - v) * kInv18);
      const float b_h = 1.0f / (expf((-k25 - v) * kInv5) + 1.0f) * k4;
      const float a_n = kAn * vtrap((-k50 - v) * kInv5);
      const float b_n = kBn * expf((-k55 - v) * kInv40);
      m = clip01(m + hdt * (a_m * (1.0f - m) - b_m * m));
      h = clip01(h + hdt * (a_h * (1.0f - h) - b_h * h));
      n = clip01(n + hdt * (a_n * (1.0f - n) - b_n * n));
    }
    v_out[i] = v;
    m_out[i] = m;
    h_out[i] = h;
    n_out[i] = n;
    above_out[i] = v >= 0.0f;
    ok &= isfinite(v) & isfinite(m) & isfinite(h) & isfinite(n);
  }
  clear_if_not_finite(finite, ok);
}

}  // namespace

extern "C" {

// v, u, v_out, u_out, spiked_out: [batch, n]; currents: n_currents
// (0..8) pointers to [batch, n] operands, added in order; a, b, c, d: [n];
// keys: null for no drive, else member b's key at keys + b * key_stride,
// whose normals of lanes first + j (j < n_real) times scale are added
// next; stim: [batch, n] rows stim_stride apart (0: one row), or null;
// finite: [batch] bytes, or null for no flag.  block and grid_x are the
// wrapper's plan (kernels.autotune.choose_block_elementwise); a block the
// source is not compiled for is refused.
int izhikevich_step_f32(const float* v, const float* u,
                        const float* const* currents, int n_currents,
                        const uint32_t* keys, long long key_stride,
                        float scale, int first, int n_real,
                        const float* stim, long long stim_stride,
                        const float* a, const float* b, const float* c,
                        const float* d, float* v_out, float* u_out,
                        uint8_t* spiked_out, uint8_t* finite, int batch,
                        int n, float dt, int block, int grid_x,
                        void* stream) {
  if (grid_x <= 0 || batch < 0 || n < 0 || n_currents < 0 ||
      n_currents > kMaxCurrents || stim_stride < 0 ||
      (keys != nullptr && (key_stride < 2 || first < 0 || n_real < 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Currents cur{};
  for (int k = 0; k < n_currents; ++k) cur.p[k] = currents[k];
  cur.count = n_currents;
  const Drive drive{keys, key_stride, scale, first, n_real};
  return static_cast<int>(kinfo::with_block(block, [&](auto bs) {
    constexpr int B = decltype(bs)::value;
    if (batch == 0 || n == 0) return cudaSuccess;
    const dim3 grid(grid_x, batch);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define IZK(D, K)                                                  \
  izhikevich_step_kernel<B, D, K><<<grid, B, 0, st>>>(             \
      v, u, cur, drive, stim, stim_stride, a, b, c, d, v_out, u_out, \
      spiked_out, finite, n, dt)
    if (keys != nullptr) {
      if (n_currents == 2) IZK(true, 2); else IZK(true, -1);
    } else {
      if (n_currents == 1) IZK(false, 1); else IZK(false, -1);
    }
#undef IZK
    return cudaGetLastError();
  }));
}

// v, m, h, n, isyn and the outputs: [batch, n_neurons] (above_out bytes);
// finite: [batch] bytes, or null for no flag; inv_c as in HHParams.  block
// and grid_x as above.
int hh_step_f32(const float* v, const float* m, const float* h,
                const float* n, const float* isyn, float* v_out,
                float* m_out, float* h_out, float* n_out, uint8_t* above_out,
                uint8_t* finite, int batch, int n_neurons, float dt,
                int substeps, float gNa, float ENa, float gK, float EK,
                float gl, float El, float inv_c, int block, int grid_x,
                void* stream) {
  if (grid_x <= 0 || batch < 0 || n_neurons < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(kinfo::with_block(block, [&](auto bs) {
    if (batch == 0 || n_neurons == 0) return cudaSuccess;
    hh_step_kernel<decltype(bs)::value>
        <<<dim3(grid_x, batch), decltype(bs)::value, 0,
           static_cast<cudaStream_t>(stream)>>>(
            v, m, h, n, isyn, v_out, m_out, h_out, n_out, above_out, finite,
            n_neurons, dt, substeps,
            HHParams{gNa, ENa, gK, EK, gl, El, inv_c});
    return cudaGetLastError();
  }));
}

KINFO_NAMES(neuron_step, "izhikevich_step", "hh_step",
            "izhikevich_step.drive")

// kernels.autotune.kernel_attributes: which 0 izhikevich_step, 1 hh_step,
// 2 izhikevich_step.drive (the instance that draws a drive), each compiled
// for one of the blocks of kinfo::with_block.
int neuron_step_kernel_info(int which, int block, int query_block,
                            int dyn_smem, int* out) {
  return static_cast<int>(kinfo::with_block(block, [&](auto bs) {
    constexpr int B = decltype(bs)::value;
    const int q = query_block > 0 ? query_block : B;
    switch (which) {
      case 0:
        return static_cast<cudaError_t>(kinfo::kernel_info(
            izhikevich_step_kernel<B, false, 1>, q, dyn_smem, out));
      case 1:
        return static_cast<cudaError_t>(
            kinfo::kernel_info(hh_step_kernel<B>, q, dyn_smem, out));
      case 2:
        return static_cast<cudaError_t>(kinfo::kernel_info(
            izhikevich_step_kernel<B, true, 2>, q, dyn_smem, out));
      default:
        return cudaErrorInvalidValue;
    }
  }));
}

const char* neuron_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
