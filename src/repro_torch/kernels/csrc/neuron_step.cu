// Fused neuron updates on Hopper (sm_90a): GeNN's generated neuron kernels.
//
// Replaces the TPU kernels repro/kernels/izhikevich_step.py::
// izhikevich_step_pallas (body `_kernel`) and repro/kernels/hh_step.py::
// hh_step_pallas (body `_kernel`).  Each is one elementwise pass that keeps
// every intermediate of the update in registers, so the state makes one
// round trip through device memory per step instead of one per statement.
//
//   izhikevich_step_f32: two V half-steps, the U update, V clamped at 30,
//     spike = V >= 29.99, reset V = c, U += d where spiked.
//   hh_step_f32: Traub-Miles Hodgkin-Huxley, `substeps` Euler substeps of
//     dt / substeps, guarded vtrap (x / (exp(x) - 1), Taylor 1 - x/2 for
//     |x| <= 1e-4), gates clipped to [0, 1].
//
// Layout: the state is [batch, n] float32, row-major.  One thread per
// (batch member, neuron), in a grid-stride loop; the tail is masked by the
// index, so nothing is padded (the TPU form pads to 128-lane rows and sets
// the HH tail's V to -60 to keep its rates finite; a masked tail needs no
// such value).  Izhikevich's a..d are [n] arrays read with a batch stride
// of 0, one array for every member; HH's seven parameters are scalars
// passed by value, as the TPU kernel's are static.
//
// Arithmetic: the statements and their order are those of the codegen'd
// models (repro_torch/core/snn/neurons.py) and of the plain versions in
// repro_torch/kernels/ref.py: IEEE division, expf (no __expf), constants
// rounded from their double literals as PyTorch rounds a Python float,
// and the build turns off multiply-add contraction (-fmad=false in
// _build.py), so each operation rounds as PyTorch's eager ops do.  One
// difference stays: PyTorch on the card divides by a Python scalar (x / 5.0,
// x / C) as a product with its reciprocal, which can be an ulp off the true
// quotient that this kernel and PyTorch on the CPU compute.  Clamps
// are written as comparisons that pass a NaN through, as torch.clamp and
// jnp.clip do (fminf/fmaxf would drop it and hide a blow-up from the NaN
// guard).
//
// What bounds them on this card: memory.
//   * Izhikevich reads v, u, isyn (12 B per member) and a..d (16 B per
//     neuron, once across the batch; the other members' reads hit L2) and
//     writes v', u' and a spike byte (9 B per member): ~28 operations
//     against ~37 B at B = 1, far below the ~20 op/B at which the card's
//     float32 rate (67 TFLOP/s) would bind before its memory (3.35 TB/s).
//   * HH reads v, m, h, n, isyn and writes v, m, h, n: 36 B per member,
//     against ~440 operations over 5 substeps, 30 of them expf (~12 op/B,
//     counting an expf or a division as one).  Still under the ridge, so
//     bytes bind too, though an expf or a division costs several
//     instructions, so the instruction throughput may come close.
// The design answers the byte bound by fusing: the inputs are read once
// and the outputs written once.  At the main path's sizes (1e5 neurons,
// 0.4-4 MB) one launch moves less than its own launch latency's worth of
// bytes, so latency, not bandwidth, will set the measured time.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;          // grid-stride beyond this

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
  return fabsf(x) > kVtrapEps ? x / (expf(x) - 1.0f) : 1.0f - x / 2.0f;
}

__global__ void __launch_bounds__(kThreads)
izhikevich_step_kernel(const float* __restrict__ v_in,
                       const float* __restrict__ u_in,
                       const float* __restrict__ isyn_in,
                       const float* __restrict__ pa,
                       const float* __restrict__ pb,
                       const float* __restrict__ pc,
                       const float* __restrict__ pd,
                       float* __restrict__ v_out, float* __restrict__ u_out,
                       uint8_t* __restrict__ spiked_out, int n, float dt) {
  const long long row = static_cast<long long>(blockIdx.y) * n;
  const float hdt = kHalf * dt;
  for (int j = blockIdx.x * kThreads + threadIdx.x; j < n;
       j += gridDim.x * kThreads) {
    const long long i = row + j;
    float v = v_in[i];
    float u = u_in[i];
    const float isyn = isyn_in[i];
    // C and Python both group these products and sums from the left
    v = v + hdt * (kIzA * v * v + kIzB * v + kIzC - u + isyn);
    v = v + hdt * (kIzA * v * v + kIzB * v + kIzC - u + isyn);
    u = u + dt * pa[j] * (pb[j] * v - u);
    v = v > kVPeak ? kVPeak : v;
    const bool spiked = v >= kVThresh;
    v_out[i] = spiked ? pc[j] : v;
    u_out[i] = spiked ? u + pd[j] : u;
    spiked_out[i] = spiked;
  }
}

struct HHParams {
  float gNa, ENa, gK, EK, gl, El, C;
};

__global__ void __launch_bounds__(kThreads)
hh_step_kernel(const float* __restrict__ v_in, const float* __restrict__ m_in,
               const float* __restrict__ h_in, const float* __restrict__ n_in,
               const float* __restrict__ isyn_in, float* __restrict__ v_out,
               float* __restrict__ m_out, float* __restrict__ h_out,
               float* __restrict__ n_out, long long total, float dt,
               int substeps, HHParams p) {
  constexpr float k52 = 52.0, k25 = 25.0, k48 = 48.0, k50 = 50.0, k55 = 55.0;
  constexpr float k4 = 4.0, k5 = 5.0, k18 = 18.0, k40 = 40.0;
  constexpr float kAm = 1.28, kBm = 1.4, kAh = 0.128, kAn = 0.16, kBn = 0.5;
  const float hdt = dt / static_cast<float>(substeps);
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * kThreads) {
    float v = v_in[i], m = m_in[i], h = h_in[i], n = n_in[i];
    const float isyn = isyn_in[i];
    for (int s = 0; s < substeps; ++s) {
      const float i_na = m * m * m * h * p.gNa * (v - p.ENa);
      const float i_k = n * n * n * n * p.gK * (v - p.EK);
      const float imem = -(i_na + i_k + p.gl * (v - p.El) - isyn);
      v = v + hdt * imem / p.C;
      const float a_m = kAm * vtrap((-k52 - v) / k4);
      const float b_m = kBm * vtrap((v + k25) / k5);
      const float a_h = kAh * expf((-k48 - v) / k18);
      const float b_h = k4 / (expf((-k25 - v) / k5) + 1.0f);
      const float a_n = kAn * vtrap((-k50 - v) / k5);
      const float b_n = kBn * expf((-k55 - v) / k40);
      m = clip01(m + hdt * (a_m * (1.0f - m) - b_m * m));
      h = clip01(h + hdt * (a_h * (1.0f - h) - b_h * h));
      n = clip01(n + hdt * (a_n * (1.0f - n) - b_n * n));
    }
    v_out[i] = v;
    m_out[i] = m;
    h_out[i] = h;
    n_out[i] = n;
  }
}

int blocks_for(long long elements) {
  const long long b = (elements + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" {

// v, u, isyn, v_out, u_out, spiked_out: [batch, n]; a, b, c, d: [n].
int izhikevich_step_f32(const float* v, const float* u, const float* isyn,
                        const float* a, const float* b, const float* c,
                        const float* d, float* v_out, float* u_out,
                        uint8_t* spiked_out, int batch, int n, float dt,
                        void* stream) {
  if (batch == 0 || n == 0) return cudaSuccess;
  dim3 grid(blocks_for(n), batch);
  izhikevich_step_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      v, u, isyn, a, b, c, d, v_out, u_out, spiked_out, n, dt);
  return static_cast<int>(cudaGetLastError());
}

// every array: `total` = batch * n float32 values.
int hh_step_f32(const float* v, const float* m, const float* h,
                const float* n, const float* isyn, float* v_out,
                float* m_out, float* h_out, float* n_out, long long total,
                float dt, int substeps, float gNa, float ENa, float gK,
                float EK, float gl, float El, float C, void* stream) {
  if (total == 0) return cudaSuccess;
  hh_step_kernel<<<blocks_for(total), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      v, m, h, n, isyn, v_out, m_out, h_out, n_out, total, dt, substeps,
      HHParams{gNa, ENa, gK, EK, gl, El, C});
  return static_cast<int>(cudaGetLastError());
}

const char* neuron_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
