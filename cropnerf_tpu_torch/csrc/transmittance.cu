// Transmittance-weighted volume-rendering weights, forward only, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel cropnerf_tpu/ops/pallas/transmittance.py
// (_kernel, _inclusive_scan): per ray row of density and deltas [R, S],
//   tau_i = sigma_i delta_i,  w_i = (1 - e^{-tau_i}) e^{-(sum_{j<=i} tau_j - tau_i)},
// the same formula as ops/render.py render_weights (an inclusive scan, then
// the exclusive sum as the inclusive one minus tau_i).
//
// Bound on an H100: memory.  Each sample reads 8 bytes and writes 4 with ~20
// flops (two exponentials), far below the card's balance point.  Design: one
// warp per row, walking the row in 32-sample segments; lane l takes sample
// s0 + l, so every load and store is one coalesced 128-byte line per warp.
// A segment's inclusive scan is five __shfl_up_sync steps; the running total
// of the earlier segments (the last lane's inclusive sum, broadcast) is
// added to it, then each lane applies the exponentials to its own sample.
// Any R and S: rows past R exit, lanes past S are masked.  There is no tile
// constraint and no fallback.  expf is the accurate exponential.
#include <cuda_runtime.h>

namespace cropnerf {

constexpr int WARPS_PER_BLOCK = 8;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
render_weights_kernel(const float* __restrict__ density,
                      const float* __restrict__ deltas, float* __restrict__ weights,
                      long long n_rays, int n_samples) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= n_rays) return;                       // whole warps exit together
  const long long base = row * n_samples;
  float carry = 0.0f;                              // sum of tau before the segment
  for (int s0 = 0; s0 < n_samples; s0 += 32) {
    const int s = s0 + lane;
    const float tau = s < n_samples ? density[base + s] * deltas[base + s] : 0.0f;
    float incl = tau;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    const float accum = carry + incl;
    if (s < n_samples)
      weights[base + s] = (1.0f - expf(-tau)) * expf(-(accum - tau));
    carry += __shfl_sync(FULL, incl, 31);
  }
}

}  // namespace cropnerf

// Launches the kernel on `stream`; returns a cudaError_t (0 on success).
// density, deltas and weights are device pointers to row-major [n_rays,
// n_samples] float32.
extern "C" int cropnerf_render_weights(const float* density, const float* deltas,
                                       float* weights, long long n_rays,
                                       int n_samples, void* stream) {
  using namespace cropnerf;
  if (n_rays < 0 || n_samples < 0) return (int)cudaErrorInvalidValue;
  if (n_rays == 0 || n_samples == 0) return 0;
  const long long blocks = (n_rays + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  render_weights_kernel<<<(unsigned)blocks, WARPS_PER_BLOCK * 32, 0,
                          reinterpret_cast<cudaStream_t>(stream)>>>(
      density, deltas, weights, n_rays, n_samples);
  return (int)cudaGetLastError();
}
