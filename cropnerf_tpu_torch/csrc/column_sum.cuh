// The fixed-order column sum that reduces the backward kernels' partial
// rows (weight and bias gradients) without atomics, so two runs give the
// same bits.
#pragma once

#include <cuda_runtime.h>

namespace cropnerf {

constexpr int SUM_THREADS = 256;

// dst[c] = sum_r src[r, c], r in order.
__global__ void column_sum_kernel(const float* __restrict__ src, long long rows,
                                  long long cols, float* __restrict__ dst) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float s = 0.0f;
  for (long long r = 0; r < rows; ++r) s += src[r * cols + c];
  dst[c] = s;
}

// Launches column_sum_kernel over `cols` columns; returns a cudaError_t.
inline int column_sum(const float* src, long long rows, long long cols, float* dst,
                      cudaStream_t s) {
  column_sum_kernel<<<(unsigned)((cols + SUM_THREADS - 1) / SUM_THREADS), SUM_THREADS, 0,
                      s>>>(src, rows, cols, dst);
  return (int)cudaGetLastError();
}

}  // namespace cropnerf
