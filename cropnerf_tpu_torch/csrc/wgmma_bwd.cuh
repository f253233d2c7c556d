// The recompute backward's register pieces of the wgmma MLP kernels that
// take weight gradients from operand tiles: K3's backward
// (fused_mlp_bwd.cu) and K5's wide backward (fused_pe_mlp_wide_bwd.cu).
// Accumulator and register A operand layouts as in wgmma_layers.cuh.
#pragma once

#include "wgmma_mlp.cuh"

namespace cropnerf {
namespace mlp {

__device__ __forceinline__ float bf_lo(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float bf_hi(uint32_t p) { return __uint_as_float(p & 0xffff0000u); }

// A warp's column sums of a thread's f32 sums over its lanes with the same
// columns (lane % 4), in a fixed shuffle order.
__device__ __forceinline__ float warp_colsum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// The output cotangent as the register A operand of G·W_lastᵀ (one k-step
// of 16 columns, zero past dout); with DB its f32 column sums over the
// warp's 16 rows added into the warp's bias row `brow`.
template <bool DB>
__device__ __forceinline__ void g_to_a(uint32_t (&a)[4], const float* t, int dout, float* brow,
                                       const Lane& ln) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = ln.cq + 8 * h;
    const float* p0 = t + ln.r0 * dout + c;
    const float* p1 = p0 + 8 * dout;
    const float u0 = c < dout ? p0[0] : 0.0f, u1 = c + 1 < dout ? p0[1] : 0.0f;
    const float w0 = c < dout ? p1[0] : 0.0f, w1 = c + 1 < dout ? p1[1] : 0.0f;
    a[2 * h] = bf16_pair(u0, u1);
    a[2 * h + 1] = bf16_pair(w0, w1);
    if (DB) {
      const float s0 = warp_colsum(u0 + w0), s1 = warp_colsum(u1 + w1);
      if (ln.lane < 4) {
        brow[c] += s0;
        brow[c + 1] += s1;
      }
    }
  }
}

// The cotangent of the layer below from acc = G·W_lᵀ: the relu mask of the
// bf16 activation `act` (the forward's A operand registers) applied in f32,
// rounded to the register A operand g of the next product; with DB the f32
// column sums over the warp's 16 rows added into the warp's bias row.
template <bool DB>
__device__ __forceinline__ void mask_to_g(uint32_t (&g)[HW / 16][4], const float (&acc)[HW / 2],
                                          const uint32_t (&act)[HW / 16][4], float* brow,
                                          const Lane& ln) {
#pragma unroll
  for (int s = 0; s < HW / 16; ++s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * s + h;
      const uint32_t m0 = act[s][2 * h], m1 = act[s][2 * h + 1];
      const float v0 = bf_lo(m0) > 0.0f ? acc[4 * j] : 0.0f;
      const float v1 = bf_hi(m0) > 0.0f ? acc[4 * j + 1] : 0.0f;
      const float v2 = bf_lo(m1) > 0.0f ? acc[4 * j + 2] : 0.0f;
      const float v3 = bf_hi(m1) > 0.0f ? acc[4 * j + 3] : 0.0f;
      g[s][2 * h] = bf16_pair(v0, v1);
      g[s][2 * h + 1] = bf16_pair(v2, v3);
      if (DB) {
        const float s0 = warp_colsum(v0 + v2), s1 = warp_colsum(v1 + v3);
        if (ln.lane < 4) {
          brow[8 * j + ln.cq] += s0;
          brow[8 * j + ln.cq + 1] += s1;
        }
      }
    }
  }
}

// Block cb of the cotangent of the layer below, from acc = G·W_lᵀ over
// that block's 64 columns: as mask_to_g, into k-steps 4cb .. 4cb + 3 of g,
// the relu mask read from the same k-steps of the bf16 activation `act`
// and the bias sums added at brow's columns 64cb ...
template <bool DB, int S>
__device__ __forceinline__ void mask_block(uint32_t (&g)[S][4], int cb,
                                           const float (&acc)[HW / 2],
                                           const uint32_t (&act)[S][4], float* brow,
                                           const Lane& ln) {
  uint32_t blk[HW / 16][4], m[HW / 16][4];
#pragma unroll
  for (int s = 0; s < HW / 16; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) m[s][i] = act[4 * cb + s][i];
  mask_to_g<DB>(blk, acc, m, brow + cb * HW, ln);
#pragma unroll
  for (int s = 0; s < HW / 16; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) g[4 * cb + s][i] = blk[s][i];
}

// One 16-column step s of a register A operand into a chunk-major tile.
__device__ __forceinline__ void store_step(bf16* t, int s, const uint32_t (&a)[4],
                                           const Lane& ln) {
  const int c = 16 * s + ln.cq;
  *reinterpret_cast<uint32_t*>(t + cm(ln.r0, c)) = a[0];
  *reinterpret_cast<uint32_t*>(t + cm(ln.r0 + 8, c)) = a[1];
  *reinterpret_cast<uint32_t*>(t + cm(ln.r0, c + 8)) = a[2];
  *reinterpret_cast<uint32_t*>(t + cm(ln.r0 + 8, c + 8)) = a[3];
}

// The register A operand of a 64-column chunk-major tile (the inverse of
// store_tile).
__device__ __forceinline__ void load_tile(uint32_t (&a)[HW / 16][4], const bf16* t,
                                          const Lane& ln) {
#pragma unroll
  for (int s = 0; s < HW / 16; ++s) {
    const int c = 16 * s + ln.cq;
    a[s][0] = *reinterpret_cast<const uint32_t*>(t + cm(ln.r0, c));
    a[s][1] = *reinterpret_cast<const uint32_t*>(t + cm(ln.r0 + 8, c));
    a[s][2] = *reinterpret_cast<const uint32_t*>(t + cm(ln.r0, c + 8));
    a[s][3] = *reinterpret_cast<const uint32_t*>(t + cm(ln.r0 + 8, c + 8));
  }
}

template <int N>
__device__ __forceinline__ void store_tile(bf16* t, const uint32_t (&a)[N][4], int steps,
                                           const Lane& ln) {
#pragma unroll
  for (int s = 0; s < N; ++s)
    if (s < steps) store_step(t, s, a[s], ln);
}

// row[i·n + c] (=, or += unless `first`) the accumulators of a 64 x n
// weight gradient (rows r0, r0 + 8 and columns 8j + cq (+1) of the thread;
// a block of a wider row where n is the row's width).
template <int R>
__device__ __forceinline__ void add_rows(float* row, int n, const float (&v)[R], bool first,
                                         const Lane& ln) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* p = row + (ln.r0 + 8 * h) * n + 8 * j + ln.cq + e;
        const float x = v[4 * j + 2 * h + e];
        *p = first ? x : *p + x;
      }
    }
  }
}

}  // namespace mlp
}  // namespace cropnerf
