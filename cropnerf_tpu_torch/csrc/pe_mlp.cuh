// The geometry both kernels of the PE proposal nets (fused_pe_mlp) share:
// the forward (fused_pe_mlp_fwd.cu) and the recompute backward
// (fused_pe_mlp_bwd.cu).
//
// A net of NL layers is padded to hidden width HW and output width OW and
// kept in shared memory as the weight images of ops/cuda/fused_pe_field.py
// pe_mlp_images: first every layer's forward image (element (k, n) of the
// [HW, width] weight at (k/8)·width·8 + n·8 + k%8, the K-major core
// matrices of a wgmma B operand), then the backward's input-gradient images
// of Wᵀ; the biases padded alike, layer after layer.  A warpgroup works on
// 64-row tiles kept chunk-major (wgmma_layers.cuh).
#pragma once

#include <cuda_bf16.h>

#include "wgmma_layers.cuh"

namespace cropnerf {
namespace pemlp {

using bf16 = __nv_bfloat16;

constexpr int ROWS = 64;               // rows of a tile (a warpgroup's)
constexpr int HW = 64;                 // hidden width, padded
constexpr int OW = 16;                 // output width, padded
constexpr int DIM = 3;                 // coordinates of x
constexpr int ENC_MAX = 64;            // encoding columns, padded
constexpr int CHUNK = 512;             // elements of an 8-column chunk
constexpr int TILE_BYTES = ROWS * HW * 2;

__host__ __device__ constexpr int al128(int b) { return (b + 127) & ~127; }

// The padded layers of a net of NL layers in the weight images.
template <int NL>
struct Net {
  __host__ __device__ static constexpr int width(int l) { return l == NL - 1 ? OW : HW; }
  __host__ __device__ static constexpr int w_off(int l) { return l * HW * HW; }  // [HW, width]
  __host__ __device__ static constexpr int b_off(int l) { return l * HW; }
  static constexpr int TOTAL_W = (NL - 1) * HW * HW + HW * OW;
  static constexpr int TOTAL_B = (NL - 1) * HW + OW;
};

// Element (r, c) of a chunk-major 64-row tile.
__device__ __forceinline__ int cm(int r, int c) { return (c >> 3) * CHUNK + r * 8 + (c & 7); }

// The calling thread's place: its thread in the warpgroup, warpgroup, warp
// and lane, and the accumulator rows r0, r0 + 8 and first column cq it
// holds (wgmma_layers.cuh).
struct Lane {
  int t, wg, warp, lane, r0, cq;
  __device__ Lane() {
    t = threadIdx.x & 127;
    wg = threadIdx.x >> 7;
    warp = t >> 5;
    lane = t & 31;
    r0 = warp * 16 + (lane >> 2);
    cq = 2 * (lane & 3);
  }
};

// acc (=) A·B: A a chunk-major 64-row tile (K-major), B a weight image of N
// columns (K-major core matrices), k < K.
template <int N>
__device__ __forceinline__ void mma_k(float (&acc)[N / 2], uint32_t a, uint32_t b, int K) {
  for (int k = 0; k < K; k += 16) {
    const uint64_t da = gmma_desc(a + (k >> 3) * 1024, 1024, 128);
    const uint64_t db = gmma_desc(b + (k >> 3) * N * 16, N * 16, 128);
    Wgmma<N, 0, 0>::mma(acc, da, db, k > 0 ? 1 : 0);
  }
}

}  // namespace pemlp
}  // namespace cropnerf
