// Shared pieces of the fused MLP kernels for Hopper (sm_90a).
//
// A block owns a tile of TILE rows (samples).  Every activation of the tile
// lives in shared memory as bf16; each of the WARPS warps owns one 16-row
// strip of it for the whole network, so a warp only ever reads the rows it
// wrote and activations need no block barrier.  Weights are packed by the
// Python wrapper into one bf16 buffer, every matrix zero-padded to multiples
// of 16 in both dims, and stream from global memory (L2-resident: the
// flagship trunk is ~0.86 MB) in K-slabs of KS rows staged in shared memory,
// which the block's warps share.  Products are nvcuda::wmma 16x16x16 bf16
// with f32 accumulators; the epilogue adds the f32 bias and either applies
// relu and rounds to bf16 back into shared memory, or writes f32 to the
// output.  These are the rounding points of the JAX kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace cropnerf {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int TILE = 128;              // rows per block
constexpr int WARPS = TILE / 16;       // one 16-row strip per warp
constexpr int THREADS = WARPS * 32;
constexpr int KS = 32;                 // weight rows staged per slab
constexpr int MAXF = 16;               // 16-col output fragments per warp
constexpr int MAX_WIDTH = MAXF * 16;   // widest padded layer output
constexpr int PAD = 8;                 // bf16 row padding against bank conflicts
constexpr int MAX_LAYERS = 32;
constexpr int SCRATCH_BYTES = WARPS * 16 * 16 * 4;

// One dense layer.  Its input is the concatenation [A0 | A1] of two shared
// memory activations: the first `ka` columns come from A0 and the rest from
// A1 (a plain layer has ka == k).  w_off/b_off index the packed buffers; k
// and n are the padded input and output widths.
struct LayerDesc {
  int w_off, b_off, k, n, ka;
};

__host__ __device__ inline int align128(int bytes) { return (bytes + 127) & ~127; }
__host__ __device__ inline int act_bytes(int width) { return align128(TILE * (width + PAD) * 2); }
__host__ __device__ inline int slab_bytes(int width) { return align128(KS * (width + PAD) * 2); }

// Epilogue: optional relu, round to bf16, store into a shared activation.
struct ToSmem {
  bf16* dst;
  int ld;
  bool relu;
  __device__ __forceinline__ void operator()(int r, int c, float v) const {
    dst[r * ld + c] = __float2bfloat16_rn(relu ? fmaxf(v, 0.0f) : v);
  }
};

// Epilogue: f32 into rows [row0, row0 + TILE) of a row-major [n_rows, cols]
// output (the ragged tail and the padded columns are masked), plus an
// optional bf16 copy into shared memory.
struct ToGlobal {
  float* out;
  int cols;
  long long row0, n_rows;
  bf16* copy;
  int ld_copy;
  __device__ __forceinline__ void operator()(int r, int c, float v) const {
    if (c < cols && row0 + r < n_rows) out[(row0 + r) * cols + c] = v;
    if (copy != nullptr) copy[r * ld_copy + c] = __float2bfloat16_rn(v);
  }
};

// out = [A0 | A1] @ W + b for the block's tile.  Every thread of the block
// must call it (it holds block barriers).  A0/A1 point at row 0 of their
// activations; the calling warp uses its own 16-row strip.  NF bounds the
// layer's 16-column output fragments (L.n <= 16 * NF); each warp holds NF
// accumulators, so a smaller NF frees registers for more resident blocks.
template <int NF, class Epi>
__device__ __forceinline__ void dense_layer(
    const bf16* a0, int lda0, const bf16* a1, int lda1,
    const bf16* __restrict__ wbuf, const float* __restrict__ bbuf,
    const LayerDesc L, bf16* wslab, float* scratch, const Epi& epi) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nfrag = L.n >> 4;
  const int ldw = L.n + PAD;
  const bf16* w = wbuf + L.w_off;
  const float* bias = bbuf + L.b_off;
  const bf16* a0w = a0 + warp * 16 * lda0;
  const bf16* a1w = a1 + warp * 16 * lda1;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.0f);

  const int vec_per_row = L.n >> 3;          // 16-byte vectors per row
  for (int k0 = 0; k0 < L.k; k0 += KS) {
    const int ks = min(KS, L.k - k0);
    __syncthreads();                         // slab free; prior writes visible
    for (int v = threadIdx.x; v < ks * vec_per_row; v += THREADS) {
      const int r = v / vec_per_row;
      const int q = v - r * vec_per_row;
      *reinterpret_cast<uint4*>(wslab + r * ldw + q * 8) = __ldg(
          reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * L.n + q * 8));
    }
    __syncthreads();
    for (int kk = 0; kk < ks; kk += 16) {
      const int kg = k0 + kk;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      if (kg < L.ka)
        wmma::load_matrix_sync(af, a0w + kg, lda0);
      else
        wmma::load_matrix_sync(af, a1w + (kg - L.ka), lda1);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        if (f < nfrag) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
          wmma::load_matrix_sync(bfr, wslab + kk * ldw + f * 16, ldw);
          wmma::mma_sync(acc[f], af, bfr, acc[f]);
        }
      }
    }
  }

  float* sc = scratch + warp * 256;
  const int r = lane >> 1;
  const int c0 = (lane & 1) * 8;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    if (f < nfrag) {
      wmma::store_matrix_sync(sc, acc[f], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = f * 16 + c0 + j;
        epi(warp * 16 + r, c, sc[r * 16 + c0 + j] + bias[c]);
      }
      __syncwarp();
    }
  }
}

// Reads the per-layer part of a meta array: 5 ints per layer.
inline bool parse_layers(const int* meta, int n_layers, LayerDesc* out) {
  if (n_layers < 1 || n_layers > MAX_LAYERS) return false;
  for (int i = 0; i < n_layers; ++i) {
    const int* m = meta + 5 * i;
    LayerDesc L{m[0], m[1], m[2], m[3], m[4]};
    if (L.k <= 0 || L.n <= 0 || L.k % 16 || L.n % 16 || L.ka % 16 ||
        L.ka <= 0 || L.ka > L.k || L.n > MAX_WIDTH || L.w_off % 8)
      return false;
    out[i] = L;
  }
  return true;
}

}  // namespace cropnerf
