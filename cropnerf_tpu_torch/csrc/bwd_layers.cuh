// Pieces of the fused MLP's recompute-backward kernels for Hopper (sm_90a)
// (fused_mlp.cu); the fused PE field's backward (fused_pe_field_bwd.cu)
// takes only column_sum from here.
//
// Layout as in fused_layers.cuh: a block owns a tile of TILE rows, each warp
// one 16-row strip.  A layer's input gradient g·Wᵀ runs on the tensor cores
// with Wᵀ staged column-major in KS-wide slabs of shared memory; its
// epilogue returns the f32 value that feeds a bias-gradient column sum,
// which is taken over each warp's strip with a fixed shuffle tree and then
// over the warps in order, so two runs give the same bits.
#pragma once

#include "fused_layers.cuh"

namespace cropnerf {

constexpr int LDB = KS + PAD;          // staged Wᵀ slab: cw rows of KS
constexpr int SUM_THREADS = 256;

// Bytes of a staged Wᵀ slab for input widths up to `width`.
__host__ __device__ inline int wt_slab_bytes(int width) { return align128(width * LDB * 2); }

// The calling lane holds 8 values of row (lane >> 1), columns c .. c+7 of
// its warp's 16-row strip; sums them over the strip's rows (a fixed
// shuffle tree) into the warp's row of colsum.
__device__ __forceinline__ void strip_colsum(float (&s)[8], float* colsum, int c) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int o = 2; o < 32; o <<= 1) s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
  }
  if (lane < 2) {
#pragma unroll
    for (int j = 0; j < 8; ++j) colsum[warp * MAX_WIDTH + c + j] = s[j];
  }
}

// Sums the warps' column sums of n columns, in warp order, into out (a
// tile's bias gradient), or adds them to it with `accumulate`.  A null out
// only synchronises.
__device__ __forceinline__ void flush_colsum(const float* colsum, int n, float* out,
                                             bool accumulate = false) {
  __syncthreads();
  if (out != nullptr) {
    for (int c = threadIdx.x; c < n; c += THREADS) {
      float s = 0.0f;
      for (int w = 0; w < WARPS; ++w) s += colsum[w * MAX_WIDTH + c];
      out[c] = accumulate ? out[c] + s : s;
    }
  }
  __syncthreads();
}

// epi(r, c, src(r, c)) over the warp's 16-row strip and n columns, in the
// lane layout of the products' epilogue.
template <class Src, class Epi>
__device__ __forceinline__ void strip_apply(int n, const Src& src, const Epi& epi,
                                            float* colsum) {
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = warp * 16 + (lane >> 1);
  const int c0 = (lane & 1) * 8;
  for (int f = 0; f < (n >> 4); ++f) {
    float s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = f * 16 + c0 + j;
      s[j] = epi(r, c, src(r, c));
    }
    if (Epi::kColsum) strip_colsum(s, colsum, f * 16 + c0);
  }
  __syncwarp();
}

// out[r, c] = sum_j gb[r, j] · W[c_lo + c, j] for c < cw, j < L.n: the
// input gradient g·Wᵀ of layer L over rows [c_lo, c_lo + cw) of its packed
// [k, n] weight.  Wᵀ is staged column-major in KS-wide slabs, read as a
// col_major wmma operand.  NF bounds the output's 16-column fragments
// (cw <= 16 * NF).  Every thread of the block calls it.
template <int NF, class Epi>
__device__ __forceinline__ void grad_input(
    const bf16* gb, int ldg, const bf16* __restrict__ wbuf, const LayerDesc L,
    int c_lo, int cw, bf16* wslab, float* scratch, float* colsum,
    const Epi& epi) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nfrag = cw >> 4;
  const bf16* w = wbuf + L.w_off;
  const bf16* gw = gb + warp * 16 * ldg;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.0f);

  constexpr int VEC = KS / 8;              // 16-byte vectors per staged row
  for (int j0 = 0; j0 < L.n; j0 += KS) {
    const int js = min(KS, L.n - j0);
    __syncthreads();                         // slab free; prior writes visible
    for (int v = threadIdx.x; v < cw * VEC; v += THREADS) {
      const int c = v / VEC;
      const int q = v - c * VEC;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (q * 8 < js)
        val = __ldg(reinterpret_cast<const uint4*>(
            w + (size_t)(c_lo + c) * L.n + j0 + q * 8));
      *reinterpret_cast<uint4*>(wslab + c * LDB + q * 8) = val;
    }
    __syncthreads();
    for (int kk = 0; kk < js; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, gw + j0 + kk, ldg);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        if (f < nfrag) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
          wmma::load_matrix_sync(bfr, wslab + f * 16 * LDB + kk, LDB);
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
      float s[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        s[j] = epi(warp * 16 + r, f * 16 + c0 + j, sc[r * 16 + c0 + j]);
      if (Epi::kColsum) strip_colsum(s, colsum, f * 16 + c0);
      __syncwarp();
    }
  }
}

struct SetF32 {
  static constexpr bool kColsum = false;
  float* dst;
  int ld;
  __device__ __forceinline__ float operator()(int r, int c, float v) const {
    dst[r * ld + c] = v;
    return 0.0f;
  }
};

struct AddF32 {
  static constexpr bool kColsum = false;
  float* dst;
  int ld;
  __device__ __forceinline__ float operator()(int r, int c, float v) const {
    dst[r * ld + c] += v;
    return 0.0f;
  }
};

struct ToRows {        // f32 into rows [row0, row0 + TILE) of [n_rows, cols]
  static constexpr bool kColsum = false;
  float* out;
  int cols;
  long long row0, n_rows;
  __device__ __forceinline__ float operator()(int r, int c, float v) const {
    if (c < cols && row0 + r < n_rows) out[(row0 + r) * cols + c] = v;
    return 0.0f;
  }
};

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
