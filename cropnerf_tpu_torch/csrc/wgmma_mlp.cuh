// What the wgmma MLP kernels share: the PE proposal nets' forward and
// recompute backward (fused_pe_mlp_fwd.cu, fused_pe_mlp_bwd.cu) and the
// vanilla field's heads' forward and backward (fused_mlp_fwd.cu,
// fused_mlp_bwd.cu).
//
// A net of NL layers is padded to hidden width HW (the heads' nets: HWP,
// a multiple of HW) and output width OW and kept in shared memory as
// weight images (ops/cuda/fused_mlp.py
// mlp_images, ops/cuda/fused_pe_field.py pe_mlp_images): first every
// layer's forward image (element (k, n) of the [K, width] weight at
// (k/8)·width·8 + n·8 + k%8, the K-major core matrices of a wgmma B
// operand), then the backward's input-gradient images of Wᵀ (element
// (n, k) at (n/8)·K·8 + k·8 + n%8); the biases padded alike, layer after
// layer.  K is HW for every layer of the PE nets, HWP for the heads'
// hidden and last layers; the heads' layer 0 takes the padded input width
// KP.  A
// warpgroup works on 64-row tiles, kept chunk-major where they are
// operands in shared memory (wgmma_layers.cuh), and feeds each hidden
// layer's bf16 activations to the next product from registers.
#pragma once

#include <cuda_bf16.h>

#include "wgmma_layers.cuh"

namespace cropnerf {
namespace pemlp {

using bf16 = __nv_bfloat16;

constexpr int ROWS = 64;               // rows of a tile (a warpgroup's)
constexpr int HW = 64;                 // hidden width, padded
constexpr int OW = 16;                 // output width, padded
constexpr int DIM = 3;                 // coordinates of x (the PE nets)
constexpr int ENC_MAX = 64;            // encoding columns, padded
constexpr int CHUNK = 512;             // elements of an 8-column chunk
constexpr int TILE_BYTES = ROWS * HW * 2;

__host__ __device__ constexpr int al128(int b) { return (b + 127) & ~127; }

// The padded layers of a PE net of NL layers in the weight images.
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

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A of the next product from a 64-column accumulator: bf16(relu(acc + b)),
// four registers for each 16 columns.
__device__ __forceinline__ void relu_to_a(uint32_t (&a)[HW / 16][4], const float (&acc)[HW / 2],
                                          const float* b, const Lane& ln) {
#pragma unroll
  for (int s = 0; s < HW / 16; ++s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * s + h, c = 8 * j + ln.cq;
      const float b0 = b[c], b1 = b[c + 1];
      a[s][2 * h] = bf16_pair(fmaxf(acc[4 * j] + b0, 0.0f), fmaxf(acc[4 * j + 1] + b1, 0.0f));
      a[s][2 * h + 1] =
          bf16_pair(fmaxf(acc[4 * j + 2] + b0, 0.0f), fmaxf(acc[4 * j + 3] + b1, 0.0f));
    }
  }
}

// acc (=) A·B over K = HW with A in registers, B a weight image of N columns.
template <int N>
__device__ __forceinline__ void mma_regs(float (&acc)[N / 2], const uint32_t (&a)[HW / 16][4],
                                         uint32_t b) {
#pragma unroll
  for (int s = 0; s < HW / 16; ++s)
    WgmmaRA<N, 0>::mma(acc, a[s], gmma_desc(b + 2 * s * N * 16, N * 16, 128), s > 0 ? 1 : 0);
}

// dw += Aᵀ·G over the tile's 64 rows: A [64 rows, 64 columns] and G [64
// rows, N columns] chunk-major, both MN-major operands.
template <int N>
__device__ __forceinline__ void mma_dw(float (&dw)[N / 2], uint32_t a, uint32_t g) {
#pragma unroll
  for (int k = 0; k < ROWS; k += 16) {
    const uint64_t da = gmma_desc(a + (k >> 3) * 128, 128, 1024);
    const uint64_t dg = gmma_desc(g + (k >> 3) * 128, 128, 1024);
    Wgmma<N, 1, 1>::mma(dw, da, dg, 1);
  }
}

}  // namespace pemlp

namespace mlp {

using namespace pemlp;

// The heads' nets (fused_mlp): x [N, din] through NL layers, every hidden
// layer padded to HWP (64, 128 or 256 columns: the host's
// ops/cuda/fused_mlp.py mlp_hidden_pad), dout padded to OW, layer 0
// taking kp = din padded to 16.  A wide layer runs in blocks of HW = 64
// columns, each a wgmma m64n64 product.  The weight images: forward images
// of layers 0 .. NL-1, then the input-gradient images in the same order
// and sizes.  Layer 0's A operand stays in registers, max_kb 16-column
// k-steps of it: 8 (din up to 128) for the 64-wide nets and every 3-layer
// net, 16 (din up to 256) for the wider 2-layer nets.  No 3-layer net 256
// wide fits shared memory.
__host__ __device__ constexpr int max_kb(int nl, int hwp) { return hwp == HW || nl == 3 ? 8 : 16; }

struct Layout {
  int din, kp, dout, nl, hw;
  __host__ __device__ Layout(int din_, int dout_, int nl_, int hw_)
      : din(din_), kp((din_ + 15) & ~15), dout(dout_), nl(nl_), hw(hw_) {}
  __host__ __device__ int fw_off(int l) const { return l == 0 ? 0 : kp * hw + (l - 1) * hw * hw; }
  __host__ __device__ int fwd_elems() const { return fw_off(nl - 1) + hw * OW; }
  __host__ __device__ int bw_off(int l) const { return fwd_elems() + fw_off(l); }
  __host__ __device__ int b_off(int l) const { return l * hw; }
  __host__ __device__ int n_bias() const { return (nl - 1) * hw + OW; }
  // a 64-row tile of x, of g (or the output): contiguous rows
  __host__ __device__ int x_bytes() const { return ROWS * din * 4; }
  __host__ __device__ int o_bytes() const { return ROWS * dout * 4; }
  // a 64-row chunk-major bf16 tile of a hidden layer
  __host__ __device__ int tile_bytes() const { return ROWS * hw * 2; }
  __host__ __device__ bool ok() const {
    const bool width = hw == 64 || hw == 128 || (hw == 256 && nl == 2);
    return width && din >= 1 && din <= 16 * max_kb(nl, hw) && dout >= 1 && dout <= OW &&
           (nl == 2 || nl == 3);
  }
};

// Columns c, c + 1 of row r of a row-major f32 tile of `din` columns as a
// bf16 pair, zero past din.
__device__ __forceinline__ uint32_t x_pair(const float* t, int r, int c, int din) {
  const float* p = t + r * din + c;
  return bf16_pair(c < din ? p[0] : 0.0f, c + 1 < din ? p[1] : 0.0f);
}

// Layer 0's register A operand from a row-major f32 tile: k-step s holds
// columns 16s .. 16s + 15 of the calling thread's rows.
template <int KB>
__device__ __forceinline__ void x_to_a(uint32_t (&a)[KB][4], const float* t, int din, int kb,
                                       const Lane& ln) {
#pragma unroll
  for (int s = 0; s < KB; ++s) {
    if (s < kb) {
      const int c = 16 * s + ln.cq;
      a[s][0] = x_pair(t, ln.r0, c, din);
      a[s][1] = x_pair(t, ln.r0 + 8, c, din);
      a[s][2] = x_pair(t, ln.r0, c + 8, din);
      a[s][3] = x_pair(t, ln.r0 + 8, c + 8, din);
    }
  }
}

// acc (=) A·B over columns 64cb .. 64cb + 63 of B: A in registers, its
// first `steps` 16-column k-steps; B a weight image (K-major core
// matrices) `width` columns wide.
template <int S>
__device__ __forceinline__ void mma_cols(float (&acc)[HW / 2], const uint32_t (&a)[S][4],
                                         uint32_t b, int width, int cb, int steps = S) {
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (s < steps)
      WgmmaRA<HW, 0>::mma(acc, a[s],
                          gmma_desc(b + 2 * s * width * 16 + cb * 1024, width * 16, 128),
                          s > 0 ? 1 : 0);
}

// acc (+)= A·B over rows 64cb .. 64cb + 63 of the last layer's [hw, OW]
// image B: the share of the hidden block cb, A its bf16 activations in
// registers; block 0 overwrites acc.
__device__ __forceinline__ void mma_out(float (&acc)[OW / 2], const uint32_t (&a)[HW / 16][4],
                                        uint32_t b, int cb) {
#pragma unroll
  for (int s = 0; s < HW / 16; ++s)
    WgmmaRA<OW, 0>::mma(acc, a[s], gmma_desc(b + 2 * (4 * cb + s) * OW * 16, OW * 16, 128),
                        cb > 0 || s > 0 ? 1 : 0);
}

// Block cb of a hidden layer's activation, bf16(relu(acc + b[64cb ..])),
// into k-steps 4cb .. 4cb + 3 of the register A operand a.
template <int S>
__device__ __forceinline__ void relu_block(uint32_t (&a)[S][4], int cb, const float (&acc)[HW / 2],
                                           const float* b, const Lane& ln) {
  uint32_t blk[HW / 16][4];
  relu_to_a(blk, acc, b + cb * HW, ln);
#pragma unroll
  for (int s = 0; s < HW / 16; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[4 * cb + s][i] = blk[s][i];
}

// Rows of a ragged or unaligned tile by ordinary loads, zero past N.
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long row0, int cols,
                                          long long n_rows, const Lane& ln) {
  for (int i = ln.t; i < ROWS * cols; i += 128)
    dst[i] = row0 + i / cols < n_rows ? __ldg(src + row0 * cols + i) : 0.0f;
}

// The forward's shared memory: the forward images and biases, then per
// warpgroup `ns` x stages, an output stage and the stages' barriers.
struct FwdSmem {
  int bias_at, wg_at, wg_bytes;
  __host__ __device__ FwdSmem(const Layout& L, int ns) {
    bias_at = L.fwd_elems() * 2;
    wg_at = al128(bias_at + L.n_bias() * 4);
    wg_bytes = ns * L.x_bytes() + L.o_bytes() + 128;
  }
  __host__ __device__ int total(int wgs) const { return wg_at + wgs * wg_bytes; }
};

// The backward's shared memory: both halves of the images and the biases,
// then per warpgroup `ns` stages of x and g tiles and the barriers; with
// weight gradients also the chunk-major tiles their products read (A_0,
// the hidden activations, the output cotangent, the hidden cotangents);
// then, with weight gradients, the warps' bias-gradient rows.
struct BwdSmem {
  int bias_at, wg_at, stage_bytes, a0_at, ah_at, gl_at, gh_at, bar_at, wg_bytes, n_bias;
  bool dw;
  __host__ __device__ BwdSmem(const Layout& L, bool dw_, int ns) : n_bias(L.n_bias()), dw(dw_) {
    bias_at = 2 * L.fwd_elems() * 2;
    wg_at = al128(bias_at + L.n_bias() * 4);
    stage_bytes = L.x_bytes() + L.o_bytes();
    int off = ns * stage_bytes;
    a0_at = off;
    if (dw) off += ROWS * L.kp * 2;
    ah_at = off;
    if (dw) off += (L.nl - 1) * L.tile_bytes();
    gl_at = off;
    if (dw) off += ROWS * OW * 2;
    gh_at = off;
    if (dw) off += (L.nl - 1) * L.tile_bytes();
    bar_at = off;
    wg_bytes = al128(off + 8 * ns);
  }
  __host__ __device__ int bsum_at(int wgs) const { return wg_at + wgs * wg_bytes; }
  __host__ __device__ int total(int wgs) const {
    return bsum_at(wgs) + (dw ? wgs * 4 * n_bias * 4 : 0);
  }
};

constexpr int MAX_SMEM = 232448;       // dynamic shared memory a block may use

// The stages of a warpgroup of a kernel of padded width HWP: two, a
// constant, for the 64-wide nets (a count known only at run time costs
// their kernels a spill at 128 registers), else the launch's.
template <int HWP>
__device__ __forceinline__ int stages(int ns) { return HWP == HW ? 2 : ns; }

// (warpgroups, stages) of a kernel of padded width hw whose shared memory
// is smem(wgs, ns): the most warpgroups up to max_wgs with two stages
// each; wider than 64, one warpgroup takes up to max_ns stages where they
// fit, and one stage where two do not.  (0, 0) where nothing fits.
template <class F>
__host__ int2 plan_blocks(const F& smem, int hw, int max_wgs, int max_ns) {
  for (int wgs = max_wgs; wgs >= 1; --wgs) {
    if (smem(wgs, 2) > MAX_SMEM) continue;
    int ns = 2;
    if (wgs == 1 && hw != HW)
      while (ns < max_ns && smem(1, ns + 1) <= MAX_SMEM) ++ns;
    return make_int2(wgs, ns);
  }
  return hw != HW && smem(1, 1) <= MAX_SMEM ? make_int2(1, 1) : make_int2(0, 0);
}

}  // namespace mlp
}  // namespace cropnerf
