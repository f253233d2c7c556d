// What the wgmma MLP kernels share: the PE proposal nets' forward and
// recompute backward (fused_pe_mlp_fwd.cu, fused_pe_mlp_bwd.cu; the nets
// wider than 64 on the PE variants of fused_mlp_fwd.cu and
// fused_mlp_bwd.cu) and the vanilla field's heads' forward and backward
// (fused_mlp_fwd.cu, fused_mlp_bwd.cu).
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
constexpr int DLD = ENC_MAX + 4;       // row stride of the PE derivative tile (f32)

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

// ---- the PE nets' encoding and the epilogue of their dx

// Row er of a 64-row tile's encoding from its x, two threads a row (half 0
// the identity columns and the even frequencies, half 1 the odd ones):
// bf16 columns [x | sin(2^f x) | cos(2^f x)] (f-major blocks,
// ops/posenc.nerf_encoding's) into the chunk-major tile e, each pair by one
// sincosf (the accurate sinf/cosf, the same bits; |2^f x| reaches 2^8).
// With DERIV also each column's f32 d(encode)/d(pre) x 2^f into drow, and
// half 1 zeroes e's columns from the encoding's end up to zero_to.
template <bool DERIV>
__device__ __forceinline__ void pe_encode(bf16* e, float* drow, const float (&xr)[DIM], int er,
                                          int half, int F, int zero_to) {
  const int cos0 = DIM * (1 + F);
  if (half == 0) {
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      e[cm(er, d)] = __float2bfloat16_rn(xr[d]);
      if (DERIV) drow[d] = 1.0f;
    }
  } else {
    for (int c = DIM * (1 + 2 * F); c < zero_to; ++c) e[cm(er, c)] = __float2bfloat16_rn(0.0f);
  }
  for (int f = half; f < F; f += 2) {
    const float scale = (float)(1 << f);
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      float sn, cs;
      sincosf(xr[d] * scale, &sn, &cs);
      const int cs_ = DIM + f * DIM + d, cc = cos0 + f * DIM + d;
      e[cm(er, cs_)] = __float2bfloat16_rn(sn);
      e[cm(er, cc)] = __float2bfloat16_rn(cs);
      if (DERIV) {
        drow[cs_] = cs * scale;
        drow[cc] = -sn * scale;
      }
    }
  }
}

// Layer 0's f32 input gradient (v0, v1) at columns c, c + 1 of the tile's
// row r, times the derivatives of the tile dd (DLD floats a row) in their
// place; nothing past the encoding's enc_cols columns.
__device__ __forceinline__ void pe_dscale(float* dd, int r, int c, float v0, float v1,
                                          int enc_cols) {
  float* p = dd + r * DLD + c;
  if (c < enc_cols) p[0] = __fmul_rn(v0, p[0]);
  if (c + 1 < enc_cols) p[1] = __fmul_rn(v1, p[1]);
}

// dx [N, 3] of the tile's rows below n_rows: per row and coordinate the sum
// of its scaled columns in column order (identity, sines by frequency,
// cosines by frequency); t the thread in the warpgroup.
__device__ __forceinline__ void pe_dx(float* dx, const float* dd, long long row0,
                                      long long n_rows, int F, int t) {
  const int cos0 = DIM * (1 + F);
  for (int i = t; i < ROWS * DIM; i += 128) {
    const int k = i / ROWS, r = i % ROWS;
    const float* p = dd + r * DLD;
    float s = p[k];
    for (int f = 0; f < F; ++f) s = __fadd_rn(s, p[DIM + f * DIM + k]);
    for (int f = 0; f < F; ++f) s = __fadd_rn(s, p[cos0 + f * DIM + k]);
    if (row0 + r < n_rows) dx[(row0 + r) * DIM + k] = s;
  }
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
//
// The PE variant (fused_pe_mlp's nets wider than 64, hidden padded to 128
// or 256): x [N, 3] is encoded, two threads a row, into a chunk-major
// tile of kp columns (din = 3(1 + 2F) at most ENC_MAX), layer 0's A
// operand read from there, and the net is laid out as the heads' with
// that din.
__host__ __device__ constexpr int max_kb(int nl, int hwp) { return hwp == HW || nl == 3 ? 8 : 16; }

struct Layout {
  int din, kp, dout, nl, hw, xc;
  bool pe;
  __host__ __device__ Layout(int din_, int dout_, int nl_, int hw_, bool pe_ = false)
      : din(din_), kp((din_ + 15) & ~15), dout(dout_), nl(nl_), hw(hw_), xc(pe_ ? DIM : din_),
        pe(pe_) {}
  __host__ __device__ int fw_off(int l) const { return l == 0 ? 0 : kp * hw + (l - 1) * hw * hw; }
  __host__ __device__ int fwd_elems() const { return fw_off(nl - 1) + hw * OW; }
  __host__ __device__ int bw_off(int l) const { return fwd_elems() + fw_off(l); }
  __host__ __device__ int b_off(int l) const { return l * hw; }
  __host__ __device__ int n_bias() const { return (nl - 1) * hw + OW; }
  // a 64-row tile of x (xc columns: din, or a PE net's 3), of g (or the
  // output): contiguous rows
  __host__ __device__ int x_bytes() const { return ROWS * xc * 4; }
  __host__ __device__ int o_bytes() const { return ROWS * dout * 4; }
  // a 64-row chunk-major bf16 tile of a hidden layer, of layer 0's input
  __host__ __device__ int tile_bytes() const { return ROWS * hw * 2; }
  __host__ __device__ int in_bytes() const { return ROWS * kp * 2; }
  __host__ __device__ bool ok() const {
    const bool width = hw == 64 || hw == 128 || (hw == 256 && nl == 2);
    return width && din >= 1 && din <= 16 * max_kb(nl, hw) && dout >= 1 && dout <= OW &&
           (nl == 2 || nl == 3) && (!pe || (hw != HW && din <= ENC_MAX));
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

// As mma_cols, A a chunk-major 64-row tile in shared memory (a PE net's
// encoding).
template <int S>
__device__ __forceinline__ void mma_cols_s(float (&acc)[HW / 2], uint32_t a, uint32_t b,
                                           int width, int cb, int steps) {
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (s < steps)
      Wgmma<HW, 0, 0>::mma(acc, gmma_desc(a + s * 2048, 1024, 128),
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
// warpgroup a PE net's encoding tile, `ns` x stages, an output stage and
// the stages' barriers.
struct FwdSmem {
  int bias_at, wg_at, x_at, wg_bytes;
  __host__ __device__ FwdSmem(const Layout& L, int ns) {
    bias_at = L.fwd_elems() * 2;
    wg_at = al128(bias_at + L.n_bias() * 4);
    x_at = L.pe ? L.in_bytes() : 0;
    wg_bytes = x_at + ns * L.x_bytes() + L.o_bytes() + 128;
  }
  __host__ __device__ int total(int wgs) const { return wg_at + wgs * wg_bytes; }
};

// The backward's shared memory: both halves of the images and the biases,
// then per warpgroup `ns` stages of x and g tiles and the barriers; with
// weight gradients also the chunk-major tiles their products read (A_0,
// the hidden activations, the output cotangent, the hidden cotangents),
// and for a PE net its encoding as A_0 and the derivative tile; then, with
// weight gradients, the warps' bias-gradient rows.
struct BwdSmem {
  int bias_at, wg_at, stage_bytes, a0_at, ah_at, gl_at, gh_at, dd_at, bar_at, wg_bytes, n_bias;
  bool dw;
  __host__ __device__ BwdSmem(const Layout& L, bool dw_, int ns) : n_bias(L.n_bias()), dw(dw_) {
    bias_at = 2 * L.fwd_elems() * 2;
    wg_at = al128(bias_at + L.n_bias() * 4);
    stage_bytes = L.x_bytes() + L.o_bytes();
    int off = ns * stage_bytes;
    a0_at = off;
    if (dw || L.pe) off += L.in_bytes();
    ah_at = off;
    if (dw) off += (L.nl - 1) * L.tile_bytes();
    gl_at = off;
    if (dw) off += ROWS * OW * 2;
    gh_at = off;
    if (dw) off += (L.nl - 1) * L.tile_bytes();
    dd_at = off;
    if (L.pe) off += ROWS * DLD * 4;
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
