// Fused positional-encoding NeRF field, backward, for Hopper (sm_90a): the
// trunk + colour and semantic heads, or the trunk alone.
//
// Replaces cropnerf_tpu/ops/pallas/fused_pe_field.py:_mega_bwd_kernel (the
// backward of fused_pe_nerf, wrapper _mega_bwd) and _bwd_kernel (the
// backward of fused_pe_density, wrapper _bwd).  Given x [N, dim], the
// extras [N, De] (heads only), the weights and the cotangents g_t [N, 1+G]
// (and g_rgb [N, 3], g_sem [N, C] with the heads), it returns dx [N, dim],
// dextras [N, De] and the float32 gradient of every weight and bias in the
// packed layout the forward reads (ops/cuda/common.py pack_layers).  A
// null dx skips dx; a program without the weight gradients (dx alone, the
// BayesRays pass) writes no workspace and no bias sums.
//
// Arithmetic, as the TPU kernels: the forward is recomputed in bf16 with f32
// sums at the forward's rounding points; the cotangent g stays f32 and is
// rounded to bf16 only as a product operand (the input gradient g·Wᵀ and
// the weight gradient Aᵀ·g); relu masks come from the bf16 activations; the
// bias gradient is the f32 column sum of g.  The semantic head always gets
// its weight gradients, but adds to the trunk's cotangent only when
// pass_sem is set.  dx goes through the sin/cos derivative of the encoding
// with the accurate sinf/cosf (arguments reach 2^9 rad).
//
// Bound on an H100: compute.  About three times the forward's ~0.87 MFLOP a
// sample (recompute, input gradient, weight gradient): ~5.1e11 FLOP at
// N = 196,608, ~0.52 ms at 989 TFLOP/s, against ~0.5 KB a row of inputs and
// outputs; two times (~0.34 ms) for the trunk's dx alone.  The weight
// gradient needs every layer's activation and cotangent of every row, a
// workspace of ~8 KB a row written once and read once: ~1 ms more at
// 3.35 TB/s at that N.
//
// Design.  The host plans the work (ops/cuda/pe_plan.py): a program of
// ops for the tile kernel, a weight image, workspace slots and the tasks of
// the weight-gradient pass.  Three passes, no floating-point atomics, so
// two runs give the same bits:
//   1. pe_field_bwd_tile_kernel, one block per 128-row tile: two consumer
//      warpgroups of 64 rows each and a producer warpgroup that hands its
//      registers to them (setmaxnreg), so that the 64 x 256 f32
//      accumulators fit without spills.  One producer thread streams the
//      weight image through a ring of 32-row slabs in shared
//      memory with bulk copies that complete on mbarriers, so the next
//      slab loads while the warpgroups multiply the current one (the tile
//      interpreter of pe_tile.cuh, which the forward shares).  Each
//      warpgroup runs the program on its rows: every product is a wgmma
//      (64 x N, N = 16..256, f32 accumulators in registers) on an operand
//      that stays in shared memory, written in place after the product,
//      so one activation buffer serves the whole network.  The forward
//      keeps each hidden layer's relu mask as bits in shared memory; the
//      backward reads them there.  With the weight gradients, each layer's
//      A and G are written to the workspace as whole 64-row blocks by one
//      bulk store each (overlapping the next product), and each layer's
//      bias-gradient column sums go to a per-warpgroup row of partials.
//   2. pe_field_bwd_dw_kernel: dW_l = A_lᵀ·G_l as a split-K wgmma GEMM over
//      the workspace, both operands MN-major straight from its blocks, 128
//      weight rows a task, 64-row blocks loaded by bulk copies into a ring.
//   3. column sums: the splits into dW, and the bias partials into db in
//      two passes (64-row chunks, then the chunks), each in a fixed order.
// Rows past N load zero cotangents, so they add nothing to dW or db.
// A trunk or head over 256 wide (up to 512) runs wide (pe_tile.cuh): the
// block takes its tile's two 64-row halves one after the other, both
// warpgroups on each, each with half of every product's columns (its own
// relu-mask words and bias column sums, and its half of each workspace
// block, by its own bulk store); the slabs are then as wide as the
// product (32 x 512 bf16, 32 KB).  Such a program streams ~7.7 MB of
// weights a 64-row half, more than its operations need from L2, so its
// blocks run as persistent clusters of CLUSTER that multicast each
// slab into every block's ring (pe_tile.cuh ClusterRing): each weight
// leaves L2 once a cluster, and no block starts or drains its ring but
// once.
// A trunk or head over 512 wide (up to 1024) runs in class 2: the same
// clusters, tiles and halves, a 1024-wide product in two passes of both
// warpgroups (pe_tile.cuh), the first pass's output (a recomputed
// activation, or a masked cotangent with its bias column sums already
// taken) kept in registers as packed bf16 until the second pass has read
// the tile.  The relu masks (8 words a thread a 1024-wide layer) go to
// device memory, a block's words apart: a 64 x 1024 tile (128 KB) and two
// 32 KB stages leave no room for them.
#include "pe_dw.cuh"

namespace cropnerf {
namespace pebwd {

using namespace pe;

// ---- the backward's part of the program (mirrors ops/cuda/pe_plan.py) -------
enum { G_MASKED, GT_ADD, DEX, GENC_SET, GENC_ADD };
enum { SRC_GT, SRC_RGB, SRC_SEM };

constexpr int CS_BYTES = 4 * MAX_N * 4;     // a warpgroup's bias column sums

struct Layout {        // dynamic shared memory of the tile kernel, in bytes
  int wg_bytes;        // one warpgroup's region (the block's one region when wide)
  int xs, enc, tb, gt, genc, act, colsum;    // offsets inside it
  int masks, ring, bars, stages, total, stage;
  int wc;              // the width class (1 and 2 wide; 2: the masks in device memory)
};

__host__ __device__ inline Layout tile_layout(const int* h) {
  Layout s;
  int off = 0;
  s.xs = off; off += al128(ROWS * h[H_DIM] * 4);
  const int u = off;
  s.enc = off; off += al128(ROWS * h[H_ENC_PAD] * 2);
  s.tb = off; off += al128(ROWS * h[H_TB_W] * 2);
  s.gt = off; off += al128(ROWS * h[H_TB_W] * 4);
  s.genc = u;                          // the backward's, over enc/tb/gt
  off = (int)lmax(off, u + al128(ROWS * h[H_ENC_PAD] * 4));
  s.act = off; off += al128(ROWS * h[H_ACT_W] * 2);
  s.wc = width_class(h);
  s.colsum = off; off += (s.wc ? 2 : 1) * CS_BYTES;
  s.wg_bytes = off;
  off = (s.wc ? 1 : 2) * s.wg_bytes;
  s.masks = off; if (s.wc != 2) off += al128(h[H_MASK_WORDS] * CONSUMERS * 4);
  // a wide program's tile kernel takes a cluster ring
  const RingLayout r =
      s.wc ? ring_layout(off, SLAB_K, PASS_W, CLUSTER_BAR_SETS) : ring_layout(off, SLAB_K);
  s.bars = r.bars;
  s.ring = r.ring;
  s.stages = r.stages;
  s.total = r.total;
  s.stage = r.stage;
  return s;
}

struct TileArgs {
  const float *x, *ex, *g_t, *g_rgb, *g_sem;
  float *dx, *dex;
  const bf16* img;
  const float* bias;
  const int* ops;
  bf16* ws;
  uint32_t* masks;     // class 2: the relu masks, a block's words each
  float* bpart;
  long long n_rows, n_pad, n_tiles;
  int h[H_HEADER];
  Layout s;
};

template <bool STORE, int WC>
struct Tile {
  static constexpr bool WIDE = WC != 0;
  const TileArgs& a;
  unsigned char* wgm;   // this warpgroup's region
  uint32_t* masks;      // in shared memory, or the block's in device memory (class 2)
  Ring rg;
  Lane ln;
  long long row0;       // first row of the warpgroup
  int slab = 0;
  int part_row = 0;     // the row of the bias partials its rows' sums go to

  __device__ bf16* act() const { return reinterpret_cast<bf16*>(wgm + a.s.act); }
  __device__ bf16* enc() const { return reinterpret_cast<bf16*>(wgm + a.s.enc); }
  __device__ bf16* tb() const { return reinterpret_cast<bf16*>(wgm + a.s.tb); }
  __device__ float* gt() const { return reinterpret_cast<float*>(wgm + a.s.gt); }
  __device__ float* genc() const { return reinterpret_cast<float*>(wgm + a.s.genc); }
  __device__ float* xs() const { return reinterpret_cast<float*>(wgm + a.s.xs); }
  __device__ float* colsum() const {
    return reinterpret_cast<float*>(wgm + a.s.colsum + (WIDE ? ln.wg * CS_BYTES : 0));
  }
  __device__ bf16* buf(int id) const { return id == ACT ? act() : id == ENC ? enc() : tb(); }
  // The threads that share the tile: a warpgroup, or both when wide.
  __device__ void sync() const {
    if constexpr (WIDE) named_sync(1, CONSUMERS);
    else named_sync(1 + ln.wg, 128);
  }
  __device__ int tid() const { return WIDE ? (int)threadIdx.x : ln.t; }
  __device__ int nthreads() const { return WIDE ? CONSUMERS : 128; }
  // Whether this warpgroup encodes the rows and forms their dx (when wide,
  // warpgroup 0 for both).
  __device__ bool rows_owner() const { return !WIDE || ln.wg == 0; }

  // Before the warpgroup overwrites a buffer: its bulk stores have read
  // their sources and every warp's products have read their operands.
  __device__ void before_write() const {
    if (STORE && ln.t == 0) bulk_wait_read();
    sync();
  }
  // After the tile's threads wrote `src` (width columns): visible to wgmma
  // and the bulk engine; stored to workspace slot `col` unless col < 0.
  // When wide each warpgroup stores the half of the columns it wrote
  // (`halves`, a product's output), or warpgroup 0 the whole.
  __device__ void after_write(const bf16* src, int col, int width, bool halves) const {
    fence_async_smem();
    sync();
    if (!STORE || col < 0 || ln.t != 0) return;
    int c0 = 0, w = width;
    if constexpr (WIDE) {
      if (halves) {
        w = width / 2;
        c0 = ln.wg * w;
      } else if (ln.wg != 0) {
        return;
      }
    }
    bf16* dst = a.ws + (long long)col * a.n_pad + (row0 / ROWS) * ROWS * width + c0 * ROWS;
    bulk_store(dst, src + c0 * ROWS, ROWS * w * 2);
    bulk_commit();
  }

  // acc = [A0 | A1] · B over the op's K, B streamed from the ring: N of
  // its columns from cb.
  template <int N>
  __device__ void product(const int* op, float (&acc)[N / 2], int cb) {
    pe::product<N, 1, AnyOrder, WIDE ? 2 * N : N>(op, smem_u32(buf(op[O_A0])),
                                                  smem_u32(buf(op[O_A1])), rg, slab, ln.lane,
                                                  acc, AnyOrder(), cb);
  }

  // The first of the op's columns this warpgroup computes (N a warpgroup).
  template <int N>
  __device__ int col_base() const { return WIDE ? ln.wg * N : 0; }

  // A cotangent tile (the warpgroup's N columns from column cb) into the
  // act buffer in place: the relu mask of `mask` (-1: none; its words from
  // mask + mo), bf16 for the next product, f32 column sums for the bias
  // gradient, the workspace slot.
  template <int N>
  __device__ void emit_g(const int* op, float (&v)[N / 2], int cb, int mo) {
    constexpr int W = (N + 63) / 64;
    uint32_t mw[W];
    const int mask = op[O_MASK];
#pragma unroll
    for (int w = 0; w < W; ++w)
      mw[w] = mask >= 0 ? masks[(mask + mo + w) * CONSUMERS + threadIdx.x] : 0xffffffffu;
    before_write();
    bf16* dst = act();
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const uint32_t bits = mw[j >> 3] >> ((j & 7) * 4);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (!((bits >> q) & 1)) v[4 * j + q] = 0.0f;
      const int c = cb + 8 * j + ln.cq;
      *reinterpret_cast<__nv_bfloat162*>(dst + cm(ln.r0, c)) =
          __floats2bfloat162_rn(v[4 * j], v[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dst + cm(ln.r0 + 8, c)) =
          __floats2bfloat162_rn(v[4 * j + 2], v[4 * j + 3]);
    }
    const int boff = op[O_BOFF];
    if (STORE && boff >= 0) {
      float s[N / 4];
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        s[2 * j] = v[4 * j] + v[4 * j + 2];
        s[2 * j + 1] = v[4 * j + 1] + v[4 * j + 3];
      }
      warp_colsum<N / 4>(s, colsum() + ln.warp * MAX_N, ln.lane);
    }
    after_write(dst, op[O_WS], op[O_N], true);
    if (STORE && boff >= 0) {
      const float* cs = colsum();
      float* out = a.bpart + (long long)part_row * a.h[H_TOTAL_B] + boff + cb;
      for (int c = ln.t; c < N && cb + c < op[O_NVALID]; c += 128)
        out[c] = ((cs[c] + cs[MAX_N + c]) + cs[2 * MAX_N + c]) + cs[3 * MAX_N + c];
    }
  }

  template <int N>
  __device__ void forward_epilogue(const int* op, float (&v)[N / 2], int cb, int mo) {
    const bool relu = op[O_EPI] == RELU;
    const float* bias = a.bias + op[O_BOFF];
    const int nvalid = op[O_NVALID];
    constexpr int W = (N + 63) / 64;
    uint32_t mw[W];
#pragma unroll
    for (int w = 0; w < W; ++w) mw[w] = 0;
    before_write();
    bf16* dst = relu ? act() : tb();
    activation_out<N>(v,
                      [&](int c) {
                        return make_float2(c < nvalid ? __ldg(bias + c) : 0.0f,
                                           c + 1 < nvalid ? __ldg(bias + c + 1) : 0.0f);
                      },
                      relu, dst, ln, mw, cb);
    if (op[O_MASK] >= 0) {
#pragma unroll
      for (int w = 0; w < W; ++w) masks[(op[O_MASK] + mo + w) * CONSUMERS + threadIdx.x] = mw[w];
    }
    after_write(dst, op[O_WS], op[O_N], true);
  }

  // Class 2: a product over PASS_W (1024) columns in two passes of both
  // warpgroups, warpgroup w's columns [512w + 256q, +256) in pass q (the
  // slabs' [256w, +256)): a recomputed hidden layer (FWD) or a masked
  // cotangent (G_MASKED).  The first pass's epilogue runs in full but its
  // bf16 output stays in registers (its mask words, or its bias column
  // sums, are written at once); it goes into the tile once the second pass
  // has read the tile, and the second pass's epilogue stores the
  // warpgroup's 512 columns to the workspace.
  __device__ void run_passes(const int* op) {
    constexpr int N = MAX_N, W = N / 64;
    const int cb = ln.wg * PASS_W;
    const bool fwd = op[O_KIND] == FWD;
    __nv_bfloat162 park[N / 4];
    {
      float v[N / 2];
      pe::product<N, 1, AnyOrder, PASS_W>(op, smem_u32(buf(op[O_A0])), smem_u32(buf(op[O_A1])),
                                          rg, slab, ln.lane, v, AnyOrder(), ln.wg * N);
      uint32_t mw[W];
      const int mask = op[O_MASK];
      if (fwd) {
        const float* bias = a.bias + op[O_BOFF];
        const int nvalid = op[O_NVALID];
#pragma unroll
        for (int w = 0; w < W; ++w) mw[w] = 0;
        activation_pack<N>(v,
                           [&](int c) {
                             return make_float2(c < nvalid ? __ldg(bias + c) : 0.0f,
                                                c + 1 < nvalid ? __ldg(bias + c + 1) : 0.0f);
                           },
                           true, park, ln, mw, cb);
        if (mask >= 0) {
#pragma unroll
          for (int w = 0; w < W; ++w) masks[(mask + w) * CONSUMERS + threadIdx.x] = mw[w];
        }
      } else {
#pragma unroll
        for (int w = 0; w < W; ++w) mw[w] = masks[(mask + w) * CONSUMERS + threadIdx.x];
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const uint32_t bits = mw[j >> 3] >> ((j & 7) * 4);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (!((bits >> q) & 1)) v[4 * j + q] = 0.0f;
        }
        const int boff = op[O_BOFF];
        if (STORE && boff >= 0) {
          float s[N / 4];
#pragma unroll
          for (int j = 0; j < N / 8; ++j) {
            s[2 * j] = v[4 * j] + v[4 * j + 2];
            s[2 * j + 1] = v[4 * j + 1] + v[4 * j + 3];
          }
          named_sync(2 + ln.wg, 128);  // the warpgroup's last bias sums have left colsum
          warp_colsum<N / 4>(s, colsum() + ln.warp * MAX_N, ln.lane);
          named_sync(2 + ln.wg, 128);
          const float* cs = colsum();
          float* out = a.bpart + (long long)part_row * a.h[H_TOTAL_B] + boff + cb;
          for (int c = ln.t; c < N && cb + c < op[O_NVALID]; c += 128)
            out[c] = ((cs[c] + cs[MAX_N + c]) + cs[2 * MAX_N + c]) + cs[3 * MAX_N + c];
        }
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          park[2 * j] = __floats2bfloat162_rn(v[4 * j], v[4 * j + 1]);
          park[2 * j + 1] = __floats2bfloat162_rn(v[4 * j + 2], v[4 * j + 3]);
        }
      }
    }
    float v[N / 2];
    pe::product<N, 1, AnyOrder, PASS_W>(op, smem_u32(buf(op[O_A0])), smem_u32(buf(op[O_A1])), rg,
                                        slab, ln.lane, v, AnyOrder(), ln.wg * N);
    before_write();                    // both passes have read the tile
    store_packed<N>(park, act(), ln, cb);
    if (fwd) forward_epilogue<N>(op, v, cb + N, W);
    else emit_g<N>(op, v, cb + N, W);
  }

  // f32 into a chunk-major f32 tile (set or add), columns from `col`.
  template <int N>
  __device__ void to_f32(float* dst, int col, bool add, const float (&v)[N / 2]) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int c = col + 8 * j + ln.cq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2* p = reinterpret_cast<float2*>(dst + cm(ln.r0 + 8 * h, c));
        float2 o = add ? *p : make_float2(0.0f, 0.0f);
        o.x += v[4 * j + 2 * h];
        o.y += v[4 * j + 2 * h + 1];
        *p = o;
      }
    }
  }

  template <int N>
  __device__ void run_product(const int* op) {
    float acc[N / 2];
    const int cb = col_base<N>();
    product<N>(op, acc, cb);
    if (op[O_KIND] == FWD) {
      forward_epilogue<N>(op, acc, cb, 0);
      return;
    }
    const int epi = op[O_EPI];
    if (epi == G_MASKED) {
      emit_g<N>(op, acc, cb, 0);
      return;
    }
    before_write();
    if (epi == DEX) {
      const int de = a.h[H_DE];
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int c = op[O_COL] + cb + 8 * j + ln.cq;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const long long row = row0 + ln.r0 + 8 * (q >> 1);
          if (c + (q & 1) < de && row < a.n_rows) a.dex[row * de + c + (q & 1)] = acc[4 * j + q];
        }
      }
    } else if (epi == GT_ADD) {
      to_f32<N>(gt(), op[O_COL] + cb, true, acc);
    } else {
      to_f32<N>(genc(), op[O_COL] + cb, epi == GENC_ADD, acc);
    }
    fence_async_smem();
    sync();
  }

  // A cotangent from the trunk output's f32 tile or from a head's input.
  template <int N>
  __device__ void emit(const int* op) {
    float v[N / 2];
    const int src = op[O_EPI];
    const float* g = src == SRC_RGB ? a.g_rgb : a.g_sem;
    const int cols = src == SRC_RGB ? a.h[H_RGB_COLS] : a.h[H_SEM_COLS];
    const int cb = col_base<N>();
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = ln.r0 + 8 * (q >> 1), c = cb + 8 * j + ln.cq + (q & 1);
        if (src == SRC_GT) {
          v[4 * j + q] = gt()[cm(r, c)];
        } else {
          const long long row = row0 + r;
          v[4 * j + q] = (c < cols && row < a.n_rows) ? g[row * cols + c] : 0.0f;
        }
      }
    }
    emit_g<N>(op, v, cb, 0);
  }

  __device__ void load_extras(const int* op) {
    before_write();
    bf16* dst = act();
    const int de = a.h[H_DE], w = op[O_N];
    for (int i = tid(); i < ROWS * w; i += nthreads()) {
      const int r = i / w, c = i - r * w;
      const long long row = row0 + r;
      dst[cm(r, c)] = __float2bfloat16_rn((c < de && row < a.n_rows) ? a.ex[row * de + c] : 0.0f);
    }
    after_write(dst, op[O_WS], w, false);
  }

  __device__ void prologue() {
    const int dim = a.h[H_DIM], tw = a.h[H_TB_W], t_cols = a.h[H_T_COLS];
    float* x = xs();
    for (int i = tid(); i < ROWS * dim; i += nthreads()) {
      const long long g = row0 * dim + i;
      x[i] = g < a.n_rows * dim ? a.x[g] : 0.0f;
    }
    for (int i = tid(); i < ROWS * tw; i += nthreads()) {
      const int r = i / tw, c = i - r * tw;
      const long long row = row0 + r;
      gt()[cm(r, c)] = (c < t_cols && row < a.n_rows) ? a.g_t[row * t_cols + c] : 0.0f;
    }
    sync();
    if (rows_owner()) {
      const float* xr = x + (ln.t >> 1) * dim;
      encode_row([&](int d) { return xr[d]; }, ln.t >> 1, ln.t & 1, a.h, enc());
    }
    after_write(enc(), a.h[H_ENC_SLOT], a.h[H_ENC_PAD], false);
  }

  __device__ void run() {
    prologue();
    const int n_ops = a.h[H_N_OPS];
    for (int o = 0; o < n_ops; ++o) {
      int op[OP_INTS];
#pragma unroll
      for (int i = 0; i < OP_INTS; ++i) op[i] = __ldg(a.ops + o * OP_INTS + i);
      const int kind = op[O_KIND];
      if (kind == EX) {
        load_extras(op);
        continue;
      }
      switch (WIDE ? op[O_N] / 2 : op[O_N]) {
#define CROPNERF_CASE(NN)                            \
  case NN:                                           \
    if (kind == EMIT) emit<NN>(op);                  \
    else run_product<NN>(op);                        \
    break;
        case 8:                        // a wide program's 16-wide products
          if constexpr (WIDE) {
            if (kind == EMIT) emit<8>(op);
            else run_product<8>(op);
          }
          break;
        CROPNERF_CASE(16)
        CROPNERF_CASE(32)
        CROPNERF_CASE(64)
        CROPNERF_CASE(128)
        CROPNERF_CASE(256)
#undef CROPNERF_CASE
        case 512:                      // class 2: a 1024-wide product in two passes
          if constexpr (WC == 2) run_passes(op);
          break;
      }
    }
  }
};

// dx = (d encode / d pre · g_enc) · Sᵀ over a warpgroup's rows; one
// function for both tile-kernel variants, so dx alone is bit-equal to the
// dx of the full backward.
__device__ __noinline__ void dx_rows(const float* xs, const float* genc, float* dx,
                                     long long row0, long long n_rows, int dim, int F, int t) {
  const int sin_end = dim * (1 + F);
  for (int i = t; i < ROWS * dim; i += 128) {
    const int r = i / dim;
    const int dd = i - r * dim;
    if (row0 + r >= n_rows) continue;
    const float xv = xs[r * dim + dd];
    float acc = genc[cm(r, dd)];
    for (int f = 0; f < F; ++f) {
      const float scale = (float)(1 << f);
      const float pre = xv * scale;
      acc += genc[cm(r, dim + f * dim + dd)] * cosf(pre) * scale;
      acc += -genc[cm(r, sin_end + f * dim + dd)] * sinf(pre) * scale;
    }
    dx[(row0 + r) * dim + dd] = acc;
  }
}

// A wide program's block of a persistent cluster (pe_tile.cuh): the
// cluster ring, the block's tiles in ClusterWalk's order, each tile's two
// 64-row halves in turn with both warpgroups on each.  Bias partials stay
// one row a tile's half (part_row), whatever block takes it; class 2's
// relu masks are the block's in device memory.
template <bool STORE, int WC>
__device__ __forceinline__ void wide_tiles(const TileArgs& a, unsigned char* smem,
                                           const RingLayout& rl) {
  const ClusterRing<CLUSTER> rg = make_cluster_ring<CLUSTER>(smem, rl);
  init_cluster_ring(rg);
  cluster_sync();
  using Walk = ClusterWalk<CLUSTER>;
  const int n_ops = a.h[H_N_OPS];
  split_roles(
      [&] {                            // the producer: the slabs, once a tile's half
        int slab = 0;
        for (int grp = Walk::first(); grp < Walk::groups(a.n_tiles); grp += Walk::step())
          for (int i = 0; i < 2; ++i)
            produce_slabs_multicast<CLUSTER, WC == 2>(a.ops, n_ops, a.img, rg, slab,
                                                      cluster_rank());
        await_release(rg, slab);
      },
      [&] {
        uint32_t* masks = WC == 2 ? a.masks + (long long)blockIdx.x * a.h[H_MASK_WORDS] * CONSUMERS
                                  : reinterpret_cast<uint32_t*>(smem + a.s.masks);
        Tile<STORE, WC> tile{a, smem, masks, rg.ring};
        const int n_halves = 2 * Walk::my_groups(a.n_tiles);
        for (int h = 0; h < n_halves; ++h) {
          const long long t = Walk::tile(Walk::first() + (h >> 1) * Walk::step());
          if (t >= a.n_tiles) {        // a padding tile: the slabs, nothing written
            skip_slabs<WC == 2>(a.ops, n_ops, tile.rg, tile.slab, tile.ln.lane);
            continue;
          }
          const int part = h & 1;
          tile.row0 = t * TILE_ROWS + part * ROWS;
          tile.part_row = (int)(t * 2 + part);
          if (h) tile.before_write();  // the last half's stores and dx have read the tile
          tile.run();
          if (a.dx != nullptr && tile.rows_owner())
            dx_rows(tile.xs(), tile.genc(), a.dx, tile.row0, a.n_rows, a.h[H_DIM],
                    a.h[H_FREQS], tile.ln.t);
        }
        if (STORE && tile.ln.t == 0) bulk_wait();
      });
}

// Up to MAX_N wide, one block a 128-row tile, a warpgroup a 64-row half;
// a wide program (class 1 or 2) runs as persistent clusters (wide_tiles,
// launched by cluster_launch).
template <bool STORE, int WC>
__global__ void __launch_bounds__(ALL_THREADS, 1)
pe_field_bwd_tile_kernel(const __grid_constant__ TileArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const RingLayout rl{a.s.bars, a.s.ring, a.s.stages, a.s.total, SLAB_K, a.s.stage};
  if constexpr (WC != 0) {
    wide_tiles<STORE, WC>(a, smem, rl);
  } else {
    const Ring rg = make_ring(smem, rl);
    init_ring(rg);
    __syncthreads();
    split_roles(
        [&] {                          // the producer: the weight slabs, in order
          int slab = 0;
          produce_slabs(a.ops, a.h[H_N_OPS], a.img, rg, slab);
        },
        [&] {
          const int wg = threadIdx.x >> 7;
          Tile<STORE, 0> tile{a, smem + wg * a.s.wg_bytes,
                                  reinterpret_cast<uint32_t*>(smem + a.s.masks), rg};
          tile.row0 = (long long)blockIdx.x * TILE_ROWS + wg * ROWS;
          tile.part_row = blockIdx.x * 2 + wg;
          tile.run();
          if (a.dx != nullptr)
            dx_rows(tile.xs(), tile.genc(), a.dx, tile.row0, a.n_rows, a.h[H_DIM],
                    a.h[H_FREQS], tile.ln.t);
          if (STORE && tile.ln.t == 0) bulk_wait();
        });
  }
}

// The program's header, checked; the split plan of the weight-gradient
// pass (pe_dw.cuh dw_split).
struct Plan {
  const int* h;
  DwSplit split;
};

static decltype(&pe_field_bwd_tile_kernel<true, 1>) tile_kernel(bool store, int wc) {
  if (store)
    return wc == 2 ? pe_field_bwd_tile_kernel<true, 2>
           : wc == 1 ? pe_field_bwd_tile_kernel<true, 1>
                     : pe_field_bwd_tile_kernel<true, 0>;
  return wc == 2 ? pe_field_bwd_tile_kernel<false, 2>
         : wc == 1 ? pe_field_bwd_tile_kernel<false, 1>
                   : pe_field_bwd_tile_kernel<false, 0>;
}

static bool plan(const int* prog, int prog_len, long long n_rows, Plan* p) {
  if (!program_ok(prog, prog_len, TASK_INTS)) return false;
  const int* h = prog;
  p->h = h;
  if (!tasks_ok(prog + H_HEADER + h[H_N_OPS] * OP_INTS, h[H_N_TASKS])) return false;
  if (tile_layout(h).stages < 2) return false;
  p->split = dw_split(n_rows, h[H_N_TASKS]);
  return true;
}

static cudaError_t device_sms(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

}  // namespace pebwd
}  // namespace cropnerf

// Sizes of the buffers the wrapper allocates for cropnerf_pe_field_bwd:
// out[0] bf16 workspace elements (0 without the weight gradients), out[1]
// f32 bias partials (and their chunk sums), out[2] f32 weight partials, out[3] packed weights,
// out[4] packed biases, out[5] uint32 relu-mask words in device memory (a
// block's for each SM of the current device in class 2, else 0).  Returns
// 0, -1 where the program is rejected, or the cudaError_t of the device
// query.
extern "C" int cropnerf_pe_field_bwd_sizes(const int* prog, int prog_len, long long n_rows,
                                           long long* out) {
  using namespace cropnerf::pebwd;
  Plan p;
  if (!plan(prog, prog_len, n_rows, &p)) return -1;
  const int* h = p.h;
  const bool store = h[H_STORE] != 0;
  out[5] = 0;
  if (width_class(h) == 2) {
    int sms = 0;
    const cudaError_t e = device_sms(&sms);
    if (e != cudaSuccess) return (int)e;
    out[5] = (long long)sms * h[H_MASK_WORDS] * CONSUMERS;
  }
  out[0] = store ? (long long)h[H_WS_COLS] * p.split.n_pad + ROWS * 128 : 0;
  out[1] = store ? bias_partial_elems(p.split, h[H_TOTAL_B]) : 0;
  out[2] = store ? p.split.splits * (long long)h[H_TOTAL_W] : 0;
  out[3] = h[H_TOTAL_W];
  out[4] = h[H_TOTAL_B];
  return 0;
}

// Dynamic shared memory of the tile kernel (-1 where the program is
// rejected).
extern "C" int cropnerf_pe_field_bwd_smem_bytes(const int* prog, int prog_len) {
  using namespace cropnerf::pebwd;
  Plan p;
  if (!plan(prog, prog_len, 1, &p)) return -1;
  return tile_layout(p.h).total;
}

// The tile kernel's grid at n_rows on the current device: out[0] the
// cluster size (0: one block a tile, up to MAX_N wide), out[1] the clusters
// resident at once, out[2] the blocks launched.  Returns 0, -1 where the
// program is rejected, or a cudaError_t (cudaErrorLaunchOutOfResources
// where no cluster fits).
extern "C" int cropnerf_pe_field_bwd_grid(const int* prog, int prog_len, long long n_rows,
                                          long long* out) {
  using namespace cropnerf::pebwd;
  Plan p;
  if (!plan(prog, prog_len, n_rows, &p)) return -1;
  const Layout s = tile_layout(p.h);
  cropnerf::pe::ClusterGrid g{0, 0, p.split.n_tiles};
  const int e = s.wc ? cluster_launch(tile_kernel(p.h[H_STORE] != 0, s.wc),
                                      static_cast<const TileArgs*>(nullptr), s.total,
                                      (p.split.n_tiles + CLUSTER - 1) / CLUSTER, nullptr, &g)
                     : 0;
  out[0] = g.cluster;
  out[1] = g.active;
  out[2] = g.blocks;
  return e;
}

// Launches the backward on `stream`; returns a cudaError_t (0 on success).
// `prog` is the program on the host, `prog_dev` the same ints on the device;
// every other pointer is on the device.  ws, bpart and wpart are scratch of
// the sizes above; dw and db receive the packed f32 weight and bias
// gradients.  Without the heads ex, g_rgb, g_sem and dex are not read
// (null).  A null dx skips dx.  `masks` holds out[5] words of the sizes
// above (class 2; else unread, null).  A wide program's tile kernel runs
// as persistent clusters (cropnerf_pe_field_bwd_grid); a refused cluster
// launch returns its error, with no other grid tried.
extern "C" int cropnerf_pe_field_bwd(const float* x, const float* ex, const float* g_t,
                                     const float* g_rgb, const float* g_sem, float* dx,
                                     float* dex, const void* img, const float* b,
                                     const int* prog, const int* prog_dev, int prog_len,
                                     long long n_rows, void* ws, void* masks, float* bpart,
                                     float* wpart, float* dw, float* db, void* stream) {
  using namespace cropnerf::pebwd;
  Plan p;
  if (!plan(prog, prog_len, n_rows, &p)) return (int)cudaErrorInvalidValue;
  const int* h = p.h;
  const bool store = h[H_STORE] != 0;
  if (store && (ws == nullptr || bpart == nullptr || wpart == nullptr || dw == nullptr ||
                db == nullptr))
    return (int)cudaErrorInvalidValue;
  const int wc = width_class(h);
  if (wc == 2 && masks == nullptr) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int sms = 0;
  if (wc == 2) {
    const cudaError_t e = device_sms(&sms);
    if (e != cudaSuccess) return (int)e;
  }

  TileArgs ta;
  ta.x = x; ta.ex = ex; ta.g_t = g_t; ta.g_rgb = g_rgb; ta.g_sem = g_sem;
  ta.dx = dx; ta.dex = dex;
  ta.img = reinterpret_cast<const cropnerf::bf16*>(img);
  ta.bias = b;
  ta.ops = prog_dev + H_HEADER;
  ta.ws = reinterpret_cast<cropnerf::bf16*>(ws);
  ta.masks = reinterpret_cast<uint32_t*>(masks);
  ta.bpart = bpart;
  ta.n_rows = n_rows;
  ta.n_pad = p.split.n_pad;
  ta.n_tiles = p.split.n_tiles;
  for (int i = 0; i < H_HEADER; ++i) ta.h[i] = h[i];
  ta.s = tile_layout(h);
  auto kernel = tile_kernel(store, ta.s.wc);
  if (ta.s.wc) {
    cropnerf::pe::ClusterGrid grid{0, 0, 0};
    // class 2's masks hold a block's words for each SM
    const int err = cluster_launch(kernel, &ta, ta.s.total, (ta.n_tiles + CLUSTER - 1) / CLUSTER,
                                   s, &grid, wc == 2 ? sms : 0);
    if (err || !store) return err;
  } else {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ta.s.total);
    if (e != cudaSuccess) return (int)e;
    kernel<<<(unsigned)p.split.n_tiles, ALL_THREADS, ta.s.total, s>>>(ta);
    e = cudaGetLastError();
    if (e != cudaSuccess || !store) return (int)e;
  }

  return run_dw_sums(ta.ws, prog_dev + H_HEADER + h[H_N_OPS] * OP_INTS, h[H_N_TASKS], p.split,
                     h[H_TOTAL_W], h[H_TOTAL_B], wpart, bpart, dw, db, s);
}
