// Fused positional-encoding NeRF field, forward, for Hopper (sm_90a).  The
// backward of fused_pe_nerf and fused_pe_density is fused_pe_field_bwd.cu.
//
// Replaces the Pallas forward kernels of cropnerf_tpu/ops/pallas/fused_pe_field.py:
//   fused_pe_density (_fwd_kernel):       encode -> trunk -> t
//   fused_pe_nerf    (_mega_fwd_kernel):  ... + colour and semantic heads
//                                         -> t, rgb_raw, sem_raw
// Per row: x [dim] -> NeRF encoding [x | sin(2^f x) | cos(2^f x)] -> relu
// base stack -> skip layer on [h | enc] -> top stack -> t [1+G] in f32;
// colour head layer 0 on [bf16(t) | extras], semantic head on bf16(t).
// bf16 operands, f32 sums, bias added in f32, relu then bf16 after each
// hidden layer: the JAX kernels' rounding points.
//
// Bound on an H100: compute.  The flagship does ~0.87 MFLOP per sample
// against ~330 bytes of input and output, far above the card's ~295
// FLOP/byte balance point, so every intermediate stays in shared memory and
// only x, the extras and the outputs touch device memory.
//
// Design.  The host plans a program (ops/cuda/pe_plan.py
// build_forward_plan): one FWD op per layer with its epilogue (RELU, or
// T_OUT / RGB_OUT / SEM_OUT for the outputs) and an EX op for the extras.
// The tile interpreter of pe_tile.cuh runs it, the same code and the same
// products as the backward's recompute, so the two give the same bits:
//  * two consumer warpgroups of 64 rows multiply with wgmma on operands in
//    shared memory; a producer warpgroup streams the weight image (~0.88 MB
//    with the heads, from L2) through a ring of 64-row slabs (4 stages of
//    32 KB).  Every slab costs a barrier wait, a fence and a release, so
//    the slabs are twice the backward's depth: each is one group of 4
//    wgmma steps, and two groups stay in flight;
//  * the warpgroups run out of phase (PingPong): warpgroup 1 starts each
//    product once warpgroup 0 has issued its first slab's, so one's
//    epilogue runs while the other's slabs multiply (on the H100 this is
//    faster than both multiplying each slab together: PERF.md).  Each slab
//    is freed when all 8 consumer warps have arrived on its `empty` barrier;
//  * persistent blocks: min(tiles, SMs) blocks walk the 128-row tiles with
//    a stride, and the producer runs the program's slab sequence once per
//    tile without draining the ring, so there is no wave tail of blocks;
//  * a trunk or head over 256 wide (up to 512) runs wide (pe_tile.cuh):
//    persistent clusters of two blocks on two SMs walk the 128-row tiles
//    together, each block computing half of every product's columns (64 x
//    N/2 accumulators a warpgroup) from 32-row slabs of that half alone
//    (16 KB), so each weight byte leaves L2 once per 128 rows, and each
//    warpgroup on its own 64 rows, out of phase as above.  Each warpgroup
//    keeps its own encoding, t and 512-wide activation tiles (both blocks
//    encode the rows and load the extras) and writes its half of every
//    output into them and into the peer block's through distributed
//    shared memory (pe_tile.cuh Mirror); the block that owns an output's
//    columns writes them to device memory;
//  * a trunk or head over 512 wide (up to 1024) runs in class 2
//    (pe_tile.cuh): persistent blocks walk 64-row tiles with both
//    warpgroups on the same rows, each computing half of every product's
//    columns in phase, from 32-row slabs as wide as the product (up to
//    512); a 1024-wide product takes two passes, the first pass's output
//    parked as packed bf16 in a block's scratch in device memory (64 KB a
//    block, written by each thread under the second pass and read back by
//    the same thread) until the second pass has read the activation tile
//    (64 x 1024 bf16, 128 KB: one copy is all a block's shared memory holds
//    beside two 32 KB stages; 64 parked registers a thread beside the 128
//    accumulators spill here, where the backward's fit).  The biases are
//    read from device memory (L1) rather than copied, and the extras are
//    loaded straight into the tile;
//  * the serial parts are kept short: the encoding takes one sincosf per
//    (coordinate, frequency), two threads a row, from x loaded into
//    registers a tile ahead; the extras (up to 2 * EX_REGS columns; wider
//    ones straight into shared memory) load into registers under the
//    trunk's last product; the biases are copied to shared memory once per
//    block and read as float2; the outputs are staged in shared memory
//    (over the encoding, free by then) and written row by row, consecutive
//    threads on consecutive addresses.
// No atomics: two runs give the same bits.
#include "pe_tile.cuh"

namespace cropnerf {
namespace pefwd {

using namespace pe;

constexpr int MAX_DIM = 4;             // a row's x is kept in registers
constexpr int SLAB_ROWS = 64;          // weight rows per slab: 4 wgmma steps a group
constexpr int WAIT_DEPTH = 2;          // wgmma groups in flight (pe::product)
constexpr int WIDE_DEPTH = 1;          // and when wide: three 16 KB stages leave a
                                       // slab's room for the producer (PERF.md)
constexpr int EX_REGS = 32;            // extras prefetched a thread (64 columns a row)
constexpr int MIN_STAGES = 3;          // PingPong hands over after 1 slab: 1 <= stages - 2
constexpr int PASS_DEPTH = 1;          // class 2: one group in flight (two 32 KB stages)
constexpr int PASS_MIN_STAGES = 2;
constexpr int PARK_WORDS = MAX_N / 4;  // class 2: the bf16 pairs a thread parks a pass

struct Layout {        // dynamic shared memory, in bytes
  int wg_bytes;        // one warpgroup's region (class 2: the block's one region)
  int enc, tb, act;    // offsets inside it; enc also stages the outputs
  int bias, ops, turn, mirror, total;
  int wc;              // the width class
  RingLayout ring;
};

__host__ __device__ inline int out_cols(const int* h) {
  return (int)lmax(h[H_T_COLS], lmax(h[H_RGB_COLS], h[H_SEM_COLS]));
}

__host__ __device__ inline Layout fwd_layout(const int* h) {
  Layout s;
  int off = 0;
  s.enc = off; off += al128((int)lmax(ROWS * h[H_ENC_PAD] * 2, ROWS * out_cols(h) * 4));
  s.tb = off; off += al128(ROWS * h[H_TB_W] * 2);
  s.act = off; off += al128(ROWS * h[H_ACT_W] * 2);
  s.wg_bytes = off;
  s.wc = width_class(h);
  off = (s.wc == 2 ? 1 : 2) * s.wg_bytes;
  s.bias = off; if (s.wc != 2) off += al128(h[H_TOTAL_B] * 4);
  s.ops = off; off += al128(h[H_N_OPS] * OP_INTS * 4);
  s.turn = off; off += 2 * 8;
  s.mirror = off; if (s.wc == 1) off += MIRROR_BYTES;
  // a class 1 block's slabs: 32 rows of its half of the columns (MAX_N);
  // class 2's: 32 rows as wide as a pass (PASS_W)
  s.ring = s.wc == 1   ? ring_layout(off, SLAB_K)
           : s.wc == 2 ? ring_layout(off, SLAB_K, PASS_W)
                       : ring_layout(off, SLAB_ROWS);
  s.total = s.ring.total;
  return s;
}

// Rows of the tiles the blocks walk: 128 (a warpgroup's 64 each), or 64
// in class 2 (both warpgroups on the same rows).
__host__ __device__ inline int tile_rows(const Layout& s) { return s.wc == 2 ? ROWS : TILE_ROWS; }

struct FwdArgs {
  const float *x, *ex;
  float *t, *rgb, *sem;
  const bf16* img;
  const float* bias;
  uint32_t* park;      // class 2: PARK_WORDS x CONSUMERS words a block
  const int* ops;
  long long n_rows, n_tiles;
  int h[H_HEADER];
  Layout s;
};

template <int WC>
struct FwdTile {
  static constexpr bool WIDE = WC == 1;     // the column split over a cluster
  static constexpr bool PASSES = WC == 2;   // both warpgroups on a tile, in passes
  const FwdArgs& a;
  unsigned char* wgm;   // this warpgroup's region (class 2: the block's)
  const float* bias;    // the block's copies of the biases (class 2: the
  const int* ops;       // biases in device memory) and the ops
  Ring rg;
  uint64_t* turn;
  Lane ln;
  int last = -1;        // when wide: the buffer the last product mirrored and
                        // its half's columns (buffer << 16 | columns), or -1
  long long row0 = 0;   // first row of the warpgroup in the current tile
  long long p = 0, total = 0;
  int slab = 0;
  // Registers: x of the thread's row (two threads a row) and its half of
  // the row's extras, loaded ahead.  Indexed only by constants, so that the
  // tile stays in registers (every method is inlined).
  float xr[MAX_DIM];
  float exr[EX_REGS];

  // When wide the region, the biases, the ops and the handshake barriers
  // are found from the layout where they are needed rather than held in
  // registers over the products (a warpgroup's 64 x 256 accumulators leave
  // little room).
  __device__ __forceinline__ unsigned char* region() const {
    if constexpr (WIDE) {
      extern __shared__ __align__(1024) unsigned char fwd_smem[];
      return fwd_smem + ln.wg * a.s.wg_bytes;
    } else if constexpr (PASSES) {     // the block's one region, at offset 0
      extern __shared__ __align__(1024) unsigned char fwd_smem[];
      return fwd_smem;
    } else {
      return wgm;
    }
  }
  __device__ __forceinline__ const float* biases() const {
    if constexpr (WIDE) {
      extern __shared__ __align__(1024) unsigned char fwd_smem[];
      return reinterpret_cast<const float*>(fwd_smem + a.s.bias);
    } else {
      return bias;
    }
  }
  __device__ __forceinline__ const int* op_list() const {
    if constexpr (WIDE) {
      extern __shared__ __align__(1024) unsigned char fwd_smem[];
      return reinterpret_cast<const int*>(fwd_smem + a.s.ops);
    } else {
      return ops;
    }
  }
  __device__ __forceinline__ Mirror mirror() const { return Mirror{a.s.mirror}; }
  __device__ __forceinline__ bf16* enc() const { return reinterpret_cast<bf16*>(region() + a.s.enc); }
  __device__ __forceinline__ float* stage() const { return reinterpret_cast<float*>(region() + a.s.enc); }
  __device__ __forceinline__ bf16* tb() const { return reinterpret_cast<bf16*>(region() + a.s.tb); }
  __device__ __forceinline__ bf16* act() const { return reinterpret_cast<bf16*>(region() + a.s.act); }
  __device__ __forceinline__ bf16* buf(int id) const { return id == ACT ? act() : id == ENC ? enc() : tb(); }
  // The threads that share the tile: the warpgroup, or both in class 2.
  __device__ __forceinline__ void sync() const {
    if constexpr (PASSES) named_sync(1, CONSUMERS);
    else named_sync(1 + ln.wg, 128);
  }
  __device__ __forceinline__ int row() const { return ln.t >> 1; }
  __device__ __forceinline__ int half() const { return ln.t & 1; }
  // The first row of this warpgroup in tile `tile`.
  __device__ __forceinline__ long long first_row(long long tile) const {
    return PASSES ? tile * ROWS : tile * TILE_ROWS + ln.wg * ROWS;
  }

  // x of the thread's row of the warpgroup's rows from row0 (zeros past N).
  __device__ __forceinline__ void load_x(long long first) {
    const long long r = first + row();
    const int dim = a.h[H_DIM];
#pragma unroll
    for (int d = 0; d < MAX_DIM; ++d) xr[d] = (d < dim && r < a.n_rows) ? a.x[r * dim + d] : 0.0f;
  }

  // The thread's half of its row's extras, loaded before the trunk's last
  // product so that the loads run under it (w <= 2 * EX_REGS).
  __device__ __forceinline__ void load_extras(int w) {
    const long long r = row0 + row();
    const int de = a.h[H_DE], c0 = half() * (w / 2);
#pragma unroll
    for (int i = 0; i < EX_REGS; ++i) {
      const int c = c0 + i;
      exr[i] = (i < w / 2 && c < de && r < a.n_rows) ? a.ex[r * de + c] : 0.0f;
    }
  }

  // The extras into the act tile: from the registers, or straight from
  // device memory where they are too wide for them or the program is wide
  // (no registers held over the trunk's last product).
  __device__ __forceinline__ void store_extras(int w) {
    const int c0 = half() * (w / 2);
    if (WIDE || PASSES || w > 2 * EX_REGS) {
      const long long r = row0 + row();
      const int de = a.h[H_DE];
      for (int i = 0; i < w / 2; ++i) {
        const int c = c0 + i;
        const float v = (c < de && r < a.n_rows) ? a.ex[r * de + c] : 0.0f;
        act()[cm(row(), c)] = __float2bfloat16_rn(v);
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < EX_REGS; ++i)
      if (i < w / 2) act()[cm(row(), c0 + i)] = __float2bfloat16_rn(exr[i]);
  }

  // f32 rows of an output: the product (columns from cb) plus its bias,
  // staged row-major [64, cols] and stored with consecutive threads on
  // consecutive addresses (rows past n_rows and the padded columns are
  // dropped; when wide, the other block's columns too; in class 2 both
  // warpgroups stage their halves, then store the rows together).
  template <int N>
  __device__ __forceinline__ void output(const int* op, const float (&v)[N / 2], const float* b,
                                         int cb) {
    const int epi = op[O_EPI], nvalid = op[O_NVALID];
    const int cols = epi == T_OUT ? a.h[H_T_COLS] : epi == RGB_OUT ? a.h[H_RGB_COLS]
                                                                  : a.h[H_SEM_COLS];
    float* out = epi == T_OUT ? a.t : epi == RGB_OUT ? a.rgb : a.sem;
    float* st = stage();
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = cb + 8 * j + ln.cq + (q & 1);
        if (c < cols)
          st[(ln.r0 + 8 * (q >> 1)) * cols + c] = v[4 * j + q] + (c < nvalid ? b[c] : 0.0f);
      }
    }
    sync();
    const long long first = row0 * cols, end = a.n_rows * cols;
    for (int i = PASSES ? (int)threadIdx.x : ln.t; i < ROWS * cols; i += PASSES ? CONSUMERS : 128) {
      if constexpr (WIDE) {
        const int c = i % cols;
        if (c < cb || c >= cb + N) continue;
      }
      if (first + i < end) out[first + i] = st[i];
    }
  }

  // The slab of op's product that first reads the peer's half of the
  // last product's output (PingPongWide), or none.
  __device__ __forceinline__ int s_wait(const int* op) const {
    const int buf = last >> 16;
    const int base = last < 0 ? -1 : op[O_A0] == buf ? 0 : op[O_A1] == buf ? op[O_KA] : -1;
    return base < 0 ? 1 << 30
                    : (base + (int)((blockIdx.x % CLUSTER) ^ 1u) * (last & 0xffff)) / SLAB_K;
  }

  // A product of N columns a warpgroup: the op's whole width, or when
  // wide this block's half of it, from column cb.  When wide an activation
  // output goes into this warpgroup's tile, then into the peer's copy
  // (Mirror).
  template <int N>
  __device__ __forceinline__ void run_product(const int* op) {
    float acc[N / 2];
    const uint32_t a0 = smem_u32(buf(op[O_A0])), a1 = smem_u32(buf(op[O_A1]));
    if constexpr (WIDE)
      pe::product<N, WIDE_DEPTH>(op, a0, a1, rg, slab, ln.lane, acc,
                                 PingPongWide{{turn, ln.wg, ln.lane, p, total},
                                              mirror().wrote(ln), s_wait(op)});
    else
      pe::product<N, WAIT_DEPTH>(op, a0, a1, rg, slab, ln.lane, acc,
                                 PingPong{turn, ln.wg, ln.lane, p, total});
    const int epi = op[O_EPI], nvalid = op[O_NVALID];
    const float* b = biases() + op[O_BOFF];
    const int cb = WIDE ? (int)(blockIdx.x % CLUSTER) * N : 0;
    const bool to_device = epi == RGB_OUT || epi == SEM_OUT;
    sync();                            // every warp's products have read their operands
    const auto bias2 = [&](int c) {    // nvalid is even: c < nvalid covers c + 1
      return c < nvalid ? *reinterpret_cast<const float2*>(b + c) : make_float2(0.0f, 0.0f);
    };
    uint32_t mw[(N + 63) / 64] = {};
    bf16* dst = epi == RELU ? act() : tb();
    if constexpr (WIDE) {              // one call site of each epilogue (fewer registers)
      mirror().done_reading(ln, to_device ? 0 : N * 128);
      mirror().await_peer(ln, p);
      ++p;
      if (!to_device) {
        activation_out<N>(acc, bias2, epi == RELU, dst, ln, mw, cb);
        fence_async_smem();            // visible to the next products (and the copy)
      }
      if (epi != RELU) output<N>(op, acc, b, cb);
      sync();
      mirror().hand_over(ln, dst, cb, to_device ? 0 : N * 128);
      last = to_device ? -1 : (epi == RELU ? ACT : TB) << 16 | N;
    } else {
      ++p;
      if (to_device) {
        output<N>(op, acc, b, cb);
        return;
      }
      activation_out<N>(acc, bias2, epi == RELU, dst, ln, mw, cb);
      fence_async_smem();              // visible to the next products
      if (epi == T_OUT) output<N>(op, acc, b, cb);
      sync();
    }
  }

  // Class 2: a product of N columns a warpgroup, both warpgroups on the
  // tile's rows in phase (AnyOrder), warpgroup w's columns [wN, (w + 1)N)
  // of the slabs (the op's 2N).
  template <int N>
  __device__ __forceinline__ void run_product_in_phase(const int* op) {
    float acc[N / 2];
    const uint32_t a0 = smem_u32(buf(op[O_A0])), a1 = smem_u32(buf(op[O_A1]));
    const int cb = ln.wg * N;
    pe::product<N, PASS_DEPTH, AnyOrder, 2 * N>(op, a0, a1, rg, slab, ln.lane, acc, AnyOrder(),
                                                 cb);
    const int epi = op[O_EPI], nvalid = op[O_NVALID];
    const float* b = a.bias + op[O_BOFF];
    sync();                            // every warp's products have read their operands
    if (epi == RGB_OUT || epi == SEM_OUT) {
      output<N>(op, acc, b, cb);
      return;
    }
    uint32_t mw[(N + 63) / 64] = {};
    activation_out<N>(acc,
                      [&](int c) {     // nvalid is even: c < nvalid covers c + 1
                        return c < nvalid ? __ldg(reinterpret_cast<const float2*>(b + c))
                                          : make_float2(0.0f, 0.0f);
                      },
                      epi == RELU, epi == RELU ? act() : tb(), ln, mw, cb);
    fence_async_smem();                // visible to the next products
    if (epi == T_OUT) output<N>(op, acc, b, cb);
    sync();
  }

  // Class 2: a hidden layer over PASS_W (1024) wide, in two passes of both
  // warpgroups; warpgroup w's columns [512w + 256q, +256) in pass q.  The
  // first pass's relu'd bf16 waits in the block's scratch in device memory
  // (each thread's own words, read back by the same thread) until the
  // second pass has read the tile.
  __device__ __forceinline__ void run_passes(const int* op) {
    constexpr int N = MAX_N;
    const uint32_t a0 = smem_u32(buf(op[O_A0])), a1 = smem_u32(buf(op[O_A1]));
    const int cb = ln.wg * PASS_W;
    const auto bias2 = [&](int c) {    // nvalid is even: c < nvalid covers c + 1
      const float* b = a.bias + op[O_BOFF];
      return c < op[O_NVALID] ? __ldg(reinterpret_cast<const float2*>(b + c))
                              : make_float2(0.0f, 0.0f);
    };
    uint32_t mw[N / 64] = {};
    uint32_t* park = a.park + (long long)blockIdx.x * PARK_WORDS * CONSUMERS + threadIdx.x;
    {
      float acc[N / 2];
      pe::product<N, PASS_DEPTH, AnyOrder, PASS_W>(op, a0, a1, rg, slab, ln.lane, acc,
                                                   AnyOrder(), ln.wg * N);
      __nv_bfloat162 v[N / 4];
      activation_pack<N>(acc, bias2, true, v, ln, mw, cb);
#pragma unroll
      for (int i = 0; i < N / 4; ++i) park[i * CONSUMERS] = *reinterpret_cast<uint32_t*>(&v[i]);
    }
    float acc[N / 2];
    pe::product<N, PASS_DEPTH, AnyOrder, PASS_W>(op, a0, a1, rg, slab, ln.lane, acc, AnyOrder(),
                                                 ln.wg * N);
    sync();                            // every warp's products have read the tile
    activation_out<N>(acc, bias2, true, act(), ln, mw, cb + N);
    __nv_bfloat162 v[N / 4];
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint32_t w = park[i * CONSUMERS];
      v[i] = *reinterpret_cast<const __nv_bfloat162*>(&w);
    }
    store_packed<N>(v, act(), ln, cb);
    fence_async_smem();
    sync();
  }

  // Class 2: the block's 64-row tiles, warpgroup 0 encoding the rows and
  // loading the extras.
  __device__ __forceinline__ void run_in_phase() {
    const int n_ops = a.h[H_N_OPS];
    const bool owner = ln.wg == 0;
    for (long long tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
      row0 = first_row(tile);
      sync();                          // the last tile's outputs have left the stage
      if (owner) {
        load_x(row0);
        encode_row([&](int d) { return d == 0 ? xr[0] : d == 1 ? xr[1] : d == 2 ? xr[2] : xr[3]; },
                   row(), half(), a.h, enc());
      }
      fence_async_smem();
      sync();
      for (int o = 0; o < n_ops; ++o) {
        const int* op = ops + o * OP_INTS;
        if (op[O_KIND] == EX) {        // the extras, over the trunk's last activation
          if (owner) store_extras(op[O_N]);
          fence_async_smem();
          sync();
          continue;
        }
        switch (op[O_N] / 2) {
          case 8: run_product_in_phase<8>(op); break;
          case 16: run_product_in_phase<16>(op); break;
          case 32: run_product_in_phase<32>(op); break;
          case 64: run_product_in_phase<64>(op); break;
          case 128: run_product_in_phase<128>(op); break;
          case 256: run_product_in_phase<256>(op); break;
          case 512: run_passes(op); break;
        }
      }
    }
  }

  __device__ __forceinline__ void run() {
    const int n_ops = a.h[H_N_OPS];
    int n_products = 0, ex_w = 0;
    for (int o = 0; o < n_ops; ++o) {
      const int kind = op_list()[o * OP_INTS + O_KIND];
      n_products += kind == FWD;
      if (kind == EX) ex_w = op_list()[o * OP_INTS + O_N];
    }
    // the tiles: the block's (persistent blocks), or when wide its
    // cluster's, which both blocks of the cluster take
    const long long first = WIDE ? blockIdx.x / CLUSTER : blockIdx.x;
    const long long step = WIDE ? gridDim.x / CLUSTER : gridDim.x;
    const long long my_tiles = (a.n_tiles - first + step - 1) / step;
    total = my_tiles * n_products;
    if constexpr (!WIDE) load_x(first_row(first));
    for (long long tile = first; tile < a.n_tiles; tile += step) {
      row0 = first_row(tile);
      sync();                          // the last tile's outputs have left the stage
      if constexpr (WIDE) load_x(row0);    // (no registers held a tile ahead)
      encode_row([&](int d) { return d == 0 ? xr[0] : d == 1 ? xr[1] : d == 2 ? xr[2] : xr[3]; },
                 row(), half(), a.h, enc());
      fence_async_smem();
      sync();
      if constexpr (!WIDE) load_x(first_row(tile + step));   // the next tile's, ahead
      for (int o = 0; o < n_ops; ++o) {
        // the op's fields: from the block's copy when wide (fewer registers
        // over the products), else copied to registers
        int opr[OP_INTS];
        const int* op = op_list() + o * OP_INTS;
        if constexpr (!WIDE) {
#pragma unroll
          for (int i = 0; i < OP_INTS; ++i) opr[i] = op[i];
          op = opr;
        }
        if (op[O_KIND] == EX) {        // the extras, over the trunk's last activation
          store_extras(op[O_N]);
          fence_async_smem();
          sync();
          continue;
        }
        if (!WIDE && op[O_EPI] == T_OUT && ex_w > 0 && ex_w <= 2 * EX_REGS) load_extras(ex_w);
        switch (WIDE ? op[O_N] / 2 : op[O_N]) {
          case 8: if constexpr (WIDE) run_product<8>(op); break;
          case 16: run_product<16>(op); break;
          case 32: run_product<32>(op); break;
          case 64: run_product<64>(op); break;
          case 128: run_product<128>(op); break;
          case 256: run_product<256>(op); break;
        }
      }
    }
    if constexpr (WIDE) mirror().drain(ln, total);
  }
};

template <int WC>
__global__ void __launch_bounds__(ALL_THREADS, 1)
pe_field_fwd_kernel(const __grid_constant__ FwdArgs a) {
  constexpr bool WIDE = WC == 1;
  extern __shared__ __align__(1024) unsigned char smem[];
  const Ring rg = make_ring(smem, a.s.ring);
  float* bias = reinterpret_cast<float*>(smem + a.s.bias);
  int* ops = reinterpret_cast<int*>(smem + a.s.ops);
  uint64_t* turn = reinterpret_cast<uint64_t*>(smem + a.s.turn);
  init_ring(rg);
  if (threadIdx.x == 0) {
    mbar_init(&turn[0], 4);
    mbar_init(&turn[1], 4);
    mbar_fence_init();
  }
  if constexpr (WIDE) make_mirror(smem, a.s.mirror);
  if constexpr (WC != 2)
    for (int i = threadIdx.x; i < a.h[H_TOTAL_B]; i += ALL_THREADS) bias[i] = a.bias[i];
  for (int i = threadIdx.x; i < a.h[H_N_OPS] * OP_INTS; i += ALL_THREADS) ops[i] = a.ops[i];
  if constexpr (WIDE) cluster_sync();  // the peer's barriers are initialised
  else __syncthreads();
  split_roles(
      [&] {                            // the producer: the program's slabs, once per tile
        int slab = 0;
        if constexpr (WIDE) {
          for (long long tile = blockIdx.x / CLUSTER; tile < a.n_tiles; tile += gridDim.x / CLUSTER)
            produce_half_slabs(a.ops, a.h[H_N_OPS], a.img, rg, slab, blockIdx.x % CLUSTER);
        } else {
          for (long long tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x)
            produce_slabs<WC == 2>(a.ops, a.h[H_N_OPS], a.img, rg, slab);
        }
      },
      [&] {
        if constexpr (WC == 2) {
          FwdTile<WC> tile{a, smem, a.bias, ops, rg, turn};
          tile.run_in_phase();
        } else {
          FwdTile<WC> tile{a, smem + (threadIdx.x >> 7) * a.s.wg_bytes, bias, ops, rg, turn};
          tile.run();
        }
      });
}

// The forward program's header and ops, checked.
static bool program_fits(const int* prog, int prog_len) {
  if (!program_ok(prog, prog_len, 0) || prog[H_N_TASKS] != 0) return false;
  const int* h = prog;
  if (h[H_DIM] > MAX_DIM) return false;
  for (int o = 0; o < h[H_N_OPS]; ++o) {
    const int* op = prog + H_HEADER + o * OP_INTS;
    if (op[O_KIND] != FWD && op[O_KIND] != EX) return false;
    if (op[O_KIND] == EX && (op[O_N] > h[H_ACT_W] || op[O_N] < 1)) return false;
    if (op[O_KIND] == FWD && (op[O_EPI] < RELU || op[O_EPI] > SEM_OUT)) return false;
  }
  const Layout s = fwd_layout(h);
  return s.ring.stages >= (s.wc == 2 ? PASS_MIN_STAGES : MIN_STAGES);
}

}  // namespace pefwd
}  // namespace cropnerf

// Launches the forward on `stream`; returns a cudaError_t (0 on success).
// `prog` is the program (pe_plan.py build_forward_plan) on the host,
// `prog_dev` the same ints on the device; `img` is its weight image, `b`
// the packed f32 biases; `park` (class 2 alone, else unread) holds
// PARK_WORDS x 256 uint32 words for each SM of the device (pe_plan.py
// fwd_park_elems).  Without the heads ex, rgb_out and sem_out are not read
// (null).  Every pointer but `prog` is on the device.
extern "C" int cropnerf_pe_field_fwd(const float* x, const float* ex, float* t_out,
                                     float* rgb_out, float* sem_out, const void* img,
                                     const float* b, void* park, const int* prog,
                                     const int* prog_dev, int prog_len, long long n_rows,
                                     void* stream) {
  using namespace cropnerf::pefwd;
  if (!program_fits(prog, prog_len)) return (int)cudaErrorInvalidValue;
  if (width_class(prog) == 2 && park == nullptr) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  FwdArgs fa;
  fa.x = x; fa.ex = ex; fa.t = t_out; fa.rgb = rgb_out; fa.sem = sem_out;
  fa.img = reinterpret_cast<const cropnerf::bf16*>(img);
  fa.bias = b;
  fa.park = reinterpret_cast<uint32_t*>(park);
  fa.ops = prog_dev + H_HEADER;
  fa.n_rows = n_rows;
  for (int i = 0; i < H_HEADER; ++i) fa.h[i] = prog[i];
  fa.s = fwd_layout(prog);
  fa.n_tiles = (n_rows + tile_rows(fa.s) - 1) / tile_rows(fa.s);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (fa.s.wc == 1) {                  // persistent clusters; a refused launch returns its error
    cropnerf::pe::ClusterGrid grid{0, 0, 0};
    return cluster_launch(pe_field_fwd_kernel<1>, &fa, fa.s.total, fa.n_tiles, st, &grid);
  }
  auto kernel = fa.s.wc == 2 ? pe_field_fwd_kernel<2> : pe_field_fwd_kernel<0>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, fa.s.total);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)lmin(fa.n_tiles, sms);
  kernel<<<blocks, ALL_THREADS, fa.s.total, st>>>(fa);
  return (int)cudaGetLastError();
}

// The forward's grid at n_rows rows on the current device: out[0] the
// cluster size (0: persistent blocks, a program of class 0 or 2),
// out[1] the clusters resident at once (0 without clusters), out[2] the
// blocks launched.  Returns 0, -1 where the program is rejected, or a
// cudaError_t (cudaErrorLaunchOutOfResources where no cluster fits).
extern "C" int cropnerf_pe_field_fwd_grid(const int* prog, int prog_len, long long n_rows,
                                          long long* out) {
  using namespace cropnerf::pefwd;
  if (!program_fits(prog, prog_len)) return -1;
  const Layout s = fwd_layout(prog);
  const long long n_tiles = (n_rows + tile_rows(s) - 1) / tile_rows(s);
  if (s.wc == 1) {
    cropnerf::pe::ClusterGrid g{0, 0, 0};
    const int e = cluster_launch(pe_field_fwd_kernel<1>, static_cast<const FwdArgs*>(nullptr),
                                 s.total, n_tiles, nullptr, &g);
    out[0] = g.cluster;
    out[1] = g.active;
    out[2] = g.blocks;
    return e;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  out[0] = 0;
  out[1] = 0;
  out[2] = lmin(n_tiles, sms);
  return (int)e;
}

// Dynamic shared memory of the forward (-1 where the program is rejected).
extern "C" int cropnerf_pe_field_fwd_smem_bytes(const int* prog, int prog_len) {
  using namespace cropnerf::pefwd;
  if (!program_fits(prog, prog_len)) return -1;
  return fwd_layout(prog).total;
}
