// The "stream" route of the fused relu MLP for Hopper (sm_90a): forward and
// recompute backward of the nets the resident-weight wgmma kernels do not
// take, for both MLP kernels of the port:
//   K3 fused_mlp     x [N, din] -> relu MLP -> [N, dout]
//   K5 fused_pe_mlp  x [N, dim] -> NeRF encoding -> relu MLP -> [N, dout]
// Every net of 1 to 32 layers whose input (din, or the encoding's dim(1 +
// 2F) columns, at most 256) and every layer are at most 512 wide: deeper,
// wider or longer-input nets than fused_mlp_{fwd,bwd}.cu and
// fused_pe_mlp_*.cu hold in shared memory (ops/cuda/fused_mlp.py
// fused_mlp_route and ops/cuda/fused_pe_field.py pe_mlp_fwd_route pick the
// route by shape).
//
// Replaces, for those nets, cropnerf_tpu/ops/pallas/fused_mlp.py
// _fwd_kernel and _bwd_kernel (K3), and cropnerf_tpu/ops/pallas/
// fused_pe_field.py _plain_fwd_kernel and _plain_bwd_kernel (K5).
//
// Arithmetic, as the TPU kernels: bf16 operands with f32 sums; the input
// rounded to bf16 (K3's x; K5's encoding with the accurate sinf/cosf); the
// f32 bias added, relu, then bf16 after every hidden layer; the last layer
// linear, written in f32.  The backward recomputes the forward from x; the
// cotangents stay f32 and are rounded to bf16 only as product operands (g·Wᵀ
// and Aᵀ·g); relu masks come from the bf16 activations; the bias gradient
// is the f32 column sum of the cotangent.  Layer 0's input gradient is f32:
// K3's dx itself; K5's goes through the encoding's derivative per
// coordinate (the TPU kernel's _encode_bwd).
//
// Bound on an H100: operations for the nets this route exists for.  A
// 256-wide layer takes 65,536 MAC a row against a few bytes of x and of
// the output: cropnerf-mxu-q's proposal nets at 256 wide (33 or 39 -> 256
// -> 256 -> 1) take ~75 kMAC a row forward, and about three times that
// backward with weight gradients (recompute, input gradients, weight
// gradients).  The weight gradient needs every layer's activation and
// cotangent of every row, and a 256 x 256 f32 weight sum (256 KB) does not
// fit a block's shared memory, so the backward writes them to a workspace
// once and reads them once, ~2.2 KB a row at those nets, which costs more
// than the operations (PERF.md).
//
// Design.  The host plans each call (ops/cuda/mlp_plan.py): a program of
// ops in the PE field's format (pe_plan.py), each product naming its
// operand buffer, its widths and the offset of its B matrix in a weight
// image that holds every product's B in program order.  Both kernels run
// the PE field's tile interpreter (pe_tile.cuh): two consumer warpgroups
// of 64 rows each multiply with wgmma (64 x N, N = 16..256, f32
// accumulators in registers) on operands in shared memory, and a producer
// warpgroup streams the weight image through a ring of slabs with bulk
// copies that complete on mbarriers, handing its registers to the
// consumers (setmaxnreg).  Each warpgroup keeps two activation buffers, the
// input's (IN) and one (ACT) that every product reads and then overwrites
// in place with its output, so the net's depth costs no shared memory.
//  * mlp_stream_fwd_kernel: persistent blocks, one an SM, walk the 128-row
//    tiles; the producer streams the program's slabs once per tile without
//    draining the ring; the warpgroups run out of phase (pe_tile.cuh
//    PingPong), so one's epilogue runs while the other's slabs multiply;
//    64-row slabs, two wgmma groups in flight.  The last layer's epilogue
//    writes the f32 rows from the accumulators.
//  * mlp_stream_bwd_kernel, persistent clusters of CLUSTER blocks
//    that multicast each weight slab into every block's ring (pe_tile.cuh
//    ClusterRing, ClusterWalk), two wgmma groups in flight up to 256 wide:
//    per 128-row tile the forward
//    recompute (relu masks as bits, kept in device memory per block, so the
//    depth costs no shared memory either), the last layer's cotangent
//    from g, then G_{l-1} = mask ⊙ G_l·W_lᵀ in place layer by layer, and
//    layer 0's input gradient in 16..256-column products (K3: dx rows in
//    f32; K5: an f32 tile, then dx per coordinate).  With the weight
//    gradients each layer's A_l and G_l go to the workspace as whole 64-row
//    blocks by one bulk store each, and each warpgroup's bias column sums
//    to one row of partials; then pe_dw.cuh's pass: dW_l = A_lᵀ·G_l as a
//    split-K wgmma GEMM over the workspace and fixed-order sums of the
//    splits and the bias rows.
//  * a net with its input or a layer over 256 wide (up to 512) runs wide
//    (pe_tile.cuh).  The forward: persistent clusters of two blocks walk
//    the 128-row tiles together, each block computing half of every
//    product's columns from 32-row slabs of that half (16 KB), each
//    warpgroup on its own 64 rows out of phase (PingPongWide) with one
//    buffer (ACT, which takes the input too: layer 0 overwrites it in
//    place like every later layer), its half of every output written
//    there, then by one bulk copy into the peer block's copy (Mirror).
//    The backward: both warpgroups on one 64-row tile at a time, each
//    with half of every product's columns, one IN and one ACT buffer for
//    the block (64 KB each at 512), slabs of 32 rows as wide as the
//    product; the blocks take their 128-row tile's halves in turn, each
//    warpgroup storing its half of every product's workspace block.
//    At 512 wide the workspace is ~1 KB a row a layer for A_l and as much
//    for G_l, written once and read once (PERF.md).
// No floating-point atomics: two runs give the same bits, and the weight
// gradients are the same with and without dx.  Rows past N load zero x
// (K3) or encode zero x (K5) and zero cotangents, so they add nothing.
#include "pe_dw.cuh"

namespace cropnerf {
namespace stream {

using namespace pe;
using pebwd::DwSplit;
using pebwd::TASK_INTS;

// ---- the program (mirrors ops/cuda/mlp_plan.py) -------------------------------
enum {
  M_DIN, M_IN_PAD, M_DOUT, M_DIM, M_FREQS, M_ACT_W, M_N_OPS, M_N_TASKS, M_TOTAL_W,
  M_TOTAL_B, M_IMG_ELEMS, M_MASK_WORDS, M_WS_COLS, M_IN_SLOT, M_STORE, M_HEADER
};
enum { IN, ACT };                  // a warpgroup's buffers
enum { RELU, Y_OUT };              // epilogues of FWD ops
enum { G_MASKED, DX, GENC };       // epilogues of BWD ops

constexpr int STREAM_W = PASS_W;   // the widest input and layer of the route
constexpr int FWD_SLAB = 64;       // forward: weight rows a slab, one wgmma group
constexpr int FWD_DEPTH = 2;       // forward: wgmma groups in flight
constexpr int MIN_FWD_STAGES = 3;  // PingPong hands over after 1 slab: 1 <= stages - 2

// Whether a program runs wide (mlp_plan.py stream_wide): its input or a
// layer over MAX_N.
__host__ __device__ inline bool stream_wide(const int* h) {
  return h[M_IN_PAD] > MAX_N || h[M_ACT_W] > MAX_N;
}

// The header, ops and tasks the kernels accept.
inline bool program_ok(const int* prog, int prog_len, bool backward) {
  if (prog_len < M_HEADER) return false;
  const int* h = prog;
  const int n_ops = h[M_N_OPS], n_tasks = h[M_N_TASKS];
  if (n_ops < 1 || n_tasks < 0 || (!backward && n_tasks) ||
      prog_len != M_HEADER + n_ops * OP_INTS + n_tasks * TASK_INTS)
    return false;
  const int pad = h[M_IN_PAD], act_w = h[M_ACT_W];
  if (h[M_DIN] < 1 || pad < h[M_DIN] || pad % 16 || pad > STREAM_W ||
      !product_width(act_w, STREAM_W) || h[M_DOUT] < 1 || h[M_DOUT] > act_w || h[M_DIM] < 0)
    return false;
  if (h[M_DIM] > 0 && (h[M_FREQS] < 0 || h[M_FREQS] > 30 || pad > MAX_N ||
                       h[M_DIN] != h[M_DIM] * (1 + 2 * h[M_FREQS])))
    return false;
  const int most = stream_wide(h) ? STREAM_W : MAX_N;
  const int* ops = prog + M_HEADER;
  for (int o = 0; o < n_ops; ++o) {
    const int* op = ops + o * OP_INTS;
    const int kind = op[O_KIND], N = op[O_N];
    if (!product_width(N, most)) return false;
    // an output into ACT fits it; layer 0's input gradient goes elsewhere
    if (!(kind == BWD && op[O_EPI] != G_MASKED) && N > act_w) return false;
    if (kind == EMIT) {
      if (!backward) return false;
      continue;
    }
    if (kind != FWD && (kind != BWD || !backward)) return false;
    const int a0 = op[O_A0];
    if ((a0 != IN && a0 != ACT) || op[O_A1] != a0 || op[O_KA] != op[O_K] || op[O_K] <= 0 ||
        op[O_K] % 16 || op[O_K] > (a0 == IN ? pad : act_w))
      return false;
    if (kind == FWD && (op[O_EPI] < RELU || op[O_EPI] > Y_OUT)) return false;
    if (kind == BWD && (op[O_EPI] < G_MASKED || op[O_EPI] > GENC)) return false;
    if (kind == BWD && op[O_EPI] != G_MASKED && op[O_COL] + N > pad) return false;
  }
  return pebwd::tasks_ok(ops + n_ops * OP_INTS, n_tasks);
}

// A_0 of the 64 rows from row0: bf16(x) (K3, thread t of `step`), or K5's
// encoding of x rounded to bf16 (two threads a row, t < 128), zero past N
// and in the padded columns.
__device__ __forceinline__ void input_tile(const float* __restrict__ x, const int* h,
                                           long long row0, long long n_rows, bf16* dst, int t,
                                           int step) {
  const int din = h[M_DIN], pad = h[M_IN_PAD], dim = h[M_DIM];
  if (dim == 0) {
    for (int i = t; i < ROWS * pad; i += step) {
      const int r = i / pad, c = i - r * pad;
      const long long row = row0 + r;
      dst[cm(r, c)] = __float2bfloat16_rn((c < din && row < n_rows) ? x[row * din + c] : 0.0f);
    }
    return;
  }
  if (t >= 128) return;
  const int r = t >> 1;
  const long long row = row0 + r;
  encode_row([&](int d) { return row < n_rows ? __ldg(x + row * dim + d) : 0.0f; }, r, t & 1,
             dim, h[M_FREQS], din, pad, dst);
}

// ---- the forward ------------------------------------------------------------------

struct FwdLayout {     // dynamic shared memory, in bytes
  int wg_bytes;        // one warpgroup's region
  int in, act;         // offsets inside it (the same when wide)
  int turn, mirror, total;
  bool wide;
  RingLayout ring;
};

__host__ __device__ inline FwdLayout fwd_layout(const int* h) {
  FwdLayout s;
  int off = 0;
  s.wide = stream_wide(h);
  if (s.wide) {        // one buffer as wide as the input and every layer
    s.in = s.act = off;
    off += al128(ROWS * (int)lmax(h[M_IN_PAD], h[M_ACT_W]) * 2);
  } else {
    s.in = off; off += al128(ROWS * h[M_IN_PAD] * 2);
    s.act = off; off += al128(ROWS * h[M_ACT_W] * 2);
  }
  s.wg_bytes = off;
  off = 2 * s.wg_bytes;
  s.turn = off; off += 2 * 8;
  s.mirror = off; if (s.wide) off += MIRROR_BYTES;
  // a wide block's slabs: 32 rows of its half of the columns (MAX_N)
  s.ring = s.wide ? ring_layout(off, SLAB_K) : ring_layout(off, FWD_SLAB);
  s.total = s.ring.total;
  return s;
}

struct FwdArgs {
  const float* x;
  float* out;
  const bf16* img;
  const float* bias;
  const int* ops;
  long long n_rows, n_tiles;
  int h[M_HEADER];
  FwdLayout s;
};

template <bool WIDE>
struct FwdTile {
  const FwdArgs& a;
  unsigned char* wgm;   // this warpgroup's region
  Ring rg;
  uint64_t* turn;
  Mirror mir;           // when wide: the handshake with the peer block
  Lane ln;
  int last_buf = -1;    // when wide: the buffer the last product mirrored (-1: none)
  int last_half = 0;    // and the columns of its half
  long long row0 = 0;   // first row of the warpgroup in the current tile
  long long p = 0, total = 0;
  int slab = 0;

  __device__ __forceinline__ bf16* in() const { return reinterpret_cast<bf16*>(wgm + a.s.in); }
  __device__ __forceinline__ bf16* act() const { return reinterpret_cast<bf16*>(wgm + a.s.act); }
  // The threads that share the tile: the warpgroup.
  __device__ __forceinline__ void sync() const { named_sync(1 + ln.wg, 128); }

  // The f32 output rows: the product (columns from cb) plus the bias,
  // straight from the accumulators (rows past N and the padded columns
  // dropped).
  template <int N>
  __device__ __forceinline__ void y_out(const float (&v)[N / 2], const float* b, int nvalid,
                                        int cb) {
    const int cols = a.h[M_DOUT];
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int c = cb + 8 * j + ln.cq;
      const float2 bb = c < nvalid ? __ldg(reinterpret_cast<const float2*>(b + c))
                                   : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long row = row0 + ln.r0 + 8 * hh;
        if (row >= a.n_rows) continue;
        if (c < cols) a.out[row * cols + c] = v[4 * j + 2 * hh] + bb.x;
        if (c + 1 < cols) a.out[row * cols + c + 1] = v[4 * j + 2 * hh + 1] + bb.y;
      }
    }
  }

  // The slab of op's product that first reads the peer's half of the
  // last product's output (PingPongWide), or none.
  __device__ __forceinline__ int s_wait(const int* op) const {
    const int base = last_buf < 0 ? -1
                     : op[O_A0] == last_buf ? 0
                     : op[O_A1] == last_buf ? op[O_KA] : -1;
    return base < 0 ? 1 << 30
                    : (base + (int)((blockIdx.x % CLUSTER) ^ 1u) * last_half) / rg.slab_k;
  }

  // A product of N columns a warpgroup: the op's whole width, or when
  // wide this block's half of it, from column cb.  When wide a hidden
  // layer's output goes into this warpgroup's tile, then into the peer's
  // copy (Mirror).
  template <int N>
  __device__ __forceinline__ void run_product(const int* op) {
    float acc[N / 2];
    const uint32_t a0 = smem_u32(op[O_A0] == IN ? in() : act());
    if constexpr (WIDE)
      pe::product<N, FWD_DEPTH>(op, a0, 0, rg, slab, ln.lane, acc,
                                PingPongWide{{turn, ln.wg, ln.lane, p, total}, mir.wrote(ln),
                                             s_wait(op)});
    else
      pe::product<N, FWD_DEPTH>(op, a0, 0, rg, slab, ln.lane, acc,
                                PingPong{turn, ln.wg, ln.lane, p, total});
    const float* b = a.bias + op[O_BOFF];
    const int nvalid = op[O_NVALID];
    const int cb = WIDE ? (int)(blockIdx.x % CLUSTER) * N : 0;
    const bool to_device = op[O_EPI] == Y_OUT;
    sync();                            // every warp's products have read their operands
    if constexpr (WIDE) {
      mir.done_reading(ln, to_device ? 0 : N * 128);
      mir.await_peer(ln, p);
    }
    ++p;
    if (to_device) {
      y_out<N>(acc, b, nvalid, cb);
      if constexpr (WIDE) {
        sync();                        // every thread has passed await_peer
        mir.hand_over(ln, nullptr, 0, 0);
        last_buf = -1;
      }
      return;
    }
    uint32_t mw[(N + 63) / 64] = {};
    activation_out<N>(acc,
                      [&](int c) {     // nvalid is a multiple of 16: c < nvalid covers c + 1
                        return c < nvalid ? __ldg(reinterpret_cast<const float2*>(b + c))
                                          : make_float2(0.0f, 0.0f);
                      },
                      true, act(), ln, mw, cb);
    fence_async_smem();                // visible to the next products (and the copy)
    sync();
    if constexpr (WIDE) {
      mir.hand_over(ln, act(), cb, N * 128);
      last_buf = ACT;
      last_half = N;
    }
  }

  __device__ __forceinline__ void run() {
    const int n_ops = a.h[M_N_OPS];
    // the tiles: the block's (persistent blocks), or when wide its
    // cluster's, which both blocks of the cluster take
    const long long first = WIDE ? blockIdx.x / CLUSTER : blockIdx.x;
    const long long step = WIDE ? gridDim.x / CLUSTER : gridDim.x;
    const long long my_tiles = (a.n_tiles - first + step - 1) / step;
    total = my_tiles * n_ops;
    for (long long tile = first; tile < a.n_tiles; tile += step) {
      row0 = tile * TILE_ROWS + ln.wg * ROWS;
      sync();                          // the last tile's products have read IN
      input_tile(a.x, a.h, row0, a.n_rows, in(), ln.t, 128);
      fence_async_smem();
      sync();
      for (int o = 0; o < n_ops; ++o) {
        int op[OP_INTS];
#pragma unroll
        for (int i = 0; i < OP_INTS; ++i) op[i] = __ldg(a.ops + o * OP_INTS + i);
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
    if constexpr (WIDE) mir.drain(ln, total);
  }
};

template <bool WIDE>
__global__ void __launch_bounds__(ALL_THREADS, 1)
mlp_stream_fwd_kernel(const __grid_constant__ FwdArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Ring rg = make_ring(smem, a.s.ring);
  uint64_t* turn = reinterpret_cast<uint64_t*>(smem + a.s.turn);
  init_ring(rg);
  if (threadIdx.x == 0) {
    mbar_init(&turn[0], 4);
    mbar_init(&turn[1], 4);
    mbar_fence_init();
  }
  Mirror mir{};
  if constexpr (WIDE) {
    mir = make_mirror(smem, a.s.mirror);
    cluster_sync();                    // the peer's barriers are initialised
  } else {
    __syncthreads();
  }
  split_roles(
      [&] {                            // the producer: the program's slabs, once per tile
        int slab = 0;
        if constexpr (WIDE) {
          for (long long tile = blockIdx.x / CLUSTER; tile < a.n_tiles; tile += gridDim.x / CLUSTER)
            produce_half_slabs(a.ops, a.h[M_N_OPS], a.img, rg, slab, blockIdx.x % CLUSTER);
        } else {
          for (long long tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x)
            produce_slabs(a.ops, a.h[M_N_OPS], a.img, rg, slab);
        }
      },
      [&] {
        FwdTile<WIDE> tile{a, smem + (threadIdx.x >> 7) * a.s.wg_bytes, rg, turn, mir};
        tile.run();
      });
}

// ---- the backward -----------------------------------------------------------------

constexpr int CS_BYTES = 4 * MAX_N * 4;     // a warpgroup's bias column sums
constexpr int BWD_DEPTH = 2;       // backward up to MAX_N wide: wgmma groups in flight
constexpr int MIN_BWD_STAGES = 3;  // and its stages (DEPTH 2 holds three)

struct BwdLayout {     // dynamic shared memory of the tile kernel, in bytes
  int wg_bytes;        // one warpgroup's region (the block's one region when wide)
  int in, genc, act, colsum;   // offsets inside it; K5's f32 genc over in
  int total;
  bool wide;
  RingLayout ring;
};

__host__ __device__ inline int min_bwd_stages(bool wide) { return wide ? 2 : MIN_BWD_STAGES; }

__host__ __device__ inline BwdLayout bwd_layout(const int* h) {
  BwdLayout s;
  const int in_bytes = al128(ROWS * h[M_IN_PAD] * 2);
  s.in = s.genc = 0;
  int off = h[M_DIM] > 0 ? (int)lmax(in_bytes, al128(ROWS * h[M_IN_PAD] * 4)) : in_bytes;
  s.act = off; off += al128(ROWS * h[M_ACT_W] * 2);
  s.wide = stream_wide(h);
  s.colsum = off; off += (s.wide ? 2 : 1) * CS_BYTES;
  s.wg_bytes = off;
  off = (s.wide ? 1 : 2) * s.wg_bytes;
  // a cluster ring of 64-row slabs where MIN_BWD_STAGES of them fit (fewer
  // waits and releases a product, faster than 32-row slabs up to 256 wide;
  // PERF.md), else 32-row slabs, or 16 where the stages the kernel needs (2
  // wide, else MIN_BWD_STAGES) of 32 do not fit (K5 at 256 encoding columns)
  const int width = s.wide ? STREAM_W : MAX_N;
  s.ring = ring_layout(off, 2 * SLAB_K, width, CLUSTER_BAR_SETS);
  if (s.ring.stages < MIN_BWD_STAGES) s.ring = ring_layout(off, SLAB_K, width, CLUSTER_BAR_SETS);
  if (s.ring.stages < min_bwd_stages(s.wide))
    s.ring = ring_layout(off, SLAB_K / 2, width, CLUSTER_BAR_SETS);
  s.total = s.ring.total;
  return s;
}

struct BwdArgs {
  const float *x, *g;
  float* dx;
  const bf16* img;
  const float* bias;
  const int* ops;
  bf16* ws;
  uint32_t* masks;
  float* bpart;
  long long n_rows, n_pad, n_tiles;
  int h[M_HEADER];
  BwdLayout s;
};

template <bool STORE, bool WIDE>
struct BwdTile {
  const BwdArgs& a;
  unsigned char* wgm;   // this warpgroup's region
  uint32_t* masks;      // the block's relu masks, a word a thread per 64 columns
  Ring rg;
  Lane ln;
  long long row0 = 0;   // first row of the warpgroup
  int slab = 0;
  int part_row = 0;     // the row of the bias partials its rows' sums go to

  __device__ bf16* in() const { return reinterpret_cast<bf16*>(wgm + a.s.in); }
  __device__ float* genc() const { return reinterpret_cast<float*>(wgm + a.s.genc); }
  __device__ bf16* act() const { return reinterpret_cast<bf16*>(wgm + a.s.act); }
  __device__ float* colsum() const {
    return reinterpret_cast<float*>(wgm + a.s.colsum + (WIDE ? ln.wg * CS_BYTES : 0));
  }
  // The threads that share the tile: a warpgroup, or both when wide.
  __device__ void sync() const {
    if constexpr (WIDE) named_sync(1, CONSUMERS);
    else named_sync(1 + ln.wg, 128);
  }
  // Whether this warpgroup forms K5's dx of the rows (when wide,
  // warpgroup 0 for both).
  __device__ bool rows_owner() const { return !WIDE || ln.wg == 0; }
  // The first of the op's columns this warpgroup computes (N a warpgroup).
  template <int N>
  __device__ int col_base() const { return WIDE ? ln.wg * N : 0; }

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

  // A cotangent tile (the warpgroup's N columns) into ACT in place: the
  // relu mask of `mask` (-1: none), bf16 for the next product, f32 column
  // sums for the bias gradient, the workspace slot.
  template <int N>
  __device__ void emit_g(const int* op, float (&v)[N / 2]) {
    const int cb = col_base<N>();
    constexpr int W = (N + 63) / 64;
    uint32_t mw[W];
    const int mask = op[O_MASK];
#pragma unroll
    for (int w = 0; w < W; ++w)
      mw[w] = mask >= 0 ? masks[(mask + w) * CONSUMERS + threadIdx.x] : 0xffffffffu;
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
      pebwd::warp_colsum<N / 4>(s, colsum() + ln.warp * MAX_N, ln.lane);
    }
    after_write(dst, op[O_WS], op[O_N], true);
    if (STORE && boff >= 0) {
      const float* cs = colsum();
      float* out = a.bpart + (long long)part_row * a.h[M_TOTAL_B] + boff + cb;
      for (int c = ln.t; c < N && cb + c < op[O_NVALID]; c += 128)
        out[c] = ((cs[c] + cs[MAX_N + c]) + cs[2 * MAX_N + c]) + cs[3 * MAX_N + c];
    }
  }

  // The recompute of a hidden layer: bias, relu, bf16 into ACT, its mask.
  template <int N>
  __device__ void forward_epilogue(const int* op, float (&v)[N / 2]) {
    const int cb = col_base<N>();
    const float* bias = a.bias + op[O_BOFF];
    const int nvalid = op[O_NVALID];
    constexpr int W = (N + 63) / 64;
    uint32_t mw[W];
#pragma unroll
    for (int w = 0; w < W; ++w) mw[w] = 0;
    before_write();
    activation_out<N>(v,
                      [&](int c) {
                        return c < nvalid ? __ldg(reinterpret_cast<const float2*>(bias + c))
                                          : make_float2(0.0f, 0.0f);
                      },
                      true, act(), ln, mw, cb);
#pragma unroll
    for (int w = 0; w < W; ++w) masks[(op[O_MASK] + w) * CONSUMERS + threadIdx.x] = mw[w];
    after_write(act(), op[O_WS], op[O_N], true);
  }

  template <int N>
  __device__ void run_product(const int* op) {
    float acc[N / 2];
    const int cb = col_base<N>();
    pe::product<N, WIDE ? 1 : BWD_DEPTH, AnyOrder, WIDE ? 2 * N : N>(
        op, smem_u32(op[O_A0] == IN ? in() : act()), 0, rg, slab, ln.lane, acc, AnyOrder(), cb);
    if (op[O_KIND] == FWD) {
      forward_epilogue<N>(op, acc);
      return;
    }
    const int epi = op[O_EPI];
    if (epi == G_MASKED) {
      emit_g<N>(op, acc);
      return;
    }
    before_write();
    if (epi == DX) {                   // K3: dx columns from O_COL, f32
      const int din = a.h[M_DIN];
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int c = op[O_COL] + cb + 8 * j + ln.cq;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const long long row = row0 + ln.r0 + 8 * (q >> 1);
          if (c + (q & 1) < din && row < a.n_rows) a.dx[row * din + c + (q & 1)] = acc[4 * j + q];
        }
      }
    } else {                           // K5: the f32 input gradient of the encoding
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int c = op[O_COL] + cb + 8 * j + ln.cq;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(genc() + cm(ln.r0 + 8 * hh, c)) =
              make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
      }
    }
    fence_async_smem();
    sync();
  }

  // The last layer's cotangent from g [N, dout].
  template <int N>
  __device__ void emit(const int* op) {
    float v[N / 2];
    const int cols = a.h[M_DOUT], cb = col_base<N>();
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long row = row0 + ln.r0 + 8 * (q >> 1);
        const int c = cb + 8 * j + ln.cq + (q & 1);
        v[4 * j + q] = (c < cols && row < a.n_rows) ? a.g[row * cols + c] : 0.0f;
      }
    }
    emit_g<N>(op, v);
  }

  __device__ void run() {
    if constexpr (WIDE) input_tile(a.x, a.h, row0, a.n_rows, in(), threadIdx.x, CONSUMERS);
    else input_tile(a.x, a.h, row0, a.n_rows, in(), ln.t, 128);
    after_write(in(), a.h[M_IN_SLOT], a.h[M_IN_PAD], false);
    const int n_ops = a.h[M_N_OPS];
    for (int o = 0; o < n_ops; ++o) {
      int op[OP_INTS];
#pragma unroll
      for (int i = 0; i < OP_INTS; ++i) op[i] = __ldg(a.ops + o * OP_INTS + i);
      const int kind = op[O_KIND];
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
      }
    }
  }
};

// K5's dx = (d encode / d pre · g_enc) · Sᵀ over a warpgroup's rows, from
// the f32 tile of the encoding's input gradient and x; one function for
// both kernel variants, so dx alone is bit-equal to the dx of the full
// backward.
__device__ __noinline__ void pe_dx_rows(const float* __restrict__ x, const float* genc,
                                        float* dx, long long row0, long long n_rows, int dim,
                                        int F, int t) {
  const int sin_end = dim * (1 + F);
  for (int i = t; i < ROWS * dim; i += 128) {
    const int r = i / dim;
    const int dd = i - r * dim;
    const long long row = row0 + r;
    if (row >= n_rows) continue;
    const float xv = x[row * dim + dd];
    float acc = genc[cm(r, dd)];
    for (int f = 0; f < F; ++f) {
      const float scale = (float)(1 << f);
      const float pre = xv * scale;
      acc += genc[cm(r, dim + f * dim + dd)] * cosf(pre) * scale;
      acc += -genc[cm(r, sin_end + f * dim + dd)] * sinf(pre) * scale;
    }
    dx[row * dim + dd] = acc;
  }
}

// One block of a persistent cluster (pe_tile.cuh): the cluster ring, and
// the block's tiles in ClusterWalk's order.  Up to MAX_N wide the two
// warpgroups take a 128-row tile's halves, two wgmma groups in flight; a
// wide program takes the halves in turn with both warpgroups on each.
// Bias partials stay one row a tile's 64-row half (part_row), whatever
// block takes it; relu masks are the block's.
template <bool STORE, bool WIDE>
__global__ void __launch_bounds__(ALL_THREADS, 1)
mlp_stream_bwd_kernel(const __grid_constant__ BwdArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  using Walk = ClusterWalk<CLUSTER>;
  const ClusterRing<CLUSTER> rg = make_cluster_ring<CLUSTER>(smem, a.s.ring);
  init_cluster_ring(rg);
  cluster_sync();
  const int n_ops = a.h[M_N_OPS];
  constexpr int halves = WIDE ? 2 : 1;
  split_roles(
      [&] {                            // the producer: the slabs, once a tile's half
        int slab = 0;
        for (int grp = Walk::first(); grp < Walk::groups(a.n_tiles); grp += Walk::step())
          for (int i = 0; i < halves; ++i)
            produce_slabs_multicast(a.ops, n_ops, a.img, rg, slab, cluster_rank());
        await_release(rg, slab);
      },
      [&] {
        const int wg = threadIdx.x >> 7;
        BwdTile<STORE, WIDE> tile{a, smem + (WIDE ? 0 : wg) * a.s.wg_bytes,
                                  a.masks + (long long)blockIdx.x * a.h[M_MASK_WORDS] * CONSUMERS,
                                  rg.ring};
        const int n_halves = halves * Walk::my_groups(a.n_tiles);
        for (int h = 0; h < n_halves; ++h) {
          const long long t = Walk::tile(Walk::first() + h / halves * Walk::step());
          if (t >= a.n_tiles) {        // a padding tile: the slabs, nothing written
            skip_slabs(a.ops, n_ops, tile.rg, tile.slab, tile.ln.lane);
            continue;
          }
          const int part = WIDE ? h & 1 : wg;
          tile.row0 = t * TILE_ROWS + part * ROWS;
          tile.part_row = (int)(t * 2 + part);
          if (h) tile.before_write();  // the last half's stores and dx have read the tile
          tile.run();
          if (a.dx != nullptr && a.h[M_DIM] > 0 && tile.rows_owner())
            pe_dx_rows(a.x, tile.genc(), a.dx, tile.row0, a.n_rows, a.h[M_DIM], a.h[M_FREQS],
                       tile.ln.t);
        }
        if (STORE && tile.ln.t == 0) bulk_wait();
      });
}

// The backward's program, checked, and the split plan of its
// weight-gradient pass.
struct Plan {
  const int* h;
  DwSplit split;
};

static bool bwd_plan(const int* prog, int prog_len, long long n_rows, Plan* p) {
  if (!program_ok(prog, prog_len, true)) return false;
  p->h = prog;
  const BwdLayout s = bwd_layout(prog);
  if (s.ring.stages < min_bwd_stages(s.wide)) return false;
  p->split = pebwd::dw_split(n_rows, prog[M_N_TASKS]);
  return true;
}

static bool fwd_program_fits(const int* prog, int prog_len) {
  return program_ok(prog, prog_len, false) && fwd_layout(prog).ring.stages >= MIN_FWD_STAGES;
}

}  // namespace stream
}  // namespace cropnerf

// Launches the forward on `stream`; returns a cudaError_t (0 on success).
// `prog` is the forward program (mlp_plan.py) on the host, `prog_dev` the
// same ints on the device; `img` is its weight image, `b` the padded f32
// biases.  x is [n_rows, din] (K3) or [n_rows, dim] (K5), out [n_rows,
// dout].  Every pointer but `prog` is on the device.
extern "C" int cropnerf_mlp_stream_fwd(const float* x, float* out, const void* img,
                                       const float* b, const int* prog, const int* prog_dev,
                                       int prog_len, long long n_rows, void* stream) {
  using namespace cropnerf::stream;
  if (!fwd_program_fits(prog, prog_len)) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  FwdArgs fa;
  fa.x = x;
  fa.out = out;
  fa.img = reinterpret_cast<const cropnerf::bf16*>(img);
  fa.bias = b;
  fa.ops = prog_dev + M_HEADER;
  fa.n_rows = n_rows;
  for (int i = 0; i < M_HEADER; ++i) fa.h[i] = prog[i];
  fa.s = fwd_layout(prog);
  fa.n_tiles = (n_rows + TILE_ROWS - 1) / TILE_ROWS;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (fa.s.wide) {                     // persistent clusters; a refused launch returns its error
    cropnerf::pe::ClusterGrid grid{0, 0, 0};
    return cluster_launch(mlp_stream_fwd_kernel<true>, &fa, fa.s.total, fa.n_tiles, st, &grid);
  }
  auto kernel = mlp_stream_fwd_kernel<false>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, fa.s.total);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)lmin(fa.n_tiles, sms);
  kernel<<<blocks, ALL_THREADS, fa.s.total, st>>>(fa);
  return (int)cudaGetLastError();
}

// The forward's grid at n_rows rows on the current device: out[0] the
// cluster size (0: persistent blocks, a program at most MAX_N wide),
// out[1] the clusters resident at once (0 without clusters), out[2] the
// blocks launched.  Returns 0, -1 where the program is rejected, or a
// cudaError_t (cudaErrorLaunchOutOfResources where no cluster fits).
extern "C" int cropnerf_mlp_stream_fwd_grid(const int* prog, int prog_len, long long n_rows,
                                            long long* out) {
  using namespace cropnerf::stream;
  if (!fwd_program_fits(prog, prog_len)) return -1;
  const FwdLayout s = fwd_layout(prog);
  const long long n_tiles = (n_rows + TILE_ROWS - 1) / TILE_ROWS;
  if (s.wide) {
    cropnerf::pe::ClusterGrid g{0, 0, 0};
    const int e = cluster_launch(mlp_stream_fwd_kernel<true>,
                                 static_cast<const FwdArgs*>(nullptr), s.total, n_tiles, nullptr,
                                 &g);
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
extern "C" int cropnerf_mlp_stream_fwd_smem_bytes(const int* prog, int prog_len) {
  using namespace cropnerf::stream;
  if (!fwd_program_fits(prog, prog_len)) return -1;
  return fwd_layout(prog).total;
}

// The SMs of the current device: a bound on the backward's persistent grid
// (a block takes more than half an SM's shared memory).
static cudaError_t device_sms(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

// Sizes of the buffers the wrapper allocates for cropnerf_mlp_stream_bwd:
// out[0] bf16 workspace elements, out[1] uint32 relu-mask words (a block's
// for each SM of the current device), out[2] f32 bias partials (and their
// chunk sums), out[3] f32 weight partials (0, 0, 0 for the workspace and
// the partials without the weight gradients), out[4] packed weights,
// out[5] packed biases.  Returns 0, -1 where the program is rejected, or
// the cudaError_t of the device query.
extern "C" int cropnerf_mlp_stream_bwd_sizes(const int* prog, int prog_len, long long n_rows,
                                             long long* out) {
  using namespace cropnerf::stream;
  Plan p;
  if (!bwd_plan(prog, prog_len, n_rows, &p)) return -1;
  int sms = 0;
  const cudaError_t e = device_sms(&sms);
  if (e != cudaSuccess) return (int)e;
  const int* h = p.h;
  const bool store = h[M_STORE] != 0;
  out[0] = store ? (long long)h[M_WS_COLS] * p.split.n_pad + ROWS * 128 : 0;
  out[1] = (long long)sms * h[M_MASK_WORDS] * CONSUMERS;
  out[2] = store ? cropnerf::pebwd::bias_partial_elems(p.split, h[M_TOTAL_B]) : 0;
  out[3] = store ? p.split.splits * (long long)h[M_TOTAL_W] : 0;
  out[4] = h[M_TOTAL_W];
  out[5] = h[M_TOTAL_B];
  return 0;
}

// Dynamic shared memory of the backward's tile kernel (-1 where the
// program is rejected).
extern "C" int cropnerf_mlp_stream_bwd_smem_bytes(const int* prog, int prog_len) {
  using namespace cropnerf::stream;
  Plan p;
  if (!bwd_plan(prog, prog_len, 1, &p)) return -1;
  return bwd_layout(p.h).total;
}

namespace cropnerf {
namespace stream {

static decltype(&mlp_stream_bwd_kernel<true, true>) bwd_kernel(bool store, bool wide) {
  return store ? (wide ? mlp_stream_bwd_kernel<true, true> : mlp_stream_bwd_kernel<true, false>)
               : (wide ? mlp_stream_bwd_kernel<false, true> : mlp_stream_bwd_kernel<false, false>);
}

}  // namespace stream
}  // namespace cropnerf

// The tile kernel's persistent grid at n_rows on the current device:
// out[0] the cluster size, out[1] the clusters resident at once, out[2] the
// blocks launched.  Returns 0, -1 where the program is rejected, or a
// cudaError_t (cudaErrorLaunchOutOfResources where no cluster fits).
extern "C" int cropnerf_mlp_stream_bwd_grid(const int* prog, int prog_len, long long n_rows,
                                            long long* out) {
  using namespace cropnerf::stream;
  Plan p;
  if (!bwd_plan(prog, prog_len, n_rows, &p)) return -1;
  const BwdLayout s = bwd_layout(p.h);
  cropnerf::pe::ClusterGrid g{0, 0, 0};
  const int e = cluster_launch(bwd_kernel(p.h[M_STORE] != 0, s.wide),
                               static_cast<const BwdArgs*>(nullptr), s.total,
                               (p.split.n_tiles + CLUSTER - 1) / CLUSTER, nullptr, &g);
  out[0] = g.cluster;
  out[1] = g.active;
  out[2] = g.blocks;
  return e;
}

// Launches the backward on `stream`; returns a cudaError_t (0 on success).
// `prog` is the backward program on the host, `prog_dev` the same ints on
// the device; every other pointer is on the device.  g is the cotangent
// [n_rows, dout]; a null dx skips dx (the program then has no input-gradient
// ops of layer 0).  masks, ws, bpart and wpart are scratch of the sizes
// above; dw and db receive the packed f32 weight and bias gradients (the
// layout of ops/cuda/common.py pack_layers).  The tile kernel runs as
// persistent clusters (cropnerf_mlp_stream_bwd_grid); a refused cluster
// launch returns its error, with no other grid tried.
extern "C" int cropnerf_mlp_stream_bwd(const float* x, const float* g, float* dx, const void* img,
                                       const float* b, const int* prog, const int* prog_dev,
                                       int prog_len, long long n_rows, void* ws, void* masks,
                                       float* bpart, float* wpart, float* dw, float* db,
                                       void* stream) {
  using namespace cropnerf::stream;
  Plan p;
  if (!bwd_plan(prog, prog_len, n_rows, &p)) return (int)cudaErrorInvalidValue;
  const int* h = p.h;
  const bool store = h[M_STORE] != 0;
  if (store && (ws == nullptr || bpart == nullptr || wpart == nullptr || dw == nullptr ||
                db == nullptr))
    return (int)cudaErrorInvalidValue;
  if (h[M_MASK_WORDS] > 0 && masks == nullptr) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int sms = 0;
  cudaError_t e = device_sms(&sms);
  if (e != cudaSuccess) return (int)e;

  BwdArgs ba;
  ba.x = x;
  ba.g = g;
  ba.dx = dx;
  ba.img = reinterpret_cast<const cropnerf::bf16*>(img);
  ba.bias = b;
  ba.ops = prog_dev + M_HEADER;
  ba.ws = reinterpret_cast<cropnerf::bf16*>(ws);
  ba.masks = reinterpret_cast<uint32_t*>(masks);
  ba.bpart = bpart;
  ba.n_rows = n_rows;
  ba.n_pad = p.split.n_pad;
  ba.n_tiles = p.split.n_tiles;
  for (int i = 0; i < M_HEADER; ++i) ba.h[i] = h[i];
  ba.s = bwd_layout(h);
  cropnerf::pe::ClusterGrid grid{0, 0, 0};
  // the masks hold a block's words for each SM
  const int err = cluster_launch(bwd_kernel(store, ba.s.wide), &ba, ba.s.total,
                                 (ba.n_tiles + CLUSTER - 1) / CLUSTER, s, &grid, sms);
  if (err || !store) return err;
  return cropnerf::pebwd::run_dw_sums(ba.ws, prog_dev + M_HEADER + h[M_N_OPS] * OP_INTS,
                                      h[M_N_TASKS], p.split, h[M_TOTAL_W], h[M_TOTAL_B], wpart,
                                      bpart, dw, db, s);
}
