// Fused positional-encoding NeRF field, backward, for Hopper (sm_90a): the
// trunk + colour and semantic heads (heads = 1), or the trunk alone
// (heads = 0).
//
// Replaces cropnerf_tpu/ops/pallas/fused_pe_field.py:_mega_bwd_kernel (the
// backward of fused_pe_nerf, wrapper _mega_bwd) and _bwd_kernel (the
// backward of fused_pe_density, wrapper _bwd).  Given x [N, dim], the
// extras [N, De] (heads only), the packed weights and the cotangents
// g_t [N, 1+G] (and g_rgb [N, 3], g_sem [N, C] with the heads), it returns
// dx [N, dim], dextras [N, De] and the float32 gradient of every weight and
// bias, in the packed layout the forward reads (ops/cuda/common.py
// pack_layers), for the wrapper to unpack.  A null dx skips dx; a null
// wpart skips the weight and bias gradients (passes 2 and 3 and the
// workspace's cotangent slots): the BayesRays pass asks for dx alone.
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
// outputs; two times (~0.34 ms) for the trunk's dx alone.
//
// Design.  On the TPU the grid runs in order and the kernel sums weight
// gradients across grid steps in its output refs; on the card blocks run
// concurrently, so that sum is a cross-block reduction and is done in
// passes, without floating-point atomics, so two runs give the same bits:
//   1. pe_field_bwd_tile_kernel, one block per 128-row tile: recomputes the
//      forward, writes every layer's bf16 input activation A_l to a
//      workspace in device memory, backpropagates the tile through the heads
//      and the trunk (input gradients on the tensor cores, Wᵀ staged
//      column-major in shared memory), writes each layer's bf16 cotangent
//      G_l to the workspace, each layer's per-tile f32 bias-gradient sum to
//      a partial buffer, dx and dextras.  Every activation of the network
//      would take ~67 KB of shared memory per layer, far beyond a block's
//      227 KB, so activations go to the workspace (bf16, ~8 KB a row at the
//      flagship's widths; the wrapper allocates it) and the block keeps only
//      the two cotangent buffers it is working on.
//   2. pe_field_bwd_dw_kernel: dW_l = A_lᵀ·G_l as a split-K product over row
//      chunks, each block a 64x64 output tile of one layer over one chunk,
//      written to an f32 [splits, packed weights] buffer.
//   3. column_sum_kernel: sums the splits into dW and the tiles' bias sums
//      into db, in a fixed order.
// Rows past N load zero cotangents, so they add nothing to dW or db.  This
// first version uses wmma (mma.sync); pipelining is later work.
#include "bwd_layers.cuh"
#include "pe_field.cuh"

namespace cropnerf {

constexpr int DW_BM = 64;              // dW tile: weight rows (input features)
constexpr int DW_BN = 64;              // dW tile: weight columns (outputs)
constexpr int DW_RK = 32;              // rows of the batch staged per step
constexpr int DW_LD = 64 + PAD;
constexpr int DW_THREADS = (DW_BM / 16) * 32;
constexpr int ROWS_PER_SPLIT = 2048;   // batch rows per split-K chunk

// Column offsets of the workspace slots, a bf16 [n_pad, cols] matrix: the
// encoding, the extras, each layer's bf16 output (act; -1 for the heads'
// last layers, whose outputs the backward does not read) and each layer's
// cotangent (g; -1 without the weight-gradient pass, which alone reads
// them).  act of the last trunk layer is bf16(t), the heads' input (written
// but not read without the heads).
struct Slots {
  int enc, ex, cols;
  int act[MAX_LAYERS];
  int g[MAX_LAYERS];
};

static Slots make_slots(const NetDesc& d, bool need_dw) {
  Slots s;
  int off = 0;
  s.enc = off; off += d.enc_pad;
  s.ex = off; off += d.ex_pad;
  const int n = d.n_layers();
  for (int l = 0; l < n; ++l) {
    const bool last_head = d.n_color > 0 && (l == d.sem0() - 1 || l == n - 1);
    s.act[l] = last_head ? -1 : off;
    if (!last_head) off += d.L[l].n;
  }
  for (int l = 0; l < n; ++l) {
    s.g[l] = need_dw ? off : -1;
    if (need_dw) off += d.L[l].n;
  }
  s.cols = off;
  return s;
}

// Slot and row range of layer l's input [A0 | A1] (A1 from row ka on).
static void layer_inputs(const NetDesc& d, const Slots& s, int l, int* a0,
                         int* a1) {
  *a1 = -1;
  if (l == 0) *a0 = s.enc;
  else if (l == d.sem0()) *a0 = s.act[d.color0() - 1];
  else *a0 = s.act[l - 1];
  if (l == d.top0()) *a1 = s.enc;
  if (l == d.color0()) *a1 = s.ex;
}

struct BwdSmem {
  int xs, enc, ex, tb, genc, gt, buf0, buf1, wslab, scratch, colsum, total;
};

// The forward's buffers (enc, ex, tb) and the backward's f32 cotangents of
// the encoding and of t (genc, gt) share one region.
__host__ __device__ inline BwdSmem bwd_smem_layout(const NetDesc& d) {
  BwdSmem s;
  int off = 0;
  s.xs = off; off += align128(TILE * d.dim * 4);
  const int u = off;
  s.enc = off; off += act_bytes(d.enc_pad);
  s.ex = off; off += act_bytes(d.ex_pad);
  s.tb = off; off += act_bytes(d.t_pad());
  const int fwd_end = off;
  off = u;
  s.genc = off; off += align128(TILE * d.enc_pad * 4);
  s.gt = off; off += align128(TILE * d.t_pad() * 4);
  off = off > fwd_end ? off : fwd_end;
  s.buf0 = off; off += act_bytes(d.hmax);
  s.buf1 = off; off += act_bytes(d.hmax);
  const int slab = slab_bytes(d.hmax);
  const int slab_t = wt_slab_bytes(MAX_WIDTH);
  s.wslab = off; off += slab > slab_t ? slab : slab_t;
  s.scratch = off; off += SCRATCH_BYTES;
  s.colsum = off; off += WARPS * MAX_WIDTH * 4;
  s.total = off;
  return s;
}

// Forward epilogue: optional relu, bf16 into shared memory and into the
// layer's workspace slot.
struct ToSmemStash {
  bf16* dst;
  int ld;
  bool relu;
  bf16* ws;
  long long ws_ld, row0;
  int col;
  __device__ __forceinline__ void operator()(int r, int c, float v) const {
    const bf16 h = __float2bfloat16_rn(relu ? fmaxf(v, 0.0f) : v);
    dst[r * ld + c] = h;
    ws[(row0 + r) * ws_ld + col + c] = h;
  }
};

// Backward epilogue of a layer's cotangent: the relu mask of the layer's
// output, bf16 into the next product's operand and, for the weight-gradient
// pass, into the workspace; the f32 value feeds the bias-gradient column
// sum.
template <bool STORE>    // keep G for the weight-gradient pass
struct GEmit {
  static constexpr bool kColsum = true;
  bf16* gb;
  int ldg;
  bf16* ws;
  long long ws_ld, row0;
  int g_col, mask_col;   // mask_col -1: no activation after the layer
  __device__ __forceinline__ float operator()(int r, int c, float v) const {
    bf16* row = ws + (row0 + r) * ws_ld;
    if (mask_col >= 0 && !(__bfloat162float(row[mask_col + c]) > 0.0f)) v = 0.0f;
    const bf16 h = __float2bfloat16_rn(v);
    gb[r * ldg + c] = h;
    if (STORE) row[g_col + c] = h;
    return v;
  }
};

// HEADS: the trunk and both heads (fused_pe_nerf) or the trunk alone
// (fused_pe_density); STORE: with the weight-gradient pass (G to the
// workspace, per-tile bias sums).  Compile-time, so each variant keeps only
// the work and the registers it needs.
template <bool HEADS, bool STORE>
__global__ void __launch_bounds__(THREADS, 1)
pe_field_bwd_tile_kernel(const float* __restrict__ x, const float* __restrict__ ex,
                         const float* __restrict__ g_t, const float* __restrict__ g_rgb,
                         const float* __restrict__ g_sem, float* __restrict__ dx,
                         float* __restrict__ dex, const bf16* __restrict__ w,
                         const float* __restrict__ b, bf16* ws,
                         float* __restrict__ bpart, const NetDesc d, const Slots sl,
                         long long n_rows, int pass_sem, int total_b) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdSmem s = bwd_smem_layout(d);
  float* xs = reinterpret_cast<float*>(smem + s.xs);
  bf16* enc = reinterpret_cast<bf16*>(smem + s.enc);
  bf16* exs = reinterpret_cast<bf16*>(smem + s.ex);
  bf16* tb = reinterpret_cast<bf16*>(smem + s.tb);
  float* genc = reinterpret_cast<float*>(smem + s.genc);
  float* gt = reinterpret_cast<float*>(smem + s.gt);
  bf16* bufs[2] = {reinterpret_cast<bf16*>(smem + s.buf0),
                   reinterpret_cast<bf16*>(smem + s.buf1)};
  bf16* wslab = reinterpret_cast<bf16*>(smem + s.wslab);
  float* scratch = reinterpret_cast<float*>(smem + s.scratch);
  float* colsum = reinterpret_cast<float*>(smem + s.colsum);

  const long long row0 = (long long)blockIdx.x * TILE;
  const long long ws_ld = sl.cols;
  float* bias_tile = STORE ? bpart + (size_t)blockIdx.x * total_b : nullptr;
  auto bias_out = [&](int l) { return STORE ? bias_tile + d.L[l].b_off : nullptr; };
  using Emit = GEmit<STORE>;

  // ---- recompute the forward; stash every layer's input in the workspace
  const long long n_x = n_rows * d.dim;
  for (int i = threadIdx.x; i < TILE * d.dim; i += THREADS) {
    const long long g = row0 * d.dim + i;
    xs[i] = g < n_x ? x[g] : 0.0f;
  }
  const int ldx = d.ex_pad + PAD;
  for (int i = threadIdx.x; i < TILE * d.ex_pad; i += THREADS) {
    const int r = i / d.ex_pad;
    const int c = i - r * d.ex_pad;
    const float v = (c < d.de && row0 + r < n_rows) ? ex[(row0 + r) * d.de + c] : 0.0f;
    const bf16 h = __float2bfloat16_rn(v);
    exs[r * ldx + c] = h;
    ws[(row0 + r) * ws_ld + sl.ex + c] = h;
  }
  __syncthreads();
  const int lde = d.enc_pad + PAD;
  const int sin_end = d.dim * (1 + d.num_freqs);
  for (int i = threadIdx.x; i < TILE * d.enc_pad; i += THREADS) {
    const int r = i / d.enc_pad;
    const int c = i - r * d.enc_pad;
    float v = 0.0f;
    if (c < d.dim) {
      v = xs[r * d.dim + c];
    } else if (c < d.enc_cols) {
      const int j = c < sin_end ? c - d.dim : c - sin_end;
      const int f = j / d.dim;
      const float pre = xs[r * d.dim + (j - f * d.dim)] * (float)(1 << f);
      v = c < sin_end ? sinf(pre) : cosf(pre);
    }
    const bf16 h = __float2bfloat16_rn(v);
    enc[r * lde + c] = h;
    ws[(row0 + r) * ws_ld + sl.enc + c] = h;
  }

  const int ldh = d.hmax + PAD;
  const int tp = d.t_pad();
  const int ldt = tp + PAD;
  int nb = 0;
  const bf16* cur = enc;
  int ldc = lde;
  for (int l = 0; l < d.n_base; ++l) {             // base stack
    bf16* dst = bufs[nb];
    nb ^= 1;
    dense_layer<MAXF>(cur, ldc, cur, ldc, w, b, d.L[l], wslab, scratch,
                      ToSmemStash{dst, ldh, true, ws, ws_ld, row0, sl.act[l]});
    cur = dst;
    ldc = ldh;
  }
  for (int i = 0; i < d.n_top; ++i) {              // skip layer, top stack
    const int l = d.top0() + i;
    const bf16* a1 = i == 0 ? enc : cur;
    const int lda1 = i == 0 ? lde : ldc;
    const bool last = i == d.n_top - 1;
    bf16* dst = last ? tb : bufs[nb];
    if (!last) nb ^= 1;
    dense_layer<MAXF>(cur, ldc, a1, lda1, w, b, d.L[l], wslab, scratch,
                      ToSmemStash{dst, last ? ldt : ldh, !last, ws, ws_ld, row0,
                                  sl.act[l]});
    cur = dst;
    ldc = last ? ldt : ldh;
  }
  for (int head = 0; head < 2; ++head) {           // the heads' hidden layers
    const int first = head == 0 ? d.color0() : d.sem0();
    const int count = head == 0 ? d.n_color : d.n_sem;
    cur = tb;
    ldc = ldt;
    for (int i = 0; i < count - 1; ++i) {
      const int l = first + i;
      const bool cat = head == 0 && i == 0;        // colour layer 0: [tb | ex]
      bf16* dst = bufs[nb];
      nb ^= 1;
      dense_layer<MAXF>(cur, ldc, cat ? exs : cur, cat ? ldx : ldc, w, b,
                        d.L[l], wslab, scratch,
                        ToSmemStash{dst, ldh, true, ws, ws_ld, row0, sl.act[l]});
      cur = dst;
      ldc = ldh;
    }
  }
  __syncthreads();                                 // genc/gt alias enc/ex/tb

  // ---- backward
  for (int i = threadIdx.x; i < TILE * tp; i += THREADS) {
    const int r = i / tp;
    const int c = i - r * tp;
    gt[i] = (c < d.t_cols && row0 + r < n_rows) ? g_t[(row0 + r) * d.t_cols + c] : 0.0f;
  }
  int gi = 0;
  bf16* gcur = bufs[0];
  for (int head = 0; head < (HEADS ? 2 : 0); ++head) {  // colour, then semantic
    const int first = head == 0 ? d.color0() : d.sem0();
    const int last = first + (head == 0 ? d.n_color : d.n_sem) - 1;
    const float* g_in = head == 0 ? g_rgb : g_sem;
    const int cols = head == 0 ? d.rgb_cols : d.sem_cols;
    strip_apply(d.L[last].n,
                [&](int r, int c) {
                  return (c < cols && row0 + r < n_rows) ? g_in[(row0 + r) * cols + c]
                                                         : 0.0f;
                },
                Emit{gcur, ldh, ws, ws_ld, row0, sl.g[last], -1}, colsum);
    flush_colsum(colsum, d.L[last].n, bias_out(last));
    for (int l = last; l > first; --l) {
      bf16* gnext = bufs[gi ^ 1];
      grad_input<MAXF>(gcur, ldh, w, d.L[l], 0, d.L[l].k, wslab, scratch, colsum,
                       Emit{gnext, ldh, ws, ws_ld, row0, sl.g[l - 1], sl.act[l - 1]});
      flush_colsum(colsum, d.L[l - 1].n, bias_out(l - 1));
      gcur = gnext;
      gi ^= 1;
    }
    const LayerDesc L0 = d.L[first];
    if (head == 0) {
      grad_input<MAXF>(gcur, ldh, w, L0, 0, L0.ka, wslab, scratch, colsum, AddF32{gt, tp});
      grad_input<MAXF>(gcur, ldh, w, L0, L0.ka, L0.k - L0.ka, wslab, scratch,
                       colsum, ToRows{dex, d.de, row0, n_rows});
    } else if (pass_sem) {
      grad_input<MAXF>(gcur, ldh, w, L0, 0, L0.k, wslab, scratch, colsum, AddF32{gt, tp});
    }
  }

  const int t_last = d.color0() - 1;               // top stack
  strip_apply(tp, [&](int r, int c) { return gt[r * tp + c]; },
              Emit{gcur, ldh, ws, ws_ld, row0, sl.g[t_last], -1}, colsum);
  flush_colsum(colsum, tp, bias_out(t_last));
  for (int l = t_last; l > d.top0(); --l) {
    bf16* gnext = bufs[gi ^ 1];
    grad_input<MAXF>(gcur, ldh, w, d.L[l], 0, d.L[l].k, wslab, scratch, colsum,
                     Emit{gnext, ldh, ws, ws_ld, row0, sl.g[l - 1], sl.act[l - 1]});
    flush_colsum(colsum, d.L[l - 1].n, bias_out(l - 1));
    gcur = gnext;
    gi ^= 1;
  }
  const LayerDesc Ls = d.L[d.top0()];              // skip layer: [h | enc]
  const int h_last = d.n_base - 1;
  bf16* gnext = bufs[gi ^ 1];
  grad_input<MAXF>(gcur, ldh, w, Ls, 0, Ls.ka, wslab, scratch, colsum,
                   Emit{gnext, ldh, ws, ws_ld, row0, sl.g[h_last], sl.act[h_last]});
  flush_colsum(colsum, d.L[h_last].n, bias_out(h_last));
  grad_input<MAXF>(gcur, ldh, w, Ls, Ls.ka, Ls.k - Ls.ka, wslab, scratch, colsum,
                   SetF32{genc, d.enc_pad});
  gcur = gnext;
  gi ^= 1;
  for (int l = h_last; l > 0; --l) {               // base stack
    gnext = bufs[gi ^ 1];
    grad_input<MAXF>(gcur, ldh, w, d.L[l], 0, d.L[l].k, wslab, scratch, colsum,
                     Emit{gnext, ldh, ws, ws_ld, row0, sl.g[l - 1], sl.act[l - 1]});
    flush_colsum(colsum, d.L[l - 1].n, bias_out(l - 1));
    gcur = gnext;
    gi ^= 1;
  }
  grad_input<MAXF>(gcur, ldh, w, d.L[0], 0, d.L[0].k, wslab, scratch, colsum,
                   AddF32{genc, d.enc_pad});
  __syncthreads();

  // dx = (d encode / d pre · g_enc) · Sᵀ
  if (dx == nullptr) return;
  for (int i = threadIdx.x; i < TILE * d.dim; i += THREADS) {
    const int r = i / d.dim;
    const int dd = i - r * d.dim;
    if (row0 + r >= n_rows) continue;
    const float xv = xs[r * d.dim + dd];
    const float* ge = genc + r * d.enc_pad;
    float acc = ge[dd];
    for (int f = 0; f < d.num_freqs; ++f) {
      const float scale = (float)(1 << f);
      const float pre = xv * scale;
      acc += ge[d.dim + f * d.dim + dd] * cosf(pre) * scale;
      acc += -ge[sin_end + f * d.dim + dd] * sinf(pre) * scale;
    }
    dx[(row0 + r) * d.dim + dd] = acc;
  }
}

// One layer of the split-K weight-gradient pass.
struct DwLayer {
  int a0, a1, ka, k, g, n, w_off, tiles_n, tiles;
};

struct DwArgs {
  DwLayer L[MAX_LAYERS];
};

// wpart[split, w_off + i·n + j] = sum over the split's rows r of
// A[r, i] · G[r, j]: blockIdx.z the layer, blockIdx.y the split, blockIdx.x
// a 64x64 output tile.  Aᵀ is a col_major wmma operand of the staged rows.
__global__ void __launch_bounds__(DW_THREADS)
pe_field_bwd_dw_kernel(const bf16* __restrict__ ws, long long ws_ld,
                       long long n_pad, int rows_per_split,
                       float* __restrict__ wpart, long long total_w,
                       const DwArgs args) {
  const DwLayer Ld = args.L[blockIdx.z];
  if ((int)blockIdx.x >= Ld.tiles) return;
  __shared__ __align__(128) bf16 as[DW_RK * DW_LD];
  __shared__ __align__(128) bf16 gs[DW_RK * DW_LD];
  const int warp = threadIdx.x >> 5;
  const int i0 = (blockIdx.x / Ld.tiles_n) * DW_BM;
  const int j0 = (blockIdx.x % Ld.tiles_n) * DW_BN;
  const long long r_begin = (long long)blockIdx.y * rows_per_split;
  const long long r_end = min(r_begin + rows_per_split, n_pad);
  const bool m_ok = i0 + warp * 16 < Ld.k;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[DW_BN / 16];
#pragma unroll
  for (int f = 0; f < DW_BN / 16; ++f) wmma::fill_fragment(acc[f], 0.0f);

  for (long long r0 = r_begin; r0 < r_end; r0 += DW_RK) {
    __syncthreads();
    for (int v = threadIdx.x; v < DW_RK * 8; v += DW_THREADS) {
      const int rr = v >> 3;
      const int q = (v & 7) * 8;
      const bf16* row = ws + (r0 + rr) * ws_ld;
      const int i = i0 + q;
      const int j = j0 + q;
      uint4 a = make_uint4(0u, 0u, 0u, 0u);
      uint4 g = make_uint4(0u, 0u, 0u, 0u);
      if (i < Ld.k)
        a = __ldg(reinterpret_cast<const uint4*>(
            row + (i < Ld.ka ? Ld.a0 + i : Ld.a1 + i - Ld.ka)));
      if (j < Ld.n) g = __ldg(reinterpret_cast<const uint4*>(row + Ld.g + j));
      *reinterpret_cast<uint4*>(as + rr * DW_LD + q) = a;
      *reinterpret_cast<uint4*>(gs + rr * DW_LD + q) = g;
    }
    __syncthreads();
    if (m_ok) {
#pragma unroll
      for (int kk = 0; kk < DW_RK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af;
        wmma::load_matrix_sync(af, as + kk * DW_LD + warp * 16, DW_LD);
#pragma unroll
        for (int f = 0; f < DW_BN / 16; ++f) {
          if (j0 + f * 16 < Ld.n) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
            wmma::load_matrix_sync(bfr, gs + kk * DW_LD + f * 16, DW_LD);
            wmma::mma_sync(acc[f], af, bfr, acc[f]);
          }
        }
      }
    }
  }
  if (!m_ok) return;
  float* out = wpart + (size_t)blockIdx.y * total_w + Ld.w_off +
               (size_t)(i0 + warp * 16) * Ld.n;
#pragma unroll
  for (int f = 0; f < DW_BN / 16; ++f)
    if (j0 + f * 16 < Ld.n)
      wmma::store_matrix_sync(out + j0 + f * 16, acc[f], Ld.n, wmma::mem_row_major);
}

struct BwdPlan {
  NetDesc d;
  Slots sl;
  long long n_pad, n_tiles, splits, total_w, total_b;
};

// heads = false plans the trunk alone (fused_pe_density's backward);
// need_dw = false leaves the cotangent slots out of the workspace.
static bool plan(const int* meta, int meta_len, long long n_rows, bool heads,
                 bool need_dw, BwdPlan* p) {
  if (!parse(meta, meta_len, heads, &p->d)) return false;
  const NetDesc& d = p->d;
  const int n = d.n_layers();
  // the wrapper's packing: the encoding feeds layer 0 and the skip layer;
  // heads after the trunk, layer 0 of each head on the padded trunk output
  if (d.L[d.top0()].k - d.L[d.top0()].ka != d.enc_pad || d.L[0].k != d.enc_pad)
    return false;
  if (heads && (d.L[d.color0()].ka != d.t_pad() ||
                d.L[d.color0()].k != d.t_pad() + d.ex_pad || d.L[d.sem0()].k != d.t_pad()))
    return false;
  p->sl = make_slots(d, need_dw);
  p->n_tiles = (n_rows + TILE - 1) / TILE;
  p->n_pad = p->n_tiles * TILE;
  p->splits = (p->n_pad + ROWS_PER_SPLIT - 1) / ROWS_PER_SPLIT;
  const LayerDesc& Ln = d.L[n - 1];
  p->total_w = (long long)Ln.w_off + (long long)Ln.k * Ln.n;
  p->total_b = (long long)Ln.b_off + Ln.n;
  return true;
}

}  // namespace cropnerf

// Sizes of the buffers the wrapper allocates for cropnerf_pe_field_bwd:
// out[0] bf16 workspace elements (fewer without the weight gradients),
// out[1] f32 bias partials, out[2] f32 weight partials, out[3] packed
// weights, out[4] packed biases.  Returns 0, or -1 where the layout is
// rejected.
extern "C" int cropnerf_pe_field_bwd_sizes(const int* meta, int meta_len,
                                           long long n_rows, int heads,
                                           int need_dw, long long* out) {
  using namespace cropnerf;
  BwdPlan p;
  if (!plan(meta, meta_len, n_rows, heads != 0, need_dw != 0, &p)) return -1;
  out[0] = p.n_pad * p.sl.cols;
  out[1] = p.n_tiles * p.total_b;
  out[2] = p.splits * p.total_w;
  out[3] = p.total_w;
  out[4] = p.total_b;
  return 0;
}

// Dynamic shared memory of the tile kernel (-1 where the layout is rejected).
extern "C" int cropnerf_pe_field_bwd_smem_bytes(const int* meta, int meta_len,
                                                int heads) {
  using namespace cropnerf;
  BwdPlan p;
  if (!plan(meta, meta_len, 1, heads != 0, true, &p)) return -1;
  return bwd_smem_layout(p.d).total;
}

// Launches the backward on `stream`; returns a cudaError_t (0 on success).
// Device pointers except `meta`; ws, bpart and wpart are scratch of the
// sizes above; dw and db receive the packed f32 weight and bias gradients.
// Without the heads ex, g_rgb, g_sem and dex are not read (null).  A null
// dx skips dx; null bpart, wpart, dw and db skip the weight gradients
// (trunk only: the heads always take them).
extern "C" int cropnerf_pe_field_bwd(
    const float* x, const float* ex, const float* g_t, const float* g_rgb,
    const float* g_sem, float* dx, float* dex, const void* w, const float* b,
    const int* meta, int meta_len, long long n_rows, int heads, int pass_sem,
    void* ws, float* bpart, float* wpart, float* dw, float* db, void* stream) {
  using namespace cropnerf;
  const bool need_dw = wpart != nullptr;
  if (need_dw && (bpart == nullptr || dw == nullptr || db == nullptr))
    return (int)cudaErrorInvalidValue;
  BwdPlan p;
  if (!plan(meta, meta_len, n_rows, heads != 0, need_dw, &p))
    return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return 0;
  const NetDesc& d = p.d;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bf16* wb = reinterpret_cast<const bf16*>(w);
  bf16* wsb = reinterpret_cast<bf16*>(ws);

  if (heads && !need_dw) return (int)cudaErrorInvalidValue;   // not built
  const int smem = bwd_smem_layout(d).total;
  auto kernel = heads ? pe_field_bwd_tile_kernel<true, true>
                : need_dw ? pe_field_bwd_tile_kernel<false, true>
                          : pe_field_bwd_tile_kernel<false, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)p.n_tiles, THREADS, smem, s>>>(
      x, ex, g_t, g_rgb, g_sem, dx, dex, wb, b, wsb, bpart, d, p.sl, n_rows,
      pass_sem, (int)p.total_b);
  e = cudaGetLastError();
  if (e != cudaSuccess || !need_dw) return (int)e;

  DwArgs args;
  int max_tiles = 0;
  const int n = d.n_layers();
  for (int l = 0; l < n; ++l) {
    DwLayer& o = args.L[l];
    layer_inputs(d, p.sl, l, &o.a0, &o.a1);
    o.ka = d.L[l].ka;
    o.k = d.L[l].k;
    o.g = p.sl.g[l];
    o.n = d.L[l].n;
    o.w_off = d.L[l].w_off;
    o.tiles_n = (o.n + DW_BN - 1) / DW_BN;
    o.tiles = o.tiles_n * ((o.k + DW_BM - 1) / DW_BM);
    max_tiles = o.tiles > max_tiles ? o.tiles : max_tiles;
  }
  pe_field_bwd_dw_kernel<<<dim3(max_tiles, (unsigned)p.splits, n), DW_THREADS, 0, s>>>(
      wsb, p.sl.cols, p.n_pad, ROWS_PER_SPLIT, wpart, p.total_w, args);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const int err = column_sum(wpart, p.splits, p.total_w, dw, s);
  if (err) return err;
  return column_sum(bpart, p.n_tiles, p.total_b, db, s);
}
