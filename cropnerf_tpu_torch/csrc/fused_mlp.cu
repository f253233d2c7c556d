// Fused relu MLP, forward and recompute-backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels cropnerf_tpu/ops/pallas/fused_mlp.py
// _fwd_kernel: x [N, Din] -> (W0, b0) -> relu -> ... -> (W_last, b_last)
// -> [N, Dout] f32, with every hidden activation kept in shared memory; and
// _bwd_kernel: the cotangent g [N, Dout] -> dx [N, Din] and the f32
// gradient of every weight and bias, recomputing the forward from x.
//
// Bound on an H100: memory.  The vanilla field's heads, [N, 15] -> 64 -> 1
// and [N, 74] -> 64 -> 3, take ~2-10 kFLOP per row against 64-308 bytes of
// input and output (the backward ~2-3 times the flops, x, g and dx), below
// the card's ~295 FLOP/byte balance point.  So the forward reads x once and
// writes y once, with no hidden activation in device memory; the few KB of
// weights stay in L2 and are staged per block.  Small widths give small
// tiles of shared memory, so several blocks share an SM.
//
// Backward design.  One block recomputes a 128-row tile's forward and keeps
// every layer's bf16 input A_l in shared memory.  Going back through the
// layers it computes, per layer l: the tile's weight gradient A_lᵀ·G_l on
// the tensor cores, added into the block's own row of an f32 partial
// buffer; then G_{l-1} = relu mask of A_l (g·W_lᵀ), written in place over
// A_l, whose last reader that product was; for l = 0, dx.  Arithmetic as the
// TPU kernel: bf16 recompute with f32 sums at the forward's rounding points
// (every hidden layer from the bf16 activation, as the forward), cotangents
// rounded to bf16 only as product operands, relu masks from the bf16
// activations, the bias gradient the f32 column sum of g.  The TPU sums the
// weight gradient over its sequential grid; here each block takes a fixed
// run of tiles in order and a fixed-order column sum reduces the blocks'
// rows, with no atomics, so two runs give the same bits.  Without weight
// gradients (the BayesRays pass asks for dx alone) each block takes one
// tile and writes no partials.  Rows past N load zero cotangents.
#include "bwd_layers.cuh"

namespace cropnerf {

// meta header (ints), then 5 ints per layer
enum { M_DIN, M_DIN_PAD, M_DOUT, M_N_LAYERS, M_HMAX, M_HEADER };

struct MlpDesc {
  int din, din_pad, dout, n_layers, hmax;
  LayerDesc L[MAX_LAYERS];
};

__host__ __device__ inline int mlp_smem_bytes(const MlpDesc& d) {
  return 2 * act_bytes(d.hmax) + slab_bytes(d.hmax) + SCRATCH_BYTES;
}

// NF: the widest layer's 16-column fragments, rounded up to 4, 8 or 16.
// The heads (64 wide) take NF = 4, which leaves registers for two or more
// resident blocks per SM.
template <int NF>
__global__ void __launch_bounds__(THREADS, NF <= 8 ? 2 : 1)
fused_mlp_fwd_kernel(const float* __restrict__ x, float* __restrict__ out,
                     const bf16* __restrict__ w, const float* __restrict__ b,
                     const MlpDesc d, long long n_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int act = act_bytes(d.hmax);
  bf16* bufs[2] = {reinterpret_cast<bf16*>(smem),
                   reinterpret_cast<bf16*>(smem + act)};
  bf16* wslab = reinterpret_cast<bf16*>(smem + 2 * act);
  float* scratch = reinterpret_cast<float*>(smem + 2 * act + slab_bytes(d.hmax));

  const long long row0 = (long long)blockIdx.x * TILE;
  const int ldh = d.hmax + PAD;
  for (int i = threadIdx.x; i < TILE * d.din_pad; i += THREADS) {
    const int r = i / d.din_pad;
    const int c = i - r * d.din_pad;
    const float v = (c < d.din && row0 + r < n_rows) ? x[(row0 + r) * d.din + c] : 0.0f;
    bufs[0][r * ldh + c] = __float2bfloat16_rn(v);
  }
  int cur = 0;
  for (int i = 0; i < d.n_layers; ++i) {
    const bf16* a = bufs[cur];
    if (i < d.n_layers - 1) {
      dense_layer<NF>(a, ldh, a, ldh, w, b, d.L[i], wslab, scratch,
                      ToSmem{bufs[cur ^ 1], ldh, true});
      cur ^= 1;
    } else {
      dense_layer<NF>(a, ldh, a, ldh, w, b, d.L[i], wslab, scratch,
                      ToGlobal{out, d.dout, row0, n_rows, nullptr, 0});
    }
  }
}

static bool parse(const int* meta, int meta_len, MlpDesc* d) {
  if (meta_len < M_HEADER) return false;
  d->din = meta[M_DIN];
  d->din_pad = meta[M_DIN_PAD];
  d->dout = meta[M_DOUT];
  d->n_layers = meta[M_N_LAYERS];
  d->hmax = meta[M_HMAX];
  if (d->din < 1 || d->din_pad < d->din || d->din_pad % 16 ||
      d->din_pad > d->hmax || d->hmax % 16 || d->hmax > MAX_WIDTH || d->dout < 1)
    return false;
  if (meta_len != M_HEADER + 5 * d->n_layers) return false;
  return parse_layers(meta + M_HEADER, d->n_layers, d->L);
}

template <int NF>
static int launch(const float* x, float* out, const void* w, const float* b,
                  const MlpDesc& d, long long n_rows, void* stream) {
  const int smem = mlp_smem_bytes(d);
  cudaError_t e = cudaFuncSetAttribute(
      fused_mlp_fwd_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((n_rows + TILE - 1) / TILE));
  fused_mlp_fwd_kernel<NF><<<grid, THREADS, smem,
                             reinterpret_cast<cudaStream_t>(stream)>>>(
      x, out, reinterpret_cast<const bf16*>(w), b, d, n_rows);
  return (int)cudaGetLastError();
}

// ---- backward --------------------------------------------------------------

constexpr int BWD_TILES_PER_BLOCK = 4;  // tiles per block with weight gradients

struct MlpBwdSmem {
  int act[MAX_LAYERS];   // A_l, the input of layer l, bf16 [TILE, k_l + PAD]
  int gl, wslab, scratch, colsum, total;
};

__host__ __device__ inline MlpBwdSmem mlp_bwd_smem(const MlpDesc& d) {
  MlpBwdSmem s;
  int off = 0;
  for (int l = 0; l < d.n_layers; ++l) { s.act[l] = off; off += act_bytes(d.L[l].k); }
  s.gl = off; off += act_bytes(d.L[d.n_layers - 1].n);
  const int slab = slab_bytes(d.hmax);
  const int slab_t = wt_slab_bytes(d.hmax);
  s.wslab = off; off += slab > slab_t ? slab : slab_t;
  s.scratch = off; off += SCRATCH_BYTES;
  s.colsum = off; off += WARPS * MAX_WIDTH * 4;
  s.total = off;
  return s;
}

// Backward epilogue of g·W_lᵀ: the relu mask of A_l, the bf16 cotangent
// G_{l-1} written over A_l; the f32 value feeds the bias column sum.
struct MaskInPlace {
  static constexpr bool kColsum = true;
  bf16* a;
  int ld;
  __device__ __forceinline__ float operator()(int r, int c, float v) const {
    bf16* p = a + r * ld + c;
    if (!(__bfloat162float(*p) > 0.0f)) v = 0.0f;
    *p = __float2bfloat16_rn(v);
    return v;
  }
};

// The last layer's cotangent from global memory: bf16 into gl, f32 for the
// column sum.
struct LoadG {
  static constexpr bool kColsum = true;
  bf16* gl;
  int ld;
  __device__ __forceinline__ float operator()(int r, int c, float v) const {
    gl[r * ld + c] = __float2bfloat16_rn(v);
    return v;
  }
};

// wrow[w_off + i·n + j] += sum_r A[r, i] · G[r, j] over the tile's rows:
// layer L's weight gradient, 16x16 output fragments spread over the warps.
// Aᵀ is a col_major wmma operand of the activation.
__device__ __forceinline__ void tile_dw(const bf16* a, int lda, const bf16* g, int ldg,
                                        const LayerDesc L, float* wrow, float* scratch) {
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tn = L.n >> 4;
  const int frags = (L.k >> 4) * tn;
  float* sc = scratch + warp * 256;
  for (int f = warp; f < frags; f += WARPS) {
    const int i0 = (f / tn) * 16;
    const int j0 = (f % tn) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int r0 = 0; r0 < TILE; r0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
      wmma::load_matrix_sync(af, a + r0 * lda + i0, lda);
      wmma::load_matrix_sync(bfr, g + r0 * ldg + j0, ldg);
      wmma::mma_sync(acc, af, bfr, acc);
    }
    wmma::store_matrix_sync(sc, acc, 16, wmma::mem_row_major);
    __syncwarp();
    const int r = lane >> 1;
    const int c0 = (lane & 1) * 8;
    float* out = wrow + L.w_off + (size_t)(i0 + r) * L.n + j0 + c0;
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] += sc[r * 16 + c0 + j];
    __syncwarp();
  }
}

template <int NF>
__global__ void __launch_bounds__(THREADS, NF <= 8 ? 2 : 1)
fused_mlp_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g_out,
                     float* __restrict__ dx, const bf16* __restrict__ w,
                     const float* __restrict__ b, float* __restrict__ wpart,
                     float* __restrict__ bpart, const MlpDesc d, long long n_rows,
                     int tiles_per_block, long long total_w, long long total_b) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MlpBwdSmem s = mlp_bwd_smem(d);
  bf16* gl = reinterpret_cast<bf16*>(smem + s.gl);
  bf16* wslab = reinterpret_cast<bf16*>(smem + s.wslab);
  float* scratch = reinterpret_cast<float*>(smem + s.scratch);
  float* colsum = reinterpret_cast<float*>(smem + s.colsum);
  auto act = [&](int l) { return reinterpret_cast<bf16*>(smem + s.act[l]); };
  auto ld = [&](int l) { return d.L[l].k + PAD; };
  const int n = d.n_layers;
  const bool need_dw = wpart != nullptr;
  float* wrow = need_dw ? wpart + (size_t)blockIdx.x * total_w : nullptr;
  float* brow = need_dw ? bpart + (size_t)blockIdx.x * total_b : nullptr;
  auto bias_out = [&](int l) { return need_dw ? brow + d.L[l].b_off : nullptr; };
  const long long n_tiles = (n_rows + TILE - 1) / TILE;

  for (int t = 0; t < tiles_per_block; ++t) {
    const long long tile = (long long)blockIdx.x * tiles_per_block + t;
    if (tile >= n_tiles) break;
    const long long row0 = tile * TILE;
    __syncthreads();                               // the previous tile is done

    // recompute the forward: A_0 = bf16(x), A_{l+1} = bf16(relu(A_l W_l + b_l))
    bf16* a0 = act(0);
    for (int i = threadIdx.x; i < TILE * d.din_pad; i += THREADS) {
      const int r = i / d.din_pad;
      const int c = i - r * d.din_pad;
      const float v = (c < d.din && row0 + r < n_rows) ? x[(row0 + r) * d.din + c] : 0.0f;
      a0[r * ld(0) + c] = __float2bfloat16_rn(v);
    }
    for (int l = 0; l < n - 1; ++l)
      dense_layer<NF>(act(l), ld(l), act(l), ld(l), w, b, d.L[l], wslab, scratch,
                      ToSmem{act(l + 1), ld(l + 1), true});

    // backward: the last layer's cotangent, then layer by layer
    const int ldgl = d.L[n - 1].n + PAD;
    strip_apply(d.L[n - 1].n,
                [&](int r, int c) {
                  return (c < d.dout && row0 + r < n_rows) ? g_out[(row0 + r) * d.dout + c]
                                                           : 0.0f;
                },
                LoadG{gl, ldgl}, colsum);
    flush_colsum(colsum, d.L[n - 1].n, bias_out(n - 1), true);
    const bf16* gcur = gl;
    int ldg = ldgl;
    for (int l = n - 1; l >= 0; --l) {
      if (need_dw) tile_dw(act(l), ld(l), gcur, ldg, d.L[l], wrow, scratch);
      if (l > 0) {
        grad_input<NF>(gcur, ldg, w, d.L[l], 0, d.L[l].k, wslab, scratch, colsum,
                       MaskInPlace{act(l), ld(l)});
        flush_colsum(colsum, d.L[l - 1].n, bias_out(l - 1), true);
        gcur = act(l);
        ldg = ld(l);
      } else if (dx != nullptr) {
        grad_input<NF>(gcur, ldg, w, d.L[0], 0, d.L[0].k, wslab, scratch, colsum,
                       ToRows{dx, d.din, row0, n_rows});
      }
    }
  }
}

struct MlpBwdPlan {
  long long n_blocks, tiles_per_block, total_w, total_b;
};

static MlpBwdPlan mlp_bwd_plan(const MlpDesc& d, long long n_rows, bool need_dw) {
  MlpBwdPlan p;
  const long long n_tiles = (n_rows + TILE - 1) / TILE;
  p.tiles_per_block = need_dw ? BWD_TILES_PER_BLOCK : 1;
  p.n_blocks = (n_tiles + p.tiles_per_block - 1) / p.tiles_per_block;
  const LayerDesc& Ln = d.L[d.n_layers - 1];
  p.total_w = (long long)Ln.w_off + (long long)Ln.k * Ln.n;
  p.total_b = (long long)Ln.b_off + Ln.n;
  return p;
}

// The backward's layout check: each layer's padded input is the previous
// layer's padded output, and the first takes the padded x.
static bool bwd_layout_ok(const MlpDesc& d) {
  if (d.L[0].k != d.din_pad) return false;
  for (int l = 0; l < d.n_layers; ++l) {
    if (d.L[l].ka != d.L[l].k || d.L[l].k > d.hmax || d.L[l].n > d.hmax) return false;
    if (l > 0 && d.L[l].k != d.L[l - 1].n) return false;
  }
  return true;
}

template <int NF>
static int launch_bwd(const float* x, const float* g, float* dx, const void* w,
                      const float* b, const MlpDesc& d, long long n_rows, float* wpart,
                      float* bpart, const MlpBwdPlan& p, cudaStream_t stream) {
  const int smem = mlp_bwd_smem(d).total;
  cudaError_t e = cudaFuncSetAttribute(
      fused_mlp_bwd_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  fused_mlp_bwd_kernel<NF><<<(unsigned)p.n_blocks, THREADS, smem, stream>>>(
      x, g, dx, reinterpret_cast<const bf16*>(w), b, wpart, bpart, d, n_rows,
      (int)p.tiles_per_block, p.total_w, p.total_b);
  return (int)cudaGetLastError();
}

}  // namespace cropnerf

// Launches the forward on `stream`; returns a cudaError_t (0 on success).
extern "C" int cropnerf_fused_mlp_fwd(const float* x, float* out,
                                      const void* w, const float* b,
                                      const int* meta, int meta_len,
                                      long long n_rows, void* stream) {
  using namespace cropnerf;
  MlpDesc d;
  if (!parse(meta, meta_len, &d)) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return 0;
  int max_n = 0;
  for (int i = 0; i < d.n_layers; ++i)
    max_n = d.L[i].n > max_n ? d.L[i].n : max_n;
  if (max_n <= 64) return launch<4>(x, out, w, b, d, n_rows, stream);
  if (max_n <= 128) return launch<8>(x, out, w, b, d, n_rows, stream);
  return launch<MAXF>(x, out, w, b, d, n_rows, stream);
}

extern "C" int cropnerf_fused_mlp_smem_bytes(const int* meta, int meta_len) {
  using namespace cropnerf;
  MlpDesc d;
  if (!parse(meta, meta_len, &d)) return -1;
  return mlp_smem_bytes(d);
}

// Sizes for cropnerf_fused_mlp_bwd: out[0] f32 weight partials and out[1]
// f32 bias partials (zeros the wrapper allocates when weight gradients are
// asked for), out[2] packed weights, out[3] packed biases.  Returns 0, or -1
// where the layout is rejected.
extern "C" int cropnerf_fused_mlp_bwd_sizes(const int* meta, int meta_len,
                                            long long n_rows, int need_dw,
                                            long long* out) {
  using namespace cropnerf;
  MlpDesc d;
  if (!parse(meta, meta_len, &d) || !bwd_layout_ok(d)) return -1;
  const MlpBwdPlan p = mlp_bwd_plan(d, n_rows, need_dw != 0);
  out[0] = p.n_blocks * p.total_w;
  out[1] = p.n_blocks * p.total_b;
  out[2] = p.total_w;
  out[3] = p.total_b;
  return 0;
}

// Dynamic shared memory of the backward (-1 where the layout is rejected).
extern "C" int cropnerf_fused_mlp_bwd_smem_bytes(const int* meta, int meta_len) {
  using namespace cropnerf;
  MlpDesc d;
  if (!parse(meta, meta_len, &d) || !bwd_layout_ok(d)) return -1;
  return mlp_bwd_smem(d).total;
}

// Launches the backward on `stream`; returns a cudaError_t (0 on success).
// g is the cotangent [n_rows, dout]; a null dx skips dx; null wpart, bpart,
// dw and db skip the weight gradients, otherwise wpart and bpart are zeroed
// scratch of the sizes above and dw, db receive the packed f32 gradients.
extern "C" int cropnerf_fused_mlp_bwd(const float* x, const float* g, float* dx,
                                      const void* w, const float* b,
                                      const int* meta, int meta_len,
                                      long long n_rows, float* wpart, float* bpart,
                                      float* dw, float* db, void* stream) {
  using namespace cropnerf;
  MlpDesc d;
  if (!parse(meta, meta_len, &d) || !bwd_layout_ok(d)) return (int)cudaErrorInvalidValue;
  const bool need_dw = wpart != nullptr;
  if (need_dw && (bpart == nullptr || dw == nullptr || db == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return 0;
  const MlpBwdPlan p = mlp_bwd_plan(d, n_rows, need_dw);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int max_n = 0;
  for (int i = 0; i < d.n_layers; ++i) {
    max_n = d.L[i].n > max_n ? d.L[i].n : max_n;
    max_n = d.L[i].k > max_n ? d.L[i].k : max_n;
  }
  const int err =
      max_n <= 64    ? launch_bwd<4>(x, g, dx, w, b, d, n_rows, wpart, bpart, p, s)
      : max_n <= 128 ? launch_bwd<8>(x, g, dx, w, b, d, n_rows, wpart, bpart, p, s)
                     : launch_bwd<MAXF>(x, g, dx, w, b, d, n_rows, wpart, bpart, p, s);
  if (err || !need_dw) return err;
  const int e = column_sum(wpart, p.n_blocks, p.total_w, dw, s);
  if (e) return e;
  return column_sum(bpart, p.n_blocks, p.total_b, db, s);
}
