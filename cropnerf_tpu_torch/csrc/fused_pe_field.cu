// Fused positional-encoding NeRF field, forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of cropnerf_tpu/ops/pallas/fused_pe_field.py:
//   HEADS=false  fused_pe_density (_fwd_kernel):       encode -> trunk -> t
//   HEADS=true   fused_pe_nerf    (_mega_fwd_kernel):  ... + colour and
//                semantic heads -> t, rgb_raw, sem_raw
// Per row: x [dim] -> NeRF encoding [x | sin(2^f x) | cos(2^f x)] -> relu
// base stack -> skip layer on [h | enc] -> top stack -> t [1+G];
// colour head layer 0 on [bf16(t) | extras], semantic head on bf16(t).
//
// Bound on an H100: compute.  The flagship does ~0.87 MFLOP per sample
// against ~330 bytes of input and output, far above the card's ~295
// FLOP/byte balance point, so the design keeps every intermediate (the
// [N, 63..319] encodings and activations) in shared memory and feeds the
// tensor cores from there; only x, the extras and the outputs touch device
// memory.  The weights (~0.86 MB bf16) do not fit one SM's shared memory;
// they stream from L2 in K-slabs shared by the block's eight warps, so a
// 128-row tile reads each weight once.  This first version uses wmma
// (mma.sync); wgmma/TMA pipelining is later work.
//
// sin/cos use the accurate sinf/cosf: arguments reach 2^9 rad.
#include "fused_layers.cuh"

namespace cropnerf {

// meta header (ints), followed by 5 ints per layer in the order
// base..., top..., colour..., semantic...
enum {
  M_DIM, M_FREQS, M_ENC_COLS, M_ENC_PAD, M_DE, M_EX_PAD,
  M_N_BASE, M_N_TOP, M_N_COLOR, M_N_SEM,
  M_T_COLS, M_RGB_COLS, M_SEM_COLS, M_HMAX, M_HEADER
};

struct NetDesc {
  int dim, num_freqs, enc_cols, enc_pad, de, ex_pad;
  int n_base, n_top, n_color, n_sem;
  int t_cols, rgb_cols, sem_cols, hmax;
  LayerDesc L[MAX_LAYERS];
};

struct Smem {
  int xs, enc, ex, tb, buf0, buf1, wslab, scratch, total;
};

__host__ __device__ inline Smem smem_layout(const NetDesc& d, bool heads) {
  Smem s;
  int off = 0;
  s.xs = off; off += align128(TILE * d.dim * 4);
  s.enc = off; off += act_bytes(d.enc_pad);
  const int t_pad = d.L[d.n_base + d.n_top - 1].n;
  s.ex = off; if (heads) off += act_bytes(d.ex_pad);
  s.tb = off; if (heads) off += act_bytes(t_pad);
  s.buf0 = off; off += act_bytes(d.hmax);
  s.buf1 = off; off += act_bytes(d.hmax);
  s.wslab = off; off += slab_bytes(d.hmax);
  s.scratch = off; off += SCRATCH_BYTES;
  s.total = off;
  return s;
}

template <bool HEADS>
__global__ void __launch_bounds__(THREADS, 1)
pe_field_fwd_kernel(const float* __restrict__ x, const float* __restrict__ ex,
                    float* __restrict__ t_out, float* __restrict__ rgb_out,
                    float* __restrict__ sem_out, const bf16* __restrict__ w,
                    const float* __restrict__ b, const NetDesc d,
                    long long n_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem s = smem_layout(d, HEADS);
  float* xs = reinterpret_cast<float*>(smem + s.xs);
  bf16* enc = reinterpret_cast<bf16*>(smem + s.enc);
  bf16* exs = reinterpret_cast<bf16*>(smem + s.ex);
  bf16* tb = reinterpret_cast<bf16*>(smem + s.tb);
  bf16* bufs[2] = {reinterpret_cast<bf16*>(smem + s.buf0),
                   reinterpret_cast<bf16*>(smem + s.buf1)};
  bf16* wslab = reinterpret_cast<bf16*>(smem + s.wslab);
  float* scratch = reinterpret_cast<float*>(smem + s.scratch);

  const long long row0 = (long long)blockIdx.x * TILE;
  const long long n_x = n_rows * d.dim;
  for (int i = threadIdx.x; i < TILE * d.dim; i += THREADS) {
    const long long g = row0 * d.dim + i;
    xs[i] = g < n_x ? x[g] : 0.0f;
  }
  const int ldx = d.ex_pad + PAD;
  if (HEADS) {
    for (int i = threadIdx.x; i < TILE * d.ex_pad; i += THREADS) {
      const int r = i / d.ex_pad;
      const int c = i - r * d.ex_pad;
      const float v = (c < d.de && row0 + r < n_rows) ? ex[(row0 + r) * d.de + c] : 0.0f;
      exs[r * ldx + c] = __float2bfloat16_rn(v);
    }
  }
  __syncthreads();

  // encoding, cast to bf16 (the JAX kernels' enc.astype(bf16))
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
    enc[r * lde + c] = __float2bfloat16_rn(v);
  }

  const int ldh = d.hmax + PAD;
  int li = 0, nb = 0;
  const bf16* cur = enc;
  int ldc = lde;
  for (int i = 0; i < d.n_base; ++i, ++li) {     // all-relu base stack
    bf16* dst = bufs[nb];
    nb ^= 1;
    dense_layer<MAXF>(cur, ldc, cur, ldc, w, b, d.L[li], wslab, scratch,
                      ToSmem{dst, ldh, true});
    cur = dst;
    ldc = ldh;
  }
  const int t_pad = d.L[d.n_base + d.n_top - 1].n;
  const int ldt = t_pad + PAD;
  for (int i = 0; i < d.n_top; ++i, ++li) {      // skip layer, then top stack
    const bf16* a1 = i == 0 ? enc : cur;
    const int lda1 = i == 0 ? lde : ldc;
    if (i < d.n_top - 1) {
      bf16* dst = bufs[nb];
      nb ^= 1;
      dense_layer<MAXF>(cur, ldc, a1, lda1, w, b, d.L[li], wslab, scratch,
                        ToSmem{dst, ldh, true});
      cur = dst;
      ldc = ldh;
    } else {
      dense_layer<MAXF>(cur, ldc, a1, lda1, w, b, d.L[li], wslab, scratch,
                        ToGlobal{t_out, d.t_cols, row0, n_rows, HEADS ? tb : nullptr, ldt});
    }
  }
  if (!HEADS) return;

  cur = tb;                                       // colour head on [tb | extras]
  ldc = ldt;
  for (int i = 0; i < d.n_color; ++i, ++li) {
    const bf16* a1 = i == 0 ? exs : cur;
    const int lda1 = i == 0 ? ldx : ldc;
    if (i < d.n_color - 1) {
      bf16* dst = bufs[nb];
      nb ^= 1;
      dense_layer<MAXF>(cur, ldc, a1, lda1, w, b, d.L[li], wslab, scratch,
                        ToSmem{dst, ldh, true});
      cur = dst;
      ldc = ldh;
    } else {
      dense_layer<MAXF>(cur, ldc, a1, lda1, w, b, d.L[li], wslab, scratch,
                        ToGlobal{rgb_out, d.rgb_cols, row0, n_rows, nullptr, 0});
    }
  }
  cur = tb;                                       // semantic head on tb
  ldc = ldt;
  for (int i = 0; i < d.n_sem; ++i, ++li) {
    if (i < d.n_sem - 1) {
      bf16* dst = bufs[nb];
      nb ^= 1;
      dense_layer<MAXF>(cur, ldc, cur, ldc, w, b, d.L[li], wslab, scratch,
                        ToSmem{dst, ldh, true});
      cur = dst;
      ldc = ldh;
    } else {
      dense_layer<MAXF>(cur, ldc, cur, ldc, w, b, d.L[li], wslab, scratch,
                        ToGlobal{sem_out, d.sem_cols, row0, n_rows, nullptr, 0});
    }
  }
}

static bool parse(const int* meta, int meta_len, bool heads, NetDesc* d) {
  if (meta_len < M_HEADER) return false;
  d->dim = meta[M_DIM];
  d->num_freqs = meta[M_FREQS];
  d->enc_cols = meta[M_ENC_COLS];
  d->enc_pad = meta[M_ENC_PAD];
  d->de = meta[M_DE];
  d->ex_pad = meta[M_EX_PAD];
  d->n_base = meta[M_N_BASE];
  d->n_top = meta[M_N_TOP];
  d->n_color = heads ? meta[M_N_COLOR] : 0;
  d->n_sem = heads ? meta[M_N_SEM] : 0;
  d->t_cols = meta[M_T_COLS];
  d->rgb_cols = meta[M_RGB_COLS];
  d->sem_cols = meta[M_SEM_COLS];
  d->hmax = meta[M_HMAX];
  const int n_layers = d->n_base + d->n_top + d->n_color + d->n_sem;
  if (d->n_base < 1 || d->n_top < 1 || (heads && (d->n_color < 1 || d->n_sem < 1)))
    return false;
  if (d->num_freqs < 0 || d->num_freqs > 30 || d->dim < 1 ||
      d->enc_cols != d->dim * (1 + 2 * d->num_freqs) ||
      d->enc_pad < d->enc_cols || d->enc_pad % 16 || d->hmax % 16 ||
      d->hmax > MAX_WIDTH || (heads && (d->ex_pad < d->de || d->ex_pad % 16)))
    return false;
  if (meta_len != M_HEADER + 5 * n_layers) return false;
  return parse_layers(meta + M_HEADER, n_layers, d->L);
}

}  // namespace cropnerf

// Launches the forward on `stream`; returns a cudaError_t (0 on success).
// heads=0: fused_pe_density (ex, rgb_out, sem_out unused); heads=1:
// fused_pe_nerf.  All pointers are device pointers except `meta`.
extern "C" int cropnerf_pe_field_fwd(const float* x, const float* ex,
                                     float* t_out, float* rgb_out,
                                     float* sem_out, const void* w,
                                     const float* b, const int* meta,
                                     int meta_len, long long n_rows,
                                     int heads, void* stream) {
  using namespace cropnerf;
  NetDesc d;
  if (!parse(meta, meta_len, heads != 0, &d)) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return 0;
  const int smem = smem_layout(d, heads != 0).total;
  const dim3 grid((unsigned)((n_rows + TILE - 1) / TILE));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bf16* wb = reinterpret_cast<const bf16*>(w);
  cudaError_t e;
  if (heads) {
    e = cudaFuncSetAttribute(pe_field_fwd_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    pe_field_fwd_kernel<true><<<grid, THREADS, smem, s>>>(
        x, ex, t_out, rgb_out, sem_out, wb, b, d, n_rows);
  } else {
    e = cudaFuncSetAttribute(pe_field_fwd_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    pe_field_fwd_kernel<false><<<grid, THREADS, smem, s>>>(
        x, ex, t_out, rgb_out, sem_out, wb, b, d, n_rows);
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory the launch above asks for (for reports and checks).
extern "C" int cropnerf_pe_field_smem_bytes(const int* meta, int meta_len,
                                            int heads) {
  using namespace cropnerf;
  NetDesc d;
  if (!parse(meta, meta_len, heads != 0, &d)) return -1;
  return smem_layout(d, heads != 0).total;
}
