// Fused relu MLP, forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel cropnerf_tpu/ops/pallas/fused_mlp.py
// (_fwd_kernel): x [N, Din] -> (W0, b0) -> relu -> ... -> (W_last, b_last)
// -> [N, Dout] f32, with every hidden activation kept in shared memory.
//
// Bound on an H100: memory.  On the export path it runs the vanilla field's
// heads, [N, 15] -> 64 -> 1 and [N, 74] -> 64 -> 3: ~2-10 kFLOP per row
// against 64-308 bytes of input and output, below the card's ~295 FLOP/byte
// balance point.  So the design reads x once and writes y once, with no
// hidden activation in device memory; the few KB of weights stay in L2 and
// are staged per block.  Small widths give small tiles of shared memory,
// so several blocks share an SM.
#include "fused_layers.cuh"

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
