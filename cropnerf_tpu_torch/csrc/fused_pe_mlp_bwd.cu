// The PE proposal nets' recompute backward (fused_pe_mlp) for Hopper
// (sm_90a).
//
// Replaces cropnerf_tpu/ops/pallas/fused_pe_field.py _plain_bwd_kernel (the
// backward of fused_pe_mlp): x [N, 3] is encoded, [x | sin(2^f x) |
// cos(2^f x)] (f-major blocks, ops/posenc.nerf_encoding's columns), and run
// through a relu MLP whose hidden layers are at most 64 wide and whose last
// layer is linear with at most 16 outputs.  Given the cotangent g [N, Dout]
// it returns dx [N, 3] and the f32 gradient of every weight and bias, each
// only where asked.  Nets wider than 64 take the PE variant of
// fused_mlp_bwd.cu.
//
// Arithmetic, as the TPU kernel: the encoding and the hidden layers are
// recomputed in bf16 with f32 sums (the accurate sinf/cosf, as one sincosf;
// |2^f x| reaches 2^8); relu masks come from the bf16 activations; the
// cotangents stay f32 and are rounded to bf16 only as product operands;
// layer 0's input gradient stays f32 through d(encode)/d(pre) times 2^f and
// is summed per coordinate in column order (identity, sines by frequency,
// cosines by frequency); bias gradients are f32 column sums of the
// cotangents.
//
// Bound on an H100: operations.  A 33 -> 64 -> 64 -> 1 net takes ~38 kFLOP
// a row on the tensor cores (the hidden layers' recompute, every input
// gradient, every weight gradient) against 28 bytes of x, g and dx:
// 0.055 ms for a training step's two nets (1,441,792 rows) at 989 TFLOP/s.
//
// Design.  Persistent blocks, one per SM, of three warpgroups; every
// warpgroup takes 64-row tiles in a fixed order (tile = its global index +
// k x the warpgroups in the grid).  The whole net stays in shared memory
// for the kernel's life: each layer's weight twice, as the B operand of the
// forward product and of the input-gradient product, in the K-major core
// matrix layout of wgmma_layers.cuh (the host builds both images,
// ops/cuda/fused_pe_field.py pe_mlp_images).  Per tile a warpgroup:
//   1. encodes its 64 rows from x loaded a tile ahead, two threads a row,
//      into a chunk-major bf16 tile E, and keeps each column's f32
//      d(encode)/d(pre) x 2^f in shared memory;
//   2. recomputes the hidden layers as wgmma m64n64 products on operands
//      that stay in shared memory;
//   3. goes back through the layers: dW_l += A_lᵀ·G_l as wgmma with both
//      operands MN-major straight from the chunk-major tiles, issued with
//      the input-gradient product G_l·W_lᵀ; the latter's epilogue applies
//      the relu mask, adds the f32 column sums into the warp's bias row and
//      writes the bf16 cotangent over A_l;
//   4. for dx, scales layer 0's input gradient by the stored derivatives
//      and sums each coordinate's columns in order.
// The weight-gradient accumulators stay in registers across all of a
// warpgroup's tiles (72 a thread for 64-64-16); at the end the block adds
// its warpgroups' in order and writes one partial row, and fixed-order
// column sums reduce the blocks' rows.  No atomics: the plan depends on N
// and the SM count alone, so two runs give the same bits.  Rows past N load
// zero x and zero cotangents, so they add nothing.
#include "column_sum.cuh"
#include "wgmma_mlp.cuh"

namespace cropnerf {
namespace pemlp {

constexpr int WGS = 3;                 // warpgroups a block
constexpr int THREADS = 128 * WGS;
constexpr int GL_BYTES = ROWS * OW * 2;

// Everything the layout of a net with NL layers fixes: the weight images
// (forward images of every layer, then input-gradient images), the biases,
// the packed gradient rows and the shared memory.
template <int NL>
struct Geo : Net<NL> {
  static constexpr int TOTAL_W = Net<NL>::TOTAL_W;
  static constexpr int TOTAL_B = Net<NL>::TOTAL_B;
  static constexpr int IMG_BYTES = 2 * TOTAL_W * 2;
  static constexpr int BIAS_AT = IMG_BYTES;
  static constexpr int WG_AT = al128(IMG_BYTES + TOTAL_B * 4);
  // one warpgroup's region: the layer inputs A_0 = E .. A_{NL-1}, the
  // output cotangent, the derivative tile, four warps' bias rows
  static constexpr int GL_AT = NL * TILE_BYTES;
  static constexpr int D_AT = GL_AT + GL_BYTES;
  static constexpr int BACC_AT = D_AT + ROWS * DLD * 4;
  static constexpr int WG_BYTES = al128(BACC_AT + 4 * TOTAL_B * 4);
  static constexpr int SMEM = WG_AT + WGS * WG_BYTES;
};
static_assert(Geo<3>::SMEM <= 232448, "shared memory");
static_assert(ROWS * HW * 4 <= Geo<2>::BACC_AT, "the reduction's staging tile");

// Adds a warp's column sums of (a, b) at columns (c, c + 1), rows r0 and
// r0 + 8 of each lane, into the warp's bias row: a fixed shuffle tree over
// the warp's 16 rows.
__device__ __forceinline__ void bias_add(float* brow, int c, float a0, float a1, float b0,
                                         float b1, const Lane& ln) {
  float s0 = a0 + b0, s1 = a1 + b1;
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  if (ln.lane < 4) {
    brow[c] += s0;
    brow[c + 1] += s1;
  }
}

// stage[i, c] (=, or += unless `first`) the accumulators of a 64 x N weight
// gradient, row-major.
template <int N>
__device__ __forceinline__ void stage_add(float* stage, const float (&v)[N / 2], bool first,
                                          const Lane& ln) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = 8 * j + ln.cq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* p = stage + (ln.r0 + 8 * h) * N + c;
      const float v0 = v[4 * j + 2 * h], v1 = v[4 * j + 2 * h + 1];
      p[0] = first ? v0 : p[0] + v0;
      p[1] = first ? v1 : p[1] + v1;
    }
  }
}

template <int NL, bool DW, bool DX>
__global__ void __launch_bounds__(THREADS, 1)
pe_mlp_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g_out,
                  float* __restrict__ dx, const bf16* __restrict__ img,
                  const float* __restrict__ bias, float* __restrict__ wpart,
                  float* __restrict__ bpart, long long n_rows, int num_freqs, int dout) {
  using G = Geo<NL>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Lane ln;
  unsigned char* reg = smem + G::WG_AT + ln.wg * G::WG_BYTES;
  bf16* act = reinterpret_cast<bf16*>(reg);                 // A_l at l * TILE_BYTES
  bf16* gl = reinterpret_cast<bf16*>(reg + G::GL_AT);
  float* dd = reinterpret_cast<float*>(reg + G::D_AT);
  float* brow = reinterpret_cast<float*>(reg + G::BACC_AT) + ln.warp * G::TOTAL_B;
  const float* sbias = reinterpret_cast<const float*>(smem + G::BIAS_AT);
  const uint32_t s_img = smem_u32(smem);
  const uint32_t s_act = smem_u32(act);
  const uint32_t s_gl = smem_u32(gl);
  auto A = [&](int l) { return s_act + l * TILE_BYTES; };
  auto fimg = [&](int l) { return s_img + G::w_off(l) * 2; };
  auto bimg = [&](int l) { return s_img + (G::TOTAL_W + G::w_off(l)) * 2; };
  const int bar = 1 + ln.wg;

  // the net, once per block
  {
    const uint4* src = reinterpret_cast<const uint4*>(img);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < G::IMG_BYTES / 16; i += THREADS) dst[i] = __ldg(src + i);
    float* b = reinterpret_cast<float*>(smem + G::BIAS_AT);
    for (int i = threadIdx.x; i < G::TOTAL_B; i += THREADS) b[i] = __ldg(bias + i);
    float* z = reinterpret_cast<float*>(reg + G::BACC_AT);
    for (int i = ln.t; i < 4 * G::TOTAL_B; i += 128) z[i] = 0.0f;
  }
  fence_async_smem();
  __syncthreads();

  float dw[NL - 1][HW / 2];
  float dwl[OW / 2];
  if constexpr (DW) {
#pragma unroll
    for (int l = 0; l < NL - 1; ++l) {
#pragma unroll
      for (int i = 0; i < HW / 2; ++i) dw[l][i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < OW / 2; ++i) dwl[i] = 0.0f;
  }
  float acc[HW / 2];

  const int F = num_freqs;
  const int enc_cols = DIM * (1 + 2 * F);
  const long long n_tiles = (n_rows + ROWS - 1) / ROWS;
  const long long stride = (long long)gridDim.x * WGS;
  long long tile = (long long)blockIdx.x * WGS + ln.wg;
  // two threads a row: this thread's row of the tile and its half
  const int er = ln.t >> 1, half = ln.t & 1;
  float xr[DIM];
  auto load_x = [&](long long tl) {
    const long long row = tl * ROWS + er;
#pragma unroll
    for (int d = 0; d < DIM; ++d) xr[d] = (tl < n_tiles && row < n_rows) ? __ldg(x + row * DIM + d) : 0.0f;
  };
  load_x(tile);

  for (; tile < n_tiles; tile += stride) {
    const long long row0 = tile * ROWS;
    // ---- 1. the encoding and its derivatives; the output cotangent
    pe_encode<true>(act, dd + er * DLD, xr, er, half, F, ENC_MAX);
    if (ln.t < ROWS) {
      const long long row = row0 + ln.t;
      const bool in = row < n_rows;
#pragma unroll
      for (int c = 0; c < OW; c += 2) {
        const float v0 = (in && c < dout) ? __ldg(g_out + row * dout + c) : 0.0f;
        const float v1 = (in && c + 1 < dout) ? __ldg(g_out + row * dout + c + 1) : 0.0f;
        *reinterpret_cast<__nv_bfloat162*>(gl + cm(ln.t, c)) = __floats2bfloat162_rn(v0, v1);
        if (DW && c < dout) {
          // the last layer's bias gradient: column sums of g over the rows
          // (warps 0 and 1 hold the tile's 64 rows)
          float s0 = v0, s1 = v1;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            s0 += __shfl_xor_sync(0xffffffffu, s0, o);
            s1 += __shfl_xor_sync(0xffffffffu, s1, o);
          }
          if (ln.lane == 0) {
            brow[G::b_off(NL - 1) + c] += s0;
            brow[G::b_off(NL - 1) + c + 1] += s1;
          }
        }
      }
    }
    load_x(tile + stride);               // the next tile's x, under this tile's products
    fence_async_smem();
    named_sync(bar, 128);

    // ---- 2. the forward: A_{l+1} = bf16(relu(A_l W_l + b_l))
#pragma unroll
    for (int l = 0; l < NL - 1; ++l) {
      wgmma_fence();
      mma_k<HW>(acc, A(l), fimg(l), l == 0 ? ((enc_cols + 15) & ~15) : HW);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      bf16* out = act + (l + 1) * (TILE_BYTES / 2);
      const float* b = sbias + G::b_off(l);
#pragma unroll
      for (int j = 0; j < HW / 8; ++j) {
        const int c = 8 * j + ln.cq;
        const float b0 = b[c], b1 = b[c + 1];
        *reinterpret_cast<__nv_bfloat162*>(out + cm(ln.r0, c)) = __floats2bfloat162_rn(
            fmaxf(acc[4 * j] + b0, 0.0f), fmaxf(acc[4 * j + 1] + b1, 0.0f));
        *reinterpret_cast<__nv_bfloat162*>(out + cm(ln.r0 + 8, c)) = __floats2bfloat162_rn(
            fmaxf(acc[4 * j + 2] + b0, 0.0f), fmaxf(acc[4 * j + 3] + b1, 0.0f));
      }
      fence_async_smem();
      named_sync(bar, 128);
    }

    // ---- 3. back through the layers: G_l at layer l's output is gl for
    // the last layer, else the tile of A_{l+1} it was written over
#pragma unroll
    for (int l = NL - 1; l >= 0; --l) {
      const uint32_t gsrc = l == NL - 1 ? s_gl : A(l + 1);
      const bool input_grad = l > 0 || DX;
      wgmma_fence();
      if constexpr (DW) {
        if (l == NL - 1) mma_dw<OW>(dwl, A(l), gsrc);
        else mma_dw<HW>(dw[l < NL - 1 ? l : 0], A(l), gsrc);
      }
      if (input_grad) mma_k<HW>(acc, gsrc, bimg(l), G::width(l));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if constexpr (DW) {
        if (l == NL - 1) fence_regs(dwl);
        else fence_regs(dw[l < NL - 1 ? l : 0]);
      }
      if (l > 0) {
        // G_{l-1} = relu mask of A_l (g·W_lᵀ), bf16 over A_l; its f32 column
        // sums are layer l-1's bias gradient
        bf16* a = act + l * (TILE_BYTES / 2);
#pragma unroll
        for (int j = 0; j < HW / 8; ++j) {
          const int c = 8 * j + ln.cq;
          __nv_bfloat162* p0 = reinterpret_cast<__nv_bfloat162*>(a + cm(ln.r0, c));
          __nv_bfloat162* p1 = reinterpret_cast<__nv_bfloat162*>(a + cm(ln.r0 + 8, c));
          const __nv_bfloat162 h0 = *p0, h1 = *p1;
          const float v0 = __bfloat162float(h0.x) > 0.0f ? acc[4 * j] : 0.0f;
          const float v1 = __bfloat162float(h0.y) > 0.0f ? acc[4 * j + 1] : 0.0f;
          const float v2 = __bfloat162float(h1.x) > 0.0f ? acc[4 * j + 2] : 0.0f;
          const float v3 = __bfloat162float(h1.y) > 0.0f ? acc[4 * j + 3] : 0.0f;
          *p0 = __floats2bfloat162_rn(v0, v1);
          *p1 = __floats2bfloat162_rn(v2, v3);
          if (DW) bias_add(brow + G::b_off(l - 1), c, v0, v1, v2, v3, ln);
        }
        fence_async_smem();
        named_sync(bar, 128);
      } else if (DX) {
        // ---- 4. d pre = (g·W_0ᵀ) x d(encode)/d(pre) x 2^f, in place of
        // the derivatives; then per row and coordinate the sum over its
        // columns in column order
#pragma unroll
        for (int j = 0; j < HW / 8; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            pe_dscale(dd, ln.r0 + 8 * h, 8 * j + ln.cq, acc[4 * j + 2 * h],
                      acc[4 * j + 2 * h + 1], enc_cols);
        }
        named_sync(bar, 128);
        pe_dx(dx, dd, row0, n_rows, F, ln.t);
      }
    }
    named_sync(bar, 128);                // the tile's buffers are free
  }

  if constexpr (DW) {
    // the block's partial row: its warpgroups' sums in order, then the
    // bias rows of every warp in order
    __syncthreads();
    float* stage = reinterpret_cast<float*>(smem + G::WG_AT);
    float* wrow = wpart + (long long)blockIdx.x * G::TOTAL_W;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const int n = G::width(l);
      for (int w = 0; w < WGS; ++w) {
        if (ln.wg == w) {
          if (l == NL - 1) stage_add<OW>(stage, dwl, w == 0, ln);
          else stage_add<HW>(stage, dw[l < NL - 1 ? l : 0], w == 0, ln);
        }
        __syncthreads();
      }
      for (int i = threadIdx.x; i < HW * n; i += THREADS) wrow[G::w_off(l) + i] = stage[i];
      __syncthreads();
    }
    float* brow_out = bpart + (long long)blockIdx.x * G::TOTAL_B;
    for (int c = threadIdx.x; c < G::TOTAL_B; c += THREADS) {
      float s = 0.0f;
      for (int w = 0; w < WGS; ++w) {
        const float* rows = reinterpret_cast<const float*>(smem + G::WG_AT + w * G::WG_BYTES +
                                                           G::BACC_AT);
        for (int q = 0; q < 4; ++q) s += rows[q * G::TOTAL_B + c];
      }
      brow_out[c] = s;
    }
  }
}

template <int NL, bool DW, bool DX>
static int launch(const float* x, const float* g, float* dx, const void* img, const float* bias,
                  float* wpart, float* bpart, long long n_rows, int num_freqs, int dout,
                  int blocks, cudaStream_t s) {
  auto k = pe_mlp_bwd_kernel<NL, DW, DX>;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<NL>::SMEM);
  if (e != cudaSuccess) return (int)e;
  k<<<(unsigned)blocks, THREADS, Geo<NL>::SMEM, s>>>(
      x, g, dx, reinterpret_cast<const bf16*>(img), bias, wpart, bpart, n_rows, num_freqs, dout);
  return (int)cudaGetLastError();
}

template <int NL>
static int run(const float* x, const float* g, float* dx, const void* img, const float* bias,
               float* wpart, float* bpart, float* dw, float* db, long long n_rows, int num_freqs,
               int dout, int blocks, cudaStream_t s) {
  const bool need_dw = wpart != nullptr, need_dx = dx != nullptr;
  int err;
  if (need_dw && need_dx)
    err = launch<NL, true, true>(x, g, dx, img, bias, wpart, bpart, n_rows, num_freqs, dout, blocks, s);
  else if (need_dw)
    err = launch<NL, true, false>(x, g, dx, img, bias, wpart, bpart, n_rows, num_freqs, dout, blocks, s);
  else
    err = launch<NL, false, true>(x, g, dx, img, bias, wpart, bpart, n_rows, num_freqs, dout, blocks, s);
  if (err || !need_dw) return err;
  err = column_sum(wpart, blocks, Geo<NL>::TOTAL_W, dw, s);
  if (err) return err;
  return column_sum(bpart, blocks, Geo<NL>::TOTAL_B, db, s);
}

}  // namespace pemlp
}  // namespace cropnerf

// Sizes of the layout of a net of n_layers layers: out[0] the elements of
// the weight images (bf16), out[1] the padded biases, out[2] and out[3] a
// block's partial row of weight and bias gradients, out[4] the dynamic
// shared memory, out[5] the warpgroups a block.  Returns 0, or -1 for a
// depth the kernel does not take.
extern "C" int cropnerf_pe_mlp_bwd_layout(int n_layers, long long* out) {
  using namespace cropnerf::pemlp;
  if (n_layers == 2) {
    out[0] = 2 * Geo<2>::TOTAL_W; out[1] = Geo<2>::TOTAL_B; out[2] = Geo<2>::TOTAL_W;
    out[3] = Geo<2>::TOTAL_B; out[4] = Geo<2>::SMEM;
  } else if (n_layers == 3) {
    out[0] = 2 * Geo<3>::TOTAL_W; out[1] = Geo<3>::TOTAL_B; out[2] = Geo<3>::TOTAL_W;
    out[3] = Geo<3>::TOTAL_B; out[4] = Geo<3>::SMEM;
  } else {
    return -1;
  }
  out[5] = WGS;
  return 0;
}

// The backward on `stream`: x [n_rows, 3], g [n_rows, dout]; img and bias
// from the layout above.  A null dx skips dx; null wpart, bpart, dw and db
// skip the weight gradients, otherwise wpart and bpart hold `blocks` rows of
// the partial sizes and dw, db receive the padded f32 gradients (layer l's
// weight [64, width] at l * 64 * 64, its bias at l * 64).  Returns a
// cudaError_t (0 on success).
extern "C" int cropnerf_pe_mlp_bwd(const float* x, const float* g, float* dx, const void* img,
                                   const float* bias, int n_layers, int num_freqs, int dout,
                                   long long n_rows, int blocks, float* wpart, float* bpart,
                                   float* dw, float* db, void* stream) {
  using namespace cropnerf::pemlp;
  const bool need_dw = wpart != nullptr;
  if ((need_dw && (bpart == nullptr || dw == nullptr || db == nullptr)) ||
      (!need_dw && dx == nullptr) || num_freqs < 0 || DIM * (1 + 2 * num_freqs) > ENC_MAX ||
      dout < 1 || dout > OW || blocks < 1 || n_rows < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (n_layers == 2)
    return run<2>(x, g, dx, img, bias, wpart, bpart, dw, db, n_rows, num_freqs, dout, blocks, s);
  if (n_layers == 3)
    return run<3>(x, g, dx, img, bias, wpart, bpart, dw, db, n_rows, num_freqs, dout, blocks, s);
  return (int)cudaErrorInvalidValue;
}
