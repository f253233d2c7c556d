// The PE proposal nets' forward (fused_pe_mlp) for Hopper (sm_90a).
//
// Replaces cropnerf_tpu/ops/pallas/fused_pe_field.py _plain_fwd_kernel (the
// forward of fused_pe_mlp): x [N, 3] is encoded, [x | sin(2^f x) |
// cos(2^f x)] (f-major blocks, ops/posenc.nerf_encoding's columns), and run
// through a relu MLP whose hidden layers are at most 64 wide and whose last
// layer is linear with at most 16 outputs, into [N, Dout] f32.  Wider nets
// take the PE variant of fused_mlp_fwd.cu, or the stream route of
// fused_mlp_stream.cu (ops/cuda/fused_pe_field.py pe_mlp_fwd_route picks
// by shape).
//
// Arithmetic, as the TPU kernel: the encoding rounded to bf16 (wgmma_mlp.cuh
// pe_encode: the accurate sinf/cosf, as one sincosf a pair);
// each hidden layer a bf16 product with f32 sums plus the f32 bias, relu,
// rounded to bf16; the last layer a product plus its f32 bias, stored f32.
//
// Bound on an H100: operations.  A 33 -> 64 -> 64 -> 1 net takes ~6.3 kMAC
// a row on the tensor cores against 16 bytes of x and the output: 0.019 ms
// for a training step's two nets (1,441,792 rows) at 989 TFLOP/s.  What
// sets the time in practice is a tile's serial chain: the encoding's
// sincosf (~1,000 a 64-row tile), then three dependent products and their
// epilogues.
//
// Design.  Persistent blocks, one per SM, of four warpgroups; every
// warpgroup takes 64-row tiles in a fixed order (tile = its global index +
// k x the warpgroups in the grid), so the warpgroups of an SM run out of
// phase and one's encoding overlaps another's products.  The forward
// images of the net (pe_mlp_images: the first half of the image the
// backward also reads) and the biases stay in shared memory for the
// kernel's life.  Per tile a warpgroup:
//   1. encodes its 64 rows from x loaded a tile ahead, two threads a row,
//      into a chunk-major bf16 tile E whose padded columns stay zero;
//   2. runs layer 0 as wgmma m64n64 on E;
//   3. adds the bias, applies relu and rounds in registers: the rounded
//      accumulator pairs are already the register A operand of the next
//      product (wgmma_layers.cuh WgmmaRA), so no hidden activation goes
//      through shared memory; the last layer is m64n16;
//   4. adds the last bias in registers and stores the rows it holds (rows
//      past N load zero x and store nothing).
#include "wgmma_mlp.cuh"

namespace cropnerf {
namespace pemlp {

constexpr int FWD_WGS = 4;             // warpgroups a block
constexpr int FWD_THREADS = 128 * FWD_WGS;
constexpr int E_BYTES = ROWS * ENC_MAX * 2;

// The forward's shared memory: the forward images, the biases, one E tile
// a warpgroup.
template <int NL>
struct FwdGeo : Net<NL> {
  static constexpr int IMG_BYTES = Net<NL>::TOTAL_W * 2;
  static constexpr int BIAS_AT = IMG_BYTES;
  static constexpr int E_AT = al128(IMG_BYTES + Net<NL>::TOTAL_B * 4);
  static constexpr int SMEM = E_AT + FWD_WGS * E_BYTES;
};
static_assert(FwdGeo<3>::IMG_BYTES % 16 == 0 && FwdGeo<2>::IMG_BYTES % 16 == 0, "uint4 copy");

template <int NL>
__global__ void __launch_bounds__(FWD_THREADS, 1)
pe_mlp_fwd_kernel(const float* __restrict__ x, float* __restrict__ out,
                  const bf16* __restrict__ img, const float* __restrict__ bias,
                  long long n_rows, int num_freqs, int dout) {
  using G = FwdGeo<NL>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Lane ln;
  bf16* e = reinterpret_cast<bf16*>(smem + G::E_AT + ln.wg * E_BYTES);
  const float* sbias = reinterpret_cast<const float*>(smem + G::BIAS_AT);
  const uint32_t s_img = smem_u32(smem);
  const uint32_t s_e = smem_u32(e);
  const int bar = 1 + ln.wg;

  // the net, once per block; the E tiles zero, so their padded columns stay
  // zero for the kernel's life
  {
    const uint4* src = reinterpret_cast<const uint4*>(img);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < G::IMG_BYTES / 16; i += FWD_THREADS) dst[i] = __ldg(src + i);
    float* b = reinterpret_cast<float*>(smem + G::BIAS_AT);
    for (int i = threadIdx.x; i < G::TOTAL_B; i += FWD_THREADS) b[i] = __ldg(bias + i);
    uint4* z = reinterpret_cast<uint4*>(smem + G::E_AT);
    for (int i = threadIdx.x; i < FWD_WGS * E_BYTES / 16; i += FWD_THREADS)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_async_smem();
  __syncthreads();

  const int F = num_freqs;
  const int enc_cols = DIM * (1 + 2 * F);
  const int k0 = (enc_cols + 15) & ~15;
  const long long n_tiles = (n_rows + ROWS - 1) / ROWS;
  const long long stride = (long long)gridDim.x * FWD_WGS;
  long long tile = (long long)blockIdx.x * FWD_WGS + ln.wg;
  // two threads a row: this thread's row of the tile and its half
  const int er = ln.t >> 1, half = ln.t & 1;
  float xr[DIM];
  auto load_x = [&](long long tl) {
    const long long row = tl * ROWS + er;
#pragma unroll
    for (int d = 0; d < DIM; ++d)
      xr[d] = (tl < n_tiles && row < n_rows) ? __ldg(x + row * DIM + d) : 0.0f;
  };
  load_x(tile);

  float acc[HW / 2];
  float acc_out[OW / 2];
  uint32_t a[HW / 16][4];
  for (; tile < n_tiles; tile += stride) {
    const long long row0 = tile * ROWS;
    // ---- 1. the encoding
    pe_encode<false>(e, nullptr, xr, er, half, F, 0);
    load_x(tile + stride);               // the next tile's x, under this tile's products
    fence_async_smem();
    named_sync(bar, 128);

    // ---- 2. layer 0 on E; E is free once it has completed
    wgmma_fence();
    mma_k<HW>(acc, s_e, s_img + G::w_off(0) * 2, k0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    named_sync(bar, 128);

    // ---- 3. the hidden layers from registers, then the last layer
#pragma unroll
    for (int l = 1; l < NL - 1; ++l) {
      relu_to_a(a, acc, sbias + G::b_off(l - 1), ln);
      wgmma_fence();
      mma_regs<HW>(acc, a, s_img + G::w_off(l) * 2);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    relu_to_a(a, acc, sbias + G::b_off(NL - 2), ln);
    wgmma_fence();
    mma_regs<OW>(acc_out, a, s_img + G::w_off(NL - 1) * 2);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_out);

    // ---- 4. the last bias, and the rows and columns this thread holds
    const float* bl = sbias + G::b_off(NL - 1);
#pragma unroll
    for (int j = 0; j < OW / 8; ++j) {
      const int c = 8 * j + ln.cq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = row0 + ln.r0 + 8 * h;
        if (row < n_rows) {
          float* o = out + row * dout + c;
          if (c < dout) o[0] = acc_out[4 * j + 2 * h] + bl[c];
          if (c + 1 < dout) o[1] = acc_out[4 * j + 2 * h + 1] + bl[c + 1];
        }
      }
    }
  }
}

template <int NL>
static int launch(const float* x, float* out, const void* img, const float* bias,
                  long long n_rows, int num_freqs, int dout, int blocks, cudaStream_t s) {
  auto k = pe_mlp_fwd_kernel<NL>;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       FwdGeo<NL>::SMEM);
  if (e != cudaSuccess) return (int)e;
  k<<<(unsigned)blocks, FWD_THREADS, FwdGeo<NL>::SMEM, s>>>(
      x, out, reinterpret_cast<const bf16*>(img), bias, n_rows, num_freqs, dout);
  return (int)cudaGetLastError();
}

}  // namespace pemlp
}  // namespace cropnerf

// Sizes of the forward for a net of n_layers layers: out[0] the elements of
// the forward images it reads (bf16; the first part of pe_mlp_images'
// image), out[1] the padded biases, out[2] the dynamic shared memory,
// out[3] the warpgroups a block.  Returns 0, or -1 for a depth the kernel
// does not take.
extern "C" int cropnerf_pe_mlp_fwd_layout(int n_layers, long long* out) {
  using namespace cropnerf::pemlp;
  if (n_layers == 2) {
    out[0] = Net<2>::TOTAL_W; out[1] = Net<2>::TOTAL_B; out[2] = FwdGeo<2>::SMEM;
  } else if (n_layers == 3) {
    out[0] = Net<3>::TOTAL_W; out[1] = Net<3>::TOTAL_B; out[2] = FwdGeo<3>::SMEM;
  } else {
    return -1;
  }
  out[3] = FWD_WGS;
  return 0;
}

// The forward on `stream`: x [n_rows, 3] -> out [n_rows, dout] f32, with
// `blocks` persistent blocks; img and bias as pe_mlp_images builds them.
// Returns a cudaError_t (0 on success).
extern "C" int cropnerf_pe_mlp_fwd(const float* x, float* out, const void* img,
                                   const float* bias, int n_layers, int num_freqs, int dout,
                                   long long n_rows, int blocks, void* stream) {
  using namespace cropnerf::pemlp;
  if (num_freqs < 0 || DIM * (1 + 2 * num_freqs) > ENC_MAX || dout < 1 || dout > OW ||
      blocks < 1 || n_rows < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (n_layers == 2) return launch<2>(x, out, img, bias, n_rows, num_freqs, dout, blocks, s);
  if (n_layers == 3) return launch<3>(x, out, img, bias, n_rows, num_freqs, dout, blocks, s);
  return (int)cudaErrorInvalidValue;
}
