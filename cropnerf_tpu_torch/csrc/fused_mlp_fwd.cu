// The vanilla field's heads' forward (fused_mlp) for Hopper (sm_90a).
//
// Replaces cropnerf_tpu/ops/pallas/fused_mlp.py _fwd_kernel (the forward
// of fused_mlp): x [N, din] f32 through a relu MLP of 2 or 3 layers whose
// hidden layers are at most 64 wide, with din at most 128 and at most 16
// outputs, into [N, dout] f32.  Other nets take the wmma route of
// fused_mlp.cu (ops/cuda/fused_mlp.py fused_mlp_route picks it by shape).
//
// Arithmetic, as the TPU kernel: x rounded to bf16; each hidden layer a
// bf16 product with f32 sums plus the f32 bias, relu, rounded to bf16; the
// last layer a product plus its f32 bias, stored f32.
//
// Bound on an H100: bytes.  The colour head [N, 74] -> 64 -> 3 takes ~5
// kMAC a row against 308 bytes of x and output, the semantic head [N, 15]
// -> 64 -> 1 ~1 kMAC against 64 bytes: ~33 and ~32 FLOP a byte, far below
// the card's ~295.  So the kernel reads x once and writes y once, keeps
// every bulk copy of x in flight a tile ahead and spends no shared-memory
// round trip on the hidden layers.
//
// Design.  Persistent blocks, one per SM, of up to four warpgroups (as
// many as shared memory holds for din); every warpgroup takes 64-row tiles
// in a fixed order (tile = its global index + k x the warpgroups in the
// grid).  The net's forward images (mlp_images: the first half of the
// image the backward also reads) and the biases stay in shared memory for
// the kernel's life.  Per tile a warpgroup:
//   1. waits for its x tile, a contiguous 256·din bytes that one thread
//      bulk-copied into one of two stages while the previous tile ran
//      (the ragged last tile, or an x not 16-byte aligned, is loaded by
//      the warpgroup's threads, rows past N as zero);
//   2. converts its rows straight into the register A operand of layer 0
//      (bf16 pairs, columns past din zero) and runs layer 0 as wgmma
//      m64n64, din/16 k-steps;
//   3. adds the bias, applies relu and rounds in registers, feeding the
//      next product from registers; the last layer is m64n16;
//   4. adds the last bias and stages the [64, dout] rows, which one thread
//      writes back with one bulk store (the ragged last tile, or an output
//      not 16-byte aligned, is stored by the threads that hold the rows).
#include "wgmma_mlp.cuh"

namespace cropnerf {
namespace mlp {

constexpr int FWD_MAX_WGS = 4;         // warpgroups a block, at most

template <int NL>
__global__ void __launch_bounds__(128 * FWD_MAX_WGS, 1)
mlp_fwd_kernel(const float* __restrict__ x, float* __restrict__ out,
               const bf16* __restrict__ img, const float* __restrict__ bias, long long n_rows,
               int din, int dout, int x_al, int out_al) {
  const Layout L(din, dout, NL);
  const FwdSmem S(L);
  extern __shared__ __align__(128) unsigned char smem[];
  const Lane ln;
  const int wgs = blockDim.x >> 7;
  const int xb = L.x_bytes(), ob = L.o_bytes();
  unsigned char* reg = smem + S.wg_at + ln.wg * S.wg_bytes;
  float* ostage = reinterpret_cast<float*>(reg + 2 * xb);
  uint64_t* full = reinterpret_cast<uint64_t*>(reg + 2 * xb + ob);
  const float* sbias = reinterpret_cast<const float*>(smem + S.bias_at);
  const uint32_t s_img = smem_u32(smem);
  const int bar = 1 + ln.wg;
  const bool elected = ln.t == 0;

  // the net, once per block; the stages' barriers
  {
    const uint4* src = reinterpret_cast<const uint4*>(img);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < S.bias_at / 16; i += blockDim.x) dst[i] = __ldg(src + i);
    float* b = reinterpret_cast<float*>(smem + S.bias_at);
    for (int i = threadIdx.x; i < L.n_bias(); i += blockDim.x) b[i] = __ldg(bias + i);
    if (elected) {
      mbar_init(&full[0], 1);
      mbar_init(&full[1], 1);
      mbar_fence_init();
    }
  }
  fence_async_smem();
  __syncthreads();

  const int kb = L.kp >> 4;
  const long long n_tiles = (n_rows + ROWS - 1) / ROWS;
  const long long stride = (long long)gridDim.x * wgs;
  auto bulk_in = [&](long long t) { return x_al && (t + 1) * ROWS <= n_rows; };
  // the elected thread's half of a tile's arrival on stage s: a bulk copy,
  // or a bare arrival where the threads load the tile themselves
  auto issue = [&](long long t, int s) {
    if (t >= n_tiles) return;
    if (bulk_in(t)) {
      mbar_expect_tx(&full[s], xb);
      bulk_load(reg + s * xb, x + t * ROWS * din, xb, &full[s]);
    } else {
      mbar_arrive(&full[s]);
    }
  };
  long long tile = (long long)blockIdx.x * wgs + ln.wg;
  if (elected) issue(tile, 0);

  float acc[HW / 2];
  float acc_out[OW / 2];
  uint32_t a[HW / 16][4];
  uint32_t a0[MAX_KB][4];
  for (int it = 0; tile < n_tiles; tile += stride, ++it) {
    const int s = it & 1;
    const long long row0 = tile * ROWS;
    float* xt = reinterpret_cast<float*>(reg + s * xb);
    if (elected) issue(tile + stride, s ^ 1);   // the next tile, under this one
    mbar_wait(&full[s], (it >> 1) & 1);
    if (!bulk_in(tile)) {
      load_rows(xt, x, row0, din, n_rows, ln);
      named_sync(bar, 128);
    }

    // ---- 1. layer 0 from registers
    x_to_a(a0, xt, din, kb, ln);
    wgmma_fence();
    mma_layer0(acc, a0, s_img + L.fw_off(0) * 2, kb);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    // ---- 2. the hidden layers from registers, then the last layer
#pragma unroll
    for (int l = 1; l < NL - 1; ++l) {
      relu_to_a(a, acc, sbias + L.b_off(l - 1), ln);
      wgmma_fence();
      mma_regs<HW>(acc, a, s_img + L.fw_off(l) * 2);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    relu_to_a(a, acc, sbias + L.b_off(NL - 2), ln);
    wgmma_fence();
    mma_regs<OW>(acc_out, a, s_img + L.fw_off(NL - 1) * 2);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_out);

    // ---- 3. the last bias; the rows staged for one bulk store, or stored
    // by the threads that hold them
    const float* bl = sbias + L.b_off(NL - 1);
    const bool bulk_out = out_al && (tile + 1) * ROWS <= n_rows;
    if (bulk_out && elected) bulk_wait_read();  // the previous store has read the stage
    named_sync(bar, 128);                       // the x stage is read, the output stage free
#pragma unroll
    for (int j = 0; j < OW / 8; ++j) {
      const int c = 8 * j + ln.cq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ln.r0 + 8 * h;
        const float v0 = acc_out[4 * j + 2 * h] + bl[c];
        const float v1 = acc_out[4 * j + 2 * h + 1] + bl[c + 1];
        float* o = bulk_out ? ostage + r * dout + c : out + (row0 + r) * dout + c;
        if (bulk_out || row0 + r < n_rows) {
          if (c < dout) o[0] = v0;
          if (c + 1 < dout) o[1] = v1;
        }
      }
    }
    if (bulk_out) {
      fence_async_smem();
      named_sync(bar, 128);
      if (elected) {
        bulk_store(out + row0 * dout, ostage, ob);
        bulk_commit();
      }
    }
  }
  if (elected) bulk_wait();
}

template <int NL>
static int launch(const float* x, float* out, const void* img, const float* bias,
                  long long n_rows, int din, int dout, int blocks, int wgs, cudaStream_t s) {
  auto k = mlp_fwd_kernel<NL>;
  const int smem = FwdSmem(Layout(din, dout, NL)).total(wgs);
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int x_al = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int out_al = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  k<<<(unsigned)blocks, 128 * wgs, smem, s>>>(x, out, reinterpret_cast<const bf16*>(img), bias,
                                              n_rows, din, dout, x_al, out_al);
  return (int)cudaGetLastError();
}

// Warpgroups a block of the forward: as many as fit, up to FWD_MAX_WGS.
static int fwd_wgs(const Layout& L) {
  const FwdSmem S(L);
  int wgs = FWD_MAX_WGS;
  while (wgs > 0 && S.total(wgs) > 232448) --wgs;
  return wgs;
}

}  // namespace mlp
}  // namespace cropnerf

// Sizes of the forward for a net x [N, din] -> n_layers layers -> dout:
// out[0] the elements of the forward images it reads (bf16; the first
// half of mlp_images' image), out[1] the padded biases, out[2] the dynamic
// shared memory, out[3] the warpgroups a block.  Returns 0, or -1 for a
// net the kernel does not take.
extern "C" int cropnerf_mlp_fwd_layout(int din, int dout, int n_layers, long long* out) {
  using namespace cropnerf::mlp;
  const Layout L(din, dout, n_layers);
  if (!L.ok()) return -1;
  const int wgs = fwd_wgs(L);
  if (wgs < 1) return -1;
  out[0] = L.fwd_elems();
  out[1] = L.n_bias();
  out[2] = FwdSmem(L).total(wgs);
  out[3] = wgs;
  return 0;
}

// The forward on `stream`: x [n_rows, din] -> out [n_rows, dout] f32, with
// `blocks` persistent blocks; img and bias as mlp_images builds them.
// Returns a cudaError_t (0 on success).
extern "C" int cropnerf_mlp_fwd(const float* x, float* out, const void* img, const float* bias,
                                int din, int dout, int n_layers, long long n_rows, int blocks,
                                void* stream) {
  using namespace cropnerf::mlp;
  const Layout L(din, dout, n_layers);
  if (!L.ok() || blocks < 1 || n_rows < 0) return (int)cudaErrorInvalidValue;
  const int wgs = fwd_wgs(L);
  if (wgs < 1) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (n_layers == 2) return launch<2>(x, out, img, bias, n_rows, din, dout, blocks, wgs, s);
  return launch<3>(x, out, img, bias, n_rows, din, dout, blocks, wgs, s);
}
