// The vanilla field's heads' forward (fused_mlp) for Hopper (sm_90a).
//
// Replaces cropnerf_tpu/ops/pallas/fused_mlp.py _fwd_kernel (the forward
// of fused_mlp): x [N, din] f32 through a relu MLP of 2 or 3 layers whose
// hidden layers are padded to HWP = 64, 128 or 256 columns, with din at
// most 256 and at most 16 outputs, into [N, dout] f32: every head of the
// cropnerf-mxu family (64 wide in -mxu and -q; 128 and 256 in -big and
// -huge).  Nets whose images do not fit shared memory take the stream
// route of fused_mlp_stream.cu (ops/cuda/fused_mlp.py fused_mlp_route
// picks it by shape).
//
// Arithmetic, as the TPU kernel: x rounded to bf16; each hidden layer a
// bf16 product with f32 sums plus the f32 bias, relu, rounded to bf16; the
// last layer a product plus its f32 bias, stored f32.
//
// Bound on an H100: bytes for the colour heads, about even for the wide
// semantic head.  [N, 74] -> 64 -> 3 takes ~5 kMAC a row against 308
// bytes of x and output (~33 FLOP a byte), -huge's [N, 89] -> 256 -> 3
// ~24 kMAC against 368 bytes (~128), -big's [N, 185] -> 128 -> 3 ~24 kMAC
// against 752 (~63), all below the card's ~295; the semantic head
// [N, 30] -> 128 -> 128 -> 1 ~21 kMAC against 124 bytes (~332).  So the
// kernel reads x once and writes y once, keeps bulk copies of x in flight
// ahead of the tile it computes and spends no shared-memory round trip on
// the hidden layers.
//
// Design.  Persistent blocks, one per SM, of up to four warpgroups (three
// for the wider nets, for their registers; as many as shared memory holds
// for din); every warpgroup takes 64-row tiles in a fixed
// order (tile = its global index + k x the warpgroups in the grid).  The
// net's forward images (mlp_images: the first half of the image the
// backward also reads) and the biases stay in shared memory for the
// kernel's life.  Per tile a warpgroup:
//   1. waits for its x tile, a contiguous 256·din bytes that one thread
//      bulk-copied into one of its `ns` stages (two; up to four where one
//      warpgroup fills the block, as for -big's 47 KB tiles) while the
//      tiles before it ran (the ragged last tile, or an x not 16-byte
//      aligned, is loaded by the warpgroup's threads, rows past N as zero);
//   2. converts its rows straight into the register A operand of layer 0
//      (bf16 pairs, columns past din zero);
//   3. runs each hidden layer in blocks of 64 columns (wgmma m64n64,
//      din/16 or HWP/16 k-steps), adding the bias, applying relu and
//      rounding in registers; the last hidden layer's blocks feed the last
//      layer's product (m64n16) one block at a time, under the product of
//      the next block, so no activation wider than 64 columns is ever held
//      whole but a 3-layer net's first (the A operand of its second);
//   4. adds the last bias and stages the [64, dout] rows, which one thread
//      writes back with one bulk store (the ragged last tile, or an output
//      not 16-byte aligned, is stored by the threads that hold the rows).
// The 64-wide nets run one block of columns, two stages, four warpgroups.
//
// The PE variant (PE = true) is the forward of fused_pe_mlp's nets wider
// than 64, replacing cropnerf_tpu/ops/pallas/fused_pe_field.py
// _plain_fwd_kernel for them (cropnerf-mxu-q's proposal nets, 33 or 39 ->
// 128 -> 128 -> 1): x [N, 3] arrives in the stages as above (768 bytes a
// tile), and step 2 is K5's encoding (wgmma_mlp.cuh pe_encode, two threads
// a row, one sincosf a pair) into the warpgroup's chunk-major tile of kp
// columns, whose padded columns stay zero, layer 0 reading its A operand
// from there (no x row in registers); the rest is the heads' kernel.
// Bound: operations, ~24 kMAC a row at -q's nets against 16 bytes of x
// and output, 0.061 ms for a training step's two nets (1,441,792 rows) at
// 989 TFLOP/s.  It takes the heads' skeleton rather than an HWP parameter
// for fused_pe_mlp_fwd.cu because the wide layers, their 64-column blocks
// and the last layer's product under the next block's are all here
// already; the PE nets add a prologue, not a kernel.
#include "wgmma_mlp.cuh"

namespace cropnerf {
namespace mlp {

// Warpgroups a block, at most: four for the 64-wide nets, three wider (the
// A operand of layer 0, a 3-layer net's first hidden layer and a block's
// products within 168 registers a thread; four spill).
__host__ __device__ constexpr int fwd_max_wgs(int hwp) { return hwp == HW ? 4 : 3; }

template <int NL, int HWP, bool PE>
__global__ void __launch_bounds__(128 * fwd_max_wgs(HWP), 1)
mlp_fwd_kernel(const float* __restrict__ x, float* __restrict__ out,
               const bf16* __restrict__ img, const float* __restrict__ bias, long long n_rows,
               int din, int dout, int ns_arg, int x_al, int out_al, int num_freqs) {
  constexpr int KB = max_kb(NL, HWP), NB = HWP / HW;
  const int ns = stages<HWP>(ns_arg);
  const Layout L(din, dout, NL, HWP, PE);
  const FwdSmem S(L, ns);
  extern __shared__ __align__(128) unsigned char smem[];
  const Lane ln;
  const int wgs = blockDim.x >> 7;
  const int xb = L.x_bytes(), ob = L.o_bytes();
  unsigned char* reg = smem + S.wg_at + ln.wg * S.wg_bytes;
  unsigned char* xs = reg + S.x_at;                        // the x stages
  bf16* e = reinterpret_cast<bf16*>(reg);                  // a PE net's encoding
  float* ostage = reinterpret_cast<float*>(xs + ns * xb);
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + ns * xb + ob);
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
      for (int s = 0; s < ns; ++s) mbar_init(&full[s], 1);
      mbar_fence_init();
    }
    // a PE net's encoding tile zero: its padded columns stay so
    if (PE)
      for (int i = ln.t; i < L.in_bytes() / 16; i += 128)
        reinterpret_cast<uint4*>(e)[i] = make_uint4(0u, 0u, 0u, 0u);
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
      bulk_load(xs + s * xb, x + t * ROWS * L.xc, xb, &full[s]);
    } else {
      mbar_arrive(&full[s]);
    }
  };
  long long tile = (long long)blockIdx.x * wgs + ln.wg;
  if (elected)
    for (int s = 0; s + 1 < ns; ++s) issue(tile + s * stride, s);

  const uint32_t w0 = s_img + L.fw_off(0) * 2, wl = s_img + L.fw_off(NL - 1) * 2;
  float acc[HW / 2];
  float acc_out[OW / 2];
  uint32_t blk[HW / 16][4];
  uint32_t a0[PE ? 1 : KB][4];
  uint32_t a1[NL == 3 ? HWP / 16 : 1][4];
  const uint32_t s_e = smem_u32(e);
  // layer 0's block cb of 64 columns: A in registers, or a PE net's
  // encoding tile
  auto layer0 = [&](int cb) {
    if constexpr (PE)
      mma_cols_s<ENC_MAX / 16>(acc, s_e, w0, HWP, cb, kb);
    else
      mma_cols<KB>(acc, a0, w0, HWP, cb, kb);
  };
  for (int it = 0; tile < n_tiles; tile += stride, ++it) {
    const int s = it % ns;
    const long long row0 = tile * ROWS;
    float* xt = reinterpret_cast<float*>(xs + s * xb);
    // the tile ns - 1 ahead, under this one, into the stage the last read
    if (elected) issue(tile + (ns - 1) * stride, (it + ns - 1) % ns);
    mbar_wait(&full[s], (it / ns) & 1);
    if (!bulk_in(tile)) {
      load_rows(xt, x, row0, L.xc, n_rows, ln);
      named_sync(bar, 128);
    }

    // ---- 1. layer 0 from registers (a PE net's from its encoding, two
    // threads a row): a 3-layer net's whole first layer, block by block,
    // the A operand of its second
    if constexpr (PE) {
      const int er = ln.t >> 1;
      float xr[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) xr[d] = xt[er * DIM + d];
      pe_encode<false>(e, nullptr, xr, er, ln.t & 1, num_freqs, 0);
      fence_async_smem();
      named_sync(bar, 128);
    } else {
      x_to_a<KB>(a0, xt, din, kb, ln);
    }
    if constexpr (NL == 3) {
#pragma unroll
      for (int cb = 0; cb < NB; ++cb) {
        wgmma_fence();
        layer0(cb);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        relu_block(a1, cb, acc, sbias + L.b_off(0), ln);
      }
    }
    // ---- 2. the last hidden layer's first block, then block by block its
    // activation into the last layer's product, under the next block's
    const int lh = NL - 2;
    const uint32_t wh = s_img + L.fw_off(lh) * 2;
    auto hidden = [&](int cb) {
      if constexpr (NL == 3)
        mma_cols<HWP / 16>(acc, a1, wh, HWP, cb);
      else
        layer0(cb);
    };
    wgmma_fence();
    hidden(0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      relu_to_a(blk, acc, sbias + L.b_off(lh) + cb * HW, ln);
      wgmma_fence();
      mma_out(acc_out, blk, wl, cb);
      if (cb + 1 < NB) hidden(cb + 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(acc_out);
    }

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

template <int NL, int HWP, bool PE = false>
static int launch(const float* x, float* out, const void* img, const float* bias,
                  long long n_rows, const Layout& L, int blocks, int2 plan, cudaStream_t s,
                  int num_freqs = 0) {
  auto k = mlp_fwd_kernel<NL, HWP, PE>;
  const int smem = FwdSmem(L, plan.y).total(plan.x);
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int x_al = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int out_al = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  k<<<(unsigned)blocks, 128 * plan.x, smem, s>>>(x, out, reinterpret_cast<const bf16*>(img),
                                                  bias, n_rows, L.din, L.dout, plan.y, x_al,
                                                  out_al, num_freqs);
  return (int)cudaGetLastError();
}

// (warpgroups, stages) of the forward's blocks: as many warpgroups as fit,
// up to fwd_max_wgs, two stages each; a lone warpgroup of a wider net
// takes up to four stages.
static int2 fwd_plan(const Layout& L) {
  return plan_blocks([&](int wgs, int ns) { return FwdSmem(L, ns).total(wgs); }, L.hw,
                     fwd_max_wgs(L.hw), 4);
}

}  // namespace mlp
}  // namespace cropnerf

// Sizes of the forward for a net x [N, din] -> n_layers layers -> dout,
// hidden layers padded to hw: out[0] the elements of the forward images it
// reads (bf16; the first half of mlp_images' image), out[1] the padded
// biases, out[2] the dynamic shared memory, out[3] the warpgroups a block,
// out[4] the x stages a warpgroup.  With pe, the PE variant for a net whose
// layer 0 takes the din-column encoding of x [N, 3].  Returns 0, or -1 for
// a net the kernel does not take.
extern "C" int cropnerf_mlp_fwd_layout(int din, int dout, int n_layers, int hw, int pe,
                                       long long* out) {
  using namespace cropnerf::mlp;
  const Layout L(din, dout, n_layers, hw, pe != 0);
  if (!L.ok()) return -1;
  const int2 plan = fwd_plan(L);
  if (plan.x < 1) return -1;
  out[0] = L.fwd_elems();
  out[1] = L.n_bias();
  out[2] = FwdSmem(L, plan.y).total(plan.x);
  out[3] = plan.x;
  out[4] = plan.y;
  return 0;
}

// The forward on `stream`: x [n_rows, din] -> out [n_rows, dout] f32, with
// `blocks` persistent blocks; img and bias as mlp_images builds them for
// hidden width hw.  num_freqs >= 0 runs the PE variant: x [n_rows, 3], its
// encoding of din = 3(1 + 2 num_freqs) columns layer 0's input.  Returns a
// cudaError_t (0 on success).
extern "C" int cropnerf_mlp_fwd(const float* x, float* out, const void* img, const float* bias,
                                int din, int dout, int n_layers, int hw, int num_freqs,
                                long long n_rows, int blocks, void* stream) {
  using namespace cropnerf::mlp;
  const bool pe = num_freqs >= 0;
  const Layout L(din, dout, n_layers, hw, pe);
  if (!L.ok() || blocks < 1 || n_rows < 0 || (pe && din != DIM * (1 + 2 * num_freqs)))
    return (int)cudaErrorInvalidValue;
  const int2 plan = fwd_plan(L);
  if (plan.x < 1) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (pe) {
    if (n_layers == 3)
      return launch<3, 128, true>(x, out, img, bias, n_rows, L, blocks, plan, s, num_freqs);
    if (hw == 128)
      return launch<2, 128, true>(x, out, img, bias, n_rows, L, blocks, plan, s, num_freqs);
    return launch<2, 256, true>(x, out, img, bias, n_rows, L, blocks, plan, s, num_freqs);
  }
  if (n_layers == 3)
    return hw == 64 ? launch<3, 64>(x, out, img, bias, n_rows, L, blocks, plan, s)
                    : launch<3, 128>(x, out, img, bias, n_rows, L, blocks, plan, s);
  if (hw == 64) return launch<2, 64>(x, out, img, bias, n_rows, L, blocks, plan, s);
  if (hw == 128) return launch<2, 128>(x, out, img, bias, n_rows, L, blocks, plan, s);
  return launch<2, 256>(x, out, img, bias, n_rows, L, blocks, plan, s);
}
