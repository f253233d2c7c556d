// K5's wide backward for Hopper (sm_90a): the recompute backward of
// fused_pe_mlp's nets wider than 64 with weight gradients, with or without
// dx.
//
// Replaces cropnerf_tpu/ops/pallas/fused_pe_field.py _plain_bwd_kernel for
// the nets ops/cuda/fused_pe_field.py pe_mlp_fwd_route sends to "wide": x
// [N, 3] encoded with F frequencies (din = 3(1 + 2F) <= 64 columns, padded
// to kp, a multiple of 16), 3 relu layers padded to 128 or 2 padded to 128
// or 256, at most 16 outputs (cropnerf-mxu-q's proposal nets, 33 or 39 ->
// 128 -> 128 -> 1).  dx alone runs on the PE variant of fused_mlp_bwd.cu.
//
// Arithmetic, K5's (fused_pe_mlp_bwd.cu's note): the forward recomputed in
// bf16 with f32 sums; relu masks from the bf16 activations; cotangents f32,
// rounded to bf16 only as product operands; dx from layer 0's f32 input
// gradient scaled by d(encode)/d(pre)·2^f and summed per coordinate in
// column order; f32 bias sums of the unrounded cotangents.
//
// Bound on an H100: operations, ~62 kMAC a row at -q's net 0 and 64 at
// net 1 (the recompute, every input gradient, every weight gradient)
// against 20 bytes of x, g and dx: 0.183 ms for a training step's two nets
// at 989 TFLOP/s.
//
// Design.  The TPU kernel keeps its weight gradients in VMEM across its
// whole grid; here each block keeps its weight sums in registers across
// all of its tiles and writes them once.  Persistent blocks, one an SM,
// take 64-row tiles in a fixed order (block b: b, b + blocks, ...), each
// block two warpgroups that hand each other one of two operand-tile sets
// (chunk-major A_0, A_l, G_l of a tile) by mbarriers:
//   - the compute warpgroup (0) takes a set whose A_0 holds the tile's
//     encoding and g from one of its stages (bulk-copied a tile ahead),
//     recomputes the hidden layers in 64-column wgmma blocks fed from
//     registers and goes back through the layers with the cotangents in
//     registers, G·W_lᵀ as wgmma, each layer's blocks two in flight (one
//     block's epilogue beside the next one's product).  It writes A_l and
//     G_l into the set and hands it over; each warp adds its rows'
//     bias-gradient column sums into its own row in shared memory;
//   - the weight-gradient warpgroup (1) holds the block's dW_0ᵀ, dW_1 and
//     dW_last in wgmma accumulators for the block's whole run (192 f32 a
//     thread at -q's nets) and adds each tile's products A_lᵀ·G_l, both
//     operands MN-major from the set, as one commit group, which it waits
//     for at once (on an H100 a group left in flight across tiles made the
//     compute warpgroup's own products up to 1.8x slower).  It takes the
//     rest of the tile's work off the compute warpgroup's path: dx =
//     G_0·W_0ᵀ from G_0's tile in 16-column products, scaled by the tile's
//     d(encode)/d(pre)·2^f (from x while the products run, in its
//     derivative tile) and summed per coordinate; the encoding of the
//     set's next tile, two threads a row, into A_0, after which it hands
//     the set back; and the stages' bulk copies.
// So the compute warpgroup runs the tile's products and their epilogues
// alone, and writes tile t + 1 into the other set while tile t's weight
// products and dx run.  Shared memory holds the forward images alone:
// G·W_lᵀ reads W_l's forward image as the MN-major B operand Wᵀ, which
// frees room for the second set (a net whose two sets do not fit takes
// one, handed back after each tile).  At the end the weight-gradient
// warpgroup writes its sums once into the block's partial row and the
// block its warps' bias sums in order into its bias row; fixed-order
// column sums (column_sum.cuh) reduce the rows.  No atomics:
// the plan depends on N and the SM count alone, so two runs give the same
// bits, and the weight gradients are the same with and without dx.  Rows
// past N encode zero x and load zero cotangents, so they add nothing.
#include "column_sum.cuh"
#include "wgmma_bwd.cuh"

namespace cropnerf {

template <int TA, int TB>
struct Wgmma<48, TA, TB> {
  __device__ __forceinline__ static void mma(float (&d)[24], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, %27, %28;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

namespace mlp {

// The block's shared memory: the forward images and the biases, then the
// compute warpgroup's `ns` stages of g, the weight-gradient warpgroup's
// derivative tile, `nset` operand-tile sets (A_0, A_l for l >= 1,
// G_{NL-1}, G_l for l < NL - 1, chunk-major), the barriers (the stages',
// the sets' full and ready), and the compute warps' bias-gradient rows.
struct WideSmem {
  int bias_at, wg_at, stage_bytes, dd_at, set_at, set_bytes, bar_at, bsum_at, total, n_bias;
  int a0, ah, gl, gh, tile;
  __host__ __device__ WideSmem(const Layout& L, int ns, int nset) : n_bias(L.n_bias()) {
    bias_at = L.fwd_elems() * 2;
    wg_at = al128(bias_at + L.n_bias() * 4);
    stage_bytes = L.o_bytes();
    int off = wg_at + ns * stage_bytes;
    dd_at = off;
    off += ROWS * DLD * 4;
    tile = L.tile_bytes();
    a0 = 0;
    ah = L.in_bytes();
    gl = ah + (L.nl - 1) * tile;
    gh = gl + ROWS * OW * 2;
    set_bytes = al128(gh + (L.nl - 1) * tile);
    set_at = off;
    off += nset * set_bytes;
    bar_at = off;
    off += 8 * (ns + 4);
    bsum_at = al128(off);
    total = bsum_at + 4 * L.n_bias() * 4;
  }
};

// acc (=) A·Wᵀ over output columns 64cb .. 64cb + 63, i.e. rows of W [K,
// width]: A in registers, its S 16-column k-steps over W's columns;
// Wᵀ read from W's forward image (K-major core matrices of W) as the
// MN-major B operand: k-steps 256 bytes apart, 8 output columns
// width·16 bytes apart.
template <int S>
__device__ __forceinline__ void mma_wt(float (&acc)[HW / 2], const uint32_t (&a)[S][4],
                                       uint32_t fw, int width, int cb) {
#pragma unroll
  for (int s = 0; s < S; ++s)
    WgmmaRA<HW, 1>::mma(acc, a[s], gmma_desc(fw + s * 256 + cb * 8 * width * 16, 128, width * 16),
                        s > 0 ? 1 : 0);
}

// Row er's f32 d(encode)/d(pre) x 2^f into drow, two threads a row (half 0
// the identity columns and the even frequencies, half 1 the odd ones): the
// derivatives wgmma_mlp.cuh pe_encode<true> writes, the same sincosf.
__device__ __forceinline__ void pe_deriv(float* drow, const float (&xr)[DIM], int half, int F) {
  const int cos0 = DIM * (1 + F);
  if (half == 0)
#pragma unroll
    for (int d = 0; d < DIM; ++d) drow[d] = 1.0f;
  for (int f = half; f < F; f += 2) {
    const float scale = (float)(1 << f);
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      float sn, cs;
      sincosf(xr[d] * scale, &sn, &cs);
      drow[DIM + f * DIM + d] = cs * scale;
      drow[cos0 + f * DIM + d] = -sn * scale;
    }
  }
}

// Layer 0's f32 input gradient (v0, v1) at columns c, c + 1 of the tile's
// row r times the derivatives of the tile dd in their place, as
// wgmma_mlp.cuh pe_dscale, in one 8-byte access; the columns past the
// encoding's hold no derivative and are never read.
__device__ __forceinline__ void dscale2(float* dd, int r, int c, float v0, float v1) {
  float2* p = reinterpret_cast<float2*>(dd + r * DLD + c);
  float2 q = *p;
  q.x = __fmul_rn(v0, q.x);
  q.y = __fmul_rn(v1, q.y);
  *p = q;
}

// dx [N, 3] of the tile's rows below n_rows, as wgmma_mlp.cuh pe_dx (per
// row and coordinate the sum of its scaled columns in column order:
// identity, sines by frequency, cosines by frequency), an item (row r,
// coordinate k) a thread with its columns loaded before the sums; items
// k-minor, so a warp's loads fall on more banks.
__device__ __forceinline__ void dx_rows(float* dx, const float* dd, long long row0,
                                        long long n_rows, int F, int t) {
  constexpr int FM = (ENC_MAX / DIM - 1) / 2;   // frequencies at most
  const int cos0 = DIM * (1 + F);
  for (int i = t; i < ROWS * DIM; i += 128) {
    const int r = i / DIM, k = i % DIM;
    const float* p = dd + r * DLD + k;
    float sn[FM], cs[FM];
#pragma unroll
    for (int f = 0; f < FM; ++f) {
      sn[f] = f < F ? p[DIM + f * DIM] : 0.0f;
      cs[f] = f < F ? p[cos0 + f * DIM] : 0.0f;
    }
    float s = p[0];
#pragma unroll
    for (int f = 0; f < FM; ++f)
      if (f < F) s = __fadd_rn(s, sn[f]);
#pragma unroll
    for (int f = 0; f < FM; ++f)
      if (f < F) s = __fadd_rn(s, cs[f]);
    if (row0 + r < n_rows) dx[(row0 + r) * DIM + k] = s;
  }
}

// A layer's NB 64-column blocks, two in flight: block cb's product
// issue(acc, cb) into one of two accumulators, then, once it is done,
// epilogue(acc, cb), which runs while block cb + 1's product does.
template <int NB, class Issue, class Epilogue>
__device__ __forceinline__ void two_in_flight(float (&acc)[2][HW / 2], const Issue& issue,
                                              const Epilogue& epilogue) {
  wgmma_fence();
  issue(acc[0], 0);
  wgmma_commit();
#pragma unroll
  for (int cb = 0; cb < NB; ++cb) {
    if (cb + 1 < NB) {
      wgmma_fence();
      issue(acc[(cb + 1) & 1], cb + 1);
      wgmma_commit();
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(acc[cb & 1]);
    epilogue(acc[cb & 1], cb);
  }
}

template <int NL, int HWP, int KB>
__global__ void __launch_bounds__(256, 1)
pe_wide_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g_out,
                   float* __restrict__ dx, const bf16* __restrict__ img,
                   const float* __restrict__ bias, float* __restrict__ wpart,
                   float* __restrict__ bpart, long long n_rows, int din, int dout, int ns,
                   int nset, int g_al, int num_freqs) {
  constexpr int NB = HWP / HW, S = HWP / 16, KP = 16 * KB;
  const Layout L(din, dout, NL, HWP, true);
  const WideSmem SM(L, ns, nset);
  extern __shared__ __align__(128) unsigned char smem[];
  const Lane ln;
  const float* sbias = reinterpret_cast<const float*>(smem + SM.bias_at);
  const uint32_t s_img = smem_u32(smem);
  auto fimg = [&](int l) { return s_img + L.fw_off(l) * 2; };
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM.bar_at);   // the stages'
  uint64_t* set_full = full + ns;                                     // a set written
  uint64_t* set_ready = set_full + 2;                                 // a set free, A_0 encoded
  unsigned char* sets = smem + SM.set_at;
  auto a0t = [&](int o) { return reinterpret_cast<bf16*>(sets + o * SM.set_bytes + SM.a0); };
  auto aht = [&](int o, int l) {                                      // A_l, l >= 1
    return reinterpret_cast<bf16*>(sets + o * SM.set_bytes + SM.ah + (l - 1) * SM.tile);
  };
  auto glt = [&](int o) { return reinterpret_cast<bf16*>(sets + o * SM.set_bytes + SM.gl); };
  auto ght = [&](int o, int l) {                                      // G_l, l < NL - 1
    return reinterpret_cast<bf16*>(sets + o * SM.set_bytes + SM.gh + l * SM.tile);
  };
  float* dd = reinterpret_cast<float*>(smem + SM.dd_at);
  float* bsum = reinterpret_cast<float*>(smem + SM.bsum_at);
  const bool elected = ln.t == 0;

  // the forward images and biases, once per block; the barriers; the bias
  // rows zero; the sets' encoding tiles zero (their padded columns stay so)
  {
    const uint4* src = reinterpret_cast<const uint4*>(img);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < SM.bias_at / 16; i += blockDim.x) dst[i] = __ldg(src + i);
    float* b = reinterpret_cast<float*>(smem + SM.bias_at);
    for (int i = threadIdx.x; i < L.n_bias(); i += blockDim.x) b[i] = __ldg(bias + i);
    if (threadIdx.x == 0) {
      for (int s = 0; s < ns; ++s) mbar_init(&full[s], 1);
      for (int o = 0; o < 2; ++o) {
        mbar_init(&set_full[o], 128);
        mbar_init(&set_ready[o], 128);
      }
      mbar_fence_init();
    }
    for (int i = threadIdx.x; i < 4 * L.n_bias(); i += blockDim.x) bsum[i] = 0.0f;
    for (int o = 0; o < nset; ++o)
      for (int i = threadIdx.x; i < L.in_bytes() / 16; i += blockDim.x)
        reinterpret_cast<uint4*>(a0t(o))[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_async_smem();
  __syncthreads();

  const long long n_tiles = (n_rows + ROWS - 1) / ROWS;
  const long long stride = gridDim.x;
  const int ob = L.o_bytes();
  auto bulk_in = [&](long long t) { return g_al && (t + 1) * ROWS <= n_rows; };
  auto stage = [&](int s) { return reinterpret_cast<float*>(smem + SM.wg_at + s * SM.stage_bytes); };
  if (ln.wg == 0) {
    // ---- the compute warpgroup
    float* brow = bsum + ln.warp * L.n_bias();
    long long tile = blockIdx.x;
    float acc[2][HW / 2];
    uint32_t act[NL - 1][S][4];          // A_l (l >= 1), bf16 pairs: the relu masks
    uint32_t gc[NL - 1][S][4];           // G_l (l < NL - 1), bf16 pairs
    uint32_t gl[4];                      // the output cotangent, bf16 pairs
    for (int it = 0; tile < n_tiles; tile += stride, ++it) {
      const int s = it % ns, o = it % nset;
      float* gt = stage(s);
      mbar_wait(&full[s], (it / ns) & 1);
      if (!bulk_in(tile)) {
        load_rows(gt, g_out, tile * ROWS, dout, n_rows, ln);
        named_sync(1, 128);
      }
      mbar_wait(&set_ready[o], (it / nset) & 1);  // the set is free, A_0 encoded

      // ---- 1. the output cotangent into registers and G's tile
      g_to_a<true>(gl, gt, dout, brow + L.b_off(NL - 1), ln);
      store_step(glt(o), 0, gl, ln);

      // ---- 2. the forward: A_{l+1} = bf16(relu(A_l W_l + b_l)) in
      // registers, a block of 64 columns at a time
      const uint32_t a0 = smem_u32(a0t(o));
      two_in_flight<NB>(
          acc, [&](auto& a, int cb) { mma_cols_s<KB>(a, a0, fimg(0), HWP, cb, KB); },
          [&](auto& a, int cb) { relu_block(act[0], cb, a, sbias + L.b_off(0), ln); });
      if constexpr (NL == 3)
        two_in_flight<NB>(
            acc, [&](auto& a, int cb) { mma_cols<S>(a, act[0], fimg(1), HWP, cb); },
            [&](auto& a, int cb) { relu_block(act[1], cb, a, sbias + L.b_off(1), ln); });
#pragma unroll
      for (int l = 1; l < NL; ++l) store_tile(aht(o, l), act[l - 1], S, ln);

      // ---- 3. back through the layers, a block of 64 columns at a time:
      // G_{l-1} = mask(A_l) (G_l·W_lᵀ), Wᵀ from the forward images
      two_in_flight<NB>(
          acc,
          [&](auto& a, int cb) {
            WgmmaRA<HW, 1>::mma(a, gl, gmma_desc(fimg(NL - 1) + cb * 8 * OW * 16, 128, OW * 16),
                                0);
          },
          [&](auto& a, int cb) {
            mask_block<true>(gc[NL - 2], cb, a, act[NL - 2], brow + L.b_off(NL - 2), ln);
          });
      if constexpr (NL == 3) {
        store_tile(ght(o, 1), gc[1], S, ln);
        two_in_flight<NB>(
            acc, [&](auto& a, int cb) { mma_wt<S>(a, gc[1], fimg(1), HWP, cb); },
            [&](auto& a, int cb) {
              mask_block<true>(gc[0], cb, a, act[0], brow + L.b_off(0), ln);
            });
      }
      store_tile(ght(o, 0), gc[0], S, ln);
      fence_async_smem();
      mbar_arrive(&set_full[o]);         // the set is written, the stage read
    }
  } else {
    // ---- the weight-gradient warpgroup: the block's sums in registers
    float dw0[NB][KP / 2];               // dW_0ᵀ rows 64hb .. (hidden units), kp columns
    float dwh[NL == 3 ? NB : 1][NL == 3 ? HWP / 2 : 1];  // dW_1 rows 64hb ..
    float dwl[NB][OW / 2];               // dW_{NL-1} rows 64hb ..
#pragma unroll
    for (int hb = 0; hb < NB; ++hb) {
#pragma unroll
      for (int i = 0; i < KP / 2; ++i) dw0[hb][i] = 0.0f;
#pragma unroll
      for (int i = 0; i < OW / 2; ++i) dwl[hb][i] = 0.0f;
    }
    if constexpr (NL == 3) {
#pragma unroll
      for (int hb = 0; hb < NB; ++hb)
#pragma unroll
        for (int i = 0; i < HWP / 2; ++i) dwh[hb][i] = 0.0f;
    }
    // a tile's g on stage s (the elected thread): a bulk copy, or a bare
    // arrival where the compute warpgroup loads it
    auto issue = [&](long long t, int s) {
      if (t >= n_tiles) return;
      if (bulk_in(t)) {
        mbar_expect_tx(&full[s], ob);
        bulk_load(stage(s), g_out + t * ROWS * dout, ob, &full[s]);
      } else {
        mbar_arrive(&full[s]);
      }
    };
    // x of the calling thread's row of tile t (two threads a row), zero past N
    const int er = ln.t >> 1, half = ln.t & 1;
    auto x_row = [&](long long t, float (&xr)[DIM]) {
      const long long row = t * ROWS + er;
#pragma unroll
      for (int d = 0; d < DIM; ++d) xr[d] = row < n_rows ? __ldg(x + row * DIM + d) : 0.0f;
    };
    // tile t's encoding into set o's A_0 tile, two threads a row; the set
    // is handed to the compute warpgroup
    auto encode = [&](long long t, int o) {
      if (t >= n_tiles) return;
      float xr[DIM];
      x_row(t, xr);
      pe_encode<false>(a0t(o), nullptr, xr, er, half, num_freqs, 0);
      fence_async_smem();
      mbar_arrive(&set_ready[o]);
    };
    if (elected)
      for (int s = 0; s < ns; ++s) issue(blockIdx.x + s * stride, s);
    for (int o = 0; o < nset; ++o) encode(blockIdx.x + o * stride, o);
    int it = 0;
    for (long long tile = blockIdx.x; tile < n_tiles; tile += stride, ++it) {
      const int o = it % nset;
      mbar_wait(&set_full[o], (it / nset) & 1);
      if (elected) issue(tile + ns * stride, it % ns);  // the stage is read
      const uint32_t a0 = smem_u32(a0t(o)), gl = smem_u32(glt(o)), g0 = smem_u32(ght(o, 0));
      const uint32_t al = smem_u32(aht(o, NL - 1));
      wgmma_fence();
#pragma unroll
      for (int hb = 0; hb < NB; ++hb) {
        mma_dw<OW>(dwl[hb], al + hb * 8 * 1024, gl);            // A_{NL-1}ᵀ·G_{NL-1}
        if constexpr (NL == 3)                                   // A_1ᵀ·G_1
          mma_dw<HWP>(dwh[hb], smem_u32(aht(o, 1)) + hb * 8 * 1024, smem_u32(ght(o, 1)));
        mma_dw<KP>(dw0[hb], g0 + hb * 8 * 1024, a0);            // G_0ᵀ·A_0
      }
      wgmma_commit();
      if (dx == nullptr) {
        wgmma_wait<0>();
      } else {
        // ---- dx = G_0·W_0ᵀ from G_0's tile, scaled by d(encode)/d(pre)·2^f
        // of the tile's rows (from x while the products run) and summed
        // per coordinate
        {
          float xr[DIM];
          x_row(tile, xr);
          pe_deriv(dd + er * DLD, xr, half, num_freqs);
        }
#pragma unroll
        for (int c0 = 0; c0 < KB; c0 += 2) {
          float d[2][8];                 // columns 16c0 .. 16c0 + 31
          wgmma_fence();
#pragma unroll
          for (int u = 0; u < 2; ++u)
            if (c0 + u < KB)
#pragma unroll
              for (int k = 0; k < S; ++k)
                Wgmma<16, 0, 1>::mma(
                    d[u], gmma_desc(g0 + k * 2048, 1024, 128),
                    gmma_desc(fimg(0) + k * 256 + (c0 + u) * 2 * HWP * 16, 128, HWP * 16),
                    k > 0 ? 1 : 0);
          wgmma_commit();
          wgmma_wait<0>();
          named_sync(2, 128);            // the derivatives are written
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (c0 + u >= KB) continue;
            fence_regs(d[u]);
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                dscale2(dd, ln.r0 + 8 * h, 16 * (c0 + u) + 8 * j + ln.cq, d[u][4 * j + 2 * h],
                        d[u][4 * j + 2 * h + 1]);
          }
        }
      }
      // the set's products are done: its next tile's encoding
      encode(tile + nset * stride, o);
      if (dx != nullptr) {
        named_sync(2, 128);
        dx_rows(dx, dd, tile * ROWS, n_rows, num_freqs, ln.t);
        named_sync(2, 128);              // the derivative tile is read
      }
    }
#pragma unroll
    for (int hb = 0; hb < NB; ++hb) {
      fence_regs(dw0[hb]);
      fence_regs(dwl[hb]);
      if constexpr (NL == 3) fence_regs(dwh[hb]);
    }
    // the block's partial row, each element written once
    float* wrow = wpart + (long long)blockIdx.x * L.fwd_elems();
#pragma unroll
    for (int hb = 0; hb < NB; ++hb) {
      // dW_0 [kp, HWP] from dW_0ᵀ: element (8j + cq + e, 64hb + r0 + 8h)
#pragma unroll
      for (int j = 0; j < KP / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            wrow[L.fw_off(0) + (8 * j + ln.cq + e) * HWP + hb * HW + ln.r0 + 8 * h] =
                dw0[hb][4 * j + 2 * h + e];
      if constexpr (NL == 3) add_rows(wrow + L.fw_off(1) + hb * HW * HWP, HWP, dwh[hb], true, ln);
      add_rows(wrow + L.fw_off(NL - 1) + hb * HW * OW, OW, dwl[hb], true, ln);
    }
  }

  // the block's bias row: its compute warps' rows in order
  __syncthreads();
  for (int c = threadIdx.x; c < L.n_bias(); c += blockDim.x) {
    float v = 0.0f;
    for (int q = 0; q < 4; ++q) v += bsum[q * L.n_bias() + c];
    bpart[(long long)blockIdx.x * L.n_bias() + c] = v;
  }
}

// (g stages, operand-tile sets) of a block: two sets where they fit
// (with two stages, else one), else one set.  (0, 0) where nothing fits.
static int2 wide_plan(const Layout& L) {
  for (int nset = 2; nset >= 1; --nset)
    for (int ns = 2; ns >= 1; --ns)
      if (WideSmem(L, ns, nset).total <= MAX_SMEM) return make_int2(ns, nset);
  return make_int2(0, 0);
}

template <int NL, int HWP, int KB>
static int run(const float* x, const float* g, float* dx, const void* img, const float* bias,
               float* wpart, float* bpart, float* dw, float* db, long long n_rows,
               const Layout& L, int blocks, int num_freqs, cudaStream_t s) {
  auto k = pe_wide_bwd_kernel<NL, HWP, KB>;
  const int2 plan = wide_plan(L);
  const int smem = WideSmem(L, plan.x, plan.y).total;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int g_al = (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  k<<<(unsigned)blocks, 256, smem, s>>>(x, g, dx, reinterpret_cast<const bf16*>(img), bias, wpart,
                                         bpart, n_rows, L.din, L.dout, plan.x, plan.y, g_al,
                                         num_freqs);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = column_sum(wpart, blocks, L.fwd_elems(), dw, s);
  if (err) return err;
  return column_sum(bpart, blocks, L.n_bias(), db, s);
}

template <int NL, int HWP>
static int run_kb(const float* x, const float* g, float* dx, const void* img, const float* bias,
                  float* wpart, float* bpart, float* dw, float* db, long long n_rows,
                  const Layout& L, int blocks, int num_freqs, cudaStream_t s) {
  switch (L.kp >> 4) {
    case 1:
      return run<NL, HWP, 1>(x, g, dx, img, bias, wpart, bpart, dw, db, n_rows, L, blocks,
                             num_freqs, s);
    case 2:
      return run<NL, HWP, 2>(x, g, dx, img, bias, wpart, bpart, dw, db, n_rows, L, blocks,
                             num_freqs, s);
    case 3:
      return run<NL, HWP, 3>(x, g, dx, img, bias, wpart, bpart, dw, db, n_rows, L, blocks,
                             num_freqs, s);
    default:
      return run<NL, HWP, 4>(x, g, dx, img, bias, wpart, bpart, dw, db, n_rows, L, blocks,
                             num_freqs, s);
  }
}

}  // namespace mlp
}  // namespace cropnerf

// Sizes of the backward with weight gradients for a PE net x [N, 3] ->
// the din-column encoding -> n_layers layers -> dout, hidden layers padded
// to hw (128, or 256 at 2 layers), as fused_mlp_bwd.cu's layout function
// reports them (need_dw and pe must be 1): out[0] the elements of the
// weight images (both halves of mlp_images; the kernel reads the forward
// half), out[1] the padded biases, out[2] and out[3] a partial row of
// weight and bias gradients, out[4] the dynamic shared memory, out[5] the
// warpgroups a block that take tiles (1; a weight-gradient warpgroup runs
// beside it), out[6] the weight partial rows a block writes (1, each
// element once), out[7] the stages of g, out[8] the operand-tile sets.
// Returns 0, or -1 for a net the kernel does not take.
extern "C" int cropnerf_pe_wide_bwd_layout(int din, int dout, int n_layers, int hw, int need_dw,
                                           int pe, long long* out) {
  using namespace cropnerf::mlp;
  const Layout L(din, dout, n_layers, hw, true);
  if (!L.ok() || !need_dw || !pe) return -1;
  const int2 plan = wide_plan(L);
  if (plan.x < 1) return -1;
  out[0] = 2 * L.fwd_elems();
  out[1] = L.n_bias();
  out[2] = L.fwd_elems();
  out[3] = L.n_bias();
  out[4] = WideSmem(L, plan.x, plan.y).total;
  out[5] = 1;
  out[6] = 1;
  out[7] = plan.x;
  out[8] = plan.y;
  return 0;
}

// The backward on `stream`, with fused_mlp_bwd.cu's arguments: x and dx
// [n_rows, 3], g [n_rows, dout], img and bias as mlp_images builds them;
// din = 3(1 + 2 num_freqs); a null dx skips dx; wpart and bpart hold
// `blocks` rows of the partial sizes (each written whole), dw and db
// receive the padded f32 gradients.  Returns a cudaError_t (0 on
// success).
extern "C" int cropnerf_pe_wide_bwd(const float* x, const float* g, float* dx, const void* img,
                                    const float* bias, int din, int dout, int n_layers, int hw,
                                    int num_freqs, long long n_rows, int blocks, float* wpart,
                                    float* bpart, float* dw, float* db, void* stream) {
  using namespace cropnerf::mlp;
  const Layout L(din, dout, n_layers, hw, true);
  if (!L.ok() || wpart == nullptr || bpart == nullptr || dw == nullptr || db == nullptr ||
      blocks < 1 || n_rows < 0 || num_freqs < 0 || din != DIM * (1 + 2 * num_freqs) ||
      wide_plan(L).x < 1)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (n_layers == 3)
    return run_kb<3, 128>(x, g, dx, img, bias, wpart, bpart, dw, db, n_rows, L, blocks,
                          num_freqs, s);
  if (hw == 128)
    return run_kb<2, 128>(x, g, dx, img, bias, wpart, bpart, dw, db, n_rows, L, blocks,
                          num_freqs, s);
  return run_kb<2, 256>(x, g, dx, img, bias, wpart, bpart, dw, db, n_rows, L, blocks, num_freqs,
                        s);
}
