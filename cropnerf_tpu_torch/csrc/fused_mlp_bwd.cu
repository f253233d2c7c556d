// The vanilla field's heads' recompute backward (fused_mlp) for Hopper
// (sm_90a).
//
// Replaces cropnerf_tpu/ops/pallas/fused_mlp.py _bwd_kernel (the backward
// of fused_mlp) for the nets fused_mlp_fwd.cu takes: x [N, din] through a
// relu MLP of 2 or 3 layers, hidden layers padded to HWP = 64, 128 or 256
// columns, din at most 256, at most 16 outputs (every head of the
// cropnerf-mxu family).  Given the cotangent g [N, dout] it returns dx
// [N, din] and the f32 gradient of every weight and bias, each only where
// asked.
//
// Arithmetic, as the TPU kernel: the forward is recomputed in bf16 with
// f32 sums; relu masks come from the bf16 activations; the cotangents stay
// f32 and are rounded to bf16 only as product operands; dx is the f32 sum
// G_0·W_0ᵀ; bias gradients are f32 column sums of the unrounded
// cotangents.
//
// Bound on an H100: bytes.  The BayesRays pass asks for dx alone: the
// colour head [N, 74] -> 64 -> 3 reads x and g and writes dx, 604 bytes a
// row, for ~10 kMAC (the hidden layer's recompute and two input
// gradients), ~33 FLOP a byte; -huge's [N, 89] -> 256 -> 3 ~49 kMAC
// against 724 bytes (~135), -big's [N, 185] -> 128 -> 3 ~48 kMAC against
// 1,492 (~64); the semantic head [N, 30] -> 128 -> 128 -> 1 ~41 kMAC
// against 244 bytes (~338, about even).  So dx is the whole cost, and the
// kernel moves x, g and dx by bulk copies with nothing else through
// device memory.
//
// Design.  The forward kernel's skeleton: persistent blocks of up to four
// warpgroups (fewer wider, or with weight gradients), 64-row tiles
// in a fixed order, the whole net resident in shared memory (both halves
// of mlp_images: the forward images and the input-gradient images of Wᵀ).
// Per tile a warpgroup:
//   1. waits for its x and g tiles, bulk-copied into one of its stages
//      while the previous tile ran (the ragged last tile, or an x or g not
//      16-byte aligned, by the threads, rows past N as zero);
//   2. recomputes the hidden layers in blocks of 64 columns, wgmma m64n64
//      products fed from registers, keeping each bf16 activation in
//      registers: they are the relu masks;
//   3. goes back through the layers with the cotangents in registers, a
//      block of 64 columns at a time: G·W_lᵀ as wgmma with G the register
//      A operand, the relu mask and the bf16 rounding in registers; dx =
//      G_0·W_0ᵀ in 16-column products, staged over the x tile it no
//      longer needs and written back by one bulk store.
// Without weight gradients that is all: no column sum, no barrier for one.
// With them, the activations and cotangents also go to chunk-major tiles,
// and dW_l += A_lᵀ·G_l runs as wgmma with both operands MN-major from
// those tiles (layer 0 as dW_0ᵀ += G_0ᵀ·A_0, one 16-column block of A_0 at
// a time), and each warp adds its rows' bias-gradient column sums into its
// own row in shared memory.  The 64-wide nets keep the weight sums in
// registers across all of a warpgroup's tiles (the masks then read back
// from the activations' tiles), and at the end the block adds its
// warpgroups' sums in order into its partial row; the wider nets' sums do
// not fit registers (-big's dW_0 alone is 192 x 128), so each tile's
// products are added, block by block, into the warpgroup's own partial
// row in device memory (zeroed by the caller; each element always by the
// same thread).  Fixed-order column sums reduce the rows.  No atomics:
// the plan depends on N and the SM count alone, so two runs give the same
// bits.  Rows past N load zero x and zero cotangents, so they add nothing.
//
// The PE variant (PE = true) is the recompute backward of fused_pe_mlp's
// nets wider than 64 without weight gradients (dx alone), replacing
// cropnerf_tpu/ops/pallas/fused_pe_field.py _plain_bwd_kernel for them,
// with K5's arithmetic (fused_pe_mlp_bwd.cu's note): x [N, 3] arrives in
// the stages (768 bytes a tile); step 1 encodes it, two threads a row
// (wgmma_mlp.cuh pe_encode), into A_0's chunk-major tile, which layer 0's
// products read, and keeps each column's f32 d(encode)/d(pre) x 2^f in a
// derivative tile; step 4 scales G_0·W_0ᵀ's f32 columns by those
// (pe_dscale) and sums each coordinate's columns in column order into dx
// [N, 3] (pe_dx).  With weight gradients those nets take
// fused_pe_mlp_wide_bwd.cu, which keeps the sums on chip.
#include "column_sum.cuh"
#include "wgmma_bwd.cuh"

namespace cropnerf {
namespace mlp {

// Warpgroups a block, at most.  64 wide: four with dx alone (three for a
// 3-layer net, whose two activations stay in registers as masks), two with
// the weight gradients in registers.  Wider: two (the activations and
// cotangents of 128 or 256 columns and layer 0's A operand stay within
// 255 registers a thread; at three, within 168, they spill).
__host__ __device__ constexpr int bwd_max_wgs(int nl, bool dw, int hwp) {
  return hwp != HW ? 2 : dw ? 2 : nl == 3 ? 3 : 4;
}

template <int NL, bool DW, bool DX, int HWP, bool PE>
__global__ void __launch_bounds__(128 * bwd_max_wgs(NL, DW, HWP), 1)
mlp_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g_out,
               float* __restrict__ dx, const bf16* __restrict__ img,
               const float* __restrict__ bias, float* __restrict__ wpart,
               float* __restrict__ bpart, long long n_rows, int din, int dout, int ns_arg,
               int in_al, int dx_al, int num_freqs) {
  constexpr int KB = max_kb(NL, HWP), NB = HWP / HW, S = HWP / 16;
  const int ns = stages<HWP>(ns_arg);
  // weight sums in registers over the warpgroup's tiles (64 wide), or
  // each tile's products flushed into the warpgroup's partial row (wider)
  constexpr bool RDW = DW && HWP == HW, FLUSH = DW && HWP != HW;
  const Layout L(din, dout, NL, HWP, PE);
  const BwdSmem SM(L, DW, ns);
  extern __shared__ __align__(128) unsigned char smem[];
  const Lane ln;
  const int wgs = blockDim.x >> 7;
  const int xb = L.x_bytes(), ob = L.o_bytes();
  unsigned char* reg = smem + SM.wg_at + ln.wg * SM.wg_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(reg + SM.bar_at);
  const float* sbias = reinterpret_cast<const float*>(smem + SM.bias_at);
  const uint32_t s_img = smem_u32(smem);
  auto fimg = [&](int l) { return s_img + L.fw_off(l) * 2; };
  auto bimg = [&](int l) { return s_img + L.bw_off(l) * 2; };
  bf16* a0t = reinterpret_cast<bf16*>(reg + SM.a0_at);                // A_0
  float* dd = reinterpret_cast<float*>(reg + SM.dd_at);               // PE: d(encode)
  auto aht = [&](int l) {                                              // A_l, l >= 1
    return reinterpret_cast<bf16*>(reg + SM.ah_at + (l - 1) * L.tile_bytes());
  };
  bf16* glt = reinterpret_cast<bf16*>(reg + SM.gl_at);                // G_{NL-1}
  auto ght = [&](int l) {                                              // G_l, l < NL - 1
    return reinterpret_cast<bf16*>(reg + SM.gh_at + l * L.tile_bytes());
  };
  // the bias gradients' column sums: one row a warp, for the whole kernel
  float* bsum = reinterpret_cast<float*>(smem + SM.bsum_at(wgs));
  float* brow = bsum + (ln.wg * 4 + ln.warp) * L.n_bias();
  const int bar = 1 + ln.wg;
  const bool elected = ln.t == 0;

  // the net, once per block; the stages' barriers; the bias rows zero
  {
    const uint4* src = reinterpret_cast<const uint4*>(img);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < SM.bias_at / 16; i += blockDim.x) dst[i] = __ldg(src + i);
    float* b = reinterpret_cast<float*>(smem + SM.bias_at);
    for (int i = threadIdx.x; i < L.n_bias(); i += blockDim.x) b[i] = __ldg(bias + i);
    if (elected) {
      for (int s = 0; s < ns; ++s) mbar_init(&full[s], 1);
      mbar_fence_init();
    }
    if (DW)
      for (int i = threadIdx.x; i < wgs * 4 * L.n_bias(); i += blockDim.x) bsum[i] = 0.0f;
    // a PE net's encoding tile zero: its padded columns stay so
    if (PE)
      for (int i = ln.t; i < L.in_bytes() / 16; i += 128)
        reinterpret_cast<uint4*>(a0t)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_async_smem();
  __syncthreads();

  // weight gradient sums over the warpgroup's tiles (64 wide)
  float dw0[KB][8];                    // dW_0ᵀ by 16-column blocks of kp
  float dwh[NL == 3 ? HW / 2 : 1];     // dW_1 of a 3-layer net
  float dwl[OW / 2];                   // dW of the last layer
  if constexpr (RDW) {
#pragma unroll
    for (int i = 0; i < KB; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dw0[i][j] = 0.0f;
#pragma unroll
    for (int i = 0; i < (NL == 3 ? HW / 2 : 1); ++i) dwh[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < OW / 2; ++i) dwl[i] = 0.0f;
  }
  // the warpgroup's partial row of weight gradients (wider nets)
  float* wrow = wpart + ((long long)blockIdx.x * wgs + ln.wg) * L.fwd_elems();

  const int kb = L.kp >> 4;
  const long long n_tiles = (n_rows + ROWS - 1) / ROWS;
  const long long stride = (long long)gridDim.x * wgs;
  auto bulk_in = [&](long long t) { return in_al && (t + 1) * ROWS <= n_rows; };
  // the elected thread's half of a tile's arrival on stage s: bulk copies
  // of x and g, or a bare arrival where the threads load them
  auto issue = [&](long long t, int s) {
    if (t >= n_tiles) return;
    unsigned char* st = reg + s * SM.stage_bytes;
    if (bulk_in(t)) {
      mbar_expect_tx(&full[s], xb + ob);
      bulk_load(st, x + t * ROWS * L.xc, xb, &full[s]);
      bulk_load(st + xb, g_out + t * ROWS * dout, ob, &full[s]);
    } else {
      mbar_arrive(&full[s]);
    }
  };
  long long tile = (long long)blockIdx.x * wgs + ln.wg;
  if (elected)
    for (int s = 0; s + 1 < ns; ++s) issue(tile + s * stride, s);

  float acc[HW / 2];
  uint32_t a0[PE ? 1 : KB][4];
  uint32_t act[NL - 1][S][4];          // A_l (l >= 1), bf16 pairs: the relu masks
  uint32_t mask[HW / 16][4];           // 64 wide with dW, a mask read back from its tile
  uint32_t gc[NL - 1][S][4];           // G_l (l < NL - 1), bf16 pairs
  uint32_t gl[4];                      // the output cotangent, bf16 pairs
  for (int it = 0; tile < n_tiles; tile += stride, ++it) {
    const int s = it % ns;
    const long long row0 = tile * ROWS;
    float* xt = reinterpret_cast<float*>(reg + s * SM.stage_bytes);
    float* gt = reinterpret_cast<float*>(reg + s * SM.stage_bytes + xb);
    if (elected) {
      bulk_wait_read();                  // the last dx store has read its stage
      issue(tile + (ns - 1) * stride, (it + ns - 1) % ns);  // ns - 1 tiles ahead
    }
    mbar_wait(&full[s], (it / ns) & 1);
    if (!bulk_in(tile)) {
      load_rows(xt, x, row0, L.xc, n_rows, ln);
      load_rows(gt, g_out, row0, dout, n_rows, ln);
      named_sync(bar, 128);
    }

    // ---- 1. the stages into registers (and, for dW, into operand tiles);
    // a PE net's x encoded, two threads a row, into A_0's tile, with its
    // derivatives for dx
    if constexpr (PE) {
      const int er = ln.t >> 1;
      float xr[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) xr[d] = xt[er * DIM + d];
      pe_encode<DX>(a0t, dd + er * DLD, xr, er, ln.t & 1, num_freqs, 0);
    } else {
      x_to_a<KB>(a0, xt, din, kb, ln);
    }
    g_to_a<DW>(gl, gt, dout, brow + L.b_off(NL - 1), ln);
    if constexpr (DW) {
      if constexpr (!PE) store_tile(a0t, a0, kb, ln);
      store_step(glt, 0, gl, ln);
    }
    if constexpr (DW || PE) fence_async_smem();
    named_sync(bar, 128);                // the stage is read

    // ---- 2. the forward: A_{l+1} = bf16(relu(A_l W_l + b_l)) in registers,
    // a block of 64 columns at a time
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      wgmma_fence();
      if constexpr (PE)
        mma_cols_s<ENC_MAX / 16>(acc, smem_u32(a0t), fimg(0), HWP, cb, kb);
      else
        mma_cols<KB>(acc, a0, fimg(0), HWP, cb, kb);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      relu_block(act[0], cb, acc, sbias + L.b_off(0), ln);
    }
    if constexpr (NL == 3) {
#pragma unroll
      for (int cb = 0; cb < NB; ++cb) {
        wgmma_fence();
        mma_cols<S>(acc, act[0], fimg(1), HWP, cb);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        relu_block(act[1], cb, acc, sbias + L.b_off(1), ln);
      }
    }
    if constexpr (DW) {
#pragma unroll
      for (int l = 1; l < NL; ++l) store_tile(aht(l), act[l - 1], S, ln);
      fence_async_smem();
      named_sync(bar, 128);
    }

    // ---- 3. back through the layers, a block of 64 columns at a time:
    // G_{NL-2} = mask(A_{NL-1}) (G_{NL-1}·W_{NL-1}ᵀ), one k-step each; 64
    // wide with dW, the last layer's weight gradient beside it, and the
    // mask read back from A's tile, so no activation stays in registers
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      wgmma_fence();
      if constexpr (RDW) mma_dw<OW>(dwl, smem_u32(aht(NL - 1)), smem_u32(glt));
      WgmmaRA<HW, 0>::mma(acc, gl, gmma_desc(bimg(NL - 1) + cb * 1024, HWP * 16, 128), 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if constexpr (RDW) {
        fence_regs(dwl);
        load_tile(mask, aht(NL - 1), ln);
        mask_to_g<DW>(gc[NL - 2], acc, mask, brow + L.b_off(NL - 2), ln);
      } else {
        mask_block<DW>(gc[NL - 2], cb, acc, act[NL - 2], brow + L.b_off(NL - 2), ln);
      }
    }
    if constexpr (NL == 3) {
      // the hidden layer: G_0 = mask(A_1) (G_1·W_1ᵀ), dW_1 += A_1ᵀ·G_1
      if constexpr (DW) {
        store_tile(ght(1), gc[1], S, ln);
        fence_async_smem();
        named_sync(bar, 128);
      }
#pragma unroll
      for (int cb = 0; cb < NB; ++cb) {
        wgmma_fence();
        if constexpr (RDW) mma_dw<HW>(dwh, smem_u32(aht(1)), smem_u32(ght(1)));
        mma_cols<S>(acc, gc[1], bimg(1), HWP, cb);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        if constexpr (RDW) {
          fence_regs(dwh);
          load_tile(mask, aht(1), ln);
          mask_to_g<DW>(gc[0], acc, mask, brow + L.b_off(0), ln);
        } else {
          mask_block<DW>(gc[0], cb, acc, act[0], brow + L.b_off(0), ln);
        }
      }
    }
    if constexpr (DW) {
      store_tile(ght(0), gc[0], S, ln);
      fence_async_smem();
      named_sync(bar, 128);
    }
    if constexpr (RDW) {
      // dW_0ᵀ += G_0ᵀ·A_0, a 16-column block of A_0 at a time
      wgmma_fence();
#pragma unroll
      for (int cb = 0; cb < KB; ++cb)
        if (cb < kb) mma_dw<16>(dw0[cb], smem_u32(ght(0)), smem_u32(a0t) + cb * 2048);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int cb = 0; cb < KB; ++cb) fence_regs(dw0[cb]);
    }

    // ---- 4. dx = G_0·W_0ᵀ, two 16-column products a group, staged over
    // the x tile for one bulk store, or stored by the threads that hold it;
    // a PE net's scaled by the derivatives and summed per coordinate
    if constexpr (DX) {
      const bool bulk_out = !PE && dx_al && (tile + 1) * ROWS <= n_rows;
      for (int cb = 0; cb < kb; cb += 2) {
        float d[2][8];
        wgmma_fence();
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (cb + u < kb) {
#pragma unroll
            for (int k = 0; k < S; ++k)
              WgmmaRA<16, 0>::mma(
                  d[u], gc[0][k],
                  gmma_desc(bimg(0) + 2 * k * L.kp * 16 + (cb + u) * 256, L.kp * 16, 128),
                  k > 0 ? 1 : 0);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(d[0]);
        fence_regs(d[1]);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (cb + u >= kb) continue;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = 16 * (cb + u) + 8 * j + ln.cq;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = ln.r0 + 8 * h;
              if constexpr (PE) {
                pe_dscale(dd, r, c, d[u][4 * j + 2 * h], d[u][4 * j + 2 * h + 1], din);
              } else {
                float* o = bulk_out ? xt + r * din + c : dx + (row0 + r) * din + c;
                if (bulk_out || row0 + r < n_rows) {
                  if (c < din) o[0] = d[u][4 * j + 2 * h];
                  if (c + 1 < din) o[1] = d[u][4 * j + 2 * h + 1];
                }
              }
            }
          }
        }
      }
      if constexpr (PE) {
        named_sync(bar, 128);
        pe_dx(dx, dd, row0, n_rows, num_freqs, ln.t);
        named_sync(bar, 128);            // the derivative tile is read
      } else if (bulk_out) {
        fence_async_smem();
        named_sync(bar, 128);
        if (elected) {
          bulk_store(dx + row0 * din, xt, xb);
          bulk_commit();
        }
      }
    }

    // ---- 5. wider nets: this tile's weight gradients from the operand
    // tiles, block by block into the warpgroup's partial row
    if constexpr (FLUSH) {
#pragma unroll 1
      for (int hb = 0; hb < NB; ++hb) {
        const uint32_t a_last = smem_u32(aht(NL - 1)) + hb * 8 * 1024;
        {   // dW_{NL-1} rows 64hb ..: A_{NL-1}ᵀ·G_{NL-1}
          float d[OW / 2];
#pragma unroll
          for (int i = 0; i < OW / 2; ++i) d[i] = 0.0f;
          wgmma_fence();
          mma_dw<OW>(d, a_last, smem_u32(glt));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(d);
          add_rows(wrow + L.fw_off(NL - 1) + hb * HW * OW, OW, d, false, ln);
        }
        if constexpr (NL == 3) {
          // dW_1 block (hb, nb): A_1ᵀ·G_1
#pragma unroll 1
          for (int nb = 0; nb < NB; ++nb) {
            float d[HW / 2];
#pragma unroll
            for (int i = 0; i < HW / 2; ++i) d[i] = 0.0f;
            wgmma_fence();
            mma_dw<HW>(d, smem_u32(aht(1)) + hb * 8 * 1024, smem_u32(ght(1)) + nb * 8 * 1024);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(d);
            add_rows(wrow + L.fw_off(1) + hb * HW * HWP + nb * HW, HWP, d, false, ln);
          }
        }
        // dW_0ᵀ rows 64hb ..: G_0ᵀ·A_0, a 16-column block of A_0 at a time
#pragma unroll 1
        for (int cb = 0; cb < kb; ++cb) {
          float d[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) d[i] = 0.0f;
          wgmma_fence();
          mma_dw<16>(d, smem_u32(ght(0)) + hb * 8 * 1024, smem_u32(a0t) + cb * 2048);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(d);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                wrow[L.fw_off(0) + (16 * cb + 8 * j + ln.cq + e) * HWP + hb * HW + ln.r0 +
                     8 * h] += d[4 * j + 2 * h + e];
        }
      }
      named_sync(bar, 128);              // the operand tiles are read
    }
  }
  if (elected) bulk_wait();

  if constexpr (DW) {
    // the block's partial row: 64 wide, its warpgroups' weight sums in
    // order; then the bias rows of every warp in order
    if constexpr (RDW) {
      float* brow_w = wpart + (long long)blockIdx.x * L.fwd_elems();
      for (int w = 0; w < wgs; ++w) {
        if (ln.wg == w) {
          // dW_0 [kp, HW] from the blocks of dW_0ᵀ: (16cb + 8j + cq + e, r0 + 8h)
#pragma unroll
          for (int cb = 0; cb < KB; ++cb) {
            if (cb >= kb) continue;
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  float* p = brow_w + L.fw_off(0) + (16 * cb + 8 * j + ln.cq + e) * HW + ln.r0 +
                             8 * h;
                  const float v = dw0[cb][4 * j + 2 * h + e];
                  *p = w == 0 ? v : *p + v;
                }
          }
          if constexpr (NL == 3) add_rows(brow_w + L.fw_off(1), HW, dwh, w == 0, ln);
          add_rows(brow_w + L.fw_off(NL - 1), OW, dwl, w == 0, ln);
        }
        __syncthreads();
      }
    } else {
      __syncthreads();
    }
    for (int c = threadIdx.x; c < L.n_bias(); c += blockDim.x) {
      float v = 0.0f;
      for (int q = 0; q < 4 * wgs; ++q) v += bsum[q * L.n_bias() + c];
      bpart[(long long)blockIdx.x * L.n_bias() + c] = v;
    }
  }
}

// Weight-gradient partial rows a block writes: one (its warpgroups' sums
// in order) 64 wide, one a warpgroup wider.
static int wpart_rows(const Layout& L, int wgs) { return L.hw == HW ? 1 : wgs; }

// (warpgroups, stages) of the backward's blocks: as many warpgroups as
// fit, up to bwd_max_wgs, two stages each; one stage where two do not fit
// one warpgroup (the wider nets with weight gradients).
static int2 bwd_plan(const Layout& L, bool dw) {
  return plan_blocks([&](int wgs, int ns) { return BwdSmem(L, dw, ns).total(wgs); }, L.hw,
                     bwd_max_wgs(L.nl, dw, L.hw), 2);
}

template <int NL, bool DW, bool DX, int HWP, bool PE>
static int launch(const float* x, const float* g, float* dx, const void* img, const float* bias,
                  float* wpart, float* bpart, long long n_rows, const Layout& L, int blocks,
                  int2 plan, int num_freqs, cudaStream_t s) {
  auto k = mlp_bwd_kernel<NL, DW, DX, HWP, PE>;
  const int smem = BwdSmem(L, DW, plan.y).total(plan.x);
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int in_al = (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  const int dx_al = (reinterpret_cast<uintptr_t>(dx) & 15) == 0;
  k<<<(unsigned)blocks, 128 * plan.x, smem, s>>>(x, g, dx, reinterpret_cast<const bf16*>(img),
                                                  bias, wpart, bpart, n_rows, L.din, L.dout,
                                                  plan.y, in_al, dx_al, num_freqs);
  return (int)cudaGetLastError();
}

template <int NL, int HWP, bool PE = false>
static int run(const float* x, const float* g, float* dx, const void* img, const float* bias,
               float* wpart, float* bpart, float* dw, float* db, long long n_rows,
               const Layout& L, int blocks, cudaStream_t s, int num_freqs = 0) {
  const bool need_dw = wpart != nullptr, need_dx = dx != nullptr;
  const int2 plan = bwd_plan(L, need_dw);
  if (!need_dw)
    return launch<NL, false, true, HWP, PE>(x, g, dx, img, bias, wpart, bpart, n_rows, L,
                                            blocks, plan, num_freqs, s);
  if constexpr (PE) {
    return (int)cudaErrorInvalidValue;   // fused_pe_mlp_wide_bwd.cu
  } else {
    const int err =
        need_dx ? launch<NL, true, true, HWP, PE>(x, g, dx, img, bias, wpart, bpart, n_rows, L,
                                                  blocks, plan, num_freqs, s)
                : launch<NL, true, false, HWP, PE>(x, g, dx, img, bias, wpart, bpart, n_rows, L,
                                                   blocks, plan, num_freqs, s);
    if (err) return err;
    const int e2 =
        column_sum(wpart, (long long)blocks * wpart_rows(L, plan.x), L.fwd_elems(), dw, s);
    if (e2) return e2;
    return column_sum(bpart, blocks, L.n_bias(), db, s);
  }
}

}  // namespace mlp
}  // namespace cropnerf

// Sizes of the backward for a net x [N, din] -> n_layers layers -> dout,
// hidden layers padded to hw, with or without weight gradients: out[0] the
// elements of the weight images (bf16; both halves of mlp_images), out[1]
// the padded biases, out[2] and out[3] a partial row of weight and bias
// gradients (layer l's padded weight [K, width] at its forward image's
// offset, its bias at l·hw), out[4] the dynamic shared memory, out[5] the
// warpgroups a block, out[6] the weight partial rows a block writes (the
// caller zeroes them for hw > 64), out[7] the x and g stages a warpgroup.
// With pe, the PE variant for a net whose layer 0 takes the din-column
// encoding of x [N, 3], without weight gradients (with them:
// fused_pe_mlp_wide_bwd.cu).  Returns 0, or -1 for a net the kernel does
// not take.
extern "C" int cropnerf_mlp_bwd_layout(int din, int dout, int n_layers, int hw, int need_dw,
                                       int pe, long long* out) {
  using namespace cropnerf::mlp;
  const Layout L(din, dout, n_layers, hw, pe != 0);
  if (!L.ok() || (pe && need_dw)) return -1;
  const int2 plan = bwd_plan(L, need_dw != 0);
  if (plan.x < 1) return -1;
  out[0] = 2 * L.fwd_elems();
  out[1] = L.n_bias();
  out[2] = L.fwd_elems();
  out[3] = L.n_bias();
  out[4] = BwdSmem(L, need_dw != 0, plan.y).total(plan.x);
  out[5] = plan.x;
  out[6] = wpart_rows(L, plan.x);
  out[7] = plan.y;
  return 0;
}

// The backward on `stream`: x [n_rows, din], g [n_rows, dout]; img and bias
// as mlp_images builds them for hidden width hw.  A null dx skips dx; null
// wpart, bpart, dw and db skip the weight gradients, otherwise wpart holds
// `blocks` x out[6] rows and bpart `blocks` rows of the partial sizes, and
// dw, db receive the padded f32 gradients.  num_freqs >= 0 runs the PE
// variant (dx alone): x and dx [n_rows, 3], their encoding of din = 3(1 +
// 2 num_freqs) columns layer 0's input.  Returns a cudaError_t (0 on
// success).
extern "C" int cropnerf_mlp_bwd(const float* x, const float* g, float* dx, const void* img,
                                const float* bias, int din, int dout, int n_layers, int hw,
                                int num_freqs, long long n_rows, int blocks, float* wpart,
                                float* bpart, float* dw, float* db, void* stream) {
  using namespace cropnerf::mlp;
  const bool pe = num_freqs >= 0;
  const Layout L(din, dout, n_layers, hw, pe);
  const bool need_dw = wpart != nullptr;
  if (!L.ok() || (need_dw && (bpart == nullptr || dw == nullptr || db == nullptr)) ||
      (!need_dw && dx == nullptr) || blocks < 1 || n_rows < 0 ||
      (pe && (din != DIM * (1 + 2 * num_freqs) || need_dw)))
    return (int)cudaErrorInvalidValue;
  if (bwd_plan(L, need_dw).x < 1) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (pe) {
    if (n_layers == 3)
      return run<3, 128, true>(x, g, dx, img, bias, wpart, bpart, dw, db, n_rows, L, blocks, s,
                               num_freqs);
    if (hw == 128)
      return run<2, 128, true>(x, g, dx, img, bias, wpart, bpart, dw, db, n_rows, L, blocks, s,
                               num_freqs);
    return run<2, 256, true>(x, g, dx, img, bias, wpart, bpart, dw, db, n_rows, L, blocks, s,
                             num_freqs);
  }
  if (n_layers == 3)
    return hw == 64 ? run<3, 64>(x, g, dx, img, bias, wpart, bpart, dw, db, n_rows, L, blocks, s)
                    : run<3, 128>(x, g, dx, img, bias, wpart, bpart, dw, db, n_rows, L, blocks,
                                  s);
  if (hw == 64) return run<2, 64>(x, g, dx, img, bias, wpart, bpart, dw, db, n_rows, L, blocks, s);
  if (hw == 128)
    return run<2, 128>(x, g, dx, img, bias, wpart, bpart, dw, db, n_rows, L, blocks, s);
  return run<2, 256>(x, g, dx, img, bias, wpart, bpart, dw, db, n_rows, L, blocks, s);
}
