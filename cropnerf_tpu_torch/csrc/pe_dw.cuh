// The weight-gradient pass shared by the recompute backwards that keep a
// workspace (the PE field's, fused_pe_field_bwd.cu, and the stream route's,
// fused_mlp_stream.cu): their tile kernels write each layer's bf16
// activation A_l and cotangent G_l as 64-row chunk-major blocks
// (ops/cuda/pe_plan.py lays the workspace out) and each warpgroup's bias
// column sums as one row of partials; this pass forms dW_l = A_lᵀ·G_l as a
// split-K wgmma GEMM over the workspace (pe_field_bwd_dw_kernel), then sums
// the splits and the bias rows in a fixed order (run_dw_sums).  No
// floating-point atomics, so two runs give the same bits.
#pragma once

#include <type_traits>

#include "column_sum.cuh"
#include "pe_tile.cuh"

namespace cropnerf {
namespace pebwd {

using namespace pe;

// a weight-gradient task (mirrors ops/cuda/pe_plan.py): G's columns
// [T_J0, T_J0 + T_BN) of its slot (T_G_COL, T_G_W), so that a G wider than
// MAX_N (a wide program's) is taken in MAX_N-column blocks
enum {
  T_A_COL, T_A_W, T_I0, T_M_VALID, T_W_ROW0, T_G_COL, T_BN, T_N, T_W_OFF, T_G_W, T_J0,
  TASK_INTS
};

// ROWS (pe_tile.cuh) is also the workspace block's row count
constexpr int DW_THREADS = CONSUMERS + 32;    // the dW pass: a producer warp
constexpr int DW_A_BYTES = 128 * ROWS * 2;      // A: 128 weight rows of a block
constexpr int DW_STAGE = DW_A_BYTES + MAX_N * ROWS * 2;
constexpr int DW_STAGES = 4;
constexpr int SPLIT_TARGET = 264;      // pe_plan.py SPLIT_TARGET

// Column sums of a warpgroup's 64 rows: s[2j + p] holds this lane's two
// rows of column 8j + cq + p.  A fixed reduce-scatter over the 8 lanes that
// share columns leaves each column's 16-row sum in one lane, written to the
// warp's row of `out`.
template <int NV>
__device__ __forceinline__ void warp_colsum(float (&s)[NV], float* out, int lane) {
  int base = 0, dup = 0;
  constexpr int C1 = NV >= 2 ? NV / 2 : 1;
  constexpr int C2 = C1 >= 2 ? C1 / 2 : 1;
  constexpr int C3 = C2 >= 2 ? C2 / 2 : 1;
  auto step = [&](auto CNT, int m) {
    constexpr int C = decltype(CNT)::value;
    const bool hi = (lane & m) != 0;
    if constexpr (C >= 2) {
#pragma unroll
      for (int i = 0; i < C / 2; ++i) {
        const float send = hi ? s[i] : s[i + C / 2];
        const float keep = hi ? s[i + C / 2] : s[i];
        s[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
      }
      if (hi) base += C / 2;
    } else {
      s[0] += __shfl_xor_sync(0xffffffffu, s[0], m);
      dup |= m;
    }
  };
  step(std::integral_constant<int, NV>{}, 4);
  step(std::integral_constant<int, C1>{}, 8);
  step(std::integral_constant<int, C2>{}, 16);
  if (lane & dup) return;
#pragma unroll
  for (int i = 0; i < C3; ++i) {
    const int idx = base + i;
    out[8 * (idx >> 1) + 2 * (lane & 3) + (idx & 1)] = s[i];
  }
}

// ---- the weight-gradient pass -------------------------------------------------

struct DwArgs {
  const bf16* ws;
  const int* tasks;
  float* wpart;
  long long n_pad, n_blocks, total_w;
  int per_split;       // 64-row blocks per split
};

// One task over one split: wpart[split, w_off + (w_row0 + i) n + j0 + j] =
// sum over the split's rows r of A[r, i0 + i] G[r, j0 + j], i < m_valid,
// j < BN, j0 + j < n.  Warpgroup w takes i in [64w, 64w + 64).
template <int BN>
__device__ void dw_task(const DwArgs& a, const int* t, unsigned char* ring, uint64_t* full,
                        uint64_t* empty, long long b0, long long b1) {
  const Lane ln;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  fence_regs(acc);
  const uint32_t r = smem_u32(ring);
  const int nb = (int)(b1 - b0);
  for (int s = 0; s < nb; ++s) {
    const int stage = s % DW_STAGES;
    mbar_wait(&full[stage], (s / DW_STAGES) & 1);
    wgmma_fence();
    const uint32_t sa = r + stage * DW_STAGE + ln.wg * (DW_A_BYTES / 2);
    const uint32_t sg = r + stage * DW_STAGE + DW_A_BYTES;
#pragma unroll
    for (int kk = 0; kk < ROWS; kk += 16) {
      const uint64_t da = gmma_desc(sa + (kk >> 3) * 128, 128, 1024);
      const uint64_t db = gmma_desc(sg + (kk >> 3) * 128, 128, 1024);
      Wgmma<BN, 1, 1>::mma(acc, da, db, 1);
    }
    wgmma_commit();
    if (s > 0) {
      wgmma_wait<1>();
      if (ln.lane == 0) mbar_arrive(&empty[(s - 1) % DW_STAGES]);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  const int n = t[T_N], m_valid = t[T_M_VALID], j0 = t[T_J0];
  float* out = a.wpart + (long long)blockIdx.y * a.total_w + t[T_W_OFF] + j0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + ln.cq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = ln.wg * ROWS + ln.r0 + 8 * h;
      if (i < m_valid && j0 + c < n) {
        float* p = out + (long long)(t[T_W_ROW0] + i) * n + c;
        *reinterpret_cast<float2*>(p) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(DW_THREADS, 1)
pe_field_bwd_dw_kernel(const __grid_constant__ DwArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + DW_STAGES * DW_STAGE);
  uint64_t* empty = full + DW_STAGES;
  int t[TASK_INTS];
#pragma unroll
  for (int i = 0; i < TASK_INTS; ++i) t[i] = __ldg(a.tasks + blockIdx.x * TASK_INTS + i);
  const long long b0 = (long long)blockIdx.y * a.per_split;
  const long long b1 = lmin(b0 + a.per_split, a.n_blocks);
  if (threadIdx.x == 0) {
    for (int i = 0; i < DW_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int BN = t[T_BN];
  if (threadIdx.x >= CONSUMERS) {      // the producer: A and G of each block
    if (threadIdx.x != CONSUMERS) return;
    const uint32_t g_bytes = (uint32_t)(BN * ROWS * 2);
    for (long long b = b0; b < b1; ++b) {
      const int s = (int)(b - b0), stage = s % DW_STAGES;
      mbar_wait(&empty[stage], ((s / DW_STAGES) & 1) ^ 1);
      mbar_expect_tx(&full[stage], DW_A_BYTES + g_bytes);
      unsigned char* dst = smem + stage * DW_STAGE;
      const bf16* pa = a.ws + (long long)t[T_A_COL] * a.n_pad + b * ROWS * t[T_A_W] +
                       (t[T_I0] >> 3) * CHUNK;
      const bf16* pg = a.ws + (long long)t[T_G_COL] * a.n_pad + b * ROWS * t[T_G_W] +
                       (t[T_J0] >> 3) * CHUNK;
      bulk_load(dst, pa, DW_A_BYTES, &full[stage]);
      bulk_load(dst + DW_A_BYTES, pg, g_bytes, &full[stage]);
    }
    return;
  }
  switch (BN) {
    case 16: dw_task<16>(a, t, smem, full, empty, b0, b1); break;
    case 32: dw_task<32>(a, t, smem, full, empty, b0, b1); break;
    case 64: dw_task<64>(a, t, smem, full, empty, b0, b1); break;
    case 128: dw_task<128>(a, t, smem, full, empty, b0, b1); break;
    case 256: dw_task<256>(a, t, smem, full, empty, b0, b1); break;
  }
}

// partial[k, c] = sum of src[r, c] over rows r of chunk k, in order: the
// first of two fixed-order passes over a tall [rows, cols] matrix (the
// bias partials, two rows a tile), the second being column_sum over the
// chunks.
constexpr int SUM_CHUNK = 64;

__global__ void chunk_sum_kernel(const float* __restrict__ src, long long rows, long long cols,
                                 float* __restrict__ partial) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const long long r0 = (long long)blockIdx.y * SUM_CHUNK;
  const long long r1 = lmin(r0 + SUM_CHUNK, rows);
  float s = 0.0f;
  for (long long r = r0; r < r1; ++r) s += src[r * cols + c];
  partial[blockIdx.y * cols + c] = s;
}

// The split plan of the weight-gradient pass (pe_plan.py dw_splits): the
// rows padded to whole tiles, their 64-row blocks, and about SPLIT_TARGET
// blocks of the pass in all, each split a whole number of blocks.
struct DwSplit {
  long long n_tiles, n_pad, n_blocks, splits, per_split;
};

__host__ inline DwSplit dw_split(long long n_rows, int n_tasks) {
  DwSplit p;
  p.n_tiles = (n_rows + TILE_ROWS - 1) / TILE_ROWS;
  p.n_pad = p.n_tiles * TILE_ROWS;
  p.n_blocks = p.n_pad / ROWS;
  const long long tasks = lmax(n_tasks, 1);
  const long long want = lmax(1, (SPLIT_TARGET + tasks - 1) / tasks);
  p.per_split = lmax(1, (p.n_blocks + want - 1) / want);
  p.splits = (p.n_blocks + p.per_split - 1) / p.per_split;
  return p;
}

// Whether every task's G columns are a wgmma width inside its slot.
inline bool tasks_ok(const int* tasks, int n_tasks) {
  for (int i = 0; i < n_tasks; ++i) {
    const int* t = tasks + i * TASK_INTS;
    if (!product_width(t[T_BN], MAX_N) || !product_width(t[T_G_W], MAX_W) || t[T_J0] < 0 ||
        t[T_J0] % 16 || t[T_J0] + t[T_BN] > t[T_G_W])
      return false;
  }
  return true;
}

// f32 elements of the bias partials: two rows a tile, then their chunk sums.
__host__ inline long long bias_partial_elems(const DwSplit& p, long long total_b) {
  return (p.n_tiles * 2 + (p.n_tiles * 2 + SUM_CHUNK - 1) / SUM_CHUNK) * total_b;
}

// After a tile kernel that stored the workspace `ws` and the bias partials
// `bpart`: the weight-gradient GEMM of the `n_tasks` tasks (on the device)
// into the split rows `wpart`, then dw and db, on stream s.
inline int run_dw_sums(const bf16* ws, const int* tasks_dev, int n_tasks, const DwSplit& p,
                       long long total_w, long long total_b, float* wpart, float* bpart,
                       float* dw, float* db, cudaStream_t s) {
  DwArgs da;
  da.ws = ws;
  da.tasks = tasks_dev;
  da.wpart = wpart;
  da.n_pad = p.n_pad;
  da.n_blocks = p.n_blocks;
  da.total_w = total_w;
  da.per_split = (int)p.per_split;
  const int dw_smem = DW_STAGES * DW_STAGE + 2 * DW_STAGES * 8;
  cudaError_t e = cudaFuncSetAttribute(pe_field_bwd_dw_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, dw_smem);
  if (e != cudaSuccess) return (int)e;
  pe_field_bwd_dw_kernel<<<dim3((unsigned)n_tasks, (unsigned)p.splits), DW_THREADS, dw_smem,
                           s>>>(da);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const int err = cropnerf::column_sum(wpart, p.splits, total_w, dw, s);
  if (err) return err;
  const long long rows = p.n_tiles * 2, chunks = (rows + SUM_CHUNK - 1) / SUM_CHUNK;
  float* partial = bpart + rows * total_b;
  chunk_sum_kernel<<<dim3((unsigned)((total_b + 255) / 256), (unsigned)chunks), 256, 0, s>>>(
      bpart, rows, total_b, partial);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return cropnerf::column_sum(partial, chunks, total_b, db, s);
}

}  // namespace pebwd
}  // namespace cropnerf
