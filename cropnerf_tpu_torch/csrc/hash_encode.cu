// Multiresolution hash-grid encoding, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel cropnerf_tpu/ops/pallas/hash_encode.py
// (hashgrid_encode_pallas, _kernel) and the XLA backward of the encode's
// custom VJP (cropnerf_tpu/ops/hashgrid.py, _encode_opt_bwd).  The Pallas
// kernel takes the dense [L, T, F] table; the presets train the packed
// [sum(rows_l), F] table.  Both are rows of F = 2 floats at a per-level row
// offset, so one source serves both: the wrapper passes each level's
// resolution, first row and dense flag in a small device array.
//
// positions [N, 3] f32 in [0, 1] -> features [N, L, 2] f32.  Per level the
// 8 corners of the position's cell are indexed densely (the clipped corner
// lattice, where (res+1)^3 <= T) or by the uint32 Teschner hash & (T-1),
// gathered as float2 and blended with trilinear weights.
//
// Bound on an H100: memory.  A call moves its positions, its output and
// at most the whole table once (the cropnerf field: 6.1 M rows, 49 MB), and
// does ~30 flops a corner; in practice the random 8-byte gathers cost a
// 32-byte sector each, about five distinct sectors a (position, level).
// The design keeps every intermediate in registers (no [N, 8, F] corner
// tensor in device memory, as the TPU kernel keeps it out of HBM).  A
// thread encodes one position at a group of G neighbouring levels
// (ops/cuda/hash_encode.py level_group: the whole row up to 8 levels, else
// 4), reading the position once, with two levels' gathers in flight; the
// group sits on the grid's y axis, so the blocks of one group run together
// and its levels' rows stay hot in the 50 MB L2 (the field's table is
// 49 MB).  The block stages its [256, G] results in shared memory and
// stores them with neighbouring threads on neighbouring output addresses:
// each 32-byte sector of the [N, L, 2] output is written whole by one
// warp, where one thread per (position, level) wrote 8 bytes of 32
// sectors in each store.  A dense level's z-neighbour corners share a
// 16-byte load where they can (gather).  Positions that bunch along rays
// (a training step's) gain most from the whole-row stores; uniform ones,
// whose gathers miss more, from the paired loads.
//
// Rounding matches the plain PyTorch version (ops/hashgrid.py
// hashgrid_encode_plain) operation for operation: scaled = pos * res with
// __fmul_rn, so nvcc cannot contract pos*res - floor(pos*res) into an fma
// and move frac or the cell near a cell edge; weights (tx*ty)*tz; corners
// summed in order 0..7 with separate roundings.  The forward equals the
// plain version bit for bit.
//
// Backward: the table gradient (sum over positions and corners of w g into
// each row) and the position gradient (sum over levels and corners of
// d(w)/d(pos) <feat, g>, the x res factor included), each computed only
// when asked: the training step asks for both (or the table alone for
// frozen positions), the BayesRays pass for the position gradient alone.
// Bound on an H100: the L2's atomic throughput (a training step's three
// encodes add ~83 M corner contributions into ~7 M rows), then the random
// gathers of the position gradient.  The work is laid out by level, each
// level one pass over the positions:
//   - a privatised level (dense, its (res+1)^3 x 8 B lattice fits a
//     block's shared memory; ops/cuda/hash_encode.py private_levels picks
//     them) is summed by each block into a shared copy with shared-memory
//     atomics, then every row the block touched is added into the table
//     with one float2 reduction: a coarse level takes as many
//     contributions as any other onto a few thousand rows;
//   - the other levels run with the level on grid y and one float2
//     reduction (red.global.add.v2.f32) a corner;
//   - in both, a warp first sums the runs of neighbouring lanes that hit
//     the same row (a ray's samples share coarse cells), so a run costs
//     one atomic;
//   - the same pass gathers the corners' rows for the position gradient,
//     under the atomics, and writes the level's share; a last kernel sums
//     the levels in order, with no atomics, so dpos has the same bits on
//     every run and in every variant.
// The table gradient is not reproducible bit for bit (nor is XLA's
// scatter-add); it agrees with the plain version to float32 rounding.
#include <cuda_runtime.h>
#include <stdint.h>

namespace cropnerf {

constexpr int THREADS = 256;
constexpr unsigned PRIME_Y = 2654435761u;
constexpr unsigned PRIME_Z = 805459861u;

// One level: its first table row, resolution and dense flag, as the
// wrapper's int64 [L, 3] array holds them.
struct Level {
  long long offset;
  int res;
  bool dense;
};

__device__ __forceinline__ Level load_level(const long long* levels, int l) {
  Level lv;
  lv.offset = __ldg(levels + 3 * l);
  lv.res = (int)__ldg(levels + 3 * l + 1);
  lv.dense = __ldg(levels + 3 * l + 2) != 0;
  return lv;
}

// The cell of a position at one level: base corner and fractional offsets.
// A dense level clips the base to [0, res-1] and keeps frac from the
// unclipped floor, so at pos = 1 frac is 0 and it returns corner res-1
// with weight 1.
struct Cell {
  int b[3];
  float f[3];
};

__device__ __forceinline__ Cell cell_of(const float p[3], const Level& lv) {
  Cell c;
  const float r = (float)lv.res;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float s = __fmul_rn(p[d], r);
    const float fl = floorf(s);
    c.f[d] = __fsub_rn(s, fl);
    int b = (int)fl;
    if (lv.dense) b = min(max(b, 0), lv.res - 1);
    c.b[d] = b;
  }
  return c;
}

// Row of one corner within its level: < (res+1)^3 when dense (the clip),
// < T when hashed (the mask), for any finite position in [0, 1].
__device__ __forceinline__ long long corner_row(const Cell& c, int corner,
                                                const Level& lv,
                                                unsigned mask) {
  const unsigned x = (unsigned)(c.b[0] + (corner & 1));
  const unsigned y = (unsigned)(c.b[1] + ((corner >> 1) & 1));
  const unsigned z = (unsigned)(c.b[2] + ((corner >> 2) & 1));
  unsigned idx;
  if (lv.dense) {
    const unsigned side = (unsigned)lv.res + 1u;
    idx = (x * side + y) * side + z;
  } else {
    idx = (x ^ (y * PRIME_Y) ^ (z * PRIME_Z)) & mask;
  }
  return lv.offset + (long long)idx;
}

// Per-dimension trilinear terms of one corner: frac where its bit is set,
// 1 - frac otherwise.
__device__ __forceinline__ void corner_terms(const Cell& c, int corner,
                                             float t[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d)
    t[d] = ((corner >> d) & 1) ? c.f[d] : __fsub_rn(1.0f, c.f[d]);
}

// One (position, level): its cell and its 8 corners' rows, gathered.  In a
// dense level the corners that differ only in z (c and c + 4) are
// neighbouring rows: one 16-byte load takes both when the first starts a
// 16-byte boundary, else it takes the first and an 8-byte load the second
// (no branch, so all of a lookup's loads go out together).  A hashed
// level's corners are 8 separate 8-byte loads (pairing them there, where
// only some x-pairs are neighbours, measured slower).
struct Lookup {
  Cell c;
  float2 v[8];
};

__device__ __forceinline__ float2 lo2(const float4& w) { return make_float2(w.x, w.y); }
__device__ __forceinline__ float2 hi2(const float4& w) { return make_float2(w.z, w.w); }

__device__ __forceinline__ Lookup gather(const float p[3], const float2* __restrict__ table,
                                         const Level& lv, unsigned mask) {
  Lookup k;
  k.c = cell_of(p, lv);
  if (lv.dense) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2* ra = table + corner_row(k.c, q, lv, mask);  // corner q + 4 at ra + 1
      const uintptr_t a = reinterpret_cast<uintptr_t>(ra);
      const bool at16 = (a & 15) == 0;
      // the 16 bytes holding row ra: rows ra, ra + 1, or ra - 1, ra (inside
      // the table's allocation, which starts 256-byte aligned, even for a
      // table that starts 8 bytes past a 16-byte boundary)
      const float4 w = __ldg(reinterpret_cast<const float4*>(a & ~(uintptr_t)15));
      k.v[q] = at16 ? lo2(w) : hi2(w);
      float2 up = hi2(w);
      if (!at16) up = __ldg(ra + 1);
      k.v[q + 4] = up;
    }
  } else {
#pragma unroll
    for (int corner = 0; corner < 8; ++corner)
      k.v[corner] = __ldg(table + corner_row(k.c, corner, lv, mask));
  }
  return k;
}

// The corners blended in order 0..7 with weights (tx·ty)·tz.
__device__ __forceinline__ float2 blend(const Lookup& k) {
  float ax = 0.0f, ay = 0.0f;
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    float t[3];
    corner_terms(k.c, corner, t);
    const float w = __fmul_rn(__fmul_rn(t[0], t[1]), t[2]);
    ax = __fadd_rn(ax, __fmul_rn(k.v[corner].x, w));
    ay = __fadd_rn(ay, __fmul_rn(k.v[corner].y, w));
  }
  return make_float2(ax, ay);
}

constexpr int MAX_GROUP = 16;

// Shared memory of a block of the forward: its [THREADS, G] results at a
// row stride of G | 1 float2, odd, so a warp's stores and loads spread
// over the banks.
__host__ __device__ inline int fwd_stage_stride(int group) { return group | 1; }

// Position i = blockIdx.x·THREADS + threadIdx.x at levels l0 .. l0+nl-1 of
// the group blockIdx.y.
__global__ void __launch_bounds__(THREADS)
hash_encode_fwd_kernel(const float* __restrict__ pos,
                       const float2* __restrict__ table,
                       const long long* __restrict__ levels, int n_levels,
                       int group, unsigned mask, float2* __restrict__ out,
                       long long n) {
  extern __shared__ float2 stage[];
  const long long i0 = (long long)blockIdx.x * THREADS;
  const long long i = i0 + threadIdx.x;
  const int l0 = blockIdx.y * group;
  const int nl = min(group, n_levels - l0);
  const int sp = fwd_stage_stride(group);
  if (i < n) {
    const float p[3] = {pos[3 * i], pos[3 * i + 1], pos[3 * i + 2]};
    float2* mine = stage + threadIdx.x * sp;
    int j = 0;
    for (; j + 1 < nl; j += 2) {       // two levels' gathers in flight
      const Lookup a = gather(p, table, load_level(levels, l0 + j), mask);
      const Lookup b = gather(p, table, load_level(levels, l0 + j + 1), mask);
      mine[j] = blend(a);
      mine[j + 1] = blend(b);
    }
    if (j < nl) mine[j] = blend(gather(p, table, load_level(levels, l0 + j), mask));
  }
  __syncthreads();
  const int rows = (int)min((long long)THREADS, n - i0);
  for (int q = threadIdx.x; q < rows * nl; q += THREADS) {
    const int r = q / nl, j = q - r * nl;
    out[(i0 + r) * n_levels + l0 + j] = stage[r * sp + j];
  }
}

// ---- backward -------------------------------------------------------------

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NO_ROW = 0xffffffffu;   // a lane past N
constexpr int PRIV_THREADS = 1024;

// The table gradient's contribution of one corner, (w g.x, w g.y), added
// by add(row, sum) into a row of a level (its shared copy or the table
// itself).  Neighbouring
// samples of a ray often share a coarse cell, so a warp's lanes hold runs of
// the same row: a segmented sum over each run of equal rows (runs are found
// between neighbouring lanes) leaves the run's sum on its first lane, which
// alone adds it.  Every lane of the warp calls it; a lane past N passes
// NO_ROW.
template <class Add>
__device__ __forceinline__ void add_runs(unsigned row, float2 v, const Add& add) {
  const int lane = threadIdx.x & 31;
  const unsigned prev = __shfl_up_sync(FULL, row, 1);
  const bool head = lane == 0 || prev != row;
  const unsigned heads = __ballot_sync(FULL, head);
  if (heads != FULL) {
    const int run = __popc(heads & (FULL >> (31 - lane)));
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float ox = __shfl_down_sync(FULL, v.x, d);
      const float oy = __shfl_down_sync(FULL, v.y, d);
      const int orun = __shfl_down_sync(FULL, run, d);
      if (lane + d < 32 && orun == run) {
        v.x += ox;
        v.y += oy;
      }
    }
  }
  if (head && row != NO_ROW) add(row, v);
}

// One level of the backward for the positions strided over the blocks,
// each warp's lanes on neighbouring positions.  With DTABLE, add(row, (w
// g.x, w g.y)) through add_runs for the 8 corners of every position (every
// lane of the block alike, NO_ROW past N).  With DPOS, the level's share of
// the position gradient, dl = sum over corners of d(w)/d(frac) <feat, g>
// (the 8 rows gathered first), into dlev[l, i, :]; the levels are summed
// afterwards in order (hash_dpos_sum_kernel).
template <int BLOCK, bool DTABLE, bool DPOS, class Add>
__device__ __forceinline__ void level_pass(const float* __restrict__ pos,
                                           const float2* __restrict__ table,
                                           const float2* __restrict__ grad, int n_levels,
                                           int l, const Level& lv, unsigned mask, long long n,
                                           float* __restrict__ dlev, const Add& add) {
  const long long stride = (long long)gridDim.x * BLOCK;
  for (long long i0 = (long long)blockIdx.x * BLOCK + (threadIdx.x & ~31); i0 < n;
       i0 += stride) {
    const long long i = i0 + (threadIdx.x & 31);
    const bool in = i < n;
    const float p[3] = {in ? pos[3 * i] : 0.0f, in ? pos[3 * i + 1] : 0.0f,
                        in ? pos[3 * i + 2] : 0.0f};
    const Cell c = cell_of(p, lv);
    const float2 g = in ? grad[i * n_levels + l] : make_float2(0.0f, 0.0f);
    float2 v[8];
    if (DPOS) {
#pragma unroll
      for (int corner = 0; corner < 8; ++corner)
        v[corner] = in ? __ldg(table + corner_row(c, corner, lv, mask)) : make_float2(0.0f, 0.0f);
    }
    float dl[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int corner = 0; corner < 8; ++corner) {
      float t[3];
      corner_terms(c, corner, t);
      if (DTABLE) {
        const float w = t[0] * t[1] * t[2];
        const unsigned row = in ? (unsigned)(corner_row(c, corner, lv, mask) - lv.offset) : NO_ROW;
        add_runs(row, make_float2(w * g.x, w * g.y), add);
      }
      if (DPOS) {
        const float dot = v[corner].x * g.x + v[corner].y * g.y;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float s = ((corner >> d) & 1) ? 1.0f : -1.0f;
          const float dw = s * t[(d + 1) % 3] * t[(d + 2) % 3];
          dl[d] += dw * dot;
        }
      }
    }
    if (DPOS && in) {
#pragma unroll
      for (int d = 0; d < 3; ++d) dlev[((long long)l * n + i) * 3 + d] = dl[d];
    }
  }
}

// One vector reduction of a row's two floats into device memory.
__device__ __forceinline__ void red2(float* dtable, long long row, float2 v) {
  atomicAdd(reinterpret_cast<float2*>(dtable) + row, v);
}

// A privatised level (dense, its (res+1)^3 lattice fits the block's shared
// memory): the block sums the table gradient into a shared copy of the
// lattice, then adds each row it touched into the table once.
template <bool DPOS>
__global__ void __launch_bounds__(PRIV_THREADS)
hash_private_kernel(const float* __restrict__ pos, const float2* __restrict__ table,
                    const float2* __restrict__ grad, const long long* __restrict__ levels,
                    int n_levels, int l, float* __restrict__ dtable, float* __restrict__ dlev,
                    long long n) {
  extern __shared__ float2 lat[];
  const Level lv = load_level(levels, l);
  const int side = lv.res + 1;
  const int rows = side * side * side;
  for (int r = threadIdx.x; r < rows; r += PRIV_THREADS) lat[r] = make_float2(0.0f, 0.0f);
  __syncthreads();
  level_pass<PRIV_THREADS, true, DPOS>(pos, table, grad, n_levels, l, lv, 0u, n, dlev,
                                       [&](unsigned r, float2 s) {
                                         atomicAdd(&lat[r].x, s.x);
                                         atomicAdd(&lat[r].y, s.y);
                                       });
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += PRIV_THREADS) {
    const float2 v = lat[r];
    if (v.x != 0.0f || v.y != 0.0f) red2(dtable, lv.offset + r, v);
  }
}

// The other levels, the level on grid y (its rows stay hot in L2 while its
// blocks run): one vector reduction a run of a row into the table.
template <bool DTABLE, bool DPOS>
__global__ void __launch_bounds__(THREADS)
hash_level_kernel(const float* __restrict__ pos, const float2* __restrict__ table,
                  const float2* __restrict__ grad, const long long* __restrict__ levels,
                  int n_levels, const int* __restrict__ level_ids, unsigned mask,
                  float* __restrict__ dtable, float* __restrict__ dlev, long long n) {
  const int l = __ldg(level_ids + blockIdx.y);
  const Level lv = load_level(levels, l);
  level_pass<THREADS, DTABLE, DPOS>(pos, table, grad, n_levels, l, lv, mask, n, dlev,
                                    [&](unsigned r, float2 s) { red2(dtable, lv.offset + r, s); });
}

// dpos = sum over the levels, in order, of res x dl: no atomics, the same
// bits on every run and in every variant.
__global__ void __launch_bounds__(THREADS)
hash_dpos_sum_kernel(const float* __restrict__ dlev, const long long* __restrict__ levels,
                     int n_levels, float* __restrict__ dpos, long long n) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float dp[3] = {0.0f, 0.0f, 0.0f};
  for (int l = 0; l < n_levels; ++l) {
    const float res = (float)load_level(levels, l).res;
#pragma unroll
    for (int d = 0; d < 3; ++d) dp[d] += dlev[((long long)l * n + i) * 3 + d] * res;
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) dpos[3 * i + d] = dp[d];
}

static bool valid(int n_levels, long long n) {
  return n_levels >= 1 && n_levels <= 65535 && n >= 0;
}

// Blocks of `kernel` that fill the card at `smem` bytes of dynamic shared
// memory a block, and no more than `needed`.
template <class K>
static int fill_blocks(K kernel, int threads, int smem, long long needed, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  const long long fill = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *blocks = (int)(needed < fill ? needed : fill);
  return 0;
}

template <bool DPOS>
static int launch_private(const float* pos, const float2* t, const float2* g,
                          const long long* levels, int n_levels, int l, int rows, float* dtable,
                          float* dlev, long long n, cudaStream_t s) {
  const int smem = rows * (int)sizeof(float2);
  cudaError_t e = cudaFuncSetAttribute(hash_private_kernel<DPOS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  const int err = fill_blocks(hash_private_kernel<DPOS>, PRIV_THREADS, smem,
                              (n + PRIV_THREADS - 1) / PRIV_THREADS, &blocks);
  if (err) return err;
  hash_private_kernel<DPOS><<<(unsigned)blocks, PRIV_THREADS, smem, s>>>(
      pos, t, g, levels, n_levels, l, dtable, dlev, n);
  return 0;
}

template <bool DTABLE, bool DPOS>
static int launch_levels(const float* pos, const float2* t, const float2* g,
                         const long long* levels, int n_levels, const int* ids, int n_ids,
                         unsigned mask, float* dtable, float* dlev, long long n, cudaStream_t s) {
  int blocks = 0;
  const int err = fill_blocks(hash_level_kernel<DTABLE, DPOS>, THREADS, 0,
                              (n + THREADS - 1) / THREADS, &blocks);
  if (err) return err;
  hash_level_kernel<DTABLE, DPOS><<<dim3((unsigned)blocks, (unsigned)n_ids), THREADS, 0, s>>>(
      pos, t, g, levels, n_levels, ids, mask, dtable, dlev, n);
  return 0;
}

}  // namespace cropnerf

// Forward on `stream`: out [n, n_levels] float2, a thread per position and
// group of `group` levels (1 to 16).  Returns a cudaError_t (0 on success).
extern "C" int cropnerf_hash_encode_fwd(const float* pos, const void* table,
                                        const long long* levels, int n_levels,
                                        int group, unsigned mask, void* out,
                                        long long n, void* stream) {
  using namespace cropnerf;
  if (!valid(n_levels, n) || group < 1 || group > MAX_GROUP) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int groups = (n_levels + group - 1) / group;
  const int smem = THREADS * fwd_stage_stride(group) * (int)sizeof(float2);
  const dim3 grid((unsigned)((n + THREADS - 1) / THREADS), (unsigned)groups);
  hash_encode_fwd_kernel<<<grid, THREADS, smem,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      pos, reinterpret_cast<const float2*>(table), levels, n_levels, group, mask,
      reinterpret_cast<float2*>(out), n);
  return (int)cudaGetLastError();
}

// Backward on `stream`.  When dtable is not null it adds the table gradient
// into it (zeros of the table's shape); when dpos is not null it writes
// dpos [n, 3], with dlev [n_levels, n, 3] as scratch.  level_ids, on the
// card, holds the n_private privatised levels and then the others;
// private_levels and private_rows, on the host, the privatised levels and
// their lattice rows.  With the table gradient, each privatised level is
// one launch and the others one launch with the level on grid y; without
// it, every level runs in that one launch.  grad is [n, n_levels] float2.
extern "C" int cropnerf_hash_encode_bwd(const float* pos, const void* table,
                                        const void* grad,
                                        const long long* levels, int n_levels,
                                        unsigned mask, float* dtable,
                                        float* dpos, float* dlev, long long n,
                                        const int* level_ids, int n_private,
                                        const int* private_levels,
                                        const int* private_rows, void* stream) {
  using namespace cropnerf;
  if (!valid(n_levels, n) || n_private < 0 || n_private > n_levels ||
      (dpos != nullptr && dlev == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || (dtable == nullptr && dpos == nullptr)) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float2* t = reinterpret_cast<const float2*>(table);
  const float2* g = reinterpret_cast<const float2*>(grad);
  const bool with_dpos = dpos != nullptr;
  int err = 0;
  if (dtable != nullptr) {
    for (int k = 0; k < n_private && !err; ++k)
      err = with_dpos ? launch_private<true>(pos, t, g, levels, n_levels, private_levels[k],
                                             private_rows[k], dtable, dlev, n, s)
                      : launch_private<false>(pos, t, g, levels, n_levels, private_levels[k],
                                              private_rows[k], dtable, dlev, n, s);
    if (!err && n_private < n_levels)
      err = with_dpos ? launch_levels<true, true>(pos, t, g, levels, n_levels,
                                                  level_ids + n_private, n_levels - n_private,
                                                  mask, dtable, dlev, n, s)
                      : launch_levels<true, false>(pos, t, g, levels, n_levels,
                                                   level_ids + n_private, n_levels - n_private,
                                                   mask, dtable, dlev, n, s);
  } else {
    err = launch_levels<false, true>(pos, t, g, levels, n_levels, level_ids, n_levels, mask,
                                     dtable, dlev, n, s);
  }
  if (err) return err;
  if (with_dpos)
    hash_dpos_sum_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, s>>>(
        dlev, levels, n_levels, dpos, n);
  return (int)cudaGetLastError();
}
