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
// 32-byte sector each.  The design keeps every intermediate in registers
// (no [N, 8, F] corner tensor in device memory, as the TPU kernel keeps it
// out of HBM) and puts the level on the grid's y axis, like the Pallas grid
// (L, N/TILE): blocks of one level run together, so its rows stay hot in
// the 50 MB L2.
//
// Rounding matches the plain PyTorch version (ops/hashgrid.py
// hashgrid_encode_plain) operation for operation: scaled = pos * res with
// __fmul_rn, so nvcc cannot contract pos*res - floor(pos*res) into an fma
// and move frac or the cell near a cell edge; weights (tx*ty)*tz; corners
// summed in order 0..7 with separate roundings.  The forward equals the
// plain version bit for bit.
//
// Backward, one thread per position, looping over the levels: the table
// gradient by atomicAdd of w*g into f32 zeros (sorting to avoid the atomics
// is later work), and, when the positions need it, the position gradient
// sum over levels and corners of dw * <feat, g> with dw = d(w)/d(pos),
// the x res factor included, accumulated in registers with no atomics.
#include <cuda_runtime.h>

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

__global__ void __launch_bounds__(THREADS)
hash_encode_fwd_kernel(const float* __restrict__ pos,
                       const float2* __restrict__ table,
                       const long long* __restrict__ levels, int n_levels,
                       unsigned mask, float2* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int l = blockIdx.y;
  const Level lv = load_level(levels, l);
  const float p[3] = {pos[3 * i], pos[3 * i + 1], pos[3 * i + 2]};
  const Cell c = cell_of(p, lv);
  float ax = 0.0f, ay = 0.0f;
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    float t[3];
    corner_terms(c, corner, t);
    const float w = __fmul_rn(__fmul_rn(t[0], t[1]), t[2]);
    const float2 v = __ldg(table + corner_row(c, corner, lv, mask));
    ax = __fadd_rn(ax, __fmul_rn(v.x, w));
    ay = __fadd_rn(ay, __fmul_rn(v.y, w));
  }
  out[i * n_levels + l] = make_float2(ax, ay);
}

template <bool DPOS>
__global__ void __launch_bounds__(THREADS)
hash_encode_bwd_kernel(const float* __restrict__ pos,
                       const float2* __restrict__ table,
                       const float2* __restrict__ grad,
                       const long long* __restrict__ levels, int n_levels,
                       unsigned mask, float* __restrict__ dtable,
                       float* __restrict__ dpos, long long n) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const float p[3] = {pos[3 * i], pos[3 * i + 1], pos[3 * i + 2]};
  float dp[3] = {0.0f, 0.0f, 0.0f};
  for (int l = 0; l < n_levels; ++l) {
    const Level lv = load_level(levels, l);
    const Cell c = cell_of(p, lv);
    const float2 g = grad[i * n_levels + l];
    float dl[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int corner = 0; corner < 8; ++corner) {
      float t[3];
      corner_terms(c, corner, t);
      const float w = t[0] * t[1] * t[2];
      const long long row = corner_row(c, corner, lv, mask);
      atomicAdd(dtable + 2 * row, w * g.x);
      atomicAdd(dtable + 2 * row + 1, w * g.y);
      if (DPOS) {
        const float2 v = __ldg(table + row);
        const float dot = v.x * g.x + v.y * g.y;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float s = ((corner >> d) & 1) ? 1.0f : -1.0f;
          const float dw = s * t[(d + 1) % 3] * t[(d + 2) % 3];
          dl[d] += dw * dot;
        }
      }
    }
    if (DPOS) {
#pragma unroll
      for (int d = 0; d < 3; ++d) dp[d] += dl[d] * (float)lv.res;
    }
  }
  if (DPOS) {
#pragma unroll
    for (int d = 0; d < 3; ++d) dpos[3 * i + d] = dp[d];
  }
}

static bool valid(int n_levels, long long n) {
  return n_levels >= 1 && n_levels <= 65535 && n >= 0;
}

}  // namespace cropnerf

// Forward on `stream`: out [n, n_levels] float2.  Returns a cudaError_t
// (0 on success).
extern "C" int cropnerf_hash_encode_fwd(const float* pos, const void* table,
                                        const long long* levels, int n_levels,
                                        unsigned mask, void* out, long long n,
                                        void* stream) {
  using namespace cropnerf;
  if (!valid(n_levels, n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const dim3 grid((unsigned)((n + THREADS - 1) / THREADS), (unsigned)n_levels);
  hash_encode_fwd_kernel<<<grid, THREADS, 0,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      pos, reinterpret_cast<const float2*>(table), levels, n_levels, mask,
      reinterpret_cast<float2*>(out), n);
  return (int)cudaGetLastError();
}

// Backward on `stream`: adds into dtable (zeros of the table's shape) and,
// when dpos is not null, writes dpos [n, 3].  grad is [n, n_levels] float2.
extern "C" int cropnerf_hash_encode_bwd(const float* pos, const void* table,
                                        const void* grad,
                                        const long long* levels, int n_levels,
                                        unsigned mask, float* dtable,
                                        float* dpos, long long n,
                                        void* stream) {
  using namespace cropnerf;
  if (!valid(n_levels, n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const dim3 grid((unsigned)((n + THREADS - 1) / THREADS));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float2* t = reinterpret_cast<const float2*>(table);
  const float2* g = reinterpret_cast<const float2*>(grad);
  if (dpos != nullptr)
    hash_encode_bwd_kernel<true><<<grid, THREADS, 0, s>>>(
        pos, t, g, levels, n_levels, mask, dtable, dpos, n);
  else
    hash_encode_bwd_kernel<false><<<grid, THREADS, 0, s>>>(
        pos, t, g, levels, n_levels, mask, dtable, dpos, n);
  return (int)cudaGetLastError();
}
