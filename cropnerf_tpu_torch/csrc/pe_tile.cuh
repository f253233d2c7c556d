// The tile interpreter shared by the PE field's forward (fused_pe_field.cu)
// and its recompute backward (fused_pe_field_bwd.cu), for Hopper (sm_90a).
//
// Both kernels run a program that ops/cuda/pe_plan.py builds: a header,
// then ops of OP_INTS ints.  A block owns tiles of 128 rows: two consumer
// warpgroups of 64 rows each run the program's products as wgmma (64 x N,
// N = 16..256, f32 accumulators in registers) on operands that stay in
// shared memory in the chunk-major layout (wgmma_layers.cuh), and a
// producer warpgroup streams the weight image (each product's B, K-major
// core matrices, in program order) through a ring of 32-row slabs with bulk
// copies that complete on mbarriers.  The producer keeps one thread and
// hands its registers to the consumers (setmaxnreg), so that a 64 x 256
// product's 128 accumulators a thread fit without spills.  A slab is free
// again when all 8 consumer warps have arrived on its `empty` barrier.
//
// A program's width class (width_class) is that of its widest layer.
// Up to MAX_N (class 0) a warpgroup takes a whole product.  Over MAX_N, up
// to PASS_W (class 1, "wide"), a 64 x 512 product's accumulators do not
// fit one warpgroup's registers: each product's columns are split in
// halves (64 x N/2, N/2 = 8..256, the same wgmma shapes and k order in
// every mode):
//  * the forward runs as persistent clusters of CLUSTER (2) blocks on two
//    SMs that walk the 128-row tiles together.  Each block computes one
//    half of every product's columns, so its producer streams only that
//    half of each slab (produce_half_slabs), and its two warpgroups take
//    their own 64 rows out of phase (PingPongWide), each with its own copy
//    of its rows' activation tiles.  A warpgroup writes its half of each
//    output into its own tile, then by one bulk copy into the peer
//    block's (the same warpgroup there, on the same rows), in place, with
//    a pairwise handshake (Mirror);
//  * the backwards keep both warpgroups on one 64-row tile at a time (a
//    128-row tile is two of them, one after the other), each taking half
//    of every product's columns from slabs as wide as the product, the
//    tile overwritten in place once both have read it (a barrier over the
//    256 consumer threads).
// Over PASS_W, up to MAX_W (class 2), the PE field's kernels keep both
// warpgroups on one 64-row tile, each with half of every product's
// columns, as the backwards do in class 1; a product over PASS_W (1024
// wide) takes two passes of both warpgroups, each pass a PASS_W-wide
// stream of slabs (the weight image holds a pass's B after the other,
// pe_plan.py pass_columns), each warpgroup 256 columns a pass.  The first
// pass's output waits as packed bf16 (activation_pack) until the second
// pass has read the tile, which it then overwrites (store_packed): in
// registers in the backward, in a block's scratch in device memory in the
// forward, which holds more registers over its products.  Relu masks too
// wide for shared memory go to device memory.
// The kernels take the class as a template argument, so that a program
// at most MAX_N wide runs none of the wide modes' code, and one at most
// PASS_W wide none of class 2's.
//
// The backwards that stream the whole image for every tile (the stream
// route's, and K1's and K2's wide programs) run as persistent clusters
// whose blocks share each slab (the cluster ring, below); the others keep
// Ring and produce_slabs.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "wgmma_layers.cuh"

namespace cropnerf {

using bf16 = __nv_bfloat16;

namespace pe {

// ---- the program (mirrors ops/cuda/pe_plan.py) -------------------------------
enum {
  H_DIM, H_FREQS, H_ENC_COLS, H_ENC_PAD, H_DE, H_EX_PAD, H_T_COLS, H_RGB_COLS,
  H_SEM_COLS, H_ACT_W, H_TB_W, H_MASK_WORDS, H_WS_COLS, H_ENC_SLOT, H_N_OPS,
  H_N_TASKS, H_TOTAL_W, H_TOTAL_B, H_IMG_ELEMS, H_STORE, H_HEADER
};
enum {
  O_KIND, O_N, O_K, O_A0, O_A1, O_KA, O_IMG, O_EPI, O_BOFF, O_NVALID, O_MASK,
  O_WS, O_COL, OP_INTS
};
enum { FWD, EX, EMIT, BWD };
enum { ACT, ENC, TB };
// epilogues of FWD ops; the *_OUT ones write f32 rows of an output
enum { RELU, LINEAR, T_OUT, RGB_OUT, SEM_OUT };

constexpr int ROWS = 64;               // rows of a warpgroup
constexpr int TILE_ROWS = 2 * ROWS;
constexpr int CONSUMERS = 256;         // two warpgroups
constexpr int ALL_THREADS = CONSUMERS + 128;  // and the producer's warpgroup
constexpr int PRODUCER_REGS = 40;      // setmaxnreg: the producer gives
constexpr int CONSUMER_REGS = 232;     // registers to the accumulators
constexpr int SLAB_K = 32;             // weight rows per slab (the backward's)
constexpr int MAX_STAGES = 8;
constexpr int MAX_N = 256;             // the widest product of a warpgroup
constexpr int PASS_W = 512;            // two warpgroups' halves: the widest layer of
                                       // class 1, a pass of class 2
constexpr int MAX_W = 1024;            // the widest layer: two passes
constexpr int SMEM_LIMIT = 232448;
constexpr int CHUNK = 512;             // elements of an 8-column chunk of 64 rows

__host__ __device__ inline int al128(int b) { return (b + 127) & ~127; }
__host__ __device__ inline long long lmax(long long a, long long b) { return a > b ? a : b; }
__host__ __device__ inline long long lmin(long long a, long long b) { return a < b ? a : b; }

// The slab ring's barriers and stages after `off` bytes of other shared
// memory: slabs of slab_k weight rows up to `width` wide (MAX_N, or PASS_W
// for a wide program), as many stages as fit, up to MAX_STAGES; `bar_sets`
// arrays of MAX_STAGES barriers (full and empty, and a cluster ring's
// peer barriers).
struct RingLayout {
  int bars, ring, stages, total, slab_k, stage;
};

__host__ __device__ inline RingLayout ring_layout(int off, int slab_k, int width = MAX_N,
                                                  int bar_sets = 2) {
  RingLayout r;
  r.bars = off;
  r.ring = al128(off + bar_sets * MAX_STAGES * 8);
  r.stage = slab_k * width * 2;
  r.stages = (int)lmin(MAX_STAGES, (SMEM_LIMIT - r.ring) / r.stage);
  r.total = r.ring + r.stages * r.stage;
  r.slab_k = slab_k;
  return r;
}

// A product width: 16 * 2^i up to `most`.
__host__ __device__ inline bool product_width(int n, int most) {
  return n >= 16 && n <= most && (n & (n - 1)) == 0;
}

// The width class of a program with header h (pe_plan.py width_class).
__host__ __device__ inline int width_class(const int* h) {
  return h[H_ACT_W] > PASS_W ? 2 : h[H_ACT_W] > MAX_N ? 1 : 0;
}

// The passes of a product N wide (class 2): one up to PASS_W, else N / PASS_W.
__host__ __device__ inline int pass_count(int N) { return N > PASS_W ? N / PASS_W : 1; }

// The header and ops both kernels accept: `task_ints` ints per task after
// the ops (0 for the forward, which has none).
inline bool program_ok(const int* prog, int prog_len, int task_ints) {
  if (prog_len < H_HEADER) return false;
  const int* h = prog;
  if (h[H_N_OPS] < 1 || h[H_N_TASKS] < 0 ||
      prog_len != H_HEADER + h[H_N_OPS] * OP_INTS + h[H_N_TASKS] * task_ints)
    return false;
  if (h[H_DIM] < 1 || h[H_FREQS] < 0 || h[H_FREQS] > 30 || h[H_ENC_PAD] % 16 ||
      h[H_ENC_PAD] > MAX_N || h[H_ACT_W] > MAX_W || h[H_ACT_W] % 16 || h[H_TB_W] > h[H_ACT_W] ||
      h[H_EX_PAD] > h[H_ACT_W] || h[H_ENC_PAD] > h[H_ACT_W])
    return false;
  const int wc = width_class(h), most = wc == 2 ? MAX_W : wc == 1 ? PASS_W : MAX_N;
  const int* ops = prog + H_HEADER;
  for (int o = 0; o < h[H_N_OPS]; ++o) {
    const int* op = ops + o * OP_INTS;
    const int N = op[O_N];
    if (!product_width(N, most) && op[O_KIND] != EX) return false;
    if ((op[O_KIND] == FWD || op[O_KIND] == BWD) && (op[O_K] <= 0 || op[O_K] % 16 ||
                                                    op[O_KA] % 16))
      return false;
    // two passes: a hidden layer's product, overwriting the tile it reads
    if (N > PASS_W && !((op[O_KIND] == FWD && op[O_EPI] == RELU) ||
                        (op[O_KIND] == BWD && op[O_EPI] == 0)))   // the backward's G_MASKED
      return false;
  }
  return true;
}

// A 64-row chunk-major tile: element (r, c).
__device__ __forceinline__ int cm(int r, int c) { return (c >> 3) * CHUNK + r * 8 + (c & 7); }

// The calling thread's place in the wgmma accumulator layout.
struct Lane {
  int t, wg, warp, lane, r0, cq;
  __device__ Lane() {
    t = threadIdx.x & 127;
    wg = threadIdx.x >> 7;
    warp = t >> 5;
    lane = t & 31;
    r0 = warp * 16 + (lane >> 2);
    cq = 2 * (lane & 3);
  }
};

// ---- the weight ring -----------------------------------------------------------

struct Ring {
  unsigned char* base;
  uint64_t* full;      // a slab has landed (the producer's transaction count)
  uint64_t* empty;     // every consumer warp is done with it
  int stages, slab_k, stage;   // stage: bytes a stage
};

__device__ __forceinline__ Ring make_ring(unsigned char* smem, const RingLayout& r) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + r.bars);
  return Ring{smem + r.ring, full, full + MAX_STAGES, r.stages, r.slab_k, r.stage};
}

// One thread initialises the barriers; a block barrier must follow.
__device__ __forceinline__ void init_ring(const Ring& rg) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < rg.stages; ++i) {
      mbar_init(&rg.full[i], 1);
      mbar_init(&rg.empty[i], CONSUMERS / 32);
    }
    mbar_fence_init();
  }
}

// The producer: every product op's B, in program order, as slabs of
// rg.slab_k rows.  `slab` counts slabs across calls (a persistent block runs
// the program once per tile without draining the ring).  With PASSES (a
// class 2 program) a product over PASS_W streams its passes' images in
// turn, each PASS_W wide.
template <bool PASSES = false>
__device__ __forceinline__ void produce_slabs(const int* ops, int n_ops, const bf16* img,
                                              const Ring& rg, int& slab) {
  const int S = rg.stages, SK = rg.slab_k;
  for (int o = 0; o < n_ops; ++o) {
    const int* op = ops + o * OP_INTS;
    const int kind = __ldg(op + O_KIND);
    if (kind != FWD && kind != BWD) continue;
    const int N = __ldg(op + O_N), K = __ldg(op + O_K);
    const int P = PASSES ? pass_count(N) : 1, BW = N / P;
    const bf16* src = img + __ldg(op + O_IMG);
    for (int q = 0; q < P; ++q, src += (long long)K * BW)
      for (int k0 = 0; k0 < K; k0 += SK, ++slab) {
        const int stage = slab % S;
        mbar_wait(&rg.empty[stage], ((slab / S) & 1) ^ 1);
        const uint32_t bytes = (uint32_t)(min(SK, K - k0) * BW * 2);
        mbar_expect_tx(&rg.full[stage], bytes);
        bulk_load(rg.base + stage * rg.stage, src + (long long)k0 * BW, bytes, &rg.full[stage]);
      }
  }
}

// The roles of a block's warpgroups: the last one keeps one producer
// thread with few registers, the first two take the rest.  No block-wide
// barrier may follow (the producer's other threads have left).
template <class Producer, class Consumer>
__device__ __forceinline__ void split_roles(Producer&& produce, Consumer&& consume) {
  if (threadIdx.x >= CONSUMERS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) produce();
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();
  consume();
}

// ---- the cluster ring: persistent clusters that share the weight stream ----------
//
// The backwards' tile kernels (the stream route's, and K1's and K2's wide
// programs) run as persistent clusters of CLUSTER blocks on
// neighbouring SMs.  Every block of a cluster runs the same slabs in the
// same order, and its producer copies its 1/CLUSTER share of each slab
// into the same stage of every block's ring at once (a multicast bulk
// copy), so each weight leaves L2 once a cluster rather than once a block.
// A block's `full` barrier expects the whole slab (every block's share
// completes on it).  The consumers release a stage on their block's
// `empty` barrier as with Ring (the same product code); the producer, once
// its block's consumers are done with a stage, relays that to every block
// of the cluster (a remote arrive on its `peer` barrier, CLUSTER
// arrivals a phase) and refills the stage only when its own `peer` barrier
// says every block is done, since its copy writes into all of them.
// Clusters of two: clusters of four ran slower on the H100 (PERF.md).
// The wide forward's column split (below) runs on clusters of the same
// size, its two blocks the halves of every product.
constexpr int CLUSTER = 2;
constexpr int CLUSTER_BAR_SETS = 3;    // full, empty and peer barriers

template <int C>
struct ClusterRing {
  Ring ring;           // what the consumers take (full and empty barriers)
  uint64_t* peer;      // every block of the cluster is done with the stage
};

// A ring laid out by ring_layout(..., CLUSTER_BAR_SETS): the peer barriers
// follow the empty ones.
template <int C>
__device__ __forceinline__ ClusterRing<C> make_cluster_ring(unsigned char* smem,
                                                            const RingLayout& r) {
  const Ring ring = make_ring(smem, r);
  return ClusterRing<C>{ring, ring.empty + MAX_STAGES};
}

// One thread initialises the barriers; a cluster barrier must follow
// before any copy or arrive.
template <int C>
__device__ __forceinline__ void init_cluster_ring(const ClusterRing<C>& rg) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < rg.ring.stages; ++i) {
      mbar_init(&rg.ring.full[i], 1);
      mbar_init(&rg.ring.empty[i], CONSUMERS / 32);
      mbar_init(&rg.peer[i], C);
    }
    mbar_fence_init();
  }
}

// Before slab `slab` goes into its stage: the stage's last use released by
// every block of the cluster (this block's consumers, relayed to the
// others; then the others' relays).  A stage's first use waits for nothing.
template <int C>
__device__ __forceinline__ void await_stage(const ClusterRing<C>& rg, int slab) {
  const int S = rg.ring.stages, stage = slab % S;
  if (slab < S) return;
  const uint32_t parity = ((slab / S) & 1) ^ 1;
  mbar_wait(&rg.ring.empty[stage], parity);
#pragma unroll
  for (int c = 0; c < C; ++c) mbar_arrive_cluster(&rg.peer[stage], c);
  mbar_wait(&rg.peer[stage], parity);
}

// produce_slabs for a cluster ring: block `rank`'s share of every slab,
// into every block of the cluster.  A slab is a multiple of 512 bytes, so
// each share is a multiple of 16.  PASSES as produce_slabs.
template <int C, bool PASSES = false>
__device__ __forceinline__ void produce_slabs_multicast(const int* ops, int n_ops,
                                                        const bf16* img, const ClusterRing<C>& rg,
                                                        int& slab, uint32_t rank) {
  const Ring& r = rg.ring;
  const int S = r.stages, SK = r.slab_k;
  for (int o = 0; o < n_ops; ++o) {
    const int* op = ops + o * OP_INTS;
    const int kind = __ldg(op + O_KIND);
    if (kind != FWD && kind != BWD) continue;
    const int N = __ldg(op + O_N), K = __ldg(op + O_K);
    const int P = PASSES ? pass_count(N) : 1, BW = N / P;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(img + __ldg(op + O_IMG));
    for (int q = 0; q < P; ++q, src += (long long)K * BW * 2)
      for (int k0 = 0; k0 < K; k0 += SK, ++slab) {
        const int stage = slab % S;
        await_stage(rg, slab);
        const uint32_t bytes = (uint32_t)(min(SK, K - k0) * BW * 2), share = bytes / C;
        mbar_expect_tx(&r.full[stage], bytes);
        bulk_load_multicast(r.base + stage * r.stage + rank * share,
                            src + (long long)k0 * BW * 2 + rank * share, share, &r.full[stage],
                            (uint16_t)((1u << C) - 1));
      }
  }
}

// The producer's last step: every stage released by the whole cluster, as
// if `slab` and the stages' next slabs followed, so that no peer arrives
// on this block's barriers after it has exited.  `slab` counts the slabs
// produced.
template <int C>
__device__ __forceinline__ void await_release(const ClusterRing<C>& rg, int slab) {
  for (int i = slab; i < slab + rg.ring.stages; ++i) await_stage(rg, i);
}

// A padding tile's part of the ring protocol: each of the program's slabs
// taken and released without a product (the calling warp's lane `lane`).
// PASSES as produce_slabs.
template <bool PASSES = false>
__device__ __forceinline__ void skip_slabs(const int* ops, int n_ops, const Ring& rg, int& slab,
                                           int lane) {
  const int S = rg.stages, SK = rg.slab_k;
  for (int o = 0; o < n_ops; ++o) {
    const int* op = ops + o * OP_INTS;
    const int kind = __ldg(op + O_KIND);
    if (kind != FWD && kind != BWD) continue;
    const int n_slabs = (PASSES ? pass_count(__ldg(op + O_N)) : 1) * ((__ldg(op + O_K) + SK - 1) / SK);
    for (int s = 0; s < n_slabs; ++s, ++slab) {
      mbar_wait(&rg.full[slab % S], (slab / S) & 1);
      if (lane == 0) mbar_arrive(&rg.empty[slab % S]);
    }
  }
}

// The tiles of a block of a persistent cluster of C blocks: the cluster
// takes groups of C consecutive tiles, from its index in steps of the
// count of clusters, and its block of rank r tile C·group + r of each.
// Where n_tiles is not a multiple of C the last group's tiles past n_tiles
// are padding tiles: their blocks take the slabs (skip_slabs) and write
// nothing.  A block's real tiles come before its padding tiles.  The walk
// keeps no state: it reads the cluster's special registers where it needs
// them.  The consumers run one loop over their halves, the tile recomputed
// from the loop's counter, with one call site of the program: a loop of
// tiles around a loop of halves holds more registers over the products,
// and the wide programs then spill.
template <int C>
struct ClusterWalk {
  __device__ static int groups(long long n_tiles) { return (int)((n_tiles + C - 1) / C); }
  __device__ static int first() { return (int)cluster_index(); }
  __device__ static int step() { return (int)cluster_count(); }
  __device__ static int tile(int group) { return group * C + (int)cluster_rank(); }
  // How many groups the block takes (at least one: the grid has no more
  // clusters than groups).
  __device__ static int my_groups(long long n_tiles) {
    return (groups(n_tiles) - first() + step() - 1) / step();
  }
};

// The persistent grid of a cluster kernel (host): as many clusters as are
// resident at once (cudaOccupancyMaxActiveClusters), at most one a group
// of tiles.
struct ClusterGrid {
  int cluster, active;
  long long blocks;
};

// cudaOccupancyMaxActiveClusters for `cfg`, asked once a (device, kernel,
// shared memory) and then remembered: a training step launches the
// backwards dozens of times at the same few sizes.
inline cudaError_t active_clusters(const void* kernel, const cudaLaunchConfig_t& cfg,
                                   int* active) {
  struct Entry {
    int device;
    const void* kernel;
    size_t smem;
    int active;
  };
  static std::mutex mu;
  static std::vector<Entry> seen;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& s : seen)
    if (s.device == device && s.kernel == kernel && s.smem == cfg.dynamicSmemBytes) {
      *active = s.active;
      return cudaSuccess;
    }
  e = cudaOccupancyMaxActiveClusters(active, kernel, &cfg);
  if (e == cudaSuccess) seen.push_back(Entry{device, kernel, cfg.dynamicSmemBytes, *active});
  return e;
}

// Sets the kernel's shared memory, sizes its grid into *grid and, unless
// args is null, launches it as clusters of CLUSTER blocks on `stream`, one
// cluster for each of `n_groups` groups of work up to the clusters
// resident at once (the backwards: CLUSTER tiles a group, a tile a block;
// the wide forward: a tile a group).  Returns a cudaError_t:
// cudaErrorLaunchOutOfResources where no cluster fits the card,
// cudaErrorInvalidConfiguration for a grid over `max_blocks` (0: no
// bound); there is no fallback to a grid without clusters.
template <class Args>
inline int cluster_launch(void (*kernel)(Args), const Args* args, int smem, long long n_groups,
                          cudaStream_t stream, ClusterGrid* grid, long long max_blocks = 0) {
  constexpr int cluster = CLUSTER;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(ALL_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  e = active_clusters((const void*)kernel, cfg, &active);
  if (e != cudaSuccess) return (int)e;
  grid->cluster = cluster;
  grid->active = active;
  grid->blocks = lmin(active, n_groups) * cluster;
  if (active < 1) return (int)cudaErrorLaunchOutOfResources;
  if (max_blocks > 0 && grid->blocks > max_blocks) return (int)cudaErrorInvalidConfiguration;
  if (args == nullptr || n_groups < 1) return 0;
  cfg.gridDim = dim3((unsigned)grid->blocks);
  e = cudaLaunchKernelEx(&cfg, kernel, *args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---- the product ---------------------------------------------------------------

// No ordering between the two warpgroups' products.
struct AnyOrder {
  __device__ void wait() const {}
  __device__ void pass() const {}
  __device__ void slab(int) const {}
};

// acc = [A0 | A1] · B over the op's K, B streamed from the ring; a0/a1 are
// the shared addresses of the chunk-major operands.  B's slabs are BW
// columns wide (the op's O_N); the product takes N of them from column cb
// (all of them, or a wide program's warpgroup's half).  Each slab's products are
// one wgmma group; up to DEPTH groups stay in flight while the next is
// issued, and a slab is released when its group is done.  `turn.wait()`
// runs before the first slab's products are issued, `turn.pass()` right
// after they are, `turn.slab(s)` before slab s is awaited.
template <int N, int DEPTH = 1, class Turn = AnyOrder, int BW = N>
__device__ __forceinline__ void product(const int* op, uint32_t a0, uint32_t a1, const Ring& rg,
                                        int& slab, int lane, float (&acc)[N / 2],
                                        const Turn& turn = Turn(), int cb = 0) {
  const int K = op[O_K], ka = op[O_KA];
  const uint32_t r = smem_u32(rg.base) + cb * 16;
  const int S = rg.stages, SK = rg.slab_k;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  fence_regs(acc);
  turn.wait();
  const int first = slab, n_slabs = (K + SK - 1) / SK;
  for (int s = 0; s < n_slabs; ++s) {
    const int cur = first + s, stage = cur % S;
    turn.slab(s);
    mbar_wait(&rg.full[stage], (cur / S) & 1);
    wgmma_fence();
    const int k0 = s * SK, ks = min(SK, K - k0);
    for (int kk = 0; kk < ks; kk += 16) {
      const int kg = k0 + kk;
      const uint32_t abase = kg < ka ? a0 + (kg >> 3) * 1024 : a1 + ((kg - ka) >> 3) * 1024;
      const uint64_t da = gmma_desc(abase, 1024, 128);
      const uint64_t db = gmma_desc(r + stage * rg.stage + (kk >> 3) * BW * 16, BW * 16, 128);
      Wgmma<N, 0, 0>::mma(acc, da, db, 1);
    }
    wgmma_commit();
    if (s == 0) turn.pass();
    if (s >= DEPTH) {
      wgmma_wait<DEPTH>();
      if (lane == 0) mbar_arrive(&rg.empty[(cur - DEPTH) % S]);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (lane == 0)
    for (int s = n_slabs > DEPTH ? n_slabs - DEPTH : 0; s < n_slabs; ++s)
      mbar_arrive(&rg.empty[(first + s) % S]);
  slab = first + n_slabs;
}

// y = v + bias over a product's columns (from column cb of the layer),
// relu'd if asked, rounded to bf16 into the chunk-major tile `dst`;
// bias2(c) gives the biases of columns c and c + 1 (c even).  Bit
// 4(j % 8) + q of mw[j / 8] is set where y[4j + q] > 0 after the rounding
// (the backward's relu masks).
template <int N, class Bias2>
__device__ __forceinline__ void activation_out(const float (&v)[N / 2], const Bias2& bias2,
                                               bool relu, bf16* dst, const Lane& ln,
                                               uint32_t (&mw)[(N + 63) / 64], int cb = 0) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = cb + 8 * j + ln.cq;
    const float2 b = bias2(c);
    float y[4] = {v[4 * j] + b.x, v[4 * j + 1] + b.y, v[4 * j + 2] + b.x, v[4 * j + 3] + b.y};
    if (relu) {
#pragma unroll
      for (int q = 0; q < 4; ++q) y[q] = fmaxf(y[q], 0.0f);
    }
    const __nv_bfloat162 h0 = __floats2bfloat162_rn(y[0], y[1]);
    const __nv_bfloat162 h1 = __floats2bfloat162_rn(y[2], y[3]);
    *reinterpret_cast<__nv_bfloat162*>(dst + cm(ln.r0, c)) = h0;
    *reinterpret_cast<__nv_bfloat162*>(dst + cm(ln.r0 + 8, c)) = h1;
    const uint32_t bits = (__bfloat162float(h0.x) > 0.0f) | (__bfloat162float(h0.y) > 0.0f) << 1 |
                          (__bfloat162float(h1.x) > 0.0f) << 2 |
                          (__bfloat162float(h1.y) > 0.0f) << 3;
    mw[j >> 3] |= bits << ((j & 7) * 4);
  }
}

// activation_out's values kept in registers (class 2's first pass): the
// bf16 pairs of row r0 and of row r0 + 8 of each 8-column group in
// park[2j] and park[2j + 1], written by store_packed once the tile may be
// overwritten; the mask bits as activation_out's.
template <int N, class Bias2>
__device__ __forceinline__ void activation_pack(const float (&v)[N / 2], const Bias2& bias2,
                                                bool relu, __nv_bfloat162 (&park)[N / 4],
                                                const Lane& ln, uint32_t (&mw)[(N + 63) / 64],
                                                int cb) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = cb + 8 * j + ln.cq;
    const float2 b = bias2(c);
    float y[4] = {v[4 * j] + b.x, v[4 * j + 1] + b.y, v[4 * j + 2] + b.x, v[4 * j + 3] + b.y};
    if (relu) {
#pragma unroll
      for (int q = 0; q < 4; ++q) y[q] = fmaxf(y[q], 0.0f);
    }
    const __nv_bfloat162 h0 = __floats2bfloat162_rn(y[0], y[1]);
    const __nv_bfloat162 h1 = __floats2bfloat162_rn(y[2], y[3]);
    park[2 * j] = h0;
    park[2 * j + 1] = h1;
    const uint32_t bits = (__bfloat162float(h0.x) > 0.0f) | (__bfloat162float(h0.y) > 0.0f) << 1 |
                          (__bfloat162float(h1.x) > 0.0f) << 2 |
                          (__bfloat162float(h1.y) > 0.0f) << 3;
    mw[j >> 3] |= bits << ((j & 7) * 4);
  }
}

// The packed pairs of activation_pack (or of a cotangent) into the
// chunk-major tile `dst` from column cb.
template <int N>
__device__ __forceinline__ void store_packed(const __nv_bfloat162 (&park)[N / 4], bf16* dst,
                                             const Lane& ln, int cb) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = cb + 8 * j + ln.cq;
    *reinterpret_cast<__nv_bfloat162*>(dst + cm(ln.r0, c)) = park[2 * j];
    *reinterpret_cast<__nv_bfloat162*>(dst + cm(ln.r0 + 8, c)) = park[2 * j + 1];
  }
}

// ---- the rows' encoding --------------------------------------------------------

// Row r's NeRF encoding [x | sin(2^f x) | cos(2^f x)] of `dim`
// coordinates and F frequencies (enc_cols columns), rounded to bf16, into
// the chunk-major tile e (zero columns up to enc_pad); xv(d) is the row's
// coordinate d.  Two threads share a row: half 0 writes x and the even
// frequencies, half 1 the odd ones and the zero columns.  sincosf is the
// accurate sinf and cosf in one range reduction (arguments reach 2^9 rad);
// no integer division.
template <class Xv>
__device__ __forceinline__ void encode_row(const Xv& xv, int r, int half, int dim, int F,
                                           int enc_cols, int enc_pad, bf16* e) {
  const int cos0 = dim * (1 + F);
  if (half == 0) {
    for (int d = 0; d < dim; ++d) e[cm(r, d)] = __float2bfloat16_rn(xv(d));
  } else {
    for (int c = enc_cols; c < enc_pad; ++c) e[cm(r, c)] = __float2bfloat16_rn(0.0f);
  }
  for (int f = half; f < F; f += 2) {
    const float scale = (float)(1 << f);
    for (int d = 0; d < dim; ++d) {
      float sn, cs;
      sincosf(xv(d) * scale, &sn, &cs);
      e[cm(r, dim + f * dim + d)] = __float2bfloat16_rn(sn);
      e[cm(r, cos0 + f * dim + d)] = __float2bfloat16_rn(cs);
    }
  }
}

// The same with the widths from a program's header.
template <class Xv>
__device__ __forceinline__ void encode_row(const Xv& xv, int r, int half, const int* h, bf16* e) {
  encode_row(xv, r, half, h[H_DIM], h[H_FREQS], h[H_ENC_COLS], h[H_ENC_PAD], e);
}

// ---- two warpgroups out of phase ---------------------------------------------

// The order of the consumers' products, out of phase: warpgroup 0 starts
// each product, warpgroup 1 starts it once warpgroup 0 has issued the
// products of its first slab, and warpgroup 0 starts the next once
// warpgroup 1 has done the same, so each warpgroup's epilogue runs while
// the other's slabs multiply.  Both read the same slabs; before it hands
// over, a warpgroup holds at most 1 <= stages - 2 slab of its product that
// the other has not read (the kernels' MIN_STAGES), so the ring always has
// room for it and the two never wait on each other in a circle.
//
// turn[w] completes a phase when the other warpgroup's 4 warps have handed
// over; p counts the calling warpgroup's products, `total` is the block's
// count, the same for both.  mbarriers rather than named barriers, so that
// a fault in the order traps (mbar_wait) instead of hanging the card.
struct PingPong {
  uint64_t* turn;
  int wg, lane;
  long long p, total;
  __device__ void wait() const {
    if (wg == 0 && p == 0) return;
    mbar_wait(&turn[wg], (uint32_t)((wg == 0 ? p - 1 : p) & 1));
  }
  __device__ void pass() const {
    if ((wg == 0 || p + 1 < total) && lane == 0) mbar_arrive(&turn[wg ^ 1]);
  }
  __device__ void slab(int) const {}
};

// mbar_wait as one asm loop, skipped where `wait` is 0, with the same trap.
// Before a product, a C++ branch or loop around a wait makes the compiler
// serialise the wide kernels' wgmma (ptxas C7520); this form, followed by
// a wgmma fence, does not.
__device__ __forceinline__ void mbar_spin(uint64_t* bar, uint32_t parity, uint32_t wait = 1) {
  asm volatile(
      "{\n.reg .pred P1, P2;\n.reg .u64 T0, T1;\n"
      "setp.eq.u32 P1, %2, 0;\n"
      "@P1 bra DONE;\n"
      "mov.u64 T0, %%clock64;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "mov.u64 T1, %%clock64;\n"
      "sub.u64 T1, T1, T0;\n"
      "setp.gt.u64 P2, T1, 20000000000;\n"
      "@P2 trap;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity), "r"(wait)
      : "memory");
}

// The order of a wide forward's products (pe::product's Turn): PingPong's,
// and the handshake's step 1 (Mirror) at the slab that first reads the
// peer's half of the previous product's output (s_wait; none past the
// product's slabs), so that the copy's flight overlaps the slabs before.
// The first product of warpgroup 0 waits for the parity a fresh barrier
// counts as completed.
struct PingPongWide : PingPong {
  uint64_t* wrote;   // this warpgroup's Mirror wrote barrier
  int s_wait;
  __device__ void wait() const {
    mbar_spin(&turn[wg], (uint32_t)((wg == 0 ? p - 1 : p) & 1));
    wgmma_fence();
  }
  __device__ void slab(int s) const {
    mbar_spin(wrote, (uint32_t)((p - 1) & 1), s == s_wait);
  }
};

// ---- the wide forward: every product's columns split over a cluster ----------
//
// A wide forward runs as persistent clusters of CLUSTER blocks on two SMs.
// The cluster walks the 128-row tiles (tiles cluster_index() + k ·
// cluster_count(), the same for both blocks); block `rank` computes columns
// [rank · N/2, (rank + 1) · N/2) of every product of N columns, and its
// warpgroups their own 64 rows of the tile, out of phase (PingPong).  Each
// warpgroup keeps its own copy of its rows' activation tiles, so the
// wgmma A operands stay local; the epilogue writes the warpgroup's half of
// the output into its own tile and into the peer's (Mirror).
constexpr int MIRROR_BYTES = 2 * 2 * 8;   // read and wrote barriers of two warpgroups

// produce_slabs for a wide forward: block `rank`'s half of every product's
// columns, slab by slab.  In the weight image a slab's 8-row k-groups each
// hold N/8 core matrices in column order, so a half is one contiguous run
// of N/2 · 16 bytes a k-group: one bulk copy each, landing as the K-major
// core-matrix layout of the [rows, N/2] half (pe::product with BW = N/2).
__device__ __forceinline__ void produce_half_slabs(const int* ops, int n_ops, const bf16* img,
                                                   const Ring& rg, int& slab, uint32_t rank) {
  const int S = rg.stages, SK = rg.slab_k;
  for (int o = 0; o < n_ops; ++o) {
    const int* op = ops + o * OP_INTS;
    if (__ldg(op + O_KIND) != FWD) continue;
    const int N = __ldg(op + O_N), K = __ldg(op + O_K), half = N / 2;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(img + __ldg(op + O_IMG));
    for (int k0 = 0; k0 < K; k0 += SK, ++slab) {
      const int stage = slab % S, groups = min(SK, K - k0) / 8;
      mbar_wait(&rg.empty[stage], ((slab / S) & 1) ^ 1);
      mbar_expect_tx(&rg.full[stage], (uint32_t)(groups * half * 16));
      for (int g = 0; g < groups; ++g)
        bulk_load(rg.base + stage * rg.stage + g * half * 16,
                  src + ((long long)(k0 / 8 + g) * N + rank * half) * 16, (uint32_t)(half * 16),
                  &rg.full[stage]);
    }
  }
}

// The handshake of a wide forward's warpgroup with its peer: the same
// warpgroup of the other block, on the same 64 rows, computing the other
// half of every product.  Each keeps its own copy of the rows' activation
// tiles; an activation output's half goes into the warpgroup's own tile,
// then by one bulk copy (chunk-major columns are contiguous) into the
// peer's, in place.  Every product p runs the same steps in both:
//  1. before it reads it, the peer's half of p - 1's output has landed
//     (wrote[wg], phase p - 1: PingPongWide waits at the first slab that
//     reads it, and a product that reads none of it does not wait, since
//     phases complete in order and a later wait covers it);
//  2. after it, once the warpgroup has passed step 1, its threads tell the
//     peer it has read its tiles (read[wg] there) and arm phase p of its
//     own wrote[wg] with the bytes the peer's copy of p brings (0 for an
//     output that goes to device memory alone);
//  3. it waits until the peer has finished p (read[wg], phase p) before it
//     writes anything: the peer has then waited for this warpgroup's copy
//     of p - 1, whose source these writes may overwrite, wherever p reads
//     it (the programs' next product reads every mirrored output but a
//     trunk-only program's t, whose copy a later wait covers before t is
//     written again);
//  4. after its writes (fenced, and a warpgroup barrier after every
//     thread's step 3), one thread copies its half to the peer and
//     arrives on the peer's wrote[wg].
// So each of the peer's phases needs this warpgroup's previous one, and no
// barrier runs a phase ahead of a wait on it.  At the end each warpgroup
// waits for the peer's last hand-over and arrives once more on the peer's
// read barrier, and leaves once the peer has done the same: nothing
// reaches a block after it exits, and its last copy has been read.
// mbarriers, so that a fault in the order traps instead of hanging the
// card; nothing waits on the whole cluster.
//
// A wide forward's grid is one-dimensional with clusters of CLUSTER blocks,
// so a block's cluster is blockIdx.x / CLUSTER and its rank blockIdx.x %
// CLUSTER; Mirror keeps no registers and reads both, and the barriers'
// offset, where it needs them (a warpgroup's 64 x 256 accumulators leave
// little room).
struct Mirror {
  int off;          // the barriers' offset in shared memory: read[2], then wrote[2]

  __device__ static uint32_t peer() { return (blockIdx.x % CLUSTER) ^ 1u; }
  __device__ uint64_t* bars() const {
    extern __shared__ __align__(1024) unsigned char mirror_smem[];
    return reinterpret_cast<uint64_t*>(mirror_smem + off);
  }
  __device__ uint64_t* read(const Lane& ln) const { return bars() + ln.wg; }
  __device__ uint64_t* wrote(const Lane& ln) const { return bars() + 2 + ln.wg; }
  // Step 2, after a warpgroup barrier: every thread arrives, and arms its
  // share of `bytes` (a multiple of 128); no branch (see mbar_spin).
  __device__ void done_reading(const Lane& ln, uint32_t bytes) const {
    mbar_arrive_cluster(read(ln), peer());
    mbar_expect_tx(wrote(ln), bytes / 128);
  }
  // Step 3 of product p.
  __device__ void await_peer(const Lane& ln, long long p) const {
    mbar_wait(read(ln), (uint32_t)(p & 1));
  }
  // Step 4: `bytes` of `tile` from column cb (none for an output that goes
  // to device memory alone).
  __device__ void hand_over(const Lane& ln, const bf16* tile, int cb, uint32_t bytes) const {
    if (ln.t != 0) return;
    const uint32_t bar = cluster_addr(wrote(ln), peer());
    if (bytes) {
      const bf16* src = tile + (cb >> 3) * CHUNK;
      bulk_copy_cluster(cluster_addr(src, peer()), src, bytes, bar);
    }
    mbar_arrive_remote(bar);
  }
  // The warpgroup's last step, after `total` products.
  __device__ void drain(const Lane& ln, long long total) const {
    mbar_wait(wrote(ln), (uint32_t)((total - 1) & 1));
    mbar_arrive_cluster(read(ln), peer());
    mbar_wait(read(ln), (uint32_t)(total & 1));
  }
};

// One thread initialises a block's Mirror barriers (after `off` bytes); a
// cluster barrier must follow before any remote arrive or copy.
__device__ __forceinline__ Mirror make_mirror(unsigned char* smem, int off) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + off);
  if (threadIdx.x == 0) {
    for (int w = 0; w < 2; ++w) {
      mbar_init(&bars[w], 128);     // the peer's threads
      mbar_init(&bars[2 + w], 129); // this warpgroup's arms, the peer's hand-over
    }
    mbar_fence_init();
  }
  return Mirror{off};
}

}  // namespace pe
}  // namespace cropnerf
