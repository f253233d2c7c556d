// Native point-cloud ops: voxel downsample, DBSCAN, statistical outlier
// removal, KMeans.
//
// The port's copy of cropnerf_tpu/native/src/pointcloud_ops.cc: host-side
// equivalents of the Open3D C++ geometry ops and sklearn's Cython kernels
// used by the reference counting stage (SURVEY §2.3 N5/N7; the reference's
// crop_nerf/segmentation/segmenter.py:69-86, clustering.py).  The counting
// stage is a host-side consumer of exported clouds, exactly as in the
// reference — but here the heavy primitives are in-repo C++ instead of
// external wheels.
//
// Build: the Makefile beside src/ (g++ -O3 -shared -fopenmp), run at first
// use into cropnerf_tpu_torch/_build by pointcloud_ops.py, which binds it
// with ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <random>
#include <unordered_map>
#include <vector>

namespace {

struct CellKey {
  int64_t x, y, z;
  bool operator==(const CellKey& o) const {
    return x == o.x && y == o.y && z == o.z;
  }
};

struct CellHash {
  size_t operator()(const CellKey& k) const {
    // same spatial-hash primes as the hash-grid encoding
    return static_cast<size_t>(k.x * 1 ^ k.y * 2654435761LL ^
                               k.z * 805459861LL);
  }
};

using Grid = std::unordered_map<CellKey, std::vector<int>, CellHash>;

Grid build_grid(const float* pts, int n, float cell) {
  Grid grid;
  grid.reserve(static_cast<size_t>(n));
  for (int i = 0; i < n; ++i) {
    CellKey key{static_cast<int64_t>(std::floor(pts[3 * i] / cell)),
                static_cast<int64_t>(std::floor(pts[3 * i + 1] / cell)),
                static_cast<int64_t>(std::floor(pts[3 * i + 2] / cell))};
    grid[key].push_back(i);
  }
  return grid;
}

inline float dist2(const float* pts, int i, int j) {
  float dx = pts[3 * i] - pts[3 * j];
  float dy = pts[3 * i + 1] - pts[3 * j + 1];
  float dz = pts[3 * i + 2] - pts[3 * j + 2];
  return dx * dx + dy * dy + dz * dz;
}

}  // namespace

extern "C" {

// Average points per occupied voxel.  out_pts must hold n*3 floats.
// Returns the number of output points.
int voxel_downsample(const float* pts, int n, float voxel, float* out_pts) {
  Grid grid = build_grid(pts, n, voxel);
  // deterministic output order: sort cells by key
  std::vector<std::pair<CellKey, const std::vector<int>*>> cells;
  cells.reserve(grid.size());
  for (const auto& kv : grid) cells.push_back({kv.first, &kv.second});
  std::sort(cells.begin(), cells.end(), [](const auto& a, const auto& b) {
    if (a.first.x != b.first.x) return a.first.x < b.first.x;
    if (a.first.y != b.first.y) return a.first.y < b.first.y;
    return a.first.z < b.first.z;
  });
  int m = 0;
  for (const auto& cell : cells) {
    double sx = 0, sy = 0, sz = 0;
    for (int i : *cell.second) {
      sx += pts[3 * i];
      sy += pts[3 * i + 1];
      sz += pts[3 * i + 2];
    }
    double c = static_cast<double>(cell.second->size());
    out_pts[3 * m] = static_cast<float>(sx / c);
    out_pts[3 * m + 1] = static_cast<float>(sy / c);
    out_pts[3 * m + 2] = static_cast<float>(sz / c);
    ++m;
  }
  return m;
}

// Grid-accelerated DBSCAN.  labels[i] = cluster id or -1 (noise).
// Returns the number of clusters.
int dbscan(const float* pts, int n, float eps, int min_pts, int* labels) {
  const float eps2 = eps * eps;
  Grid grid = build_grid(pts, n, eps);

  auto neighbors = [&](int i, std::vector<int>& out) {
    out.clear();
    int64_t cx = static_cast<int64_t>(std::floor(pts[3 * i] / eps));
    int64_t cy = static_cast<int64_t>(std::floor(pts[3 * i + 1] / eps));
    int64_t cz = static_cast<int64_t>(std::floor(pts[3 * i + 2] / eps));
    for (int64_t dx = -1; dx <= 1; ++dx)
      for (int64_t dy = -1; dy <= 1; ++dy)
        for (int64_t dz = -1; dz <= 1; ++dz) {
          auto it = grid.find(CellKey{cx + dx, cy + dy, cz + dz});
          if (it == grid.end()) continue;
          for (int j : it->second)
            if (dist2(pts, i, j) <= eps2) out.push_back(j);
        }
  };

  std::fill(labels, labels + n, -2);  // -2 = unvisited
  int cluster = 0;
  std::vector<int> nbrs, seed_nbrs;
  for (int i = 0; i < n; ++i) {
    if (labels[i] != -2) continue;
    neighbors(i, nbrs);
    if (static_cast<int>(nbrs.size()) < min_pts) {
      labels[i] = -1;
      continue;
    }
    labels[i] = cluster;
    std::queue<int> q;
    for (int j : nbrs)
      if (j != i) q.push(j);
    while (!q.empty()) {
      int j = q.front();
      q.pop();
      if (labels[j] == -1) labels[j] = cluster;  // border point
      if (labels[j] != -2) continue;
      labels[j] = cluster;
      neighbors(j, seed_nbrs);
      if (static_cast<int>(seed_nbrs.size()) >= min_pts)
        for (int k : seed_nbrs) {
          if (labels[k] == -2 || labels[k] == -1) q.push(k);
        }
    }
    ++cluster;
  }
  return cluster;
}

// Statistical outlier removal: keep[i]=1 if the mean distance to the k
// nearest neighbours is within mean + std_ratio * std of the global
// distribution (Open3D remove_statistical_outlier semantics).
// Grid-based kNN with expanding ring search.
void statistical_outlier_removal(const float* pts, int n, int k,
                                 float std_ratio, uint8_t* keep) {
  if (n <= k + 1) {
    std::fill(keep, keep + n, 1);
    return;
  }
  // estimate a cell size from the bounding box so ~k points live per cell
  float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
  for (int i = 0; i < n; ++i)
    for (int d = 0; d < 3; ++d) {
      lo[d] = std::min(lo[d], pts[3 * i + d]);
      hi[d] = std::max(hi[d], pts[3 * i + d]);
    }
  float vol = std::max(1e-12f, (hi[0] - lo[0]) * (hi[1] - lo[1]) *
                                   (hi[2] - lo[2]));
  float cell = std::cbrt(vol * k / std::max(1, n));
  cell = std::max(cell, 1e-9f);
  Grid grid = build_grid(pts, n, cell);

  std::vector<float> mean_d(n);
#pragma omp parallel
  {
    std::vector<std::pair<float, int>> cand;
#pragma omp for schedule(dynamic, 256)
    for (int i = 0; i < n; ++i) {
      int64_t cx = static_cast<int64_t>(std::floor(pts[3 * i] / cell));
      int64_t cy = static_cast<int64_t>(std::floor(pts[3 * i + 1] / cell));
      int64_t cz = static_cast<int64_t>(std::floor(pts[3 * i + 2] / cell));
      cand.clear();
      for (int ring = 1; ring <= 64; ++ring) {
        cand.clear();
        for (int64_t dx = -ring; dx <= ring; ++dx)
          for (int64_t dy = -ring; dy <= ring; ++dy)
            for (int64_t dz = -ring; dz <= ring; ++dz) {
              auto it = grid.find(CellKey{cx + dx, cy + dy, cz + dz});
              if (it == grid.end()) continue;
              for (int j : it->second)
                if (j != i) cand.push_back({dist2(pts, i, j), j});
            }
        // enough candidates and the k-th is safely inside the ring radius
        if (static_cast<int>(cand.size()) >= k) {
          std::nth_element(cand.begin(), cand.begin() + (k - 1), cand.end());
          float kth = std::sqrt(cand[k - 1].first);
          if (kth <= ring * cell || ring == 64) break;
        }
      }
      int kk = std::min<int>(k, cand.size());
      std::partial_sort(cand.begin(), cand.begin() + kk, cand.end());
      float s = 0;
      for (int j = 0; j < kk; ++j) s += std::sqrt(cand[j].first);
      mean_d[i] = kk > 0 ? s / kk : 0.0f;
    }
  }
  double mu = 0;
  for (int i = 0; i < n; ++i) mu += mean_d[i];
  mu /= n;
  double var = 0;
  for (int i = 0; i < n; ++i) var += (mean_d[i] - mu) * (mean_d[i] - mu);
  double sd = std::sqrt(var / n);
  double thresh = mu + std_ratio * sd;
  for (int i = 0; i < n; ++i) keep[i] = mean_d[i] <= thresh ? 1 : 0;
}

// KMeans with kmeans++ init and Lloyd iterations.
void kmeans(const float* pts, int n, int k, int iters, uint32_t seed,
            int* labels) {
  std::mt19937 rng(seed);
  std::vector<float> centers(3 * k);
  // kmeans++ seeding
  std::uniform_int_distribution<int> uni(0, n - 1);
  int first = uni(rng);
  std::copy(pts + 3 * first, pts + 3 * first + 3, centers.begin());
  std::vector<float> d2(n, 1e30f);
  for (int c = 1; c < k; ++c) {
    double total = 0;
    for (int i = 0; i < n; ++i) {
      float dx = pts[3 * i] - centers[3 * (c - 1)];
      float dy = pts[3 * i + 1] - centers[3 * (c - 1) + 1];
      float dz = pts[3 * i + 2] - centers[3 * (c - 1) + 2];
      d2[i] = std::min(d2[i], dx * dx + dy * dy + dz * dz);
      total += d2[i];
    }
    std::uniform_real_distribution<double> ud(0.0, total);
    double r = ud(rng);
    int pick = n - 1;
    double acc = 0;
    for (int i = 0; i < n; ++i) {
      acc += d2[i];
      if (acc >= r) {
        pick = i;
        break;
      }
    }
    std::copy(pts + 3 * pick, pts + 3 * pick + 3, centers.begin() + 3 * c);
  }
  // Lloyd
  std::vector<double> sums(3 * k);
  std::vector<int> counts(k);
  for (int it = 0; it < iters; ++it) {
    bool changed = false;
#pragma omp parallel for schedule(static) reduction(|| : changed)
    for (int i = 0; i < n; ++i) {
      float best = 1e30f;
      int bj = 0;
      for (int j = 0; j < k; ++j) {
        float dx = pts[3 * i] - centers[3 * j];
        float dy = pts[3 * i + 1] - centers[3 * j + 1];
        float dz = pts[3 * i + 2] - centers[3 * j + 2];
        float d = dx * dx + dy * dy + dz * dz;
        if (d < best) {
          best = d;
          bj = j;
        }
      }
      if (labels[i] != bj) {
        labels[i] = bj;
        changed = true;
      }
    }
    if (!changed && it > 0) break;
    std::fill(sums.begin(), sums.end(), 0.0);
    std::fill(counts.begin(), counts.end(), 0);
    for (int i = 0; i < n; ++i) {
      int j = labels[i];
      sums[3 * j] += pts[3 * i];
      sums[3 * j + 1] += pts[3 * i + 1];
      sums[3 * j + 2] += pts[3 * i + 2];
      counts[j]++;
    }
    for (int j = 0; j < k; ++j)
      if (counts[j] > 0)
        for (int d = 0; d < 3; ++d)
          centers[3 * j + d] = static_cast<float>(sums[3 * j + d] / counts[j]);
  }
}

}  // extern "C"
