// dnet_native — in-repo C++ host kernels for the TPU-native DiffusionNet framework.
//
// Replaces external native dependencies of the reference (sklearn KDTree used at
// reference geometry.py:704; libigl exact_geodesic + multiprocessing Pool at
// geometry.py:784-867) with a single self-contained shared library exposed via
// ctypes (no pybind11 in this environment).
//
// Exposed C ABI:
//   dnet_knn(target, n_target, source, n_source, k, out_dists, out_inds)
//   dnet_dijkstra_geodesics(verts, V, faces, F, sources, S, out)  // (S, V) float32
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 dnet_native.cpp -o libdnet_native.so

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <limits>
#include <queue>
#include <thread>
#include <vector>

namespace {

// ----------------------------------------------------------------------------
// KD-tree (3-D, median split) for kNN queries
// ----------------------------------------------------------------------------

struct KDNode {
  int32_t left = -1, right = -1;
  int32_t begin = 0, end = 0;  // leaf range into `order`
  int8_t axis = -1;            // -1 => leaf
  double split = 0.0;
};

class KDTree3 {
 public:
  KDTree3(const double* pts, int64_t n) : pts_(pts), n_(n), order_(n) {
    for (int64_t i = 0; i < n; ++i) order_[i] = i;
    nodes_.reserve(2 * (n / kLeafSize + 1));
    root_ = build(0, n);
  }

  // k nearest neighbors of query q; writes sorted (dist, idx) pairs.
  // Thread-safe: the working heap is local to the call.
  void query(const double* q, int k, double* out_d, int64_t* out_i) const {
    // bounded max-heap of (dist2, idx)
    std::vector<std::pair<double, int64_t>> heap_;
    heap_.reserve(k + 1);
    search(root_, q, k, heap_);
    std::sort_heap(heap_.begin(), heap_.end());
    int m = static_cast<int>(heap_.size());
    if (m == 0) {  // empty tree: no out_d[m-1] to repeat (would be OOB)
      for (int i = 0; i < k; ++i) {
        out_d[i] = std::numeric_limits<double>::infinity();
        out_i[i] = -1;
      }
      return;
    }
    for (int i = 0; i < k; ++i) {
      if (i < m) {
        out_d[i] = std::sqrt(heap_[i].first);
        out_i[i] = heap_[i].second;
      } else {  // fewer points than k: repeat last
        out_d[i] = out_d[m - 1];
        out_i[i] = out_i[m - 1];
      }
    }
  }

 private:
  static constexpr int kLeafSize = 16;

  int32_t build(int64_t begin, int64_t end) {
    KDNode node;
    if (end - begin <= kLeafSize) {
      node.axis = -1;
      node.begin = static_cast<int32_t>(begin);
      node.end = static_cast<int32_t>(end);
      nodes_.push_back(node);
      return static_cast<int32_t>(nodes_.size() - 1);
    }
    // pick the widest axis
    double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
    for (int64_t i = begin; i < end; ++i) {
      const double* p = pts_ + 3 * order_[i];
      for (int a = 0; a < 3; ++a) {
        lo[a] = std::min(lo[a], p[a]);
        hi[a] = std::max(hi[a], p[a]);
      }
    }
    int axis = 0;
    double width = hi[0] - lo[0];
    for (int a = 1; a < 3; ++a)
      if (hi[a] - lo[a] > width) { width = hi[a] - lo[a]; axis = a; }

    int64_t mid = (begin + end) / 2;
    std::nth_element(order_.begin() + begin, order_.begin() + mid,
                     order_.begin() + end, [&](int64_t x, int64_t y) {
                       return pts_[3 * x + axis] < pts_[3 * y + axis];
                     });
    node.axis = static_cast<int8_t>(axis);
    node.split = pts_[3 * order_[mid] + axis];
    int32_t me = static_cast<int32_t>(nodes_.size());
    nodes_.push_back(node);
    int32_t l = build(begin, mid);
    int32_t r = build(mid, end);
    nodes_[me].left = l;
    nodes_[me].right = r;
    return me;
  }

  using Heap = std::vector<std::pair<double, int64_t>>;

  void consider(const double* q, int64_t idx, int k, Heap& heap_) const {
    const double* p = pts_ + 3 * idx;
    double d2 = 0.0;
    for (int a = 0; a < 3; ++a) {
      double d = p[a] - q[a];
      d2 += d * d;
    }
    if (static_cast<int>(heap_.size()) < k) {
      heap_.emplace_back(d2, idx);
      std::push_heap(heap_.begin(), heap_.end());
    } else if (d2 < heap_.front().first) {
      std::pop_heap(heap_.begin(), heap_.end());
      heap_.back() = {d2, idx};
      std::push_heap(heap_.begin(), heap_.end());
    }
  }

  void search(int32_t ni, const double* q, int k, Heap& heap_) const {
    const KDNode& node = nodes_[ni];
    if (node.axis < 0) {
      for (int32_t i = node.begin; i < node.end; ++i)
        consider(q, order_[i], k, heap_);
      return;
    }
    double diff = q[node.axis] - node.split;
    int32_t near = diff <= 0 ? node.left : node.right;
    int32_t far = diff <= 0 ? node.right : node.left;
    search(near, q, k, heap_);
    double worst = (static_cast<int>(heap_.size()) < k)
                       ? std::numeric_limits<double>::infinity()
                       : heap_.front().first;
    if (diff * diff < worst) search(far, q, k, heap_);
  }

  const double* pts_;
  int64_t n_;
  std::vector<int64_t> order_;
  std::vector<KDNode> nodes_;
  int32_t root_;
};

// ----------------------------------------------------------------------------
// Point-cloud local triangulation: per-point tangent-plane Bowyer-Watson
// Delaunay (the robust-laplacian / Sharp-Crane point-cloud construction)
// ----------------------------------------------------------------------------

// eigenvectors of a symmetric 3x3 (Jacobi sweeps); columns of V, evals ascending
void eig3_sym(double m[3][3], double evec[3][3], double eval[3]) {
  double v[3][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
  for (int sweep = 0; sweep < 24; ++sweep) {
    double off = std::fabs(m[0][1]) + std::fabs(m[0][2]) + std::fabs(m[1][2]);
    if (off < 1e-15) break;
    for (int p = 0; p < 2; ++p)
      for (int q = p + 1; q < 3; ++q) {
        if (std::fabs(m[p][q]) < 1e-18) continue;
        double theta = (m[q][q] - m[p][p]) / (2.0 * m[p][q]);
        double t = (theta >= 0 ? 1.0 : -1.0)
                   / (std::fabs(theta) + std::sqrt(theta * theta + 1.0));
        double c = 1.0 / std::sqrt(t * t + 1.0), s = t * c;
        for (int r = 0; r < 3; ++r) {
          double mrp = m[r][p], mrq = m[r][q];
          m[r][p] = c * mrp - s * mrq;
          m[r][q] = s * mrp + c * mrq;
        }
        for (int r = 0; r < 3; ++r) {
          double mpr = m[p][r], mqr = m[q][r];
          m[p][r] = c * mpr - s * mqr;
          m[q][r] = s * mpr + c * mqr;
        }
        for (int r = 0; r < 3; ++r) {
          double vrp = v[r][p], vrq = v[r][q];
          v[r][p] = c * vrp - s * vrq;
          v[r][q] = s * vrp + c * vrq;
        }
      }
  }
  int ord[3] = {0, 1, 2};
  double d[3] = {m[0][0], m[1][1], m[2][2]};
  std::sort(ord, ord + 3, [&](int a, int b) { return d[a] < d[b]; });
  for (int c = 0; c < 3; ++c) {
    eval[c] = d[ord[c]];
    for (int r = 0; r < 3; ++r) evec[r][c] = v[r][ord[c]];
  }
}

struct Tri2 {
  int a, b, c;
  double cx, cy, r2;
  bool alive;
};

bool circum(const std::vector<double>& px, const std::vector<double>& py,
            Tri2& t) {
  double ax = px[t.a], ay = py[t.a], bx = px[t.b], by = py[t.b];
  double cx = px[t.c], cy = py[t.c];
  double d = 2.0 * (ax * (by - cy) + bx * (cy - ay) + cx * (ay - by));
  if (std::fabs(d) < 1e-14) return false;
  double a2 = ax * ax + ay * ay, b2 = bx * bx + by * by, c2 = cx * cx + cy * cy;
  t.cx = (a2 * (by - cy) + b2 * (cy - ay) + c2 * (ay - by)) / d;
  t.cy = (a2 * (cx - bx) + b2 * (ax - cx) + c2 * (bx - ax)) / d;
  t.r2 = (t.cx - ax) * (t.cx - ax) + (t.cy - ay) * (t.cy - ay);
  return true;
}

// Bowyer-Watson over n points; appends triangles as index triples
void delaunay2d(const std::vector<double>& px_in,
                const std::vector<double>& py_in,
                std::vector<std::array<int, 3>>& out) {
  int n = static_cast<int>(px_in.size());
  if (n < 3) return;
  std::vector<double> px = px_in, py = py_in;
  double lo_x = 1e300, hi_x = -1e300, lo_y = 1e300, hi_y = -1e300;
  for (int i = 0; i < n; ++i) {
    lo_x = std::min(lo_x, px[i]); hi_x = std::max(hi_x, px[i]);
    lo_y = std::min(lo_y, py[i]); hi_y = std::max(hi_y, py[i]);
  }
  double w = std::max({hi_x - lo_x, hi_y - lo_y, 1e-12});
  double mx = 0.5 * (lo_x + hi_x), my = 0.5 * (lo_y + hi_y);
  // super-triangle (indices n, n+1, n+2)
  px.push_back(mx - 20 * w); py.push_back(my - 10 * w);
  px.push_back(mx + 20 * w); py.push_back(my - 10 * w);
  px.push_back(mx);          py.push_back(my + 20 * w);

  std::vector<Tri2> tris;
  Tri2 super{n, n + 1, n + 2, 0, 0, 0, true};
  if (!circum(px, py, super)) return;
  tris.push_back(super);

  std::vector<std::pair<int, int>> poly;
  for (int i = 0; i < n; ++i) {
    poly.clear();
    for (auto& t : tris) {
      if (!t.alive) continue;
      double dx = px[i] - t.cx, dy = py[i] - t.cy;
      if (dx * dx + dy * dy <= t.r2 * (1.0 + 1e-12)) {
        t.alive = false;
        int e[3][2] = {{t.a, t.b}, {t.b, t.c}, {t.c, t.a}};
        for (auto& ed : e) {
          bool dup = false;
          for (auto& pe : poly) {
            if ((pe.first == ed[1] && pe.second == ed[0])
                || (pe.first == ed[0] && pe.second == ed[1])) {
              pe.first = -1;  // shared edge: interior, drop both
              dup = true;
              break;
            }
          }
          if (!dup) poly.emplace_back(ed[0], ed[1]);
        }
      }
    }
    for (auto& pe : poly) {
      if (pe.first < 0) continue;
      Tri2 nt{pe.first, pe.second, i, 0, 0, 0, true};
      if (circum(px, py, nt)) tris.push_back(nt);
    }
    // periodic compaction keeps the scan linear-ish
    if (tris.size() > 4096) {
      std::vector<Tri2> kept;
      kept.reserve(tris.size());
      for (auto& t : tris) if (t.alive) kept.push_back(t);
      tris.swap(kept);
    }
  }
  for (auto& t : tris) {
    if (!t.alive) continue;
    if (t.a >= n || t.b >= n || t.c >= n) continue;  // touches super-tri
    out.push_back({t.a, t.b, t.c});
  }
}

}  // namespace

extern "C" {

// CSR (V,V) x dense row-major (V,C) float64 SpMM: out = A @ B, threaded
// over row blocks. Exists because scipy's csr @ dense multivector runs at
// ~0.1 GFLOP/s on wide B (measured: 4.5 s for 1.4M nnz x 160 cols at 200k
// vertices) while this contiguous-axpy loop auto-vectorizes to the memory
// roofline (~20x). Used by the f64 Rayleigh-Ritz polish of the device
// eigensolver (geometry/eigen.py:_rr_polish_host), whose SpMMs dominated
// its wall clock.
void dnet_csr_spmm_f64(const int64_t* indptr, const int64_t* indices,
                       const double* data, const double* B, int64_t V,
                       int64_t C, double* out, int32_t n_threads) {
  if (n_threads < 1) {
    n_threads = static_cast<int32_t>(
        std::max(1u, std::thread::hardware_concurrency()));
  }
  n_threads = static_cast<int32_t>(
      std::min<int64_t>(n_threads, std::max<int64_t>(V / 1024, 1)));
  auto rows = [&](int64_t r0, int64_t r1) {
    for (int64_t i = r0; i < r1; ++i) {
      double* o = out + i * C;
      std::memset(o, 0, sizeof(double) * C);
      for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
        const double a = data[p];
        const double* b = B + indices[p] * C;
        for (int64_t c = 0; c < C; ++c) o[c] += a * b[c];
      }
    }
  };
  if (n_threads <= 1) {
    rows(0, V);
    return;
  }
  std::vector<std::thread> pool;
  const int64_t chunk = (V + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    const int64_t r0 = t * chunk, r1 = std::min<int64_t>(V, r0 + chunk);
    if (r0 >= r1) break;
    pool.emplace_back(rows, r0, r1);
  }
  for (auto& th : pool) th.join();
}

// Point-cloud triangle soup: per-point tangent-plane Delaunay triangles
// incident to the point, unioned and deduplicated (Sharp-Crane point-cloud
// Laplacian construction, threaded). verts (V,3) float64; writes up to
// max_tris canonicalized triples into out (n,3) int64; returns the count,
// or -1 if max_tris would overflow.
int64_t dnet_cloud_triangles(const double* verts, int64_t V, int32_t k,
                             int64_t* out, int64_t max_tris) {
  if (V < 3) return 0;
  k = static_cast<int32_t>(std::min<int64_t>(k, V - 1));
  KDTree3 tree(verts, V);

  unsigned n_threads = std::max<unsigned>(1, std::thread::hardware_concurrency());
  std::vector<std::vector<std::array<int64_t, 3>>> per_thread(n_threads);

  auto worker = [&](unsigned tid) {
    auto& acc = per_thread[tid];
    std::vector<double> qd(k + 1);
    std::vector<int64_t> qi(k + 1);
    std::vector<double> px, py;
    std::vector<std::array<int, 3>> local;
    for (int64_t i = tid; i < V; i += n_threads) {
      tree.query(verts + 3 * i, k + 1, qd.data(), qi.data());
      // neighborhood ids with self first
      std::vector<int64_t> ids;
      ids.reserve(k + 1);
      ids.push_back(i);
      for (int j = 0; j <= k && (int)ids.size() < k + 1; ++j)
        if (qi[j] != i) ids.push_back(qi[j]);
      int m = static_cast<int>(ids.size());
      if (m < 3) continue;
      // tangent plane: covariance of the centered neighborhood
      double mean[3] = {0, 0, 0};
      for (int j = 0; j < m; ++j)
        for (int a = 0; a < 3; ++a)
          mean[a] += verts[3 * ids[j] + a];
      for (int a = 0; a < 3; ++a) mean[a] /= m;
      double cov[3][3] = {{0, 0, 0}, {0, 0, 0}, {0, 0, 0}};
      for (int j = 0; j < m; ++j) {
        double d[3];
        for (int a = 0; a < 3; ++a) d[a] = verts[3 * ids[j] + a] - mean[a];
        for (int a = 0; a < 3; ++a)
          for (int b = 0; b < 3; ++b) cov[a][b] += d[a] * d[b];
      }
      double evec[3][3], eval[3];
      eig3_sym(cov, evec, eval);
      // basis = the two largest-eigenvalue directions (columns 1, 2)
      px.assign(m, 0.0);
      py.assign(m, 0.0);
      for (int j = 0; j < m; ++j) {
        double d[3];
        for (int a = 0; a < 3; ++a)
          d[a] = verts[3 * ids[j] + a] - verts[3 * i + a];
        px[j] = d[0] * evec[0][2] + d[1] * evec[1][2] + d[2] * evec[2][2];
        py[j] = d[0] * evec[0][1] + d[1] * evec[1][1] + d[2] * evec[2][1];
      }
      local.clear();
      delaunay2d(px, py, local);
      for (auto& t : local) {
        if (t[0] != 0 && t[1] != 0 && t[2] != 0) continue;  // not incident
        int64_t g[3] = {ids[t[0]], ids[t[1]], ids[t[2]]};
        std::sort(g, g + 3);
        if (g[0] == g[1] || g[1] == g[2]) continue;  // duplicate points
        acc.push_back({g[0], g[1], g[2]});
      }
    }
  };
  if (n_threads <= 1) {
    worker(0);
  } else {
    std::vector<std::thread> pool;
    for (unsigned t = 0; t < n_threads; ++t) pool.emplace_back(worker, t);
    for (auto& th : pool) th.join();
  }

  std::vector<std::array<int64_t, 3>> all;
  size_t total = 0;
  for (auto& acc : per_thread) total += acc.size();
  all.reserve(total);
  for (auto& acc : per_thread)
    all.insert(all.end(), acc.begin(), acc.end());
  std::sort(all.begin(), all.end());
  all.erase(std::unique(all.begin(), all.end()), all.end());
  if (static_cast<int64_t>(all.size()) > max_tris) return -1;
  for (size_t t = 0; t < all.size(); ++t)
    for (int c = 0; c < 3; ++c) out[3 * t + c] = all[t][c];
  return static_cast<int64_t>(all.size());
}

// target: (n_target, 3) float64; source: (n_source, 3) float64.
// out_dists: (n_source, k) float64; out_inds: (n_source, k) int64.
void dnet_knn(const double* target, int64_t n_target, const double* source,
              int64_t n_source, int32_t k, double* out_dists, int64_t* out_inds) {
  KDTree3 tree(target, n_target);
  for (int64_t i = 0; i < n_source; ++i) {
    tree.query(source + 3 * i, k, out_dists + (int64_t)k * i,
               out_inds + (int64_t)k * i);
  }
}

// Graph geodesics: Dijkstra over the mesh edge graph with Euclidean weights.
// verts: (V,3) float64; faces: (F,3) int64; sources: (S,) int64;
// out: (S, V) float32 distances.
void dnet_dijkstra_geodesics(const double* verts, int64_t V, const int64_t* faces,
                             int64_t F, const int64_t* sources, int64_t S,
                             float* out) {
  // build CSR adjacency (undirected, deduped per face edge)
  std::vector<std::vector<std::pair<int32_t, float>>> adj(V);
  auto add_edge = [&](int64_t a, int64_t b) {
    double d2 = 0.0;
    for (int c = 0; c < 3; ++c) {
      double d = verts[3 * a + c] - verts[3 * b + c];
      d2 += d * d;
    }
    float w = static_cast<float>(std::sqrt(d2));
    adj[a].emplace_back(static_cast<int32_t>(b), w);
    adj[b].emplace_back(static_cast<int32_t>(a), w);
  };
  for (int64_t f = 0; f < F; ++f) {
    int64_t i = faces[3 * f], j = faces[3 * f + 1], k = faces[3 * f + 2];
    add_edge(i, j);
    add_edge(j, k);
    add_edge(k, i);
  }
  for (auto& nbrs : adj) {
    std::sort(nbrs.begin(), nbrs.end());
    nbrs.erase(std::unique(nbrs.begin(), nbrs.end()), nbrs.end());
  }

  // independent per-source Dijkstras fanned over hardware threads
  // (replaces the reference's Python multiprocessing.Pool, geometry.py:862)
  unsigned n_threads = std::max<unsigned>(1, std::thread::hardware_concurrency());
  auto worker = [&](int64_t begin, int64_t step) {
    std::vector<float> dist(V);
    using QE = std::pair<float, int32_t>;
    for (int64_t s = begin; s < S; s += step) {
      std::fill(dist.begin(), dist.end(),
                std::numeric_limits<float>::infinity());
      std::priority_queue<QE, std::vector<QE>, std::greater<QE>> pq;
      dist[sources[s]] = 0.0f;
      pq.emplace(0.0f, static_cast<int32_t>(sources[s]));
      while (!pq.empty()) {
        auto [d, u] = pq.top();
        pq.pop();
        if (d > dist[u]) continue;
        for (auto [v, w] : adj[u]) {
          float nd = d + w;
          if (nd < dist[v]) {
            dist[v] = nd;
            pq.emplace(nd, v);
          }
        }
      }
      std::memcpy(out + s * V, dist.data(), V * sizeof(float));
    }
  };
  if (n_threads <= 1 || S <= 1) {
    worker(0, 1);
  } else {
    std::vector<std::thread> pool;
    for (unsigned t = 0; t < n_threads; ++t)
      pool.emplace_back(worker, t, n_threads);
    for (auto& th : pool) th.join();
  }
}

// Steiner-point geodesics: Dijkstra over a refined graph with k extra nodes per
// edge and complete connections among the (3 + 3k) nodes bordering each face.
// Converges to the true polyhedral geodesic as k grows (error ~ O(1/k));
// substantially more accurate than vertex-graph Dijkstra for few-source queries.
// verts: (V,3) float64; faces: (F,3) int64; sources: (S,) int64 (vertex ids);
// out: (S, V) float32 distances at original vertices.
void dnet_steiner_geodesics(const double* verts, int64_t V, const int64_t* faces,
                            int64_t F, const int64_t* sources, int64_t S,
                            int32_t k_steiner, float* out) {
  const int32_t k = k_steiner;
  // ---- node table: originals [0, V); Steiner nodes appended per unique edge
  struct PairHash {
    size_t operator()(const std::pair<int64_t, int64_t>& p) const {
      return std::hash<int64_t>()(p.first * 0x9e3779b97f4a7c15LL + p.second);
    }
  };
  std::unordered_map<std::pair<int64_t, int64_t>, int64_t, PairHash> edge_base;
  std::vector<double> pos(verts, verts + 3 * V);

  auto edge_key = [](int64_t a, int64_t b) {
    return std::make_pair(std::min(a, b), std::max(a, b));
  };

  // first pass: allocate Steiner nodes on unique edges
  for (int64_t f = 0; f < F; ++f) {
    for (int c = 0; c < 3; ++c) {
      int64_t a = faces[3 * f + c], b = faces[3 * f + (c + 1) % 3];
      auto key = edge_key(a, b);
      if (edge_base.count(key)) continue;
      int64_t base = pos.size() / 3;
      edge_base[key] = base;
      for (int32_t s = 1; s <= k; ++s) {
        double t = double(s) / (k + 1);
        for (int d = 0; d < 3; ++d)
          pos.push_back((1.0 - t) * verts[3 * key.first + d]
                        + t * verts[3 * key.second + d]);
      }
    }
  }
  int64_t N = pos.size() / 3;

  auto dist3 = [&](int64_t a, int64_t b) {
    double d2 = 0.0;
    for (int d = 0; d < 3; ++d) {
      double dd = pos[3 * a + d] - pos[3 * b + d];
      d2 += dd * dd;
    }
    return static_cast<float>(std::sqrt(d2));
  };

  // second pass: complete graph among each face's boundary nodes
  std::vector<std::vector<std::pair<int32_t, float>>> adj(N);
  std::vector<int64_t> ring;
  for (int64_t f = 0; f < F; ++f) {
    ring.clear();
    for (int c = 0; c < 3; ++c) {
      int64_t a = faces[3 * f + c], b = faces[3 * f + (c + 1) % 3];
      ring.push_back(a);
      auto key = edge_key(a, b);
      int64_t base = edge_base[key];
      if (a <= b) {
        for (int32_t s = 0; s < k; ++s) ring.push_back(base + s);
      } else {
        for (int32_t s = k - 1; s >= 0; --s) ring.push_back(base + s);
      }
    }
    for (size_t i = 0; i < ring.size(); ++i)
      for (size_t j = i + 1; j < ring.size(); ++j) {
        float w = dist3(ring[i], ring[j]);
        adj[ring[i]].emplace_back(static_cast<int32_t>(ring[j]), w);
        adj[ring[j]].emplace_back(static_cast<int32_t>(ring[i]), w);
      }
  }
  for (auto& nbrs : adj) {
    std::sort(nbrs.begin(), nbrs.end());
    nbrs.erase(std::unique(nbrs.begin(), nbrs.end()), nbrs.end());
  }

  // independent per-source Dijkstras fanned over hardware threads
  // (replaces the reference's Python multiprocessing.Pool, geometry.py:862)
  unsigned n_threads = std::max<unsigned>(1, std::thread::hardware_concurrency());
  auto worker = [&](int64_t begin, int64_t step) {
    std::vector<float> dist(N);
    using QE = std::pair<float, int32_t>;
    for (int64_t s = begin; s < S; s += step) {
      std::fill(dist.begin(), dist.end(),
                std::numeric_limits<float>::infinity());
      std::priority_queue<QE, std::vector<QE>, std::greater<QE>> pq;
      dist[sources[s]] = 0.0f;
      pq.emplace(0.0f, static_cast<int32_t>(sources[s]));
      while (!pq.empty()) {
        auto [d, u] = pq.top();
        pq.pop();
        if (d > dist[u]) continue;
        for (auto [v, w] : adj[u]) {
          float nd = d + w;
          if (nd < dist[v]) {
            dist[v] = nd;
            pq.emplace(nd, v);
          }
        }
      }
      std::memcpy(out + s * V, dist.data(), V * sizeof(float));
    }
  };
  if (n_threads <= 1 || S <= 1) {
    worker(0, 1);
  } else {
    std::vector<std::thread> pool;
    for (unsigned t = 0; t < n_threads; ++t)
      pool.emplace_back(worker, t, n_threads);
    for (auto& th : pool) th.join();
  }
}

}  // extern "C"
