// Exact polyhedral geodesics via ICH (improved Chen-Han continuous Dijkstra)
// with MMP-style pairwise window trimming, the exact-geodesic capability
// matching the reference's use of libigl's MMP (reference geometry.py:784-794).
// Computes exact source-to-all-VERTICES distances, which is precisely what the
// geodesic-error metric consumes (geometry.py:768-770).
//
// Algorithm: windows (unfolded source images over directed half-edges)
// propagate across faces in a priority queue ordered by minimal window
// distance; saddle/boundary vertices spawn pseudo-sources from their settled
// labels. Window count is controlled by two exact prunes:
//   1. vertex-label trimming — the MMP endpoint lemma applied as an interval
//      CLIP (a window loses a prefix to the through-src path and a suffix to
//      the through-dst path; the crossover is a 1-D quadratic);
//   2. pairwise window trimming — windows stored per edge are kept PAIRWISE
//      NON-OVERLAPPING: an incoming window is clipped against each stored
//      window at the (unique, MMP Lemma) crossing of their distance functions,
//      and stored windows are symmetrically clipped/split/killed where the
//      newcomer wins. The queue holds window IDs, so a clipped or killed
//      window never propagates its stale extent.
// A hard budget on queue pops guards pathological inputs; the caller falls
// back to Steiner-refined Dijkstra on failure.
//
// Mesh assumptions: triangle mesh, edge-manifold and consistently oriented
// (each directed edge appears at most once). Returns 1 on success, 0 when the
// mesh is non-manifold or the window budget is exceeded.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <unordered_map>
#include <vector>

namespace ich {

constexpr double kEps = 1e-12;
constexpr double kMinWin = 1e-12;  // minimum surviving interval width

// plain sqrt beats std::hypot ~3x in the innermost loops; coordinates here
// are O(mesh diameter) so hypot's over/underflow guards buy nothing
inline double dist2d(double dx, double dy) {
  return std::sqrt(dx * dx + dy * dy);
}

struct HalfEdge {
  int32_t dst = -1;    // head vertex
  int32_t src = -1;    // tail vertex
  int32_t twin = -1;   // opposite half-edge (-1 on boundary)
  int32_t next = -1;   // next half-edge in the face (ccw)
  int32_t face = -1;
  double len = 0.0;
};

// A window: interval [b0, b1] on half-edge `he` (param measured from src) with
// the unfolded pseudo-source at (sx, sy), sy >= 0, and accumulated distance
// sigma from the pseudo-source to the true source.
struct StoredWin {
  double b0, b1;
  double sx, sy;
  double sigma;
  int32_t he;
  bool dead;
};

// distance carried by window w to edge parameter p
inline double fdist(const StoredWin& w, double p) {
  return w.sigma + dist2d(p - w.sx, w.sy);
}

struct QEntry {
  double key;       // sigma + min distance to the interval (at push time)
  int32_t id;       // index into store_, or -1 for a vertex event
  int32_t vevent;   // >= 0: vertex-settled event — when popped (in key order)
  // the vertex's label is final and, if it is a saddle or boundary vertex,
  // its pseudo-source windows are spawned exactly then
};

// 8-ary min-heap: ~3x shallower than a binary heap and each child scan
// touches one 128-byte cache line (8 x 16B entries); sift-down dominates
// pop cost, and the PQ is ~30% of solve time at 10k vertices.
class PQ8 {
 public:
  bool empty() const { return v_.empty(); }
  size_t size() const { return v_.size(); }
  void reserve(size_t n) { v_.reserve(n); }
  const QEntry& top() const { return v_[0]; }

  void push(const QEntry& e) {
    size_t i = v_.size();
    v_.push_back(e);
    while (i > 0) {
      size_t p = (i - 1) >> 3;
      if (v_[p].key <= e.key) break;
      v_[i] = v_[p];
      i = p;
    }
    v_[i] = e;
  }

  void pop() {
    QEntry last = v_.back();
    v_.pop_back();
    if (v_.empty()) return;
    size_t n = v_.size(), i = 0;
    for (;;) {
      size_t c0 = (i << 3) + 1;
      if (c0 >= n) break;
      size_t cend = std::min(c0 + 8, n);
      size_t m = c0;
      double mk = v_[c0].key;
      for (size_t c = c0 + 1; c < cend; ++c)
        if (v_[c].key < mk) { mk = v_[c].key; m = c; }
      if (mk >= last.key) break;
      v_[i] = v_[m];
      i = m;
    }
    v_[i] = last;
  }

 private:
  std::vector<QEntry> v_;
};

class Solver {
 public:
  // returns false if the mesh is unusable (non-manifold / non-oriented)
  bool build(const double* verts, int64_t V, const int64_t* faces, int64_t F) {
    V_ = V;
    pos_ = verts;
    he_.clear();
    he_.reserve(3 * F);
    std::unordered_map<int64_t, int32_t> half;  // (u<<32|v) -> he index
    half.reserve(3 * F);

    auto vkey = [&](int64_t u, int64_t v) { return (u << 32) | v; };

    for (int64_t f = 0; f < F; ++f) {
      int32_t base = static_cast<int32_t>(he_.size());
      for (int c = 0; c < 3; ++c) {
        int64_t u = faces[3 * f + c], v = faces[3 * f + (c + 1) % 3];
        if (u == v) return false;
        HalfEdge h;
        h.src = static_cast<int32_t>(u);
        h.dst = static_cast<int32_t>(v);
        h.face = static_cast<int32_t>(f);
        h.next = base + (c + 1) % 3;
        double d2 = 0.0;
        for (int k = 0; k < 3; ++k) {
          double d = pos_[3 * v + k] - pos_[3 * u + k];
          d2 += d * d;
        }
        h.len = std::sqrt(d2);
        if (h.len < kEps) return false;
        auto key = vkey(u, v);
        if (half.count(key)) return false;  // non-oriented / non-manifold
        half[key] = static_cast<int32_t>(he_.size());
        he_.push_back(h);
      }
    }
    for (size_t i = 0; i < he_.size(); ++i) {
      auto it = half.find(vkey(he_[i].dst, he_[i].src));
      he_[i].twin = (it == half.end()) ? -1 : it->second;
    }

    // outgoing half-edge lists + total angle per vertex (saddle detection)
    out_.assign(V_, {});
    angle_.assign(V_, 0.0);
    for (size_t i = 0; i < he_.size(); ++i) {
      out_[he_[i].src].push_back(static_cast<int32_t>(i));
      // corner angle at src of this half-edge within its face
      const HalfEdge& a = he_[i];
      const HalfEdge& c = he_[he_[a.next].next];  // incoming at src
      double la = a.len, lb = he_[a.next].len, lc = c.len;
      double cosv = (la * la + lc * lc - lb * lb) / (2.0 * la * lc);
      cosv = std::max(-1.0, std::min(1.0, cosv));
      angle_[a.src] += std::acos(cosv);
    }
    boundary_.assign(V_, false);
    for (const auto& h : he_)
      if (h.twin < 0) {
        boundary_[h.src] = true;
        boundary_[h.dst] = true;
      }
    return true;
  }

  // single-source exact distances to all vertices; false on budget overflow
  bool solve(int64_t source, float* out_dist, int64_t window_budget) {
    dist_.assign(V_, std::numeric_limits<double>::infinity());
    n_inf_ = V_;
    maxlab_ = std::numeric_limits<double>::infinity();
    store_.clear();
    // reuse per-edge id lists across solves (keeps their capacity instead of
    // reallocating ~3F vectors per source)
    if (edge_ids_.size() != he_.size()) {
      edge_ids_.assign(he_.size(), {});
    } else {
      for (auto& lst : edge_ids_) lst.clear();
    }
    PQ pq;
    pq.reserve(4096);
    processed_ = 0;
    budget_ = window_budget;

    dist_[source] = 0.0;
    --n_inf_;
    // initial windows: full opposite edge of every face incident to source
    for (int32_t hi : out_[source]) {
      const HalfEdge& h = he_[hi];
      push_source_windows(pq, h.next, source, 0.0);
      relax(pq, h.dst, h.len);  // direct edge distance
    }

    while (!pq.empty()) {
      QEntry q = pq.top();
      pq.pop();
      if (++processed_ > budget_) return false;
      // Early exit: only VERTEX distances are requested. Queue keys are
      // non-decreasing (continuous Dijkstra), labels only decrease, and any
      // relaxation from an entry with key k yields a distance >= k — so once
      // every label is finite and the minimum key reaches the largest label,
      // no label can strictly improve and the remaining queue (interior
      // window refinement) is irrelevant. maxlab_ is refreshed lazily; a
      // stale value only over-estimates the true max, which merely delays
      // the exit.
      if (n_inf_ == 0) {
        if ((processed_ & 2047) == 0) {
          double m = 0.0;
          for (int64_t v = 0; v < V_; ++v) m = std::max(m, dist_[v]);
          maxlab_ = m;
        }
        if (q.key >= maxlab_) break;
      }
      if (q.vevent >= 0) {
        // spawn only if this event still matches the best label (stale events
        // from earlier, larger labels are skipped cheaply)
        if (q.key <= dist_[q.vevent] + 1e-15) spawn_pseudo(pq, q.vevent);
        continue;
      }
      if (store_[q.id].dead) continue;
      // re-trim with the vertex labels as of NOW (tighter than at push time);
      // stale queue entries die or shrink here before any unfolding work.
      // The stored entry is updated so later arrivals clip against the
      // tightened interval.
      StoredWin w = store_[q.id];
      if (!trim_stored(w)) {
        store_[q.id].dead = true;
        continue;
      }
      store_[q.id].b0 = w.b0;
      store_[q.id].b1 = w.b1;
      propagate(pq, w);
    }
    for (int64_t v = 0; v < V_; ++v)
      out_dist[v] = static_cast<float>(dist_[v]);
    return true;
  }

 private:
  using PQ = PQ8;

  // Improve a vertex distance. Every improvement at a saddle/boundary vertex
  // must eventually spawn its pseudo-source windows — geodesics bend around
  // such vertices, and a label improved through an edge-endpoint relaxation
  // covers paths the window propagation alone would miss (classic MMP/CH
  // invariant). Spawning is deferred to a vertex event popped in key order,
  // so each vertex spawns once, from its settled (final) label.
  void relax(PQ& pq, int32_t v, double d) {
    if (d < dist_[v]) {
      if (std::isinf(dist_[v])) --n_inf_;
      dist_[v] = d;
      if (boundary_[v] || angle_[v] > 2.0 * M_PI + 1e-9) {
        pq.push({d, -1, v});
      }
    }
  }

  // windows from a (pseudo)source AT A VERTEX `src_v` with accumulated sigma,
  // placed on half-edge `hi` (an edge of a face incident to src_v, opposite it)
  void push_source_windows(PQ& pq, int32_t hi, int32_t src_v, double sigma) {
    const HalfEdge& h = he_[hi];
    double dA = 0.0, dB = 0.0;
    for (int k = 0; k < 3; ++k) {
      double a = pos_[3 * h.src + k] - pos_[3 * src_v + k];
      double b = pos_[3 * h.dst + k] - pos_[3 * src_v + k];
      dA += a * a;
      dB += b * b;
    }
    dA = std::sqrt(dA);
    dB = std::sqrt(dB);
    insert_window(pq, hi, 0.0, h.len, dA, dB, sigma);
  }

  void spawn_pseudo(PQ& pq, int32_t v) {
    double sig = dist_[v];
    for (int32_t hi : out_[v]) push_source_windows(pq, he_[hi].next, v, sig);
  }

  // Interval trimming against the edge-endpoint vertex labels — the MMP
  // endpoint lemma applied as a CLIP instead of an all-or-nothing drop.
  // Window distance along the edge parameter p:  f(p) = sigma + |(p,0)-(sx,sy)|
  // vs the through-src path  g_a(p) = dist[src] + p        (f-g_a decreasing)
  // and the through-dst path g_b(p) = dist[dst] + (L - p)  (f-g_b increasing),
  // so src-domination removes a PREFIX and dst-domination a SUFFIX of [b0,b1].
  // Labels only ever decrease, so trimming with the current labels is
  // conservative-safe. Returns false when nothing survives.
  bool trim_stored(StoredWin& w) const {
    const HalfEdge& h = he_[w.he];
    // endpoint distances computed once; after a clip the new endpoint sits ON
    // the crossing, where the window distance equals the vertex path exactly
    double f0 = fdist(w, w.b0), f1 = fdist(w, w.b1);
    double ds = dist_[h.src];
    if (ds + w.b0 <= f0 + kEps) {  // src path wins at b0
      if (ds + w.b1 <= f1 + kEps) return false;
      double c = ds - w.sigma;  // solve sqrt((p-sx)^2+sy^2) = c + p
      double den = 2.0 * (w.sx + c);
      if (std::fabs(den) > kEps) {
        double p = (w.sx * w.sx + w.sy * w.sy - c * c) / den;
        if (p > w.b0 && p < w.b1) {
          w.b0 = p;
          f0 = w.sigma + c + p;  // = fdist(w, p) at the crossing
        }
      }
    }
    double dd = dist_[h.dst], L = h.len;
    if (dd + (L - w.b1) <= f1 + kEps) {  // dst path wins at b1
      if (dd + (L - w.b0) <= f0 + kEps) return false;
      double c2 = dd + L - w.sigma;  // solve sqrt((p-sx)^2+sy^2) = c2 - p
      double den = 2.0 * (c2 - w.sx);
      if (std::fabs(den) > kEps) {
        double p = (c2 * c2 - w.sx * w.sx - w.sy * w.sy) / den;
        if (p > w.b0 && p < w.b1) w.b1 = p;
      }
    }
    return w.b1 - w.b0 >= kMinWin;
  }

  // unique crossing of fdist(a,.) - fdist(b,.) on [lo, hi] (MMP Lemma: two
  // windows' distance functions cross at most once on their overlap).
  // Analytic: A - B = k with A/B the source distances linearizes to
  // B = gamma*u + delta, then one more squaring gives a quadratic in u;
  // roots are validated in-interval with the sign structure, falling back to
  // bisection when the algebra degenerates (near-equal sources, k ~ 0 etc.).
  static double cross_param(const StoredWin& a, const StoredWin& b,
                            double lo, double hi, bool a_wins_lo) {
    double k = b.sigma - a.sigma;
    double alpha = 2.0 * (b.sx - a.sx);
    double beta = a.sx * a.sx + a.sy * a.sy - b.sx * b.sx - b.sy * b.sy;
    double span = hi - lo;
    if (std::fabs(k) < 1e-14) {
      // equal sigma: crossing where the squared distances match (linear)
      if (std::fabs(alpha) > 1e-14) {
        double u = -beta / alpha;
        if (u > lo && u < hi) return u;
      }
    } else {
      double gamma = alpha / (2.0 * k);
      double delta = (beta - k * k) / (2.0 * k);
      // (u - bx)^2 + by^2 = (gamma u + delta)^2
      double qa = 1.0 - gamma * gamma;
      double qb = -2.0 * (b.sx + gamma * delta);
      double qc = b.sx * b.sx + b.sy * b.sy - delta * delta;
      double u = std::numeric_limits<double>::quiet_NaN();
      if (std::fabs(qa) < 1e-14) {
        if (std::fabs(qb) > 1e-14) u = -qc / qb;
        if (u > lo && u < hi && gamma * u + delta >= 0.0) return u;
      } else {
        double disc = qb * qb - 4.0 * qa * qc;
        if (disc >= 0.0) {
          double sq = std::sqrt(disc);
          for (double r : {(-qb - sq) / (2.0 * qa), (-qb + sq) / (2.0 * qa)}) {
            if (r > lo && r < hi && gamma * r + delta >= 0.0
                && std::fabs(fdist(a, r) - fdist(b, r)) < 1e-9 * (1.0 + span))
              return r;
          }
        }
      }
    }
    // fallback: bisection (also handles roots rejected by rounding)
    for (int it = 0; it < 40 && hi - lo > 1e-13; ++it) {
      double mid = 0.5 * (lo + hi);
      if ((fdist(a, mid) < fdist(b, mid)) == a_wins_lo) lo = mid;
      else hi = mid;
    }
    return 0.5 * (lo + hi);
  }

  // dynamic piece buffers (member vectors reused across inserts, so their
  // capacity persists and the hot path never allocates): the previous
  // fixed-capacity buffer committed an UNCLIPPED piece on overflow, which
  // could leave two STORED windows overlapping — breaking the
  // pairwise-disjointness invariant the single-win-region clip below relies
  // on, and thus (rarely, on very high-valence edges) a silent distance
  // overestimate in an 'exact' solver. Unbounded buffers make overflow
  // structurally impossible.
  using Pieces = std::vector<StoredWin>;

  // pc minus [lo, hi] -> up to two surviving pieces appended to `out`
  static void subtract_interval(const StoredWin& pc, double lo, double hi,
                                Pieces& out) {
    if (lo - pc.b0 >= kMinWin) {
      StoredWin l = pc;
      l.b1 = lo;
      out.push_back(l);
    }
    if (pc.b1 - hi >= kMinWin) {
      StoredWin r = pc;
      r.b0 = hi;
      out.push_back(r);
    }
  }

  void commit(PQ& pq, const StoredWin& w) {
    double m = (w.sx < w.b0)   ? dist2d(w.b0 - w.sx, w.sy)
               : (w.sx > w.b1) ? dist2d(w.b1 - w.sx, w.sy)
                               : w.sy;
    // windows whose minimum possible distance already exceeds every vertex
    // label can never improve a label (see the solve-loop early exit) —
    // dropping them (not stored, not queued) loses only redundant coverage
    if (w.sigma + m >= maxlab_) return;
    int32_t id = static_cast<int32_t>(store_.size());
    store_.push_back(w);
    edge_ids_[w.he].push_back(id);
    pq.push({w.sigma + m, id, -1});
  }

  // remove [lo, hi] (where the newcomer wins) from stored window `id`
  void clip_stored(PQ& pq, int32_t id, double lo, double hi) {
    StoredWin e = store_[id];
    bool left = lo - e.b0 >= kMinWin;
    bool right = e.b1 - hi >= kMinWin;
    if (left && right) {
      StoredWin r = e;
      r.b0 = hi;
      store_[id].b1 = lo;  // shrink in place: its queue entry stays valid
      commit(pq, r);       // the right part needs its own queue entry
    } else if (left) {
      store_[id].b1 = lo;
    } else if (right) {
      store_[id].b0 = hi;
    } else {
      store_[id].dead = true;
    }
  }

  // Insert a window (b0..b1 on half-edge `hi_edge`, endpoint source distances
  // d0/d1, accumulated sigma): relax edge-end vertices, clip against vertex
  // labels, then mutually clip against the windows already stored on the edge
  // so alive windows stay pairwise non-overlapping.
  void insert_window(PQ& pq, int32_t hi_edge, double b0, double b1,
                     double d0, double d1, double sigma) {
    const HalfEdge& h = he_[hi_edge];
    b0 = std::max(0.0, b0);
    b1 = std::min(h.len, b1);
    if (b1 - b0 < kMinWin) return;

    // canonical planar source position from (b0, b1, d0, d1)
    double dx = b1 - b0;
    double x = (d0 * d0 - d1 * d1 + b1 * b1 - b0 * b0) / (2.0 * dx);
    double y2 = d0 * d0 - (x - b0) * (x - b0);
    StoredWin w{b0, b1, x, (y2 <= 0.0) ? 0.0 : std::sqrt(y2),
                sigma, hi_edge, false};

    // endpoint relaxations (valid whenever the interval reaches the vertex)
    if (w.b0 < 1e-9) relax(pq, h.src, fdist(w, 0.0));
    if (w.b1 > h.len - 1e-9) relax(pq, h.dst, fdist(w, h.len));

    if (!trim_stored(w)) return;

    Pieces* pieces = &pieces_a_;
    Pieces* nextp = &pieces_b_;
    pieces->clear();
    nextp->clear();
    pieces->push_back(w);
    auto& lst = edge_ids_[hi_edge];
    // lazy compaction: dead ids otherwise accumulate and make this scan
    // quadratic on churn-heavy edges
    if (lst.size() > 16) {
      size_t dead = 0;
      for (int32_t id : lst) dead += store_[id].dead;
      if (2 * dead > lst.size()) {
        size_t out = 0;
        for (int32_t id : lst)
          if (!store_[id].dead) lst[out++] = id;
        lst.resize(out);
      }
    }
    size_t n0 = lst.size();  // ids appended during this insert (via
    // clip_stored splits) are already consistent with the candidate
    for (size_t li = 0; li < n0 && !pieces->empty(); ++li) {
      int32_t eid = lst[li];
      if (store_[eid].dead) continue;
      StoredWin e = store_[eid];  // copy: store_ may reallocate below
      Pieces& next = *nextp;
      next.clear();
      // stored windows are pairwise disjoint, and candidate pieces are only
      // separated by intervals owned by OTHER stored windows — so at most one
      // contiguous candidate-win region lies inside e
      double win_lo = 1e300, win_hi = -1e300;
      for (const StoredWin& pc : *pieces) {
        double lo = std::max(pc.b0, e.b0), hi2 = std::min(pc.b1, e.b1);
        if (hi2 - lo < kMinWin) {
          next.push_back(pc);
          continue;
        }
        // ties favor the incumbent (strict '<' with slack): an identical
        // duplicate window is absorbed instead of accumulating
        bool pc_lo = fdist(pc, lo) < fdist(e, lo) - kEps;
        bool pc_hi = fdist(pc, hi2) < fdist(e, hi2) - kEps;
        if (!pc_lo && !pc_hi) {
          // incumbent keeps the overlap: subtract it from the candidate
          subtract_interval(pc, lo, hi2, next);
        } else if (pc_lo && pc_hi) {
          win_lo = std::min(win_lo, lo);
          win_hi = std::max(win_hi, hi2);
          next.push_back(pc);
        } else {
          double p = cross_param(pc, e, lo, hi2, pc_lo);
          if (pc_lo) {
            win_lo = std::min(win_lo, lo);
            win_hi = std::max(win_hi, p);
            subtract_interval(pc, p, hi2, next);
          } else {
            win_lo = std::min(win_lo, p);
            win_hi = std::max(win_hi, hi2);
            subtract_interval(pc, lo, p, next);
          }
        }
      }
      std::swap(pieces, nextp);
      if (win_hi - win_lo >= kMinWin) clip_stored(pq, eid, win_lo, win_hi);
    }
    for (const StoredWin& pc : *pieces)
      if (pc.b1 - pc.b0 >= kMinWin) commit(pq, pc);
  }

  void propagate(PQ& pq, const StoredWin& w) {
    const HalfEdge& h = he_[w.he];
    if (h.twin < 0) return;  // boundary: nothing beyond

    double sx = w.sx, sy = w.sy;

    const HalfEdge& t = he_[h.twin];             // dst->src direction
    const HalfEdge& e1 = he_[t.next];            // h.src -> apex (at x=0)
    const HalfEdge& e2 = he_[e1.next];           // apex -> h.dst (at x=L)
    double L = h.len;
    // unfold the twin face below the x-axis: apex at (ax, ay<=0) from lengths
    // |h.src-apex| = e1.len (from x=0), |h.dst-apex| = e2.len (from x=L)
    double ax = (e1.len * e1.len - e2.len * e2.len + L * L) / (2.0 * L);
    double ay2 = e1.len * e1.len - ax * ax;
    double ay = (ay2 <= 0.0) ? 0.0 : -std::sqrt(ay2);
    int32_t apex = e1.dst;

    // distance source -> apex through this window's unfolding
    double d_apex = dist2d(sx - ax, sy - ay);

    // rays from source through interval endpoints (on the x-axis at b0/b1)
    // continue into y < 0; intersect with the far edges e1 (x=0..apex) and
    // e2 (apex..x=L)
    auto intersect = [&](double bx, double px, double py, double qx, double qy,
                         double& tt, double& ix, double& iy) -> bool {
      double rx = bx - sx, ry = -sy;
      double ex = qx - px, ey = qy - py;
      double den = rx * ey - ry * ex;
      if (std::fabs(den) < kEps) return false;
      double ss = ((px - sx) * ey - (py - sy) * ex) / den;
      tt = (std::fabs(ex) > std::fabs(ey))
               ? ((sx + ss * rx) - px) / ex
               : ((sy + ss * ry) - py) / ey;
      if (ss < 1.0 - 1e-6) return false;  // must pass BEYOND the shared edge
      ix = sx + ss * rx;
      iy = sy + ss * ry;
      return tt >= -1e-9 && tt <= 1.0 + 1e-9;
    };

    // side of the apex relative to each boundary ray (sign of the cross
    // product of ray direction with (apex - source))
    auto side_of_apex = [&](double bx) {
      return (bx - sx) * (ay - sy) - (0.0 - sy) * (ax - sx);
    };
    double c0 = side_of_apex(w.b0);
    double c1 = side_of_apex(w.b1);

    struct Hit { bool ok; double t, x, y; };
    auto hit_left = [&](double bx) {
      Hit r{false, 0, 0, 0};
      r.ok = intersect(bx, 0.0, 0.0, ax, ay, r.t, r.x, r.y);
      return r;
    };
    auto hit_right = [&](double bx) {
      Hit r{false, 0, 0, 0};
      r.ok = intersect(bx, ax, ay, L, 0.0, r.t, r.x, r.y);
      return r;
    };

    auto push = [&](int32_t edge_he, double t_lo, double t_hi,
                    double x_lo, double y_lo, double x_hi, double y_hi,
                    double edge_len) {
      if (t_hi - t_lo < 1e-12) return;
      double nb0 = std::max(0.0, t_lo * edge_len);
      double nb1 = std::min(edge_len, t_hi * edge_len);
      if (nb1 - nb0 < 1e-12) return;
      insert_window(pq, edge_he, nb0, nb1,
                    dist2d(sx - x_lo, sy - y_lo),
                    dist2d(sx - x_hi, sy - y_hi), w.sigma);
    };
    auto push_left = [&](const Hit& a, const Hit& b) {
      push(t.next, a.t, b.t, a.x, a.y, b.x, b.y, e1.len);
    };
    auto push_right = [&](const Hit& a, const Hit& b) {
      push(e1.next, a.t, b.t, a.x, a.y, b.x, b.y, e2.len);
    };
    const Hit hit_apex_l{true, 1.0, ax, ay};   // apex endpoint on the left edge
    const Hit hit_apex_r{true, 0.0, ax, ay};   // apex endpoint on the right edge

    // strict apex-straddle test: the apex must lie INSIDE the window's cone;
    // a loose OR over ray hits can relax the apex through an invalid straight
    // line, and pseudo-sources then propagate the underestimate
    bool through_apex = (c0 > kEps && c1 < -kEps) || (c0 < -kEps && c1 > kEps);
    if (through_apex) {
      relax(pq, apex, w.sigma + d_apex);
      Hit l0 = hit_left(w.b0), r1 = hit_right(w.b1);
      if (l0.ok) push_left(l0, hit_apex_l);
      if (r1.ok) push_right(hit_apex_r, r1);
      return;
    }
    // both endpoint rays pass on one side of the apex (c > 0: left of the
    // ray is the apex -> the cone exits the LEFT far edge; c < 0: right),
    // so try that edge first — the common case costs 2 ray intersections,
    // not 4 — and keep the full fallback chain for numerical slivers
    if (c0 > 0.0 || c1 > 0.0) {
      Hit l0 = hit_left(w.b0), l1 = hit_left(w.b1);
      if (l0.ok && l1.ok) { push_left(l0, l1); return; }
      Hit r0 = hit_right(w.b0), r1 = hit_right(w.b1);
      if (r0.ok && r1.ok) { push_right(r0, r1); return; }
      if (l0.ok && r1.ok) {
        // rays hit different edges but the strict straddle test was
        // inconclusive (apex grazing a ray): split at the apex WITHOUT
        // relaxing it directly — the pushed windows' endpoint relaxations
        // reach it through valid paths
        push_left(l0, hit_apex_l);
        push_right(hit_apex_r, r1);
      }
    } else {
      Hit r0 = hit_right(w.b0), r1 = hit_right(w.b1);
      if (r0.ok && r1.ok) { push_right(r0, r1); return; }
      Hit l0 = hit_left(w.b0), l1 = hit_left(w.b1);
      if (l0.ok && l1.ok) { push_left(l0, l1); return; }
      if (l0.ok && r1.ok) {
        push_left(l0, hit_apex_l);
        push_right(hit_apex_r, r1);
      }
    }
    // remaining combinations are numerical slivers; dropping them can only
    // lose coverage (over-estimate), never produce an invalid short path
  }

  const double* pos_ = nullptr;
  int64_t V_ = 0;
  std::vector<HalfEdge> he_;
  std::vector<std::vector<int32_t>> out_;
  std::vector<double> angle_;
  std::vector<bool> boundary_;
  std::vector<double> dist_;
  int64_t processed_ = 0, budget_ = 0;
  int64_t n_inf_ = 0;   // vertices still at +inf (early exit gate)
  double maxlab_ = std::numeric_limits<double>::infinity();

 public:
  // window store + per-edge id lists (public for native test harnesses)
  std::vector<StoredWin> store_;
  std::vector<std::vector<int32_t>> edge_ids_;

 private:
  Pieces pieces_a_, pieces_b_;  // reused per insert (capacity persists)
};

}  // namespace ich

extern "C" {

// Exact geodesic distances source->all-vertices. Returns 1 when every source
// solved, 0 when some sources exceeded the window budget, -1 when the mesh is
// non-manifold/non-oriented (nothing computed). ok_out (len S, may be null)
// gets a per-source success flag so callers can patch ONLY failed rows with
// Steiner distances instead of discarding the exact result wholesale.
// out: (S, V) float32.
int32_t dnet_ich_geodesics(const double* verts, int64_t V, const int64_t* faces,
                           int64_t F, const int64_t* sources, int64_t S,
                           int64_t window_budget, float* out, int32_t* ok_out) {
  ich::Solver proto;
  if (!proto.build(verts, V, faces, F)) {
    if (ok_out) std::memset(ok_out, 0, S * sizeof(int32_t));
    return -1;
  }

  std::vector<int32_t> ok(S, 1);
  unsigned n_threads = std::max<unsigned>(1, std::thread::hardware_concurrency());
  n_threads = std::min<unsigned>(n_threads, static_cast<unsigned>(S));
  auto worker = [&](int64_t begin, int64_t step) {
    ich::Solver solver;
    solver.build(verts, V, faces, F);
    for (int64_t s = begin; s < S; s += step) {
      if (!solver.solve(sources[s], out + s * V, window_budget)) ok[s] = 0;
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
  if (ok_out) std::memcpy(ok_out, ok.data(), S * sizeof(int32_t));
  for (int64_t s = 0; s < S; ++s)
    if (!ok[s]) return 0;
  return 1;
}

}  // extern "C"
