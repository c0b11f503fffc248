// Native SAH BVH builder → threaded flat arrays.
//
// C++ implementation of the scene compiler's hottest host-side loop: the
// full-sweep SAH build the reference does in Rust
// (/root/reference/src/aggregate/bvh.rs:24-124) — identical cost model
// (sort per axis, prefix/suffix bound sweeps, cost = 0.125 +
// (nL·SA_L + nR·SA_R)/SA_parent, leaf when best cost > count) — plus the
// hit/miss-link threading and LEAF_SIZE leaf chaining that ops/bvh.py
// needs for stackless traversal. Exposed via a plain C ABI for ctypes.
//
// Build: make -C native  (produces native/libbvh.so)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kLeafSize = 4;

struct Bounds {
  float mn[3];
  float mx[3];
  void init() {
    for (int i = 0; i < 3; i++) {
      mn[i] = std::numeric_limits<float>::infinity();
      mx[i] = -std::numeric_limits<float>::infinity();
    }
  }
  void merge(const float* bmn, const float* bmx) {
    for (int i = 0; i < 3; i++) {
      mn[i] = std::min(mn[i], bmn[i]);
      mx[i] = std::max(mx[i], bmx[i]);
    }
  }
  double surface_area() const {
    double d0 = std::max(0.0f, mx[0] - mn[0]);
    double d1 = std::max(0.0f, mx[1] - mn[1]);
    double d2 = std::max(0.0f, mx[2] - mn[2]);
    return 2.0 * (d0 * d1 + d0 * d2 + d1 * d2);
  }
};

struct Node {
  bool leaf;
  int first, count;   // leaves
  int left, right;    // internal
  Bounds b;
};

struct Builder {
  const float* bmin;  // (n,3)
  const float* bmax;
  std::vector<float> center;  // (n,3)
  std::vector<int> order;
  std::vector<Node> nodes;
  // scratch for sweeps
  std::vector<int> scratch_idx;
  std::vector<double> fwd_sa, bwd_sa;

  int build(int lo, int hi) {
    int count = hi - lo;
    int me = (int)nodes.size();
    nodes.push_back(Node{});
    Node& reserve = nodes[me];
    Bounds full;
    full.init();
    for (int i = lo; i < hi; i++) {
      int p = order[i];
      full.merge(bmin + 3 * p, bmax + 3 * p);
    }
    if (count <= 1) {
      nodes[me] = Node{true, lo, count, -1, -1, full};
      return me;
    }
    (void)reserve;

    double best_cost = std::numeric_limits<double>::infinity();
    int best_axis = -1, best_k = -1;
    std::vector<int> best_sorted;
    double sa_parent = std::max(full.surface_area(), 1e-20);

    for (int axis = 0; axis < 3; axis++) {
      scratch_idx.assign(order.begin() + lo, order.begin() + hi);
      std::stable_sort(scratch_idx.begin(), scratch_idx.end(), [&](int a, int b) {
        return center[3 * a + axis] < center[3 * b + axis];
      });
      fwd_sa.resize(count);
      bwd_sa.resize(count);
      Bounds acc;
      acc.init();
      for (int i = 0; i < count; i++) {
        int p = scratch_idx[i];
        acc.merge(bmin + 3 * p, bmax + 3 * p);
        fwd_sa[i] = acc.surface_area();
      }
      acc.init();
      for (int i = count - 1; i >= 0; i--) {
        int p = scratch_idx[i];
        acc.merge(bmin + 3 * p, bmax + 3 * p);
        bwd_sa[i] = acc.surface_area();
      }
      for (int i = 0; i + 1 < count; i++) {
        double cost =
            0.125 + ((i + 1) * fwd_sa[i] + (count - 1 - i) * bwd_sa[i + 1]) / sa_parent;
        if (cost < best_cost) {
          best_cost = cost;
          best_k = i;
          if (axis != best_axis) {
            best_axis = axis;
            best_sorted = scratch_idx;
          }
        }
      }
    }

    if (best_cost > (double)count || best_axis < 0) {
      nodes[me] = Node{true, lo, count, -1, -1, full};
      return me;
    }
    std::copy(best_sorted.begin(), best_sorted.end(), order.begin() + lo);
    int left = build(lo, lo + best_k + 1);
    int right = build(lo + best_k + 1, hi);
    nodes[me] = Node{false, -1, 0, left, right, full};
    return me;
  }
};

struct Emitter {
  const std::vector<Node>* nodes;
  float* fb_min;
  float* fb_max;
  int32_t* fhit;
  int32_t* fmiss;
  int32_t* ffirst;
  int32_t* fcount;
  int n_emitted = 0;
  int capacity = 0;

  int alloc(const Bounds& b, int first, int count, int hit, int miss) {
    int me = n_emitted++;
    if (me >= capacity) return -1000000;  // overflow guard (checked by caller)
    std::memcpy(fb_min + 3 * me, b.mn, 12);
    std::memcpy(fb_max + 3 * me, b.mx, 12);
    ffirst[me] = first;
    fcount[me] = count;
    fhit[me] = hit;
    fmiss[me] = miss;
    return me;
  }

  // miss == -3 is the "patch to right sibling" placeholder
  int emit(int node_id, int miss) {
    const Node& node = (*nodes)[node_id];
    if (node.leaf) {
      int me = n_emitted;
      int count = node.count, first = node.first;
      int pieces = (count + kLeafSize - 1) / kLeafSize;
      if (pieces == 0) pieces = 1;
      for (int i = 0; i < pieces; i++) {
        int f0 = first + i * kLeafSize;
        int c0 = std::min(kLeafSize, count - i * kLeafSize);
        if (c0 < 0) c0 = 0;
        int nxt = (i == pieces - 1) ? miss : n_emitted + 1;
        alloc(node.b, f0, c0, nxt, nxt);
      }
      return me;
    }
    int me = alloc(node.b, -1, 0, -2, miss);
    int mark = n_emitted;
    emit(node.left, -3);
    int rid = emit(node.right, miss);
    fhit[me] = me + 1;
    for (int j = mark; j < rid; j++) {
      if (fmiss[j] == -3) fmiss[j] = rid;
      if (fhit[j] == -3) fhit[j] = rid;
    }
    return me;
  }
};

}  // namespace

extern "C" {

// Returns number of flat nodes, or -1 on capacity overflow.
// Output arrays must have capacity `cap` nodes (cap = 4n is always enough:
// ≤ 2n-1 tree nodes + ≤ n extra chained leaf pieces).
int bvh_sah_build_flat(const float* bmin, const float* bmax, int n,
                       float* out_bmin, float* out_bmax, int32_t* out_hit,
                       int32_t* out_miss, int32_t* out_first, int32_t* out_count,
                       int32_t* out_order, int cap) {
  if (n <= 0) return 0;
  Builder b;
  b.bmin = bmin;
  b.bmax = bmax;
  b.center.resize(3 * n);
  for (int i = 0; i < 3 * n; i++) b.center[i] = 0.5f * (bmin[i] + bmax[i]);
  b.order.resize(n);
  for (int i = 0; i < n; i++) b.order[i] = i;
  b.nodes.reserve(2 * n);
  b.build(0, n);

  Emitter e;
  e.nodes = &b.nodes;
  e.fb_min = out_bmin;
  e.fb_max = out_bmax;
  e.fhit = out_hit;
  e.fmiss = out_miss;
  e.ffirst = out_first;
  e.fcount = out_count;
  e.capacity = cap;
  e.emit(0, -1);
  if (e.n_emitted > cap) return -1;

  for (int i = 0; i < n; i++) out_order[i] = b.order[i];
  return e.n_emitted;
}
}
