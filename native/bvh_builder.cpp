// Native binned-SAH BLAS builder — C++ core of the scene compiler.
//
// Same algorithm and decision points as the Python reference implementation
// (gdpathtracing/bvh/blas.py), which itself re-expresses the semantics
// of the reference's C++ builder (src/bvh/bvh.cpp:24-262): top-down, 8-bin
// SAH over 3 axes, 0.8 cost slack, stable-median fallback, <=max_leaf
// leaves, identical node-index allocation order. Exposed through a C ABI
// consumed via ctypes (gdpathtracing/bvh/native.py).
//
// Determinism contract with the Python builder: float32 centroids/bounds,
// float64 SAH arithmetic, identical bin index computation, stable sort for
// the median fallback — the two builders must produce bit-identical trees
// (tested in tests/test_native_bvh.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int BINS = 8;
constexpr double INF = std::numeric_limits<double>::infinity();

struct V3 {
  float x, y, z;
  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

static inline V3 vmin(const V3 &a, const V3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(const V3 &a, const V3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

static inline double half_area(const V3 &lo, const V3 &hi) {
  double ex = std::max(0.0, double(hi.x) - double(lo.x));
  double ey = std::max(0.0, double(hi.y) - double(lo.y));
  double ez = std::max(0.0, double(hi.z) - double(lo.z));
  return ex * ey + ey * ez + ez * ex;
}

struct BuildCtx {
  const float *verts;  // (n, 9)
  std::vector<V3> cent, tmin, tmax;
  std::vector<int32_t> order;
  // node storage
  std::vector<V3> node_min, node_max;
  std::vector<int32_t> left, right, first, count;
  int max_leaf;
};

// 8-bin SAH sweep (mirror of BLASBuilder._find_sah_split). Returns true and
// sets (axis, plane) when a split beats parent_cost with the 0.8 slack.
static bool find_sah_split(BuildCtx &c, int lo, int hi, const V3 &bmin,
                           const V3 &bmax, int *out_axis, double *out_plane) {
  int n = hi - lo;
  double parent_cost = half_area(bmin, bmax) * n;
  double best_cost = INF;
  int best_axis = -1;
  double best_plane = 0.0;
  for (int axis = 0; axis < 3; ++axis) {
    float cmin = std::numeric_limits<float>::infinity();
    float cmax = -std::numeric_limits<float>::infinity();
    for (int k = lo; k < hi; ++k) {
      float v = c.cent[c.order[k]][axis];
      cmin = std::min(cmin, v);
      cmax = std::max(cmax, v);
    }
    if (cmax <= cmin) continue;
    // Match numpy: scale in float64, bin = min(int((c-cmin)*scale), 7).
    double scale = double(BINS) / (double(cmax) - double(cmin));
    int bin_counts[BINS] = {0};
    V3 bin_min[BINS], bin_max[BINS];
    for (int b = 0; b < BINS; ++b) {
      bin_min[b] = {INFINITY, INFINITY, INFINITY};
      bin_max[b] = {-INFINITY, -INFINITY, -INFINITY};
    }
    for (int k = lo; k < hi; ++k) {
      int t = c.order[k];
      int b = std::min<int>(
          int((double(c.cent[t][axis]) - double(cmin)) * scale), BINS - 1);
      bin_counts[b]++;
      bin_min[b] = vmin(bin_min[b], c.tmin[t]);
      bin_max[b] = vmax(bin_max[b], c.tmax[t]);
    }
    // prefix/suffix scans
    V3 lmin[BINS], lmax[BINS], rmin[BINS], rmax[BINS];
    int lcount[BINS], rcount[BINS];
    lmin[0] = bin_min[0]; lmax[0] = bin_max[0]; lcount[0] = bin_counts[0];
    for (int b = 1; b < BINS; ++b) {
      lmin[b] = vmin(lmin[b - 1], bin_min[b]);
      lmax[b] = vmax(lmax[b - 1], bin_max[b]);
      lcount[b] = lcount[b - 1] + bin_counts[b];
    }
    rmin[BINS - 1] = bin_min[BINS - 1]; rmax[BINS - 1] = bin_max[BINS - 1];
    rcount[BINS - 1] = bin_counts[BINS - 1];
    for (int b = BINS - 2; b >= 0; --b) {
      rmin[b] = vmin(rmin[b + 1], bin_min[b]);
      rmax[b] = vmax(rmax[b + 1], bin_max[b]);
      rcount[b] = rcount[b + 1] + bin_counts[b];
    }
    for (int i = 0; i < BINS - 1; ++i) {
      if (lcount[i] == 0 || rcount[i + 1] == 0) continue;
      double cost = lcount[i] * half_area(lmin[i], lmax[i]) +
                    rcount[i + 1] * half_area(rmin[i + 1], rmax[i + 1]);
      if (cost < best_cost) {
        best_cost = cost;
        best_axis = axis;
        best_plane = double(cmin) + double(i + 1) / scale;
      }
    }
  }
  if (best_axis < 0 || best_cost * 0.8 >= parent_cost) return false;
  *out_axis = best_axis;
  *out_plane = best_plane;
  return true;
}

}  // namespace

extern "C" {

// Build one mesh subtree. Returns the number of nodes written (< 0 on
// error). Outputs are caller-allocated with capacity 2*n_tris nodes.
// tri_order receives the permutation: position i in BVH order holds
// original triangle tri_order[i].
int32_t gdpt_build_blas(const float *tri_verts, int32_t n_tris,
                        int32_t max_leaf, float *node_min_out,
                        float *node_max_out, int32_t *node_left_out,
                        int32_t *node_right_out, int32_t *node_first_out,
                        int32_t *node_count_out, int32_t *tri_order_out) {
  if (n_tris <= 0 || max_leaf <= 0) return -1;
  BuildCtx c;
  c.verts = tri_verts;
  c.max_leaf = max_leaf;
  c.cent.resize(n_tris);
  c.tmin.resize(n_tris);
  c.tmax.resize(n_tris);
  c.order.resize(n_tris);
  for (int i = 0; i < n_tris; ++i) {
    const float *v = tri_verts + size_t(i) * 9;
    V3 v0{v[0], v[1], v[2]}, v1{v[3], v[4], v[5]}, v2{v[6], v[7], v[8]};
    // float32 centroid, same op order as numpy mean: (v0+v1+v2)/3
    c.cent[i] = {(v0.x + v1.x + v2.x) / 3.0f, (v0.y + v1.y + v2.y) / 3.0f,
                 (v0.z + v1.z + v2.z) / 3.0f};
    c.tmin[i] = vmin(vmin(v0, v1), v2);
    c.tmax[i] = vmax(vmax(v0, v1), v2);
    c.order[i] = i;
  }

  c.node_min.reserve(2 * n_tris);

  struct Item { int32_t node, lo, hi; };
  std::vector<Item> stack;
  auto alloc_node = [&]() {
    c.node_min.push_back({});
    c.node_max.push_back({});
    c.left.push_back(0);
    c.right.push_back(0);
    c.first.push_back(0);
    c.count.push_back(0);
    return int32_t(c.node_min.size() - 1);
  };
  int32_t root = alloc_node();
  stack.push_back({root, 0, n_tris});

  std::vector<int32_t> scratch;
  while (!stack.empty()) {
    Item it = stack.back();
    stack.pop_back();
    V3 bmin{INFINITY, INFINITY, INFINITY};
    V3 bmax{-INFINITY, -INFINITY, -INFINITY};
    for (int k = it.lo; k < it.hi; ++k) {
      bmin = vmin(bmin, c.tmin[c.order[k]]);
      bmax = vmax(bmax, c.tmax[c.order[k]]);
    }
    int n = it.hi - it.lo;

    bool do_split = false;
    int mid = 0;
    if (n > c.max_leaf) {
      int axis;
      double plane;
      if (find_sah_split(c, it.lo, it.hi, bmin, bmax, &axis, &plane)) {
        // Partition preserving relative order within sides, matching
        // numpy's nonzero()-based selection (stable).
        scratch.clear();
        std::vector<int32_t> rightv;
        for (int k = it.lo; k < it.hi; ++k) {
          int t = c.order[k];
          if (double(c.cent[t][axis]) < plane) scratch.push_back(t);
          else rightv.push_back(t);
        }
        if (!scratch.empty() && !rightv.empty()) {
          std::copy(scratch.begin(), scratch.end(), c.order.begin() + it.lo);
          std::copy(rightv.begin(), rightv.end(),
                    c.order.begin() + it.lo + scratch.size());
          mid = it.lo + int(scratch.size());
          do_split = true;
        }
      }
      if (!do_split) {
        // Median fallback on widest centroid axis, stable sort
        // (mirror of numpy argsort kind='stable').
        float ext[3];
        for (int a = 0; a < 3; ++a) {
          float mn = INFINITY, mx = -INFINITY;
          for (int k = it.lo; k < it.hi; ++k) {
            mn = std::min(mn, c.cent[c.order[k]][a]);
            mx = std::max(mx, c.cent[c.order[k]][a]);
          }
          ext[a] = mx - mn;
        }
        int axis = 0;
        if (ext[1] > ext[axis]) axis = 1;
        if (ext[2] > ext[axis]) axis = 2;
        std::stable_sort(c.order.begin() + it.lo, c.order.begin() + it.hi,
                         [&](int32_t a, int32_t b) {
                           return c.cent[a][axis] < c.cent[b][axis];
                         });
        mid = it.lo + n / 2;
        do_split = true;
      }
    }

    if (!do_split) {
      c.node_min[it.node] = bmin;
      c.node_max[it.node] = bmax;
      c.first[it.node] = it.lo;
      c.count[it.node] = n;
      continue;
    }
    int32_t li = alloc_node();
    int32_t ri = alloc_node();
    c.node_min[it.node] = bmin;
    c.node_max[it.node] = bmax;
    c.left[it.node] = li;
    c.right[it.node] = ri;
    stack.push_back({ri, mid, it.hi});
    stack.push_back({li, it.lo, mid});
  }

  int32_t n_nodes = int32_t(c.node_min.size());
  std::memcpy(node_min_out, c.node_min.data(), sizeof(V3) * n_nodes);
  std::memcpy(node_max_out, c.node_max.data(), sizeof(V3) * n_nodes);
  std::memcpy(node_left_out, c.left.data(), sizeof(int32_t) * n_nodes);
  std::memcpy(node_right_out, c.right.data(), sizeof(int32_t) * n_nodes);
  std::memcpy(node_first_out, c.first.data(), sizeof(int32_t) * n_nodes);
  std::memcpy(node_count_out, c.count.data(), sizeof(int32_t) * n_nodes);
  std::memcpy(tri_order_out, c.order.data(), sizeof(int32_t) * n_tris);
  return n_nodes;
}

}  // extern "C"
