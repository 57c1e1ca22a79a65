// Native binned-SAH BVH builder: the port's own copy of native/bvh_builder.cpp.
//
// Host code.  It is compiled by the host C++ compiler with the flags of
// native/Makefile (nebulae_tpu_torch/kernels/build.py::build_host) and
// produces the flat skip-link layout documented in
// nebulae_tpu_torch/bvh/builder.py.  The engine uses it on the CPU and the
// GPU path alike: with those flags its tree is the JAX package's native
// tree on the same host, bit for bit.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kNumBins = 16;
constexpr float kInf = std::numeric_limits<float>::infinity();

struct Vec3 {
  float x, y, z;
  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  Vec3 lo{kInf, kInf, kInf};
  Vec3 hi{-kInf, -kInf, -kInf};
  void grow(const AABB& o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  void grow(const Vec3& p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float half_area() const {
    float dx = std::max(hi.x - lo.x, 0.0f);
    float dy = std::max(hi.y - lo.y, 0.0f);
    float dz = std::max(hi.z - lo.z, 0.0f);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct BuildNode {
  AABB box;
  int32_t first = 0;   // inner: left child; leaf: first tri (into tri_index)
  int32_t count = 0;   // 0 for inner
  int32_t right = -1;  // inner: right child
};

struct Builder {
  const float* tri_pos;  // [T, 3, 3]
  int max_leaf;
  std::vector<AABB> tri_box;
  std::vector<Vec3> centroid;
  std::vector<int32_t> ids;  // permutation being sorted in place
  std::vector<BuildNode> nodes;

  void init(int num_tris) {
    tri_box.resize(num_tris);
    centroid.resize(num_tris);
    ids.resize(num_tris);
    for (int t = 0; t < num_tris; ++t) {
      AABB b;
      for (int v = 0; v < 3; ++v) {
        const float* p = tri_pos + (static_cast<size_t>(t) * 3 + v) * 3;
        b.grow(Vec3{p[0], p[1], p[2]});
      }
      tri_box[t] = b;
      centroid[t] = {0.5f * (b.lo.x + b.hi.x), 0.5f * (b.lo.y + b.hi.y),
                     0.5f * (b.lo.z + b.hi.z)};
      ids[t] = t;
    }
    nodes.reserve(static_cast<size_t>(num_tris) * 2 + 1);
  }

  // Build subtree over ids[begin, end); returns node index (pre-order).
  int32_t build_range(int begin, int end) {
    int32_t ni = static_cast<int32_t>(nodes.size());
    nodes.emplace_back();
    AABB box;
    AABB cbox;
    for (int i = begin; i < end; ++i) {
      box.grow(tri_box[ids[i]]);
      cbox.grow(centroid[ids[i]]);
    }
    nodes[ni].box = box;
    int n = end - begin;

    int axis = 0;
    {
      float dx = cbox.hi.x - cbox.lo.x, dy = cbox.hi.y - cbox.lo.y,
            dz = cbox.hi.z - cbox.lo.z;
      if (dy > dx) axis = 1;
      if (dz > (axis == 0 ? dx : dy)) axis = 2;
    }
    float ext = cbox.hi[axis] - cbox.lo[axis];

    int mid = -1;
    if (n > max_leaf && ext > 1e-12f) {
      // Binned SAH sweep.
      float scale = kNumBins * (1.0f - 1e-6f) / ext;
      int bin_count[kNumBins] = {0};
      AABB bin_box[kNumBins];
      auto bin_of = [&](int id) {
        int b = static_cast<int>((centroid[id][axis] - cbox.lo[axis]) * scale);
        return std::min(std::max(b, 0), kNumBins - 1);
      };
      for (int i = begin; i < end; ++i) {
        int b = bin_of(ids[i]);
        bin_count[b]++;
        bin_box[b].grow(tri_box[ids[i]]);
      }
      float rarea[kNumBins];
      {
        AABB acc;
        for (int b = kNumBins - 1; b > 0; --b) {
          acc.grow(bin_box[b]);
          rarea[b] = acc.half_area();
        }
      }
      float best_cost = kInf;
      int best_bin = -1;
      {
        AABB acc;
        int lcnt = 0;
        for (int b = 0; b < kNumBins - 1; ++b) {
          acc.grow(bin_box[b]);
          lcnt += bin_count[b];
          int rcnt = n - lcnt;
          if (lcnt == 0 || rcnt == 0) continue;
          float cost = acc.half_area() * lcnt + rarea[b + 1] * rcnt;
          if (cost < best_cost) {
            best_cost = cost;
            best_bin = b;
          }
        }
      }
      if (best_bin >= 0) {
        auto it = std::partition(ids.begin() + begin, ids.begin() + end,
                                 [&](int id) { return bin_of(id) <= best_bin; });
        mid = static_cast<int>(it - ids.begin());
        if (mid == begin || mid == end) mid = -1;
      }
    }
    if (mid < 0 && n > 4 * max_leaf) {
      // Degenerate centroids: median split keeps leaves bounded.
      mid = begin + n / 2;
      std::nth_element(ids.begin() + begin, ids.begin() + mid, ids.begin() + end,
                       [&](int a, int b) {
                         return centroid[a][axis] < centroid[b][axis];
                       });
    }

    if (mid < 0) {
      nodes[ni].first = begin;  // leaf: tri range in the sorted permutation
      nodes[ni].count = n;
      nodes[ni].right = -1;
    } else {
      int32_t left = build_range(begin, mid);   // == ni + 1 (pre-order)
      int32_t right = build_range(mid, end);
      nodes[ni].first = left;
      nodes[ni].count = 0;
      nodes[ni].right = right;
    }
    return ni;
  }
};

}  // namespace

extern "C" {

// Returns the number of nodes written, or -1 if the caller's buffers are too
// small (caller should allocate 2*T+1 nodes). All output arrays are
// caller-allocated.
int32_t nebulae_build_bvh(const float* tri_pos, int32_t num_tris,
                          int32_t max_leaf, int32_t max_nodes, float* node_lo,
                          float* node_hi, int32_t* node_first,
                          int32_t* node_count, int32_t* node_skip,
                          int32_t* node_right, int32_t* tri_index) {
  if (num_tris <= 0) {
    if (max_nodes < 1) return -1;
    node_lo[0] = node_lo[1] = node_lo[2] = 0.0f;
    node_hi[0] = node_hi[1] = node_hi[2] = 0.0f;
    node_first[0] = 0;
    node_count[0] = 0;
    node_skip[0] = 1;
    node_right[0] = -1;
    return 1;
  }
  Builder b;
  b.tri_pos = tri_pos;
  b.max_leaf = max_leaf > 0 ? max_leaf : 4;
  b.init(num_tris);
  b.build_range(0, num_tris);
  int32_t n = static_cast<int32_t>(b.nodes.size());
  if (n > max_nodes) return -1;

  for (int32_t i = 0; i < n; ++i) {
    const BuildNode& nd = b.nodes[i];
    node_lo[i * 3 + 0] = nd.box.lo.x;
    node_lo[i * 3 + 1] = nd.box.lo.y;
    node_lo[i * 3 + 2] = nd.box.lo.z;
    node_hi[i * 3 + 0] = nd.box.hi.x;
    node_hi[i * 3 + 1] = nd.box.hi.y;
    node_hi[i * 3 + 2] = nd.box.hi.z;
    node_first[i] = nd.first;
    node_count[i] = nd.count;
    node_right[i] = nd.right;
  }
  std::memcpy(tri_index, b.ids.data(), sizeof(int32_t) * num_tris);

  // Skip links: iterative pre-order walk (matches bvh/builder.py `assign`).
  std::vector<std::pair<int32_t, int32_t>> stack;
  stack.emplace_back(0, n);
  while (!stack.empty()) {
    auto [i, skip] = stack.back();
    stack.pop_back();
    node_skip[i] = skip;
    if (node_count[i] == 0) {
      stack.emplace_back(node_first[i], node_right[i]);
      stack.emplace_back(node_right[i], skip);
    }
  }
  return n;
}

}  // extern "C"
