// BVH traversal kernels: fat4 closest hit, fused shadow+bounce and any hit
// (K1-K3, each also built with a leaf slot gate: K6b), the fat2 closest,
// fused and any hit (K7), and the one-node closest and any hit (K8).
//
// Replaces the Pallas packet kernels in nebulae_tpu/kernels/pallas_trace.py:
//   K1 _make_closest_fat4_kernel (pallas_closest_hit_fat4)
//   K2 _make_combo_fat4_kernel   (pallas_shadow_closest_fat4)
//   K3 _make_any_fat4_kernel     (pallas_any_hit_fat4)
//   K6b the same three with slot_range=(lo, hi) (_leaf_gate), which walk the
//       whole tree but intersect only leaves whose first slot lies in
//       [lo, hi), reading row first - lo of a triangle chunk
//   K6a the paged=True builds: on the GPU the triangle table stays in device
//       memory and the caches do the paging, so the paged route runs K1-K3
//   K7 _closest_fat_kernel / _combo_fat_kernel / _any_fat_kernel
//       (pallas_closest_hit_fat / pallas_shadow_closest_fat /
//       pallas_any_hit_fat), both children's boxes per visit over
//       pack_bvh_fat's rows (bvh_wide=2)
//   K8 _closest_kernel / _any_kernel (pallas_closest_hit / pallas_any_hit),
//       one BVH2 node per visit over pack_bvh_for_pallas's rows
// They compute the same hit records over the same fat4 tables (grandchild
// boxes per node, G triangles per leaf slot, precomputed v0/e1/e2) with the
// same slab and Moller-Trumbore arithmetic (EPS = 1e-7, strict t < best).
//
// Design: one thread per ray with a private stack in local memory.  The TPU
// kernels shared one stack per 8x128 packet because the TPU has no per-lane
// gather; a GPU thread can load its own node rows, so none of the packet
// machinery (lane-select fetches, integers in f32, majority-sign order) is
// kept.  Near-first order uses the ray's own direction signs.
//
// Bound: on the H100 these kernels are latency bound on dependent node and
// triangle loads (pointer chasing), not on DRAM bandwidth or FLOPs: the
// ~8 MB tables of a 139k-triangle scene stay in the 50 MB L2, and each ray
// needs a few hundred FLOPs per visited node.  A ~2M-triangle scene packs to
// ~110 MB, past the L2: there the walk also waits on device memory, which
// chip_smoke.py measures on the paged route.  The design keeps every load
// a contiguous row (a fat4 node is 128 bytes, a fat2 node 64, a triangle 40)
// read through the read-only path, and relies on the caller sorting rays for
// coherence so that neighbouring threads walk the same rows.  Warp divergence
// is the known cost left for a later optimisation (persistent threads, wide
// loads).
//
// Build with --fmad=false: the plain PyTorch version rounds after every
// multiply and add, and nvcc would otherwise contract a*b-c into an FMA.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr float kEps = 1e-7f;
constexpr float kDeadOrigin = 1.0e13f;
constexpr int kStackMax = 128;  // packers reject trees that could need more
constexpr int kNodeStride = 32;
constexpr int kTriStride = 10;
constexpr int kMaxLeafField = 15;
constexpr int kInnerField = 16;
constexpr int kThreads = 128;

__device__ __forceinline__ float safe_inv(float d) {
  // sign / max(|d|, 1e-12) with sign = (d >= 0) ? 1 : -1, so -0.0 -> +1e12
  float sign = (d >= 0.0f) ? 1.0f : -1.0f;
  return sign / fmaxf(fabsf(d), 1e-12f);
}

__device__ __forceinline__ bool is_dead(float ox, float dx, float dy, float dz) {
  return fabsf(ox) >= kDeadOrigin || (fabsf(dx) + fabsf(dy)) + fabsf(dz) < 1e-6f;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float ix, iy, iz, oix, oiy, oiz;
  bool pos[3];
};

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz, float dx, float dy,
                                        float dz) {
  Ray r;
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.dx = dx; r.dy = dy; r.dz = dz;
  r.ix = safe_inv(dx); r.iy = safe_inv(dy); r.iz = safe_inv(dz);
  r.oix = ox * r.ix; r.oiy = oy * r.iy; r.oiz = oz * r.iz;
  r.pos[0] = dx >= 0.0f; r.pos[1] = dy >= 0.0f; r.pos[2] = dz >= 0.0f;
  return r;
}

// Slab test of box k of a node row (lo.xyz, hi.xyz at 6k).
__device__ __forceinline__ bool slab(const float* __restrict__ row, int k, const Ray& r,
                                     float cap) {
  const float* b = row + 6 * k;
  float t0x = __ldg(b + 0) * r.ix - r.oix;
  float t1x = __ldg(b + 3) * r.ix - r.oix;
  float t0y = __ldg(b + 1) * r.iy - r.oiy;
  float t1y = __ldg(b + 4) * r.iy - r.oiy;
  float t0z = __ldg(b + 2) * r.iz - r.oiz;
  float t1z = __ldg(b + 5) * r.iz - r.oiz;
  float tenter = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  float texit = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return (tenter <= texit) && (texit > kEps) && (tenter < cap);
}

// Two-sided Moller-Trumbore against one triangle row (v0, e1, e2, id).
__device__ __forceinline__ bool moller(const float* __restrict__ tv, const Ray& r, float cap,
                                       float& t, float& u, float& v) {
  float v0x = __ldg(tv + 0), v0y = __ldg(tv + 1), v0z = __ldg(tv + 2);
  float e1x = __ldg(tv + 3), e1y = __ldg(tv + 4), e1z = __ldg(tv + 5);
  float e2x = __ldg(tv + 6), e2y = __ldg(tv + 7), e2z = __ldg(tv + 8);
  float px = r.dy * e2z - r.dz * e2y;
  float py = r.dz * e2x - r.dx * e2z;
  float pz = r.dx * e2y - r.dy * e2x;
  float det = (e1x * px + e1y * py) + e1z * pz;
  float inv_det = (fabsf(det) < kEps) ? 0.0f : 1.0f / (det == 0.0f ? 1.0f : det);
  float tvx = r.ox - v0x, tvy = r.oy - v0y, tvz = r.oz - v0z;
  u = ((tvx * px + tvy * py) + tvz * pz) * inv_det;
  float qx = tvy * e1z - tvz * e1y;
  float qy = tvz * e1x - tvx * e1z;
  float qz = tvx * e1y - tvy * e1x;
  v = ((r.dx * qx + r.dy * qy) + r.dz * qz) * inv_det;
  t = ((e2x * qx + e2y * qy) + e2z * qz) * inv_det;
  return (fabsf(det) >= kEps) && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
         (t > kEps) && (t < cap);
}

struct Fields {
  int field[4];
  int meta[4];
  int om_s, om_l, om_r;
};

__device__ __forceinline__ Fields decode(const float* __restrict__ row) {
  Fields f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int enc = __float_as_int(__ldg(row + 24 + k));
    f.field[k] = enc & 31;
    f.meta[k] = enc >> 5;
  }
  int om = __float_as_int(__ldg(row + 28));
  f.om_s = om / 36;
  int rest = om % 36;
  f.om_l = rest / 6;
  f.om_r = rest % 6;
  return f;
}

// True when the first node of an (om-described) pair is nearer along d.
__device__ __forceinline__ bool near_first(int om, const bool* pos) {
  return pos[om >> 1] == ((om & 1) != 0);
}

// Push the hit inner slots, near pair's near child on top (K1/K2 order).
__device__ __forceinline__ void push_near_first(int* stack, int& sp, const Fields& f,
                                                const bool* ok, const bool* pos) {
  bool ns = near_first(f.om_s, pos);
  bool nl = near_first(f.om_l, pos);
  bool nr = near_first(f.om_r, pos);
  int ln = nl ? 0 : 1, lf = nl ? 1 : 0;
  int rn = nr ? 2 : 3, rf = nr ? 3 : 2;
  int order[4] = {ns ? rf : lf, ns ? rn : ln, ns ? lf : rf, ns ? ln : rn};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int k = order[i];
    if (ok[k]) stack[sp++] = f.meta[k];
  }
}

__device__ __forceinline__ bool is_leaf(int field) {
  return field > 0 && field <= kMaxLeafField;
}

// Leaf residency.  AllSlots is the single-table case and compiles to no
// code; SlotRange is _leaf_gate: a leaf is intersected only when its first
// slot lies in [lo, hi), at row first - lo of the chunk's triangle table.
struct AllSlots {
  __device__ __forceinline__ bool resident(int) const { return true; }
  __device__ __forceinline__ int row(int first) const { return first; }
};

struct SlotRange {
  int lo, hi;
  __device__ __forceinline__ bool resident(int first) const { return first >= lo && first < hi; }
  __device__ __forceinline__ int row(int first) const { return first - lo; }
};

template <class Gate>
__global__ void closest_fat4_kernel(const float* __restrict__ o, const float* __restrict__ d,
                                    const float* __restrict__ tmax, int tmax_stride,
                                    const float* __restrict__ nodes,
                                    const float* __restrict__ tris, int G, int n,
                                    float* __restrict__ t_out, int32_t* __restrict__ tri_out,
                                    float* __restrict__ u_out, float* __restrict__ v_out,
                                    Gate gate) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r = make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1], d[3 * i + 2]);
  float bt = tmax[i * tmax_stride];
  int btri = -1;
  float bu = 0.0f, bv = 0.0f;
  if (!is_dead(r.ox, r.dx, r.dy, r.dz) && bt > kEps) {
    int stack[kStackMax];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      const float* row = nodes + static_cast<int64_t>(stack[--sp]) * kNodeStride;
      bool box[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) box[k] = slab(row, k, r, bt);
      Fields f = decode(row);
      for (int k = 0; k < 4; ++k) {
        if (!(box[k] && is_leaf(f.field[k]) && gate.resident(f.meta[k]))) continue;
        int first = gate.row(f.meta[k]);
        for (int s = 0; s < f.field[k]; ++s) {
          const float* slot = tris + (static_cast<int64_t>(first) + s) * G * kTriStride;
          for (int g = 0; g < G; ++g) {
            const float* tv = slot + g * kTriStride;
            float t, u, v;
            if (moller(tv, r, bt, t, u, v)) {
              bt = t;
              btri = __float_as_int(__ldg(tv + 9));
              bu = u;
              bv = v;
            }
          }
        }
      }
      bool ok[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) ok[k] = box[k] && f.field[k] >= kInnerField;
      push_near_first(stack, sp, f, ok, r.pos);
    }
  }
  t_out[i] = btri >= 0 ? bt : __int_as_float(0x7f800000);
  tri_out[i] = btri;
  u_out[i] = bu;
  v_out[i] = bv;
}

template <class Gate>
__global__ void combo_fat4_kernel(const float* __restrict__ o, const float* __restrict__ b,
                                  const float* __restrict__ l, const float* __restrict__ tmax_b,
                                  int sb, const float* __restrict__ tmax_l, int sl,
                                  const float* __restrict__ nodes,
                                  const float* __restrict__ tris, int G, int n,
                                  float* __restrict__ t_out, int32_t* __restrict__ tri_out,
                                  float* __restrict__ u_out, float* __restrict__ v_out,
                                  bool* __restrict__ occ_out, Gate gate) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  Ray rb = make_ray(ox, oy, oz, b[3 * i], b[3 * i + 1], b[3 * i + 2]);
  Ray rl = make_ray(ox, oy, oz, l[3 * i], l[3 * i + 1], l[3 * i + 2]);
  float bt = tmax_b[i * sb];
  float cap_l = tmax_l[i * sl];
  bool live_b = !is_dead(ox, rb.dx, rb.dy, rb.dz) && bt > kEps;
  bool live_l = !is_dead(ox, rl.dx, rl.dy, rl.dz) && cap_l > kEps;
  int btri = -1;
  float bu = 0.0f, bv = 0.0f;
  bool occ = false;
  if (live_b || live_l) {
    int stack[kStackMax];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      const float* row = nodes + static_cast<int64_t>(stack[--sp]) * kNodeStride;
      bool box_b[4], box_l[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        box_b[k] = live_b && slab(row, k, rb, bt);
        box_l[k] = live_l && !occ && slab(row, k, rl, cap_l);
      }
      Fields f = decode(row);
      for (int k = 0; k < 4; ++k) {
        bool tested = box_b[k] || box_l[k];
        if (!(tested && is_leaf(f.field[k]) && gate.resident(f.meta[k]))) continue;
        int first = gate.row(f.meta[k]);
        for (int s = 0; s < f.field[k]; ++s) {
          const float* slot = tris + (static_cast<int64_t>(first) + s) * G * kTriStride;
          for (int g = 0; g < G; ++g) {
            const float* tv = slot + g * kTriStride;
            float t, u, v;
            if (box_b[k] && moller(tv, rb, bt, t, u, v)) {
              bt = t;
              btri = __float_as_int(__ldg(tv + 9));
              bu = u;
              bv = v;
            }
            if (box_l[k] && !occ && moller(tv, rl, cap_l, t, u, v)) occ = true;
          }
        }
      }
      bool ok[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) ok[k] = (box_b[k] || box_l[k]) && f.field[k] >= kInnerField;
      push_near_first(stack, sp, f, ok, rb.pos);
    }
  }
  t_out[i] = btri >= 0 ? bt : __int_as_float(0x7f800000);
  tri_out[i] = btri;
  u_out[i] = bu;
  v_out[i] = bv;
  occ_out[i] = occ;
}

template <class Gate>
__global__ void any_fat4_kernel(const float* __restrict__ o, const float* __restrict__ d,
                                const float* __restrict__ tmax, int tmax_stride,
                                const float* __restrict__ nodes,
                                const float* __restrict__ tris, int G, int n,
                                bool* __restrict__ occ_out, Gate gate) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r = make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1], d[3 * i + 2]);
  float cap = tmax[i * tmax_stride];
  bool occ = false;
  if (!is_dead(r.ox, r.dx, r.dy, r.dz) && cap > kEps) {
    int stack[kStackMax];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0 && !occ) {
      const float* row = nodes + static_cast<int64_t>(stack[--sp]) * kNodeStride;
      bool box[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) box[k] = slab(row, k, r, cap);
      Fields f = decode(row);
      for (int k = 0; k < 4 && !occ; ++k) {
        if (!(box[k] && is_leaf(f.field[k]) && gate.resident(f.meta[k]))) continue;
        int first = gate.row(f.meta[k]);
        for (int s = 0; s < f.field[k] && !occ; ++s) {
          const float* slot = tris + (static_cast<int64_t>(first) + s) * G * kTriStride;
          for (int g = 0; g < G; ++g) {
            float t, u, v;
            if (moller(slot + g * kTriStride, r, cap, t, u, v)) {
              occ = true;
              break;
            }
          }
        }
      }
      // Any hit needs no order: slots are pushed 0..3, slot 3 on top.
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (box[k] && f.field[k] >= kInnerField) stack[sp++] = f.meta[k];
    }
  }
  occ_out[i] = occ;
}

// K8: one BVH2 node per visit over rows [n, 8] f32: lo.xyz, hi.xyz, then
// enc as int32 bits (leaf: first_slot*32 + slots; inner: right*32 + 16 +
// axis*2 + left_is_lower, left child = node + 1).  A node's own box is
// tested when it is popped; a leaf then intersects its slots.
constexpr int kOneNodeStride = 8;

__global__ void closest_node_kernel(const float* __restrict__ o, const float* __restrict__ d,
                                    const float* __restrict__ tmax, int tmax_stride,
                                    const float* __restrict__ nodes,
                                    const float* __restrict__ tris, int G, int n,
                                    float* __restrict__ t_out, int32_t* __restrict__ tri_out,
                                    float* __restrict__ u_out, float* __restrict__ v_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r = make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1], d[3 * i + 2]);
  float bt = tmax[i * tmax_stride];
  int btri = -1;
  float bu = 0.0f, bv = 0.0f;
  if (!is_dead(r.ox, r.dx, r.dy, r.dz) && bt > kEps) {
    int stack[kStackMax];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      int node = stack[--sp];
      const float* row = nodes + static_cast<int64_t>(node) * kOneNodeStride;
      if (!slab(row, 0, r, bt)) continue;
      int enc = __float_as_int(__ldg(row + 6));
      int field = enc & 31, meta = enc >> 5;
      if (is_leaf(field)) {
        for (int s = 0; s < field; ++s) {
          const float* slot = tris + (static_cast<int64_t>(meta) + s) * G * kTriStride;
          for (int g = 0; g < G; ++g) {
            const float* tv = slot + g * kTriStride;
            float t, u, v;
            if (moller(tv, r, bt, t, u, v)) {
              bt = t;
              btri = __float_as_int(__ldg(tv + 9));
              bu = u;
              bv = v;
            }
          }
        }
      } else if (field >= kInnerField) {
        // Near child on top: the left child is nearer when the ray's sign
        // on the split axis agrees with left_is_lower.
        int code = field - kInnerField;
        bool near_is_left = r.pos[code >> 1] == ((code & 1) != 0);
        stack[sp++] = near_is_left ? meta : node + 1;
        stack[sp++] = near_is_left ? node + 1 : meta;
      }
    }
  }
  t_out[i] = btri >= 0 ? bt : __int_as_float(0x7f800000);
  tri_out[i] = btri;
  u_out[i] = bu;
  v_out[i] = bv;
}

__global__ void any_node_kernel(const float* __restrict__ o, const float* __restrict__ d,
                                const float* __restrict__ tmax, int tmax_stride,
                                const float* __restrict__ nodes,
                                const float* __restrict__ tris, int G, int n,
                                bool* __restrict__ occ_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r = make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1], d[3 * i + 2]);
  float cap = tmax[i * tmax_stride];
  bool occ = false;
  if (!is_dead(r.ox, r.dx, r.dy, r.dz) && cap > kEps) {
    int stack[kStackMax];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0 && !occ) {
      int node = stack[--sp];
      const float* row = nodes + static_cast<int64_t>(node) * kOneNodeStride;
      if (!slab(row, 0, r, cap)) continue;
      int enc = __float_as_int(__ldg(row + 6));
      int field = enc & 31, meta = enc >> 5;
      if (is_leaf(field)) {
        for (int s = 0; s < field && !occ; ++s) {
          const float* slot = tris + (static_cast<int64_t>(meta) + s) * G * kTriStride;
          for (int g = 0; g < G; ++g) {
            float t, u, v;
            if (moller(slot + g * kTriStride, r, cap, t, u, v)) {
              occ = true;
              break;
            }
          }
        }
      } else if (field >= kInnerField) {
        // The Pallas kernel's order: right child below, left child on top.
        stack[sp++] = meta;
        stack[sp++] = node + 1;
      }
    }
  }
  occ_out[i] = occ;
}

// K7: fat2 rows [n_inner, 16] f32: the left child's box at 0, the right
// child's at 6, then encL, encR and the order meta axis*2 + left_is_lower as
// int32 bits.  Both boxes are tested against the cap the visit starts with;
// the left leaf child's triangles are intersected, then the right one's;
// at most two pushes.
constexpr int kFatStride = 16;

struct FatFields {
  int field[2];
  int meta[2];
  int om;
};

__device__ __forceinline__ FatFields decode_fat(const float* __restrict__ row) {
  FatFields f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    int enc = __float_as_int(__ldg(row + 12 + k));
    f.field[k] = enc & 31;
    f.meta[k] = enc >> 5;
  }
  f.om = __float_as_int(__ldg(row + 14));
  return f;
}

// Push the hit inner children, far first and near on top (K7a/K7b order).
__device__ __forceinline__ void push_fat_near_first(int* stack, int& sp, const FatFields& f,
                                                    const bool* ok, const bool* pos) {
  int nk = near_first(f.om, pos) ? 0 : 1;
  int fk = 1 - nk;
  if (ok[fk]) stack[sp++] = f.meta[fk];
  if (ok[nk]) stack[sp++] = f.meta[nk];
}

__global__ void closest_fat_kernel(const float* __restrict__ o, const float* __restrict__ d,
                                   const float* __restrict__ tmax, int tmax_stride,
                                   const float* __restrict__ nodes,
                                   const float* __restrict__ tris, int G, int n,
                                   float* __restrict__ t_out, int32_t* __restrict__ tri_out,
                                   float* __restrict__ u_out, float* __restrict__ v_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r = make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1], d[3 * i + 2]);
  float bt = tmax[i * tmax_stride];
  int btri = -1;
  float bu = 0.0f, bv = 0.0f;
  if (!is_dead(r.ox, r.dx, r.dy, r.dz) && bt > kEps) {
    int stack[kStackMax];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      const float* row = nodes + static_cast<int64_t>(stack[--sp]) * kFatStride;
      bool box[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) box[k] = slab(row, k, r, bt);
      FatFields f = decode_fat(row);
      for (int k = 0; k < 2; ++k) {
        if (!(box[k] && is_leaf(f.field[k]))) continue;
        for (int s = 0; s < f.field[k]; ++s) {
          const float* slot = tris + (static_cast<int64_t>(f.meta[k]) + s) * G * kTriStride;
          for (int g = 0; g < G; ++g) {
            const float* tv = slot + g * kTriStride;
            float t, u, v;
            if (moller(tv, r, bt, t, u, v)) {
              bt = t;
              btri = __float_as_int(__ldg(tv + 9));
              bu = u;
              bv = v;
            }
          }
        }
      }
      bool ok[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) ok[k] = box[k] && f.field[k] >= kInnerField;
      push_fat_near_first(stack, sp, f, ok, r.pos);
    }
  }
  t_out[i] = btri >= 0 ? bt : __int_as_float(0x7f800000);
  tri_out[i] = btri;
  u_out[i] = bu;
  v_out[i] = bv;
}

__global__ void combo_fat_kernel(const float* __restrict__ o, const float* __restrict__ b,
                                 const float* __restrict__ l, const float* __restrict__ tmax_b,
                                 int sb, const float* __restrict__ tmax_l, int sl,
                                 const float* __restrict__ nodes,
                                 const float* __restrict__ tris, int G, int n,
                                 float* __restrict__ t_out, int32_t* __restrict__ tri_out,
                                 float* __restrict__ u_out, float* __restrict__ v_out,
                                 bool* __restrict__ occ_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  Ray rb = make_ray(ox, oy, oz, b[3 * i], b[3 * i + 1], b[3 * i + 2]);
  Ray rl = make_ray(ox, oy, oz, l[3 * i], l[3 * i + 1], l[3 * i + 2]);
  float bt = tmax_b[i * sb];
  float cap_l = tmax_l[i * sl];
  bool live_b = !is_dead(ox, rb.dx, rb.dy, rb.dz) && bt > kEps;
  bool live_l = !is_dead(ox, rl.dx, rl.dy, rl.dz) && cap_l > kEps;
  int btri = -1;
  float bu = 0.0f, bv = 0.0f;
  bool occ = false;
  if (live_b || live_l) {
    int stack[kStackMax];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      const float* row = nodes + static_cast<int64_t>(stack[--sp]) * kFatStride;
      bool box_b[2], box_l[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        box_b[k] = live_b && slab(row, k, rb, bt);
        box_l[k] = live_l && !occ && slab(row, k, rl, cap_l);
      }
      FatFields f = decode_fat(row);
      for (int k = 0; k < 2; ++k) {
        if (!((box_b[k] || box_l[k]) && is_leaf(f.field[k]))) continue;
        for (int s = 0; s < f.field[k]; ++s) {
          const float* slot = tris + (static_cast<int64_t>(f.meta[k]) + s) * G * kTriStride;
          for (int g = 0; g < G; ++g) {
            const float* tv = slot + g * kTriStride;
            float t, u, v;
            // The bounce hit is gated by the bounce box, the shadow hit by
            // the shadow box and its own cap.
            if (box_b[k] && moller(tv, rb, bt, t, u, v)) {
              bt = t;
              btri = __float_as_int(__ldg(tv + 9));
              bu = u;
              bv = v;
            }
            if (box_l[k] && !occ && moller(tv, rl, cap_l, t, u, v)) occ = true;
          }
        }
      }
      bool ok[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) ok[k] = (box_b[k] || box_l[k]) && f.field[k] >= kInnerField;
      push_fat_near_first(stack, sp, f, ok, rb.pos);
    }
  }
  t_out[i] = btri >= 0 ? bt : __int_as_float(0x7f800000);
  tri_out[i] = btri;
  u_out[i] = bu;
  v_out[i] = bv;
  occ_out[i] = occ;
}

__global__ void any_fat_kernel(const float* __restrict__ o, const float* __restrict__ d,
                               const float* __restrict__ tmax, int tmax_stride,
                               const float* __restrict__ nodes,
                               const float* __restrict__ tris, int G, int n,
                               bool* __restrict__ occ_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r = make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1], d[3 * i + 2]);
  float cap = tmax[i * tmax_stride];
  bool occ = false;
  if (!is_dead(r.ox, r.dx, r.dy, r.dz) && cap > kEps) {
    int stack[kStackMax];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0 && !occ) {
      const float* row = nodes + static_cast<int64_t>(stack[--sp]) * kFatStride;
      bool box[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) box[k] = slab(row, k, r, cap);
      FatFields f = decode_fat(row);
      for (int k = 0; k < 2 && !occ; ++k) {
        if (!(box[k] && is_leaf(f.field[k]))) continue;
        for (int s = 0; s < f.field[k] && !occ; ++s) {
          const float* slot = tris + (static_cast<int64_t>(f.meta[k]) + s) * G * kTriStride;
          for (int g = 0; g < G; ++g) {
            float t, u, v;
            if (moller(slot + g * kTriStride, r, cap, t, u, v)) {
              occ = true;
              break;
            }
          }
        }
      }
      // JAX's any-hit order: left pushed first, right on top.
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (box[k] && f.field[k] >= kInnerField) stack[sp++] = f.meta[k];
    }
  }
  occ_out[i] = occ;
}

inline int grid_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// K1-K3 over one table (the single-table and paged routes).
int nb_closest_fat4(const float* o, const float* d, const float* tmax, int tmax_stride,
                    const float* nodes, const float* tris, int G, int n, float* t,
                    int32_t* tri, float* u, float* v, void* stream) {
  if (n > 0) {
    closest_fat4_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, tmax, tmax_stride, nodes, tris, G, n, t, tri, u, v, AllSlots{});
  }
  return static_cast<int>(cudaGetLastError());
}

int nb_combo_fat4(const float* o, const float* b, const float* l, const float* tmax_b, int sb,
                  const float* tmax_l, int sl, const float* nodes, const float* tris, int G,
                  int n, float* t, int32_t* tri, float* u, float* v, bool* occ,
                  void* stream) {
  if (n > 0) {
    combo_fat4_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, b, l, tmax_b, sb, tmax_l, sl, nodes, tris, G, n, t, tri, u, v, occ, AllSlots{});
  }
  return static_cast<int>(cudaGetLastError());
}

int nb_any_fat4(const float* o, const float* d, const float* tmax, int tmax_stride,
                const float* nodes, const float* tris, int G, int n, bool* occ,
                void* stream) {
  if (n > 0) {
    any_fat4_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, tmax, tmax_stride, nodes, tris, G, n, occ, AllSlots{});
  }
  return static_cast<int>(cudaGetLastError());
}

// K6b: the same walks, intersecting only leaves whose first slot lies in
// [slot_lo, slot_hi); `tris` is that chunk's table (global slot slot_lo at
// row 0).
int nb_closest_fat4_slots(const float* o, const float* d, const float* tmax, int tmax_stride,
                          const float* nodes, const float* tris, int G, int n, int slot_lo,
                          int slot_hi, float* t, int32_t* tri, float* u, float* v,
                          void* stream) {
  if (n > 0) {
    closest_fat4_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, tmax, tmax_stride, nodes, tris, G, n, t, tri, u, v, SlotRange{slot_lo, slot_hi});
  }
  return static_cast<int>(cudaGetLastError());
}

int nb_combo_fat4_slots(const float* o, const float* b, const float* l, const float* tmax_b,
                        int sb, const float* tmax_l, int sl, const float* nodes,
                        const float* tris, int G, int n, int slot_lo, int slot_hi, float* t,
                        int32_t* tri, float* u, float* v, bool* occ, void* stream) {
  if (n > 0) {
    combo_fat4_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, b, l, tmax_b, sb, tmax_l, sl, nodes, tris, G, n, t, tri, u, v, occ,
        SlotRange{slot_lo, slot_hi});
  }
  return static_cast<int>(cudaGetLastError());
}

int nb_any_fat4_slots(const float* o, const float* d, const float* tmax, int tmax_stride,
                      const float* nodes, const float* tris, int G, int n, int slot_lo,
                      int slot_hi, bool* occ, void* stream) {
  if (n > 0) {
    any_fat4_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, tmax, tmax_stride, nodes, tris, G, n, occ, SlotRange{slot_lo, slot_hi});
  }
  return static_cast<int>(cudaGetLastError());
}

// K7 over fat2 rows.
int nb_closest_fat(const float* o, const float* d, const float* tmax, int tmax_stride,
                   const float* nodes, const float* tris, int G, int n, float* t, int32_t* tri,
                   float* u, float* v, void* stream) {
  if (n > 0) {
    closest_fat_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, tmax, tmax_stride, nodes, tris, G, n, t, tri, u, v);
  }
  return static_cast<int>(cudaGetLastError());
}

int nb_combo_fat(const float* o, const float* b, const float* l, const float* tmax_b, int sb,
                 const float* tmax_l, int sl, const float* nodes, const float* tris, int G,
                 int n, float* t, int32_t* tri, float* u, float* v, bool* occ, void* stream) {
  if (n > 0) {
    combo_fat_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, b, l, tmax_b, sb, tmax_l, sl, nodes, tris, G, n, t, tri, u, v, occ);
  }
  return static_cast<int>(cudaGetLastError());
}

int nb_any_fat(const float* o, const float* d, const float* tmax, int tmax_stride,
               const float* nodes, const float* tris, int G, int n, bool* occ, void* stream) {
  if (n > 0) {
    any_fat_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, tmax, tmax_stride, nodes, tris, G, n, occ);
  }
  return static_cast<int>(cudaGetLastError());
}

// K8 over one-node rows.
int nb_closest_node(const float* o, const float* d, const float* tmax, int tmax_stride,
                    const float* nodes, const float* tris, int G, int n, float* t,
                    int32_t* tri, float* u, float* v, void* stream) {
  if (n > 0) {
    closest_node_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, tmax, tmax_stride, nodes, tris, G, n, t, tri, u, v);
  }
  return static_cast<int>(cudaGetLastError());
}

int nb_any_node(const float* o, const float* d, const float* tmax, int tmax_stride,
                const float* nodes, const float* tris, int G, int n, bool* occ,
                void* stream) {
  if (n > 0) {
    any_node_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, tmax, tmax_stride, nodes, tris, G, n, occ);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
