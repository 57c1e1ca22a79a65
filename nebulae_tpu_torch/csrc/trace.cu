// Fat4 BVH traversal kernels K1-K3: closest hit, fused shadow+bounce, any hit.
//
// Replaces the Pallas packet kernels in nebulae_tpu/kernels/pallas_trace.py:
//   K1 _make_closest_fat4_kernel (pallas_closest_hit_fat4)
//   K2 _make_combo_fat4_kernel   (pallas_shadow_closest_fat4)
//   K3 _make_any_fat4_kernel     (pallas_any_hit_fat4)
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
// needs a few hundred FLOPs per visited node.  The design keeps every load
// a contiguous row (a node is 128 bytes, a triangle 40) read through the
// read-only path, and relies on the caller sorting rays for coherence so
// that neighbouring threads walk the same rows.  Warp divergence is the
// known cost left for a later optimisation (persistent threads, wide loads).
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

__global__ void closest_fat4_kernel(const float* __restrict__ o, const float* __restrict__ d,
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
      const float* row = nodes + static_cast<int64_t>(stack[--sp]) * kNodeStride;
      bool box[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) box[k] = slab(row, k, r, bt);
      Fields f = decode(row);
      for (int k = 0; k < 4; ++k) {
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

__global__ void combo_fat4_kernel(const float* __restrict__ o, const float* __restrict__ b,
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
      const float* row = nodes + static_cast<int64_t>(stack[--sp]) * kNodeStride;
      bool box_b[4], box_l[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        box_b[k] = live_b && slab(row, k, rb, bt);
        box_l[k] = live_l && !occ && slab(row, k, rl, cap_l);
      }
      Fields f = decode(row);
      for (int k = 0; k < 4; ++k) {
        if (!((box_b[k] || box_l[k]) && is_leaf(f.field[k]))) continue;
        for (int s = 0; s < f.field[k]; ++s) {
          const float* slot = tris + (static_cast<int64_t>(f.meta[k]) + s) * G * kTriStride;
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

__global__ void any_fat4_kernel(const float* __restrict__ o, const float* __restrict__ d,
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
      const float* row = nodes + static_cast<int64_t>(stack[--sp]) * kNodeStride;
      bool box[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) box[k] = slab(row, k, r, cap);
      Fields f = decode(row);
      for (int k = 0; k < 4 && !occ; ++k) {
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
      // Any hit needs no order: slots are pushed 0..3, slot 3 on top.
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (box[k] && f.field[k] >= kInnerField) stack[sp++] = f.meta[k];
    }
  }
  occ_out[i] = occ;
}

inline int grid_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int nb_closest_fat4(const float* o, const float* d, const float* tmax, int tmax_stride,
                    const float* nodes, const float* tris, int G, int n, float* t,
                    int32_t* tri, float* u, float* v, void* stream) {
  if (n > 0) {
    closest_fat4_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, tmax, tmax_stride, nodes, tris, G, n, t, tri, u, v);
  }
  return static_cast<int>(cudaGetLastError());
}

int nb_combo_fat4(const float* o, const float* b, const float* l, const float* tmax_b, int sb,
                  const float* tmax_l, int sl, const float* nodes, const float* tris, int G,
                  int n, float* t, int32_t* tri, float* u, float* v, bool* occ,
                  void* stream) {
  if (n > 0) {
    combo_fat4_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, b, l, tmax_b, sb, tmax_l, sl, nodes, tris, G, n, t, tri, u, v, occ);
  }
  return static_cast<int>(cudaGetLastError());
}

int nb_any_fat4(const float* o, const float* d, const float* tmax, int tmax_stride,
                const float* nodes, const float* tris, int G, int n, bool* occ,
                void* stream) {
  if (n > 0) {
    any_fat4_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, tmax, tmax_stride, nodes, tris, G, n, occ);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
