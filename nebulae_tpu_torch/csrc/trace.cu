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
// is the known cost left for a later optimisation.
//
// K1 (closest_fat4_kernel) and K2 (combo_fat4_kernel and
// combo_fat4_group_kernel), and so their paged and SlotRange builds, share
// a design of their own, described above K1's kernel.  For K2: on the bench
// scene (~139k triangles, 1080p) it is bound by the latency of each ray's
// chain of dependent row loads and by the instructions a visit issues, not
// by bytes or FLOPs: its bound is ~0.04 ms against ~1.1 ms at 2^21 rays.  A
// frame's launches after the first (10^3-10^4 lanes) leave the card nearly
// empty, and one thread per ray then takes as long as its slowest warp's
// walk, ~0.36 ms each.  Kept, each against the design before it on the same
// card in the same run (chip_smoke.py --ab; H100 80GB HBM3 at 700 W; ms
// at 2^21 rays, then the sum of a frame's three launches replayed):
//   - wide loads (8 16-byte loads per row, 5 8-byte loads per triangle,
//     one triangle load for both rays): 1.485 -> 1.099 and 1.657 -> 1.269;
//   - the leaf loop unrolled by 4, so that triangles overlap: 1.110 ->
//     1.092 and 1.318 -> 1.210;
//   - 8 lanes per ray (the group kernel) up to 540,672 rays on an H100: a
//     frame's later launches 0.341 -> 0.152 and 0.373 -> 0.137 ms
//     (replayed; 0.36 -> 0.07 ms each in a profiled frame), its first
//     launch (443k rays) 0.458 -> 0.395; larger launches keep one thread
//     per ray (see launch_combo_fat4).
// Tried and dropped, each no better than the kept design in its run:
//   - the stack in shared memory, [depth][128] (1.129, 1.263), and with
//     __launch_bounds__(128, 8) for 32 of 64 warps per SM (64 registers,
//     24 bytes of spills; 1.118, 1.302);
//   - persistent warps whose idle lanes fetch rays from an atomic counter in
//     sorted order (74 registers; 1.172 against 1.148, 1.332 against 1.294);
//   - an L1 prefetch of the next row before the leaf tests (1.200, 1.314);
//   - the leaf loop unrolled by 8 (1.146 against 1.145, 1.232 against
//     1.263);
//   - the next node kept in a register instead of on the stack (1.060
//     against 1.048, 1.252 against 1.175).
// combo_fat4_kernel uses 78 registers and a 512-byte stack frame (the
// 128-entry stack): 24 of 64 warps per SM; the group kernel 84 registers:
// 20 warps.
// K1 took the wide loads, the registers and the leaf loop x4 (it walks ~2M
// primary rays a frame, so it keeps one thread per ray): 0.500 -> 0.329 ms
// on the 1080p primary rays (chip_smoke.py --ab, same card and run), 66
// registers and the 512-byte stack: 28 of 64 warps per SM.  Tried and
// dropped: one warp per 8x4 pixel tile instead of 32 rays of a row (0.350
// against 0.333).
// K3 (any_fat4_kernel, any_fat4_group_kernel) and K7b (combo_fat_kernel,
// combo_fat_group_kernel) took K2's design: wide loads, registers, the leaf
// loop x4, and 8 lanes per ray up to the same cutoff.  Device time from the
// profiler, each against the parent's kernel on the same launches in one
// chip_smoke.py --ab session (A B C C B A; H100 80GB HBM3 at 700 W):
//   - K3 on a 1080p frame's last-vertex launch (1,169 rays) 0.166 -> 0.018
//     ms (4 lanes: 0.035), at 2^21 rays (one thread per ray) 0.295 ->
//     0.227; 64 registers in the group body;
//   - K7b on a 1080p fat2 frame's three launches (443k, 15k, 7.6k rays)
//     0.510 + 0.417 + 0.494 -> 0.372 + 0.077 + 0.066 ms (4 lanes: 0.304 +
//     0.102 + 0.099), at 2^21 rays 1.233 -> 1.036; 80 registers in the
//     group body.
// Four lanes (kGroup = 4 for these two) win from ~2^18 rays up and lose on
// small launches, so all three group bodies keep kGroup = 8.  Each group
// body still beats one thread per ray at 524,288 rays and loses at 2^20, as
// K2's does: the cutoff stays.
// K7a (closest_fat_kernel) took K1's levers over fat2 rows, with one thread
// per ray, and K7c (any_fat_kernel, any_fat_group_kernel) K3's two bodies
// behind the same cutoff; K1 and K7a share closest_leaf, K3 and K7c
// any_leaf and any_leaf_group.  Device time against the parent's kernels
// on the same launches in one chip_smoke.py --ab session (A B B A, two
// rounds; H100 80GB HBM3 at 700 W):
//   - K7a on the 1080p primary rays over the fat2 table 0.411 -> 0.313 ms
//     (64 registers, 50% est. occupancy): 1.31x, where K1 took 1.52x from
//     the same levers;
//   - K7c on a 1080p fat2 frame's last-vertex launch (1,169 rays) 0.164 ->
//     0.026 ms (group body, 63 registers), at 2^21 rays (thread body, 54
//     registers) 0.300 -> 0.269.  Its group body wins at 2^19 rays (0.158
//     against 0.181) and loses at 2^20 (0.312 against 0.192): the cutoff
//     stays.
// Tried and dropped, as a third tree in a second session: the next node
// kept in a register, since a binary walk pops right after each push (K7a
// 0.318 against 0.313, K7c at 2^21 rays 0.268 against 0.266).  K1's SASS
// moved with closest_leaf and its time did not (0.262 both); K3's SASS is
// unchanged.
// K8 (closest_node_kernel, closest_node_group_kernel, any_node_kernel)
// took K1's levers and the shared leaf loops; its closest hit keeps a group
// body for launches that fit one wave of the card, its any hit one thread
// per ray (what was measured is above its kernels).  Every other kernel's
// SASS stayed the parent's.
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

// K1 and K2, redesigned for Hopper (see the head of this file for what
// bounds them and what was measured), visit the same nodes and test the
// same triangles in the same order as the plain walks, with the same
// arithmetic, so tri (and K2's occ) stay equal to the plain versions bit
// for bit.  What changes is how a visit reads memory: a 128-byte fat4 row
// is 8 16-byte loads issued together right after the pop, and a 40-byte
// triangle 5 8-byte loads (made once for both of K2's rays; the wrappers
// check the alignment these loads need).  The visit's boxes, hit masks and
// encodings stay in registers: bit masks and selects, no arrays indexed at
// run time.
struct Box {
  float lx, ly, lz, hx, hy, hz;
};

__device__ __forceinline__ bool slab_box(const Box& bx, const Ray& r, float cap) {
  float t0x = bx.lx * r.ix - r.oix;
  float t1x = bx.hx * r.ix - r.oix;
  float t0y = bx.ly * r.iy - r.oiy;
  float t1y = bx.hy * r.iy - r.oiy;
  float t0z = bx.lz * r.iz - r.oiz;
  float t1z = bx.hz * r.iz - r.oiz;
  float tenter = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  float texit = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return (tenter <= texit) && (texit > kEps) && (tenter < cap);
}

struct Tri {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
  int id;
};

__device__ __forceinline__ Tri load_tri(const float* __restrict__ tv) {
  const float2* p = reinterpret_cast<const float2*>(tv);
  float2 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2), d = __ldg(p + 3), e = __ldg(p + 4);
  return {a.x, a.y, b.x, b.y, c.x, c.y, d.x, d.y, e.x, __float_as_int(e.y)};
}

// Two-sided Moller-Trumbore against a triangle row (v0, e1, e2, id) in
// registers.
__device__ __forceinline__ bool moller_tri(const Tri& tr, const Ray& r, float cap, float& t,
                                           float& u, float& v) {
  float px = r.dy * tr.e2z - r.dz * tr.e2y;
  float py = r.dz * tr.e2x - r.dx * tr.e2z;
  float pz = r.dx * tr.e2y - r.dy * tr.e2x;
  float det = (tr.e1x * px + tr.e1y * py) + tr.e1z * pz;
  float inv_det = (fabsf(det) < kEps) ? 0.0f : 1.0f / (det == 0.0f ? 1.0f : det);
  float tvx = r.ox - tr.v0x, tvy = r.oy - tr.v0y, tvz = r.oz - tr.v0z;
  u = ((tvx * px + tvy * py) + tvz * pz) * inv_det;
  float qx = tvy * tr.e1z - tvz * tr.e1y;
  float qy = tvz * tr.e1x - tvx * tr.e1z;
  float qz = tvx * tr.e1y - tvy * tr.e1x;
  v = ((r.dx * qx + r.dy * qy) + r.dz * qz) * inv_det;
  t = ((tr.e2x * qx + tr.e2y * qy) + tr.e2z * qz) * inv_det;
  return (fabsf(det) >= kEps) && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
         (t > kEps) && (t < cap);
}

__device__ __forceinline__ int pick(int k, int a, int b, int c, int d) {
  return k == 0 ? a : (k == 1 ? b : (k == 2 ? c : d));
}

// A ray's direction signs as bits (x, y, z at bits 0, 1, 2).
__device__ __forceinline__ unsigned pos_bits(const Ray& r) {
  return static_cast<unsigned>(r.pos[0]) | static_cast<unsigned>(r.pos[1]) << 1 |
         static_cast<unsigned>(r.pos[2]) << 2;
}

// True when the first node of an (om-described) pair is nearer along the
// direction whose sign bits are pos.
__device__ __forceinline__ bool near_first_bits(int om, unsigned pos) {
  return ((pos >> (om >> 1)) & 1u) == static_cast<unsigned>(om & 1);
}

// Push the slots in the `inner` mask, the near pair's near child on top, by
// the order meta om and the sign bits pos, from encodings in registers.
__device__ __forceinline__ void push_inner(int* stack, int& sp, const int (&enc)[4],
                                           unsigned inner, int om, unsigned pos) {
  bool ns = near_first_bits(om / 36, pos);
  bool nl = near_first_bits((om % 36) / 6, pos);
  bool nr = near_first_bits(om % 6, pos);
  int ln = nl ? 0 : 1, lf = nl ? 1 : 0;
  int rn = nr ? 2 : 3, rf = nr ? 3 : 2;
  const int order[4] = {ns ? rf : lf, ns ? rn : ln, ns ? lf : rf, ns ? ln : rn};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    int k = order[m];
    if ((inner >> k) & 1u) stack[sp++] = pick(k, enc[0], enc[1], enc[2], enc[3]) >> 5;
  }
}

// One leaf's `count` triangles from `slot` for the closest-hit walks (K1,
// K7a): each test under the running best t, the leaf loop unrolled by 4 so
// that the next triangles' loads overlap this one's test.
__device__ __forceinline__ void closest_leaf(const float* __restrict__ slot, int count, const Ray& r,
                                             float& bt, int& btri, float& bu, float& bv) {
#pragma unroll 4
  for (int j = 0; j < count; ++j) {
    Tri tr = load_tri(slot + j * kTriStride);
    float t, u, v;
    if (moller_tri(tr, r, bt, t, u, v)) {
      bt = t;
      btri = tr.id;
      bu = u;
      bv = v;
    }
  }
}

// One leaf's `count` triangles from `slot` for the any-hit walks' one-thread
// bodies (K3, K7c): true at the first hit under cap; later triangles skip
// their test.
__device__ __forceinline__ bool any_leaf(const float* __restrict__ slot, int count, const Ray& r,
                                         float cap) {
  bool occ = false;
#pragma unroll 4
  for (int j = 0; j < count; ++j) {
    Tri tr = load_tri(slot + j * kTriStride);
    float t, u, v;
    if (!occ && moller_tri(tr, r, cap, t, u, v)) occ = true;
  }
  return occ;
}

// One leaf's `count` triangles from `slot` for the fused walks' one-thread
// bodies (K2, K7b): the bounce ray, where its box was hit (tb), keeps the
// closest hit under its running cap; the shadow ray, where its box was hit
// (tl), stops testing at its first hit under cap_l.  Unrolled so that the
// next triangles' loads and arithmetic, which do not depend on bt, overlap
// this one's test and update.
__device__ __forceinline__ void combo_leaf(const float* __restrict__ slot, int count, bool tb,
                                           bool tl, const Ray& rb, const Ray& rl, float cap_l,
                                           float& bt, int& btri, float& bu, float& bv,
                                           bool& occ) {
#pragma unroll 4
  for (int j = 0; j < count; ++j) {
    Tri tr = load_tri(slot + j * kTriStride);
    float t, u, v;
    if (tb && moller_tri(tr, rb, bt, t, u, v)) {
      bt = t;
      btri = tr.id;
      bu = u;
      bv = v;
    }
    if (tl && !occ && moller_tri(tr, rl, cap_l, t, u, v)) occ = true;
  }
}

// K1, the closest-hit walk (and so its paged build K6a, its SlotRange build
// K6b and the subtree chains K6c), redesigned for Hopper with K2's levers:
// a fat4 row as 8 16-byte loads right after the pop, a triangle as 5 8-byte
// loads, boxes, masks and encodings in registers (no array indexed at run
// time, so nothing of a visit goes to local memory), and the leaf loop
// unrolled by 4.  It visits the same nodes and tests the same triangles in
// the same order with the same arithmetic as the plain walk, so tri, t, u
// and v stay equal to closest_hit_fat4_plain.  A 1080p frame gives it ~2M
// primary rays, far above the count where K2's group kernel stops winning
// (~590k), so it keeps one thread per ray.
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
    const float4* rows = reinterpret_cast<const float4*>(nodes);
    unsigned pos = pos_bits(r);
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      const float4* row = rows + static_cast<int64_t>(stack[--sp]) * (kNodeStride / 4);
      float4 q0 = __ldg(row), q1 = __ldg(row + 1), q2 = __ldg(row + 2), q3 = __ldg(row + 3);
      float4 q4 = __ldg(row + 4), q5 = __ldg(row + 5), q6 = __ldg(row + 6), q7 = __ldg(row + 7);
      const Box box[4] = {{q0.x, q0.y, q0.z, q0.w, q1.x, q1.y},
                          {q1.z, q1.w, q2.x, q2.y, q2.z, q2.w},
                          {q3.x, q3.y, q3.z, q3.w, q4.x, q4.y},
                          {q4.z, q4.w, q5.x, q5.y, q5.z, q5.w}};
      const int enc[4] = {__float_as_int(q6.x), __float_as_int(q6.y), __float_as_int(q6.z),
                          __float_as_int(q6.w)};
      // Every box is tested against the cap from before the visit's leaves.
      unsigned leaves = 0, inner = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        bool hit = slab_box(box[k], r, bt);
        int field = enc[k] & 31;
        if (hit && is_leaf(field) && gate.resident(enc[k] >> 5)) leaves |= 1u << k;
        if (hit && field >= kInnerField) inner |= 1u << k;
      }
      // Leaf slots in slot order 0..3, as the plain walk takes them.
      while (leaves) {
        int k = __ffs(leaves) - 1;
        leaves &= leaves - 1;
        int e = pick(k, enc[0], enc[1], enc[2], enc[3]);
        closest_leaf(tris + static_cast<int64_t>(gate.row(e >> 5)) * G * kTriStride, (e & 31) * G, r,
                     bt, btri, bu, bv);
      }
      push_inner(stack, sp, enc, inner, __float_as_int(q7.x), pos);
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
    const float4* rows = reinterpret_cast<const float4*>(nodes);
    unsigned pos = pos_bits(rb);
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      const float4* row = rows + static_cast<int64_t>(stack[--sp]) * (kNodeStride / 4);
      float4 q0 = __ldg(row), q1 = __ldg(row + 1), q2 = __ldg(row + 2), q3 = __ldg(row + 3);
      float4 q4 = __ldg(row + 4), q5 = __ldg(row + 5), q6 = __ldg(row + 6), q7 = __ldg(row + 7);
      const Box box[4] = {{q0.x, q0.y, q0.z, q0.w, q1.x, q1.y},
                          {q1.z, q1.w, q2.x, q2.y, q2.z, q2.w},
                          {q3.x, q3.y, q3.z, q3.w, q4.x, q4.y},
                          {q4.z, q4.w, q5.x, q5.y, q5.z, q5.w}};
      const int enc[4] = {__float_as_int(q6.x), __float_as_int(q6.y), __float_as_int(q6.z),
                          __float_as_int(q6.w)};
      unsigned mb = 0, ml = 0, leaves = 0, inner = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        bool hb = live_b && slab_box(box[k], rb, bt);
        bool hl = live_l && !occ && slab_box(box[k], rl, cap_l);
        int field = enc[k] & 31;
        mb |= static_cast<unsigned>(hb) << k;
        ml |= static_cast<unsigned>(hl) << k;
        if ((hb || hl) && is_leaf(field) && gate.resident(enc[k] >> 5)) leaves |= 1u << k;
        if ((hb || hl) && field >= kInnerField) inner |= 1u << k;
      }
      // Leaf slots in slot order 0..3, as the plain walk takes them.
      while (leaves) {
        int k = __ffs(leaves) - 1;
        leaves &= leaves - 1;
        int e = pick(k, enc[0], enc[1], enc[2], enc[3]);
        combo_leaf(tris + static_cast<int64_t>(gate.row(e >> 5)) * G * kTriStride, (e & 31) * G,
                   (mb >> k) & 1u, (ml >> k) & 1u, rb, rl, cap_l, bt, btri, bu, bv, occ);
      }
      push_inner(stack, sp, enc, inner, __float_as_int(q7.x), pos);
    }
  }
  t_out[i] = btri >= 0 ? bt : __int_as_float(0x7f800000);
  tri_out[i] = btri;
  u_out[i] = bu;
  v_out[i] = bv;
  occ_out[i] = occ;
}

// K2 for launches of up to a few hundred thousand rays (a path's vertices:
// a frame's later launches hold 10^3-10^4 lanes, too few to fill the card,
// and each warp's time is its slowest ray's walk): kGroup lanes walk one ray
// together, so that a visit's box tests and a leaf slot's triangles run side
// by side.  Lanes 0-3 test the bounce ray against boxes
// 0-3, lanes 4-7 the shadow ray; a slot's triangles are dealt out to the
// lanes and tested against the cap from before the slot, and the bounce hit
// is the least t with the earliest triangle on a tie, which is the answer
// of the sequential test.  Every lane keeps the same stack and ray state.
constexpr int kGroup = 8;

// A leaf's `slots` slots of G triangles from `slot` for the fused walks'
// group bodies (K2, K7b), in slot order: each lane tests its triangles g =
// sub, sub + kGroup, ... of a slot against the caps from before the slot;
// the group's least (t, g) is the bounce hit, and any lane's shadow hit
// occludes.  Every lane of the group calls it with the same arguments
// except `sub`, and leaves with the same bt, btri, bu, bv and occ.
__device__ __forceinline__ void combo_group_slots(const float* __restrict__ slot, int slots, int G,
                                                  int sub, int base, unsigned group, bool tb,
                                                  bool tl, const Ray& rb, const Ray& rl,
                                                  float cap_l, float& bt, int& btri, float& bu,
                                                  float& bv, bool& occ) {
  for (int s = 0; s < slots; ++s, slot += G * kTriStride) {
    float best_t = bt, best_u = 0.0f, best_v = 0.0f;
    int best_g = G, best_id = -1;
    bool hit_l = false;
    for (int g = sub; g < G; g += kGroup) {
      Tri tr = load_tri(slot + g * kTriStride);
      float t, u, v;
      if (tb && moller_tri(tr, rb, bt, t, u, v) && t < best_t) {
        best_t = t;
        best_g = g;
        best_u = u;
        best_v = v;
        best_id = tr.id;
      }
      if (tl && !occ && moller_tri(tr, rl, cap_l, t, u, v)) hit_l = true;
    }
    // The group's least (t, g).
    float win_t = best_t;
    int win_g = best_g;
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1) {
      float ot = __shfl_xor_sync(group, win_t, off);
      int og = __shfl_xor_sync(group, win_g, off);
      if (ot < win_t || (ot == win_t && og < win_g)) {
        win_t = ot;
        win_g = og;
      }
    }
    if (win_g < G) {
      int owner = base + win_g % kGroup;
      bt = win_t;
      btri = __shfl_sync(group, best_id, owner);
      bu = __shfl_sync(group, best_u, owner);
      bv = __shfl_sync(group, best_v, owner);
    }
    occ = occ || (__ballot_sync(group, hit_l) != 0u);
  }
}

template <class Gate>
__global__ void combo_fat4_group_kernel(const float* __restrict__ o, const float* __restrict__ b,
                                        const float* __restrict__ l,
                                        const float* __restrict__ tmax_b, int sb,
                                        const float* __restrict__ tmax_l, int sl,
                                        const float* __restrict__ nodes,
                                        const float* __restrict__ tris, int G, int n,
                                        float* __restrict__ t_out, int32_t* __restrict__ tri_out,
                                        float* __restrict__ u_out, float* __restrict__ v_out,
                                        bool* __restrict__ occ_out, Gate gate) {
  int i = (blockIdx.x * blockDim.x + threadIdx.x) / kGroup;
  if (i >= n) return;  // the whole group
  const int sub = threadIdx.x % kGroup;
  const int base = (threadIdx.x & 31) - sub;
  const unsigned group = ((1u << kGroup) - 1u) << base;
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
    unsigned pos = pos_bits(rb);
    const bool shadow_lane = sub >= 4;
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      const float* row = nodes + static_cast<int64_t>(stack[--sp]) * kNodeStride;
      // This lane's box, 6 floats at 24 * (sub % 4) bytes: 3 8-byte loads.
      const float2* bp = reinterpret_cast<const float2*>(row + 6 * (sub & 3));
      float2 b0 = __ldg(bp), b1 = __ldg(bp + 1), b2 = __ldg(bp + 2);
      float4 q6 = __ldg(reinterpret_cast<const float4*>(row) + 6);
      int om = __float_as_int(__ldg(row + 28));
      const Box bx = {b0.x, b0.y, b1.x, b1.y, b2.x, b2.y};
      bool hit = shadow_lane ? live_l && !occ && slab_box(bx, rl, cap_l)
                             : live_b && slab_box(bx, rb, bt);
      unsigned bits = __ballot_sync(group, hit) >> base;
      unsigned mb = bits & 15u, ml = (bits >> 4) & 15u;
      const int enc[4] = {__float_as_int(q6.x), __float_as_int(q6.y), __float_as_int(q6.z),
                          __float_as_int(q6.w)};
      unsigned leaves = 0, inner = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        bool tested = ((mb | ml) >> k) & 1u;
        int field = enc[k] & 31;
        if (tested && is_leaf(field) && gate.resident(enc[k] >> 5)) leaves |= 1u << k;
        if (tested && field >= kInnerField) inner |= 1u << k;
      }
      while (leaves) {
        int k = __ffs(leaves) - 1;
        leaves &= leaves - 1;
        int e = pick(k, enc[0], enc[1], enc[2], enc[3]);
        combo_group_slots(tris + static_cast<int64_t>(gate.row(e >> 5)) * G * kTriStride, e & 31, G,
                          sub, base, group, (mb >> k) & 1u, (ml >> k) & 1u, rb, rl, cap_l, bt,
                          btri, bu, bv, occ);
      }
      push_inner(stack, sp, enc, inner, om, pos);
    }
  }
  if (sub == 0) {
    t_out[i] = btri >= 0 ? bt : __int_as_float(0x7f800000);
    tri_out[i] = btri;
    u_out[i] = bu;
    v_out[i] = bv;
    occ_out[i] = occ;
  }
}

// One leaf's `count` triangles from `slot` for the any-hit walks' group
// bodies (K3, K7c): each lane tests its triangles j = sub, sub + kGroup,
// ... against cap, and one ballot gives the group's answer.  Every lane of
// the group calls it with the same arguments except `sub`.
__device__ __forceinline__ bool any_leaf_group(const float* __restrict__ slot, int count, int sub,
                                               unsigned group, const Ray& r, float cap) {
  bool hit = false;
  for (int j = sub; j < count; j += kGroup) {
    Tri tr = load_tri(slot + j * kTriStride);
    float t, u, v;
    if (moller_tri(tr, r, cap, t, u, v)) hit = true;
  }
  return __ballot_sync(group, hit) != 0u;
}

// K3, the any-hit walk (and so its paged build K6a, its SlotRange build
// K6b and the subtree chains K6c), redesigned for Hopper.  Occlusion under
// a fixed cap does not depend on the order of the walk: the walk tests
// every triangle of every leaf whose box the ray enters under the cap, and
// stops at the first hit.  So any body gives the plain walk's occ bit for
// bit; both keep its push order (slots pushed 0..3, slot 3 on top) all the
// same, so that the work counts stay comparable.  Two bodies behind one
// launch (launch_any_fat4), as K2's:
//   - one thread per ray for large launches (2^21 rays at a path vertex,
//     the direct pass), with K1's and K2's levers: the row as 16-byte loads
//     right after the pop (7 of the 8: the order meta is not needed),
//     masks and encodings in registers, triangles as 8-byte loads, the leaf
//     loop unrolled by 4;
//   - kGroup lanes per ray for small ones (the main path's last-vertex
//     launch holds ~1,200 rays, 10 blocks of 128 threads on a 132-SM card,
//     so one thread per ray takes as long as its slowest warp's walk):
//     lanes 0-3 test boxes 0-3 (lanes 4-7 repeat them), a leaf's triangles
//     are dealt out to the lanes, and one ballot tells the group whether to
//     leave the walk.
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
    const float4* rows = reinterpret_cast<const float4*>(nodes);
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0 && !occ) {
      const float4* row = rows + static_cast<int64_t>(stack[--sp]) * (kNodeStride / 4);
      float4 q0 = __ldg(row), q1 = __ldg(row + 1), q2 = __ldg(row + 2), q3 = __ldg(row + 3);
      float4 q4 = __ldg(row + 4), q5 = __ldg(row + 5), q6 = __ldg(row + 6);
      const Box box[4] = {{q0.x, q0.y, q0.z, q0.w, q1.x, q1.y},
                          {q1.z, q1.w, q2.x, q2.y, q2.z, q2.w},
                          {q3.x, q3.y, q3.z, q3.w, q4.x, q4.y},
                          {q4.z, q4.w, q5.x, q5.y, q5.z, q5.w}};
      const int enc[4] = {__float_as_int(q6.x), __float_as_int(q6.y), __float_as_int(q6.z),
                          __float_as_int(q6.w)};
      unsigned leaves = 0, inner = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        bool hit = slab_box(box[k], r, cap);
        int field = enc[k] & 31;
        if (hit && is_leaf(field) && gate.resident(enc[k] >> 5)) leaves |= 1u << k;
        if (hit && field >= kInnerField) inner |= 1u << k;
      }
      while (leaves && !occ) {
        int k = __ffs(leaves) - 1;
        leaves &= leaves - 1;
        int e = pick(k, enc[0], enc[1], enc[2], enc[3]);
        occ = any_leaf(tris + static_cast<int64_t>(gate.row(e >> 5)) * G * kTriStride, (e & 31) * G,
                       r, cap);
      }
      if (!occ) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if ((inner >> k) & 1u) stack[sp++] = pick(k, enc[0], enc[1], enc[2], enc[3]) >> 5;
      }
    }
  }
  occ_out[i] = occ;
}

// K3's group body: kGroup lanes walk one ray.
template <class Gate>
__global__ void any_fat4_group_kernel(const float* __restrict__ o, const float* __restrict__ d,
                                      const float* __restrict__ tmax, int tmax_stride,
                                      const float* __restrict__ nodes,
                                      const float* __restrict__ tris, int G, int n,
                                      bool* __restrict__ occ_out, Gate gate) {
  int i = (blockIdx.x * blockDim.x + threadIdx.x) / kGroup;
  if (i >= n) return;  // the whole group
  const int sub = threadIdx.x % kGroup;
  const int base = (threadIdx.x & 31) - sub;
  const unsigned group = ((1u << kGroup) - 1u) << base;
  Ray r = make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1], d[3 * i + 2]);
  float cap = tmax[i * tmax_stride];
  bool occ = false;
  if (!is_dead(r.ox, r.dx, r.dy, r.dz) && cap > kEps) {
    int stack[kStackMax];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      const float* row = nodes + static_cast<int64_t>(stack[--sp]) * kNodeStride;
      // This lane's box, 6 floats at 24 * (sub % 4) bytes: 3 8-byte loads.
      const float2* bp = reinterpret_cast<const float2*>(row + 6 * (sub & 3));
      float2 b0 = __ldg(bp), b1 = __ldg(bp + 1), b2 = __ldg(bp + 2);
      float4 q6 = __ldg(reinterpret_cast<const float4*>(row) + 6);
      const Box bx = {b0.x, b0.y, b1.x, b1.y, b2.x, b2.y};
      unsigned hits = (__ballot_sync(group, slab_box(bx, r, cap)) >> base) & 15u;
      const int enc[4] = {__float_as_int(q6.x), __float_as_int(q6.y), __float_as_int(q6.z),
                          __float_as_int(q6.w)};
      unsigned leaves = 0, inner = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        bool hit = (hits >> k) & 1u;
        int field = enc[k] & 31;
        if (hit && is_leaf(field) && gate.resident(enc[k] >> 5)) leaves |= 1u << k;
        if (hit && field >= kInnerField) inner |= 1u << k;
      }
      while (leaves) {
        int k = __ffs(leaves) - 1;
        leaves &= leaves - 1;
        int e = pick(k, enc[0], enc[1], enc[2], enc[3]);
        if (any_leaf_group(tris + static_cast<int64_t>(gate.row(e >> 5)) * G * kTriStride,
                           (e & 31) * G, sub, group, r, cap)) {
          occ = true;
          break;
        }
      }
      if (occ) break;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if ((inner >> k) & 1u) stack[sp++] = pick(k, enc[0], enc[1], enc[2], enc[3]) >> 5;
    }
  }
  if (sub == 0) occ_out[i] = occ;
}

// K8: one BVH2 node per visit over rows [n, 8] f32: lo.xyz, hi.xyz, then
// enc as int32 bits (leaf: first_slot*32 + slots; inner: right*32 + 16 +
// axis*2 + left_is_lower, left child = node + 1).  A node's own box is
// tested when it is popped; a leaf then intersects its slots.
//
// K8 redesigned for Hopper.  Its real launches walk one node: the tables
// of a root-leaf scene (the one-node route) and of a single-leaf subtree
// chunk hold one row, so a ray's cost is one row, one slab test and, for
// the rays that enter the box, one leaf of field * G triangles (8 on the
// ~2M scene's single-leaf chunks, 16 for the 12-triangle box).  Both walks
// take K1's levers: the 32-byte row as two 16-byte loads (lo.xyz + hi.x,
// then hi.yz + enc + pad) with box and enc in registers, and the leaf's
// contiguous slots through the shared leaf loops (8-byte triangle loads,
// the loop unrolled by 4).  The general walk stays as it was: the near
// child on top for closest hit, the Pallas kernel's fixed right-below-left
// order for any hit.  Device time against the kernels before this design
// on the same launches (chip_smoke.py --ab, A B B A twice; H100 80GB HBM3
// at 700 W):
//   - closest, one thread per ray: a 1080p frame's 2M primary rays over a
//     single-leaf chunk of the ~2M scene 0.0538 -> 0.0364 ms, over the box
//     0.0865 -> 0.0784; the ~2M scene's 439k-ray bounce launches 0.0111 ->
//     0.0058, the box's 1.26M-ray one 0.0336 -> 0.0228;
//   - closest, kGroup lanes a ray (closest_node_group_kernel): 10.8k- and
//     5.4k-ray launches 0.0041 -> 0.0025 ms.  On subsets of the chunk's
//     primary rays it beats one thread per ray 1.6x at 4,096 rays, 1.4x at
//     16,384 and ties at 32,768; at 65,536 it loses 1.9x and at 262,144
//     6.3x (the box's rays: 2.0x, 1.6x, tie, 1.8x slower), since most rays
//     miss a single leaf's box and the group then spends 8 lanes on one
//     slab test.  So it runs only while its lanes fit one wave of the card
//     (kNodeGroupWaves: 33,792 rays on an H100);
//   - any hit, one thread per ray (any_node_kernel): unchanged, 0.0137 ms
//     on the box's 1.26M shadow rays and 0.0047 on a 439k-ray launch: its
//     rays mostly miss the box, so the row and ray loads are its work.  A
//     group body lost on every launch and subset measured, 1,093 to 439k
//     rays (0.0018 against 0.0017 ms at 1,093, 0.026 against 0.0047 at
//     439k), and was dropped.
constexpr int kOneNodeStride = 8;

struct NodeRow {
  Box box;
  int enc;
};

__device__ __forceinline__ NodeRow load_node(const float* __restrict__ nodes, int node) {
  const float4* row =
      reinterpret_cast<const float4*>(nodes) + static_cast<int64_t>(node) * (kOneNodeStride / 4);
  float4 a = __ldg(row), b = __ldg(row + 1);
  return {{a.x, a.y, a.z, a.w, b.x, b.y}, __float_as_int(b.z)};
}

// One leaf's `count` triangles from `slot` for K8's closest-hit group body:
// each lane tests its triangles j = sub, sub + kGroup, ... against the cap
// from before the leaf and keeps its least t (the earliest j on a tie); the
// group's least (t, j) is the hit the sequential test under the running cap
// gives.  Every lane of the group calls it with the same arguments except
// `sub`, and leaves with the same bt, btri, bu and bv.
__device__ __forceinline__ void closest_leaf_group(const float* __restrict__ slot, int count,
                                                   int sub, int base, unsigned group, const Ray& r,
                                                   float& bt, int& btri, float& bu, float& bv) {
  float best_t = bt, best_u = 0.0f, best_v = 0.0f;
  int best_j = count, best_id = -1;
  for (int j = sub; j < count; j += kGroup) {
    Tri tr = load_tri(slot + j * kTriStride);
    float t, u, v;
    if (moller_tri(tr, r, bt, t, u, v) && t < best_t) {
      best_t = t;
      best_j = j;
      best_u = u;
      best_v = v;
      best_id = tr.id;
    }
  }
  float win_t = best_t;
  int win_j = best_j;
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1) {
    float ot = __shfl_xor_sync(group, win_t, off);
    int oj = __shfl_xor_sync(group, win_j, off);
    if (ot < win_t || (ot == win_t && oj < win_j)) {
      win_t = ot;
      win_j = oj;
    }
  }
  if (win_j < count) {
    int owner = base + win_j % kGroup;
    bt = win_t;
    btri = __shfl_sync(group, best_id, owner);
    bu = __shfl_sync(group, best_u, owner);
    bv = __shfl_sync(group, best_v, owner);
  }
}

// K8 closest hit, one thread per ray.
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
    unsigned pos = pos_bits(r);
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      int node = stack[--sp];
      NodeRow nr = load_node(nodes, node);
      if (!slab_box(nr.box, r, bt)) continue;
      int field = nr.enc & 31, meta = nr.enc >> 5;
      if (is_leaf(field)) {
        closest_leaf(tris + static_cast<int64_t>(meta) * G * kTriStride, field * G, r, bt, btri, bu,
                     bv);
      } else if (field >= kInnerField) {
        // Near child on top: the left child is nearer when the ray's sign
        // on the split axis agrees with left_is_lower.
        bool near_is_left = near_first_bits(field - kInnerField, pos);
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

// K8 closest hit's group body: kGroup lanes walk one ray, each lane with
// the same row, box test and stack; a leaf's triangles are dealt out.
__global__ void closest_node_group_kernel(const float* __restrict__ o, const float* __restrict__ d,
                                          const float* __restrict__ tmax, int tmax_stride,
                                          const float* __restrict__ nodes,
                                          const float* __restrict__ tris, int G, int n,
                                          float* __restrict__ t_out, int32_t* __restrict__ tri_out,
                                          float* __restrict__ u_out, float* __restrict__ v_out) {
  int i = (blockIdx.x * blockDim.x + threadIdx.x) / kGroup;
  if (i >= n) return;  // the whole group
  const int sub = threadIdx.x % kGroup;
  const int base = (threadIdx.x & 31) - sub;
  const unsigned group = ((1u << kGroup) - 1u) << base;
  Ray r = make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1], d[3 * i + 2]);
  float bt = tmax[i * tmax_stride];
  int btri = -1;
  float bu = 0.0f, bv = 0.0f;
  if (!is_dead(r.ox, r.dx, r.dy, r.dz) && bt > kEps) {
    int stack[kStackMax];
    unsigned pos = pos_bits(r);
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      int node = stack[--sp];
      NodeRow nr = load_node(nodes, node);
      if (!slab_box(nr.box, r, bt)) continue;
      int field = nr.enc & 31, meta = nr.enc >> 5;
      if (is_leaf(field)) {
        closest_leaf_group(tris + static_cast<int64_t>(meta) * G * kTriStride, field * G, sub, base,
                           group, r, bt, btri, bu, bv);
      } else if (field >= kInnerField) {
        bool near_is_left = near_first_bits(field - kInnerField, pos);
        stack[sp++] = near_is_left ? meta : node + 1;
        stack[sp++] = near_is_left ? node + 1 : meta;
      }
    }
  }
  if (sub == 0) {
    t_out[i] = btri >= 0 ? bt : __int_as_float(0x7f800000);
    tri_out[i] = btri;
    u_out[i] = bu;
    v_out[i] = bv;
  }
}

// K8 any hit, one thread per ray: out at the first hit.
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
      NodeRow nr = load_node(nodes, node);
      if (!slab_box(nr.box, r, cap)) continue;
      int field = nr.enc & 31, meta = nr.enc >> 5;
      if (is_leaf(field)) {
        occ = any_leaf(tris + static_cast<int64_t>(meta) * G * kTriStride, field * G, r, cap);
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

// The hit inner children in `inner`, far first and near on top (K7a/K7b
// order), by the order meta om and the sign bits pos.
__device__ __forceinline__ void push_fat_inner(int* stack, int& sp, const int (&enc)[2],
                                               unsigned inner, int om, unsigned pos) {
  const int far = near_first_bits(om, pos) ? 1 : 0;
  if ((inner >> far) & 1u) stack[sp++] = (far ? enc[1] : enc[0]) >> 5;
  if ((inner >> (1 - far)) & 1u) stack[sp++] = (far ? enc[0] : enc[1]) >> 5;
}

// K7a, the fat2 closest hit, redesigned for Hopper with K1's levers: the
// 64-byte row as 4 16-byte loads right after the pop, both boxes and both
// encodings in registers, leaf and inner children as bit masks (no array
// indexed at run time), and triangles through closest_leaf (5 8-byte loads
// each, the leaf loop unrolled by 4).  It visits the same nodes and tests
// the same triangles in the same order with the same arithmetic as
// closest_hit_fat_plain, so t, tri, u and v stay equal to it bit for bit.
// It keeps one thread per ray: every launch is a frame's primary rays (~2M
// at 1080p, once per subtree chunk on the chained route), far above
// group_rays(), where the group bodies stop winning.
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
    const float4* rows = reinterpret_cast<const float4*>(nodes);
    unsigned pos = pos_bits(r);
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      const float4* row = rows + static_cast<int64_t>(stack[--sp]) * (kFatStride / 4);
      float4 q0 = __ldg(row), q1 = __ldg(row + 1), q2 = __ldg(row + 2), q3 = __ldg(row + 3);
      const Box box[2] = {{q0.x, q0.y, q0.z, q0.w, q1.x, q1.y},
                          {q1.z, q1.w, q2.x, q2.y, q2.z, q2.w}};
      const int enc[2] = {__float_as_int(q3.x), __float_as_int(q3.y)};
      unsigned leaves = 0, inner = 0;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        bool hit = slab_box(box[k], r, bt);
        int field = enc[k] & 31;
        if (hit && is_leaf(field)) leaves |= 1u << k;
        if (hit && field >= kInnerField) inner |= 1u << k;
      }
      // The left leaf child's slots, then the right one's.
      while (leaves) {
        int k = __ffs(leaves) - 1;
        leaves &= leaves - 1;
        int e = k ? enc[1] : enc[0];
        closest_leaf(tris + static_cast<int64_t>(e >> 5) * G * kTriStride, (e & 31) * G, r, bt,
                     btri, bu, bv);
      }
      push_fat_inner(stack, sp, enc, inner, __float_as_int(q3.z), pos);
    }
  }
  t_out[i] = btri >= 0 ? bt : __int_as_float(0x7f800000);
  tri_out[i] = btri;
  u_out[i] = bu;
  v_out[i] = bv;
}

// K7b, the fused walk over fat2 rows, redesigned for Hopper with K2's
// design: a 64-byte row as 4 16-byte loads right after the pop, boxes,
// masks and encodings in registers, a triangle loaded once for both rays as
// 5 8-byte loads, the leaf loop unrolled by 4 (combo_leaf), and for
// launches up to group_rays() a group body (combo_fat_group_kernel).  Each
// visits the same nodes and tests the same triangles in the same order as
// shadow_closest_fat_plain, so tri, t, u, v and occ stay equal to it.  A
// 1080p fat2 frame gives it one first-vertex launch (~443k rays on the
// bench view) and two small ones (7.5k-59k rays).
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
    const float4* rows = reinterpret_cast<const float4*>(nodes);
    unsigned pos = pos_bits(rb);
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      const float4* row = rows + static_cast<int64_t>(stack[--sp]) * (kFatStride / 4);
      float4 q0 = __ldg(row), q1 = __ldg(row + 1), q2 = __ldg(row + 2), q3 = __ldg(row + 3);
      const Box box[2] = {{q0.x, q0.y, q0.z, q0.w, q1.x, q1.y},
                          {q1.z, q1.w, q2.x, q2.y, q2.z, q2.w}};
      const int enc[2] = {__float_as_int(q3.x), __float_as_int(q3.y)};
      // The bounce hit is gated by the bounce box, the shadow hit by the
      // shadow box and its own cap.
      unsigned mb = 0, ml = 0, leaves = 0, inner = 0;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        bool hb = live_b && slab_box(box[k], rb, bt);
        bool hl = live_l && !occ && slab_box(box[k], rl, cap_l);
        int field = enc[k] & 31;
        mb |= static_cast<unsigned>(hb) << k;
        ml |= static_cast<unsigned>(hl) << k;
        if ((hb || hl) && is_leaf(field)) leaves |= 1u << k;
        if ((hb || hl) && field >= kInnerField) inner |= 1u << k;
      }
      // The left leaf child's slots, then the right one's.
      while (leaves) {
        int k = __ffs(leaves) - 1;
        leaves &= leaves - 1;
        int e = k ? enc[1] : enc[0];
        combo_leaf(tris + static_cast<int64_t>(e >> 5) * G * kTriStride, (e & 31) * G,
                   (mb >> k) & 1u, (ml >> k) & 1u, rb, rl, cap_l, bt, btri, bu, bv, occ);
      }
      push_fat_inner(stack, sp, enc, inner, __float_as_int(q3.z), pos);
    }
  }
  t_out[i] = btri >= 0 ? bt : __int_as_float(0x7f800000);
  tri_out[i] = btri;
  u_out[i] = bu;
  v_out[i] = bv;
  occ_out[i] = occ;
}

// K7b's group body, K2's applied to fat2 rows: kGroup lanes walk one ray.
// Lanes 0-1 test the bounce ray against the two boxes and lanes 2-3 the
// shadow ray (lanes 4-7 repeat them); a slot's triangles are dealt out to
// the lanes (combo_group_slots).
__global__ void combo_fat_group_kernel(const float* __restrict__ o, const float* __restrict__ b,
                                       const float* __restrict__ l,
                                       const float* __restrict__ tmax_b, int sb,
                                       const float* __restrict__ tmax_l, int sl,
                                       const float* __restrict__ nodes,
                                       const float* __restrict__ tris, int G, int n,
                                       float* __restrict__ t_out, int32_t* __restrict__ tri_out,
                                       float* __restrict__ u_out, float* __restrict__ v_out,
                                       bool* __restrict__ occ_out) {
  int i = (blockIdx.x * blockDim.x + threadIdx.x) / kGroup;
  if (i >= n) return;  // the whole group
  const int sub = threadIdx.x % kGroup;
  const int base = (threadIdx.x & 31) - sub;
  const unsigned group = ((1u << kGroup) - 1u) << base;
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
    unsigned pos = pos_bits(rb);
    const bool shadow_lane = (sub & 2) != 0;
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      const float* row = nodes + static_cast<int64_t>(stack[--sp]) * kFatStride;
      // This lane's box, 6 floats at 24 * (sub % 2) bytes: 3 8-byte loads.
      const float2* bp = reinterpret_cast<const float2*>(row + 6 * (sub & 1));
      float2 b0 = __ldg(bp), b1 = __ldg(bp + 1), b2 = __ldg(bp + 2);
      float4 q3 = __ldg(reinterpret_cast<const float4*>(row) + 3);
      const Box bx = {b0.x, b0.y, b1.x, b1.y, b2.x, b2.y};
      bool hit = shadow_lane ? live_l && !occ && slab_box(bx, rl, cap_l)
                             : live_b && slab_box(bx, rb, bt);
      unsigned bits = __ballot_sync(group, hit) >> base;
      unsigned mb = bits & 3u, ml = (bits >> 2) & 3u;
      const int enc[2] = {__float_as_int(q3.x), __float_as_int(q3.y)};
      unsigned leaves = 0, inner = 0;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        bool tested = ((mb | ml) >> k) & 1u;
        int field = enc[k] & 31;
        if (tested && is_leaf(field)) leaves |= 1u << k;
        if (tested && field >= kInnerField) inner |= 1u << k;
      }
      while (leaves) {
        int k = __ffs(leaves) - 1;
        leaves &= leaves - 1;
        int e = k ? enc[1] : enc[0];
        combo_group_slots(tris + static_cast<int64_t>(e >> 5) * G * kTriStride, e & 31, G, sub,
                          base, group, (mb >> k) & 1u, (ml >> k) & 1u, rb, rl, cap_l, bt, btri, bu,
                          bv, occ);
      }
      push_fat_inner(stack, sp, enc, inner, __float_as_int(q3.z), pos);
    }
  }
  if (sub == 0) {
    t_out[i] = btri >= 0 ? bt : __int_as_float(0x7f800000);
    tri_out[i] = btri;
    u_out[i] = bu;
    v_out[i] = bv;
    occ_out[i] = occ;
  }
}

// K7c, the fat2 any hit, redesigned for Hopper as K3: occlusion under a
// fixed cap does not depend on the order of the walk, so both bodies give
// any_hit_fat_plain's occ bit for bit, and both keep JAX's any-hit push
// order (left pushed first, right on top) so that the work counts stay
// comparable.  Two bodies behind one launch (nb_any_fat):
//   - one thread per ray for large launches (2^21 rays, the chains' direct
//     pass): the row as 4 16-byte loads right after the pop, masks and
//     encodings in registers, triangles through any_leaf (8-byte loads, the
//     leaf loop unrolled by 4), out at the first hit;
//   - kGroup lanes per ray for small ones (a fat2 frame's last-vertex
//     launch holds ~1,200 rays, 10 blocks of one thread per ray): lane
//     sub & 1 tests box sub & 1 (3 8-byte loads), one ballot gives the hit
//     mask, a leaf's triangles are dealt out to the lanes (any_leaf_group),
//     and one ballot tells the group to leave at the first hit.
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
    const float4* rows = reinterpret_cast<const float4*>(nodes);
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0 && !occ) {
      const float4* row = rows + static_cast<int64_t>(stack[--sp]) * (kFatStride / 4);
      float4 q0 = __ldg(row), q1 = __ldg(row + 1), q2 = __ldg(row + 2), q3 = __ldg(row + 3);
      const Box box[2] = {{q0.x, q0.y, q0.z, q0.w, q1.x, q1.y},
                          {q1.z, q1.w, q2.x, q2.y, q2.z, q2.w}};
      const int enc[2] = {__float_as_int(q3.x), __float_as_int(q3.y)};
      unsigned leaves = 0, inner = 0;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        bool hit = slab_box(box[k], r, cap);
        int field = enc[k] & 31;
        if (hit && is_leaf(field)) leaves |= 1u << k;
        if (hit && field >= kInnerField) inner |= 1u << k;
      }
      while (leaves && !occ) {
        int k = __ffs(leaves) - 1;
        leaves &= leaves - 1;
        int e = k ? enc[1] : enc[0];
        occ = any_leaf(tris + static_cast<int64_t>(e >> 5) * G * kTriStride, (e & 31) * G, r, cap);
      }
      if (!occ) {
        if (inner & 1u) stack[sp++] = enc[0] >> 5;
        if (inner & 2u) stack[sp++] = enc[1] >> 5;
      }
    }
  }
  occ_out[i] = occ;
}

// K7c's group body: kGroup lanes walk one ray.
__global__ void any_fat_group_kernel(const float* __restrict__ o, const float* __restrict__ d,
                                     const float* __restrict__ tmax, int tmax_stride,
                                     const float* __restrict__ nodes,
                                     const float* __restrict__ tris, int G, int n,
                                     bool* __restrict__ occ_out) {
  int i = (blockIdx.x * blockDim.x + threadIdx.x) / kGroup;
  if (i >= n) return;  // the whole group
  const int sub = threadIdx.x % kGroup;
  const int base = (threadIdx.x & 31) - sub;
  const unsigned group = ((1u << kGroup) - 1u) << base;
  Ray r = make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1], d[3 * i + 2]);
  float cap = tmax[i * tmax_stride];
  bool occ = false;
  if (!is_dead(r.ox, r.dx, r.dy, r.dz) && cap > kEps) {
    int stack[kStackMax];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      const float* row = nodes + static_cast<int64_t>(stack[--sp]) * kFatStride;
      // This lane's box, 6 floats at 24 * (sub % 2) bytes: 3 8-byte loads.
      const float2* bp = reinterpret_cast<const float2*>(row + 6 * (sub & 1));
      float2 b0 = __ldg(bp), b1 = __ldg(bp + 1), b2 = __ldg(bp + 2);
      float2 e2 = __ldg(reinterpret_cast<const float2*>(row + 12));
      const Box bx = {b0.x, b0.y, b1.x, b1.y, b2.x, b2.y};
      unsigned hits = (__ballot_sync(group, slab_box(bx, r, cap)) >> base) & 3u;
      const int enc[2] = {__float_as_int(e2.x), __float_as_int(e2.y)};
      unsigned leaves = 0, inner = 0;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        bool hit = (hits >> k) & 1u;
        int field = enc[k] & 31;
        if (hit && is_leaf(field)) leaves |= 1u << k;
        if (hit && field >= kInnerField) inner |= 1u << k;
      }
      while (leaves) {
        int k = __ffs(leaves) - 1;
        leaves &= leaves - 1;
        int e = k ? enc[1] : enc[0];
        if (any_leaf_group(tris + static_cast<int64_t>(e >> 5) * G * kTriStride, (e & 31) * G, sub,
                           group, r, cap)) {
          occ = true;
          break;
        }
      }
      if (occ) break;
      if (inner & 1u) stack[sp++] = enc[0] >> 5;
      if (inner & 2u) stack[sp++] = enc[1] >> 5;
    }
  }
  if (sub == 0) occ_out[i] = occ;
}

inline int grid_for(int n) { return (n + kThreads - 1) / kThreads; }

// K2's launch: the group kernel for n <= kGroupWaves * SMs * (resident
// threads per SM) / kGroup rays (540,672 on an H100), else one thread per
// ray.  For one view, more rays put more nearby origins into each sorted
// warp, so one thread per ray gains with the count and the group kernel
// does not.  On the bench scene's own first-vertex launches (H100 80GB
// HBM3 at 700 W, chip_smoke.py --ab, each body on the same launch): 443k
// rays (1080p) group 0.380 ms against 0.463; 788k (1440p) 0.707 against
// 0.513; 1.77M (2160p) 1.414 against 0.850.  Every later launch (7.5k-59k
// rays) is 2-4x faster as a group.  K3, K7b and K7c (launch_any_fat4,
// nb_combo_fat, nb_any_fat) take the same cutoff through launch_by_size,
// K8's closest hit a sixteenth of it (kNodeGroupWaves).
constexpr int64_t kGroupWaves = 16;
constexpr int kMaxDevices = 64;

// The most rays the group kernel takes on the current device, read once
// per device.
cudaError_t group_rays(int64_t* rays) {
  static int64_t cache[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
    if (err != cudaSuccess) return err;
    cache[dev] = kGroupWaves * sms * per_sm / kGroup;
  }
  *rays = cache[dev];
  return cudaSuccess;
}

// K8's closest hit takes its group body only while the group's lanes fit
// one wave of the card (see above closest_node_group_kernel).
constexpr int64_t kNodeGroupWaves = 1;

// Enqueues a walk of n rays: group() (its group body, kGroup lanes a ray)
// up to group_rays() rays (or `waves` waves of the group's lanes), else
// thread() (one thread per ray).
template <class Group, class Thread>
int launch_by_size(int n, Group group, Thread thread, int64_t waves = kGroupWaves) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  int64_t most = 0;
  cudaError_t err = group_rays(&most);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= most / kGroupWaves * waves) {
    group();
  } else {
    thread();
  }
  return static_cast<int>(cudaGetLastError());
}

template <class Gate>
int launch_any_fat4(const float* o, const float* d, const float* tmax, int tmax_stride,
                    const float* nodes, const float* tris, int G, int n, bool* occ, Gate gate,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_by_size(
      n,
      [&] {
        any_fat4_group_kernel<<<grid_for(n * kGroup), kThreads, 0, st>>>(
            o, d, tmax, tmax_stride, nodes, tris, G, n, occ, gate);
      },
      [&] {
        any_fat4_kernel<<<grid_for(n), kThreads, 0, st>>>(o, d, tmax, tmax_stride, nodes, tris,
                                                          G, n, occ, gate);
      });
}

template <class Gate>
int launch_combo_fat4(const float* o, const float* b, const float* l, const float* tmax_b, int sb,
                      const float* tmax_l, int sl, const float* nodes, const float* tris, int G,
                      int n, float* t, int32_t* tri, float* u, float* v, bool* occ, Gate gate,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_by_size(
      n,
      [&] {
        combo_fat4_group_kernel<<<grid_for(n * kGroup), kThreads, 0, st>>>(
            o, b, l, tmax_b, sb, tmax_l, sl, nodes, tris, G, n, t, tri, u, v, occ, gate);
      },
      [&] {
        combo_fat4_kernel<<<grid_for(n), kThreads, 0, st>>>(o, b, l, tmax_b, sb, tmax_l, sl,
                                                            nodes, tris, G, n, t, tri, u, v,
                                                            occ, gate);
      });
}

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
  return launch_combo_fat4(o, b, l, tmax_b, sb, tmax_l, sl, nodes, tris, G, n, t, tri, u, v, occ,
                           AllSlots{}, stream);
}

// The most rays for which K2, K3 (all their builds), K7b and K7c run their
// group bodies on the current device; one thread per ray above it (K1, K7a
// and K8's any hit always take one thread per ray).
int nb_group_rays(int64_t* rays) { return static_cast<int>(group_rays(rays)); }

int nb_any_fat4(const float* o, const float* d, const float* tmax, int tmax_stride,
                const float* nodes, const float* tris, int G, int n, bool* occ,
                void* stream) {
  return launch_any_fat4(o, d, tmax, tmax_stride, nodes, tris, G, n, occ, AllSlots{}, stream);
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
  return launch_combo_fat4(o, b, l, tmax_b, sb, tmax_l, sl, nodes, tris, G, n, t, tri, u, v, occ,
                           SlotRange{slot_lo, slot_hi}, stream);
}

int nb_any_fat4_slots(const float* o, const float* d, const float* tmax, int tmax_stride,
                      const float* nodes, const float* tris, int G, int n, int slot_lo,
                      int slot_hi, bool* occ, void* stream) {
  return launch_any_fat4(o, d, tmax, tmax_stride, nodes, tris, G, n, occ,
                         SlotRange{slot_lo, slot_hi}, stream);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_by_size(
      n,
      [&] {
        combo_fat_group_kernel<<<grid_for(n * kGroup), kThreads, 0, st>>>(
            o, b, l, tmax_b, sb, tmax_l, sl, nodes, tris, G, n, t, tri, u, v, occ);
      },
      [&] {
        combo_fat_kernel<<<grid_for(n), kThreads, 0, st>>>(o, b, l, tmax_b, sb, tmax_l, sl,
                                                           nodes, tris, G, n, t, tri, u, v, occ);
      });
}

int nb_any_fat(const float* o, const float* d, const float* tmax, int tmax_stride,
               const float* nodes, const float* tris, int G, int n, bool* occ, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_by_size(
      n,
      [&] {
        any_fat_group_kernel<<<grid_for(n * kGroup), kThreads, 0, st>>>(o, d, tmax, tmax_stride,
                                                                          nodes, tris, G, n, occ);
      },
      [&] {
        any_fat_kernel<<<grid_for(n), kThreads, 0, st>>>(o, d, tmax, tmax_stride, nodes, tris, G,
                                                         n, occ);
      });
}

// K8 over one-node rows: closest hit's group body up to
// nb_node_group_rays() rays, one thread per ray above; any hit one thread
// per ray.
int nb_closest_node(const float* o, const float* d, const float* tmax, int tmax_stride,
                    const float* nodes, const float* tris, int G, int n, float* t,
                    int32_t* tri, float* u, float* v, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_by_size(
      n,
      [&] {
        closest_node_group_kernel<<<grid_for(n * kGroup), kThreads, 0, st>>>(
            o, d, tmax, tmax_stride, nodes, tris, G, n, t, tri, u, v);
      },
      [&] {
        closest_node_kernel<<<grid_for(n), kThreads, 0, st>>>(o, d, tmax, tmax_stride, nodes, tris,
                                                              G, n, t, tri, u, v);
      },
      kNodeGroupWaves);
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

// The most rays for which K8's closest hit runs its group body on the
// current device.
int nb_node_group_rays(int64_t* rays) {
  int64_t most = 0;
  cudaError_t err = group_rays(&most);
  *rays = most / kGroupWaves * kNodeGroupWaves;
  return static_cast<int>(err);
}

}  // extern "C"
