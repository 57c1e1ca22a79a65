// Path-vertex draws and ray keys: kernel K9, one launch a path vertex.
//
// K9 replaces no TPU kernel.  On the TPU, XLA's jit fused each vertex's
// elementwise chain (nebulae_tpu/passes/pathtrace.py nee_bounce_draws, the
// shading half of _nee_direct, and tracer/sorting.py ray_sort_key) into a
// few loops.  Eager PyTorch issues every operation of that chain as a launch
// of its own: ~273 a bounce vertex, ~162 at the last vertex, and 111 for
// each sort key, each at full width (a lane a pixel).  The host's issue of
// those launches, not their device time, set the pace of a frame.
//
// Per lane, the bounce form (Last = false) makes the vertex's 5 XorShift
// draws in the RNG contract's order (2 sun-disk NEE, 1 lobe roulette, 2
// cosine bounce) and computes what the plain version
// (kernels/vertex.py bounce_draws_plain) computes from them: the NEE
// direction l and its clamped cosine, the GGX + Lambert BRDF f, the shadow
// mask, the offset origin, the bounce direction, the diffuse weight over
// the lobe probability, the roulette decision and that probability, the
// new RNG state and, with Key, ray_sort_key(origin, new_d).  The last form
// (Last = true) makes the 2 NEE draws and writes l, its cosine, f, the
// shadow mask, the shadow origin (DEAD_ORIGIN where the lane does not
// shoot), the state and ray_sort_key(origin, l).
//
// Bound: device memory.  A bounce lane reads 77 bytes and writes 86
// (163 B; ~338 MB at 1080p, 0.10 ms at 3.35 TB/s); its ~400 f32
// operations, two sinf/cosf pairs and three rsqrtf are far below the
// card's rate.  So the design is one thread a lane, each input read once
// and each output written once, with every intermediate in registers.
// The scene box and the sun's direction and disk radius are read on the
// device from their tensors: no host copy, no wait.
//
// Rounding: built with --fmad=false, every operation is written in the
// plain version's order and rounds as PyTorch's eager CUDA operation does
// (a*b+c is two roundings; clamp keeps NaN; x / c for a Python float c is
// x * (1.0f / (float)c), as ATen's division by a CPU scalar computes it;
// constants are Python doubles rounded to float).  normalize's
// powf(n + eps, -0.5) (core/math.py) is rsqrtf here: ATen's pow with a
// CPU-scalar exponent of -0.5 computes rsqrtf on the card, and its sin, cos,
// sqrt and reciprocal are sinf, cosf, sqrtf and 1/x (each equal on every
// one of 4,194,304 lanes, H100 80GB HBM3 at 700 W).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

// Python's constants, as PyTorch rounds them to float.
constexpr double kPi = 3.14159265358979;
constexpr float kTwoPi = static_cast<float>(2.0 * kPi);
constexpr float kInvPi = 1.0f / static_cast<float>(kPi);
constexpr float kPiF = static_cast<float>(kPi);
constexpr float kEps = static_cast<float>(1e-12);
constexpr float kDeadOrigin = static_cast<float>(1.0e14);
constexpr float kOffset = static_cast<float>(1e-4);
constexpr float kF0 = static_cast<float>(0.04);

struct VertexArgs {
  // Inputs: rows of 3 floats (unit column stride) or single values, each
  // with its row stride in elements.
  const float* position;
  const float* normal_g;
  const float* normal_s;
  const float* albedo;
  const float* view;
  const float* roughness;
  const float* metalness;
  const unsigned char* alive;
  const long long* rng_in;
  long long s_position, s_normal_g, s_normal_s, s_albedo, s_view, s_roughness, s_metalness, s_alive,
      s_rng;
  // The sun ([3] direction, 0-d tan of the half angle) and the scene box ([3] each).
  const float* sun_dir;
  const float* tan_half;
  const float* aabb_min;
  const float* aabb_max;
  // Outputs, contiguous: [N, 3] rows or [N].  The bounce-only ones are
  // unused by the last form.
  float* l;
  float* n_dot_l;
  float* f;
  unsigned char* shoot;
  float* origin;
  float* new_d;
  float* weight;
  unsigned char* rr_continue;
  float* p_d;
  long long* rng_out;
  long long* key;
  long long n;
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p, long long stride, long long i) {
  const float* r = p + i * stride;
  return {__ldg(r), __ldg(r + 1), __ldg(r + 2)};
}

__device__ __forceinline__ void store3(float* p, long long i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

// torch.clamp / clamp(min=): NaN passes through (v != v only for NaN).
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }

// core/math.py dot: (x + y) + z.
__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// core/math.py normalize: v * (|v|^2 + eps)^-0.5, which ATen computes as
// rsqrtf on the card.
__device__ __forceinline__ V3 normalize3(V3 v) {
  const float n = v.x * v.x + v.y * v.y + v.z * v.z;
  const float s = rsqrtf(n + kEps);
  return {v.x * s, v.y * s, v.z * s};
}

// core/math.py build_orthonormal_basis (Pixar's branchless frame).
__device__ __forceinline__ void basis(V3 n, V3& t, V3& b) {
  const float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + n.z);
  const float bb = n.x * n.y * a;
  t = {1.0f + sign * n.x * n.x * a, sign * bb, -sign * n.x};
  b = {bb, sign + n.y * n.y * a, -n.y};
}

// core/rng.py: XorShift32, then asfloat(0x3f800000 | x >> 9) - 1.
__device__ __forceinline__ float next_float(uint32_t& s) {
  s ^= s << 13;
  s ^= s >> 17;
  s ^= s << 5;
  return __int_as_float(static_cast<int>(0x3F800000u | (s >> 9))) - 1.0f;
}

// core/brdf.py sun_disk_sample.
__device__ __forceinline__ V3 sun_disk(float u1, float u2, V3 dir, float tan_half) {
  V3 t, b;
  basis(dir, t, b);
  const float r = sqrtf(u1) * tan_half;
  const float phi = u2 * kTwoPi;
  const float c = cosf(phi);
  const float s = sinf(phi);
  return normalize3({dir.x + r * (c * t.x + s * b.x), dir.y + r * (c * t.y + s * b.y),
                     dir.z + r * (c * t.z + s * b.z)});
}

// core/brdf.py cosine_hemisphere_sample.
__device__ __forceinline__ V3 cosine_hemisphere(float u1, float u2, V3 n) {
  const float r = sqrtf(u1);
  const float phi = u2 * kTwoPi;
  V3 t, b;
  basis(n, t, b);
  const float x = r * cosf(phi);
  const float y = r * sinf(phi);
  const float z = sqrtf(clamp_min(1.0f - u1, 0.0f));
  return normalize3({x * t.x + y * b.x + z * n.x, x * t.y + y * b.y + z * n.y, x * t.z + y * b.z + z * n.z});
}

// core/math.py ipow(x, 5): x * ((x * x) * (x * x)).
__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x * (x2 * x2);
}

// core/brdf.py base_f0, one channel.
__device__ __forceinline__ float f0_of(float albedo, float m) { return kF0 * (1.0f - m) + albedo * m; }

// core/brdf.py fresnel_schlick, one channel, given ipow(1 - clip(cos), 5).
__device__ __forceinline__ float fresnel(float f0, float p5) { return f0 + (1.0f - f0) * p5; }

__device__ __forceinline__ float smith_g1(float x, float alpha) {
  const float k = alpha * 0.5f;
  return x / clamp_min(x * (1.0f - k) + k, static_cast<float>(1e-8));
}

__device__ __forceinline__ float luminance(float r, float g, float b) {
  return r * static_cast<float>(0.2126) + g * static_cast<float>(0.7152) + b * static_cast<float>(0.0722);
}

// core/brdf.py eval_brdf(n, v, l, albedo, roughness, metalness).
__device__ __forceinline__ V3 eval_brdf(V3 n, V3 v, V3 l, V3 albedo, float rough, float m) {
  const V3 h = normalize3({v.x + l.x, v.y + l.y, v.z + l.z});
  const float n_dot_l = clampf(dot3(n, l), 0.0f, 1.0f);
  const float n_dot_v = clampf(dot3(n, v), 0.0f, 1.0f);
  const float n_dot_h = clampf(dot3(n, h), 0.0f, 1.0f);
  const float v_dot_h = clampf(dot3(v, h), 0.0f, 1.0f);
  const float alpha = clamp_min(rough * rough, static_cast<float>(1e-3));
  const float p5 = pow5(1.0f - clampf(v_dot_h, 0.0f, 1.0f));
  const V3 fres = {fresnel(f0_of(albedo.x, m), p5), fresnel(f0_of(albedo.y, m), p5),
                   fresnel(f0_of(albedo.z, m), p5)};
  const float a2 = alpha * alpha;
  const float dd = n_dot_h * n_dot_h * (a2 - 1.0f) + 1.0f;
  const float d = a2 / clamp_min(dd * kPiF * dd, static_cast<float>(1e-8));
  const float g = smith_g1(n_dot_l, alpha) * smith_g1(n_dot_v, alpha);
  const float s = d * g / clamp_min(n_dot_l * 4.0f * n_dot_v, static_cast<float>(1e-8));
  const float km = 1.0f - m;
  return {(1.0f - fres.x) * km * albedo.x * kInvPi + fres.x * s,
          (1.0f - fres.y) * km * albedo.y * kInvPi + fres.y * s,
          (1.0f - fres.z) * km * albedo.z * kInvPi + fres.z * s};
}

// tracer's ray_sort_key: [3 dir octant][21 origin morton][5 dir bucket].
__device__ __forceinline__ long long sort_key(V3 o, V3 d, const float* lo, const float* hi) {
  const float lx = __ldg(lo), ly = __ldg(lo + 1), lz = __ldg(lo + 2);
  const float ex = clamp_min(__ldg(hi) - lx, static_cast<float>(1e-6));
  const float ey = clamp_min(__ldg(hi + 1) - ly, static_cast<float>(1e-6));
  const float ez = clamp_min(__ldg(hi + 2) - lz, static_cast<float>(1e-6));
  const long long qx = static_cast<long long>(clampf((o.x - lx) / ex, 0.0f, 1.0f) * 127.0f);
  const long long qy = static_cast<long long>(clampf((o.y - ly) / ey, 0.0f, 1.0f) * 127.0f);
  const long long qz = static_cast<long long>(clampf((o.z - lz) / ez, 0.0f, 1.0f) * 127.0f);
  long long morton = 0;
#pragma unroll
  for (int bit = 0; bit < 7; ++bit) {
    morton |= ((qx >> bit) & 1) << (3 * bit);
    morton |= ((qy >> bit) & 1) << (3 * bit + 1);
    morton |= ((qz >> bit) & 1) << (3 * bit + 2);
  }
  const long long octant = (d.x >= 0.0f ? 1 : 0) + 2 * (d.y >= 0.0f ? 1 : 0) + 4 * (d.z >= 0.0f ? 1 : 0);
  const long long dir_bits = static_cast<long long>(clampf(d.y * 0.5f + 0.5f, 0.0f, 1.0f) * 30.0f);
  return (octant << 26) | (morton << 5) | dir_bits;
}

template <bool Last, bool Key>
__global__ void __launch_bounds__(256) vertex_kernel(const VertexArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const V3 pos = load3(a.position, a.s_position, i);
  const V3 ng = load3(a.normal_g, a.s_normal_g, i);
  const V3 ns = load3(a.normal_s, a.s_normal_s, i);
  const V3 albedo = load3(a.albedo, a.s_albedo, i);
  const V3 view = load3(a.view, a.s_view, i);
  const float rough = __ldg(a.roughness + i * a.s_roughness);
  const float metal = __ldg(a.metalness + i * a.s_metalness);
  const bool alive = __ldg(a.alive + i * a.s_alive) != 0;
  uint32_t state = static_cast<uint32_t>(__ldg(a.rng_in + i * a.s_rng));
  const V3 sun = {__ldg(a.sun_dir), __ldg(a.sun_dir + 1), __ldg(a.sun_dir + 2)};

  // Sun-disk NEE: 2 draws.
  const float u1 = next_float(state);
  const float u2 = next_float(state);
  const V3 l = sun_disk(u1, u2, sun, __ldg(a.tan_half));
  const float n_dot_l = clampf(dot3(ns, l), 0.0f, 1.0f);
  const V3 f = eval_brdf(ns, view, l, albedo, rough, metal);
  // offset_ray_origin: p + n * 1e-4.
  const V3 origin = {pos.x + ng.x * kOffset, pos.y + ng.y * kOffset, pos.z + ng.z * kOffset};
  const bool shoot = alive && n_dot_l > 0.0f;
  store3(a.l, i, l);
  a.n_dot_l[i] = n_dot_l;
  store3(a.f, i, f);
  a.shoot[i] = shoot;

  if constexpr (Last) {
    const V3 o_sh = shoot ? origin : V3{kDeadOrigin, kDeadOrigin, kDeadOrigin};
    store3(a.origin, i, o_sh);
    if constexpr (Key) a.key[i] = sort_key(o_sh, l, a.aabb_min, a.aabb_max);
  } else {
    // Lobe roulette: 1 draw against the diffuse probability.
    const float u_rr = next_float(state);
    const float n_dot_v = clampf(dot3(ns, view), 0.0f, 1.0f);
    const float km = 1.0f - metal;
    const float p5 = pow5(1.0f - clampf(n_dot_v, 0.0f, 1.0f));
    const float fr = fresnel(f0_of(albedo.x, metal), p5);
    const float fg = fresnel(f0_of(albedo.y, metal), p5);
    const float fb = fresnel(f0_of(albedo.z, metal), p5);
    const V3 diff = {albedo.x * km, albedo.y * km, albedo.z * km};
    const float s = luminance(fr, fg, fb);
    const float dl = luminance(diff.x, diff.y, diff.z);
    const float p_spec =
        clampf(s / clamp_min(s + dl, static_cast<float>(1e-8)), static_cast<float>(0.1), static_cast<float>(0.9));
    const float p_d = 1.0f - p_spec;
    // Cosine bounce: 2 draws.
    const float u3 = next_float(state);
    const float u4 = next_float(state);
    const V3 new_d = cosine_hemisphere(u3, u4, ns);
    store3(a.origin, i, origin);
    store3(a.new_d, i, new_d);
    store3(a.weight, i, V3{diff.x / p_d, diff.y / p_d, diff.z / p_d});
    a.rr_continue[i] = u_rr < p_d;
    a.p_d[i] = p_d;
    if constexpr (Key) a.key[i] = sort_key(origin, new_d, a.aabb_min, a.aabb_max);
  }
  a.rng_out[i] = static_cast<long long>(state);
}

template <bool Last>
int launch(const VertexArgs* args, int with_key, void* stream) {
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((args->n + threads - 1) / threads);
  auto kernel = with_key ? vertex_kernel<Last, true> : vertex_kernel<Last, false>;
  kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The size of VertexArgs, which the wrapper's ctypes mirror must match.
int nb_vertex_args_size(void) { return static_cast<int>(sizeof(VertexArgs)); }

int nb_vertex(const void* args, int last, int with_key, void* stream) {
  const VertexArgs* a = static_cast<const VertexArgs*>(args);
  if (a->n <= 0) return static_cast<int>(cudaGetLastError());
  return last ? launch<true>(a, with_key, stream) : launch<false>(a, with_key, stream);
}

}  // extern "C"
