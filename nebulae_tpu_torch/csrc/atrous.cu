// SVGF a-trous step: forward kernel K4 and backward kernel K5.
//
// K4 replaces the Pallas stencil nebulae_tpu/kernels/pallas_svgf.py:
// _atrous_kernel in mode "fwd" (via _run_stencil / atrous_step_pallas).  One
// dilated 5x5 B3-spline step with the SVGF edge stops
//   wz = exp(-|z0 - z| / (phi_z * step)),  wn = clip(n0 . n, 0, 1)^phi_n,
//   wl = exp(-|lum0 - lum| / vscale0),     vscale0 = max(phi_c sqrt(var0), 1e-6)
// and output sum(c w) / max(sum(w), 1e-4) plus sum(w).  Taps outside the
// image carry zero weight (the Pallas kernel's zero pad has the same
// effect), so they are skipped.
//
// K5 replaces the same Pallas kernel in mode "bwd" (via _atrous_bwd, the
// custom VJP of atrous_step_pallas).  The weights are constants of the
// gradient, so the step is linear in the radiance and its VJP is the
// transposed stencil
//   grad_c(q) = sum_o g(q+o) w(q+o, q),   g = gbar / max(sum_w, 1e-4),
// with the forward's weight math evaluated around the tap pixel p = q+o:
// the luminance stop divides by the tap's vscale (the forward multiplies by
// the centre's 1/vscale, as the Pallas kernel does in each mode).  Taps
// outside the image have g = 0 in the Pallas kernel and are skipped here.
//
// K4's design (atrous_fwd_kernel) is K5's, applied to the forward: a block
// takes 32x8 outputs of one residue class of the step and stages their
// 36x12 neighbourhood's own terms once in shared memory (r, g, b,
// luminance and clamped depth, normal: two 16-byte words a pixel, 13,824
// bytes); the 25 taps then run out of shared memory, two loads a tap, and
// each output's centre takes 1/vscale from its own variance.  The design it
// replaces ran one thread per pixel and read every tap's radiance, depth
// and normal from device memory (7 loads and a luminance a tap), with the
// phi_normal power as a loop at run time.  Its byte bound is 0.030 ms (48
// bytes per pixel over 3.35 TB/s); what is left per tap is issue slots for
// ~30 f32 operations (two expf, the power), as in K5.  Measured (chip_smoke.py
// --ab, 1080p, mean of steps 1, 2, 4, 8; H100 80GB HBM3 at 700 W, one
// run): 0.409 ms -> 0.240 with the tile and the power unrolled, -> 0.186
// with each staged pixel as two 16-byte words (two shared loads a tap
// instead of eight).  32 registers and 13,824 bytes of shared memory a
// block of 256 threads: 64 of 64 warps per SM.
//
// K5's design (atrous_bwd_kernel below) stages each pixel's own terms once
// in a shared-memory tile of its residue subgrid and runs the taps out of
// shared memory.  Its DRAM bytes (60 per pixel) bound it at ~0.04 ms on the
// H100; what it spends is the pairs' arithmetic (two expf, the power, one
// division per tap).  Measured against the one-thread-per-pixel design that
// formed g, luminance and vscale at every tap (chip_smoke.py --ab, 1080p,
// mean of steps 1, 2, 4, 8; H100 80GB HBM3 at 700 W, one run): 0.584
// ms -> 0.491 with the tile, -> 0.314 with the power unrolled for
// phi_normal 128.  Unrolling the 25 taps as well: 0.299 against 0.304, no
// better, dropped.  48 registers and 15,552 bytes of shared memory a block
// of 256 threads: 40 of 64 warps per SM.
//
// Built with --fmad=false and precise expf so that they follow the plain
// PyTorch versions' rounding.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;

__device__ __forceinline__ float lum_rgb(float r, float g, float b) {
  return (r * 0.2126f + g * 0.7152f) + b * 0.0722f;
}

__device__ __forceinline__ float lum_of(const float* __restrict__ c) {
  return lum_rgb(__ldg(c), __ldg(c + 1), __ldg(c + 2));
}

__device__ __forceinline__ float pow_static(float x, int n) {
  // Binary exponentiation in the Pallas kernel's order (_pow_static).
  float acc = 1.0f;
  bool have = false;
  float base = x;
  while (n) {
    if (n & 1) {
      acc = have ? acc * base : base;
      have = true;
    }
    n >>= 1;
    if (n) base = base * base;
  }
  return acc;
}

// Both kernels tile the residue subgrid of their step: the taps of step s
// around pixel (x, y) fall on pixels congruent to (x, y) mod s, so a block
// takes kThreadsX x kThreadsY outputs spaced s apart, one residue class, and
// stages their (kThreadsX + 4) x (kThreadsY + 4) neighbourhood.  Each staged
// pixel's own terms are computed once, and the 25-tap stencil then reads
// them from shared memory, with the arithmetic and dy-major order of the
// plain version, so each kernel equals it exactly.  Blocks are numbered
// residue first, so the s*s blocks that share a region of the image (and
// its cache sectors) run side by side.  kPhiNormal > 0 fixes phi_normal at
// compile time, so that pow_static unrolls into its squarings; 0 takes it
// at run time.  SVGF's phi_normal is 128 unless a caller sets another.
constexpr int kHalo = 2;
constexpr int kDefaultPhiNormal = 128;
constexpr int kTileW = kThreadsX + 2 * kHalo;
constexpr int kTileH = kThreadsY + 2 * kHalo;
constexpr int kTilePts = kTileW * kTileH;

// The residue class and subgrid tile of a block: (rx, ry) the residue,
// (sx0, sy0) the subgrid coordinates of the tile's first output.
struct SubgridTile {
  int rx, ry, sx0, sy0;
};

__device__ __forceinline__ SubgridTile subgrid_tile(int w, int step) {
  int classes = step * step;
  int res = blockIdx.x % classes;
  int tile = blockIdx.x / classes;
  int tiles_x = ((w + step - 1) / step + kThreadsX - 1) / kThreadsX;
  return {res % step, res / step, (tile % tiles_x) * kThreadsX, (tile / tiles_x) * kThreadsY};
}

template <int kPhiNormal>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
atrous_fwd_kernel(const float* __restrict__ rad, const float* __restrict__ var,
                  const float* __restrict__ depth, const float* __restrict__ nrm, int h, int w,
                  int step, float phi_color, int phi_normal, float inv_phi_z,
                  float* __restrict__ out, float* __restrict__ sum_w_out) {
  const float b3[5] = {1.0f / 16.0f, 1.0f / 4.0f, 3.0f / 8.0f, 1.0f / 4.0f, 1.0f / 16.0f};
  // A staged pixel as two 16-byte words, so that a tap is two shared loads:
  // (r, g, b, luminance) and (clamped depth, normal xyz).
  __shared__ float4 s_col[kTilePts], s_geo[kTilePts];
  const SubgridTile st = subgrid_tile(w, step);
  for (int p = threadIdx.y * kThreadsX + threadIdx.x; p < kTilePts; p += kThreadsX * kThreadsY) {
    int px = st.rx + step * (st.sx0 + p % kTileW - kHalo);
    int py = st.ry + step * (st.sy0 + p / kTileW - kHalo);
    if (px < 0 || px >= w || py < 0 || py >= h) continue;  // never read: outside the image
    int64_t q = static_cast<int64_t>(py) * w + px;
    float r = __ldg(rad + 3 * q), g = __ldg(rad + 3 * q + 1), b = __ldg(rad + 3 * q + 2);
    s_col[p] = make_float4(r, g, b, lum_rgb(r, g, b));
    s_geo[p] = make_float4(fminf(__ldg(depth + q), 1e8f), __ldg(nrm + 3 * q), __ldg(nrm + 3 * q + 1),
                           __ldg(nrm + 3 * q + 2));
  }
  __syncthreads();
  int x = st.rx + step * (st.sx0 + threadIdx.x);
  int y = st.ry + step * (st.sy0 + threadIdx.y);
  if (x >= w || y >= h) return;
  int64_t p = static_cast<int64_t>(y) * w + x;
  int c = (threadIdx.y + kHalo) * kTileW + threadIdx.x + kHalo;
  const float lum0 = s_col[c].w;
  const float4 g0 = s_geo[c];
  float vs0 = fmaxf(phi_color * sqrtf(fmaxf(__ldg(var + p), 1e-8f)), 1e-6f);
  float inv_vs0 = 1.0f / fmaxf(vs0, 1e-9f);
  float sr = 0.0f, sg = 0.0f, sb = 0.0f, sw = 0.0f;
  for (int dy = -2; dy <= 2; ++dy) {
    int yy = y + dy * step;
    if (yy < 0 || yy >= h) continue;
    for (int dx = -2; dx <= 2; ++dx) {
      int xx = x + dx * step;
      if (xx < 0 || xx >= w) continue;
      const float4 tc = s_col[c + dy * kTileW + dx], tg = s_geo[c + dy * kTileW + dx];
      // Indexed by |offset| as in the JAX package (centre 1/16, outer 3/8).
      float k = b3[abs(dy)] * b3[abs(dx)];
      float ndot = (g0.y * tg.y + g0.z * tg.z) + g0.w * tg.w;
      float wn = pow_static(fminf(fmaxf(ndot, 0.0f), 1.0f),
                            kPhiNormal > 0 ? kPhiNormal : phi_normal);
      float wz = expf(-fabsf(g0.x - tg.x) * inv_phi_z);
      float dl = fabsf(lum0 - tc.w);
      float wl = expf(-dl * inv_vs0);
      float wt = ((k * wz) * wn) * wl;
      sr = sr + tc.x * wt;
      sg = sg + tc.y * wt;
      sb = sb + tc.z * wt;
      sw = sw + wt;
    }
  }
  float inv = 1.0f / fmaxf(sw, 1e-4f);
  out[3 * p] = sr * inv;
  out[3 * p + 1] = sg * inv;
  out[3 * p + 2] = sb * inv;
  sum_w_out[p] = sw;
}

__device__ __forceinline__ float vscale_of(float var, float phi_color) {
  return fmaxf(phi_color * sqrtf(fmaxf(var, 1e-8f)), 1e-6f);
}

// K5's staged terms per pixel: g = gbar / max(sum_w, 1e-4), its luminance,
// clamped depth, normal and tap vscale max(vscale, 1e-9).
template <int kPhiNormal>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
atrous_bwd_kernel(const float* __restrict__ gbar, const float* __restrict__ sum_w,
                  const float* __restrict__ rad, const float* __restrict__ var,
                  const float* __restrict__ depth, const float* __restrict__ nrm, int h, int w,
                  int step, float phi_color, int phi_normal, float inv_phi_z,
                  float* __restrict__ grad) {
  const float b3[5] = {1.0f / 16.0f, 1.0f / 4.0f, 3.0f / 8.0f, 1.0f / 4.0f, 1.0f / 16.0f};
  __shared__ float s_gr[kTilePts], s_gg[kTilePts], s_gb[kTilePts], s_lum[kTilePts];
  __shared__ float s_z[kTilePts], s_nx[kTilePts], s_ny[kTilePts], s_nz[kTilePts];
  __shared__ float s_vs[kTilePts];
  const SubgridTile st = subgrid_tile(w, step);
  for (int p = threadIdx.y * kThreadsX + threadIdx.x; p < kTilePts; p += kThreadsX * kThreadsY) {
    int px = st.rx + step * (st.sx0 + p % kTileW - kHalo);
    int py = st.ry + step * (st.sy0 + p / kTileW - kHalo);
    if (px < 0 || px >= w || py < 0 || py >= h) continue;  // never read: outside the image
    int64_t q = static_cast<int64_t>(py) * w + px;
    float norm = fmaxf(__ldg(sum_w + q), 1e-4f);
    s_gr[p] = __ldg(gbar + 3 * q) / norm;
    s_gg[p] = __ldg(gbar + 3 * q + 1) / norm;
    s_gb[p] = __ldg(gbar + 3 * q + 2) / norm;
    s_lum[p] = lum_of(rad + 3 * q);
    s_z[p] = fminf(__ldg(depth + q), 1e8f);
    s_nx[p] = __ldg(nrm + 3 * q);
    s_ny[p] = __ldg(nrm + 3 * q + 1);
    s_nz[p] = __ldg(nrm + 3 * q + 2);
    s_vs[p] = fmaxf(vscale_of(__ldg(var + q), phi_color), 1e-9f);
  }
  __syncthreads();
  int x = st.rx + step * (st.sx0 + threadIdx.x);
  int y = st.ry + step * (st.sy0 + threadIdx.y);
  if (x >= w || y >= h) return;
  int c = (threadIdx.y + kHalo) * kTileW + threadIdx.x + kHalo;
  float lum0 = s_lum[c], z0 = s_z[c];
  float n0x = s_nx[c], n0y = s_ny[c], n0z = s_nz[c];
  float sr = 0.0f, sg = 0.0f, sb = 0.0f;
  for (int dy = -2; dy <= 2; ++dy) {
    int yy = y + dy * step;
    if (yy < 0 || yy >= h) continue;
    for (int dx = -2; dx <= 2; ++dx) {
      int xx = x + dx * step;
      if (xx < 0 || xx >= w) continue;
      int t = c + dy * kTileW + dx;
      float k = b3[abs(dy)] * b3[abs(dx)];
      float ndot = (n0x * s_nx[t] + n0y * s_ny[t]) + n0z * s_nz[t];
      float wn = pow_static(fminf(fmaxf(ndot, 0.0f), 1.0f),
                            kPhiNormal > 0 ? kPhiNormal : phi_normal);
      float wz = expf(-fabsf(z0 - s_z[t]) * inv_phi_z);
      float dl = fabsf(lum0 - s_lum[t]);
      float wl = expf(-dl / s_vs[t]);
      float wt = ((k * wz) * wn) * wl;
      sr = sr + s_gr[t] * wt;
      sg = sg + s_gg[t] * wt;
      sb = sb + s_gb[t] * wt;
    }
  }
  int64_t q = static_cast<int64_t>(y) * w + x;
  grad[3 * q] = sr;
  grad[3 * q + 1] = sg;
  grad[3 * q + 2] = sb;
}

// One block per residue class per subgrid tile (both kernels).
inline int subgrid_blocks(int h, int w, int step) {
  int tiles_x = ((w + step - 1) / step + kThreadsX - 1) / kThreadsX;
  int tiles_y = ((h + step - 1) / step + kThreadsY - 1) / kThreadsY;
  return step * step * tiles_x * tiles_y;
}

}  // namespace

extern "C" {

int nb_atrous_fwd(const float* rad, const float* var, const float* depth, const float* nrm,
                  int h, int w, int step, float phi_color, int phi_normal, float inv_phi_z,
                  float* out, float* sum_w, void* stream) {
  if (h > 0 && w > 0) {
    dim3 block(kThreadsX, kThreadsY);
    auto kernel = phi_normal == kDefaultPhiNormal ? atrous_fwd_kernel<kDefaultPhiNormal>
                                                  : atrous_fwd_kernel<0>;
    kernel<<<subgrid_blocks(h, w, step), block, 0, static_cast<cudaStream_t>(stream)>>>(
        rad, var, depth, nrm, h, w, step, phi_color, phi_normal, inv_phi_z, out, sum_w);
  }
  return static_cast<int>(cudaGetLastError());
}

int nb_atrous_bwd(const float* gbar, const float* sum_w, const float* rad, const float* var,
                  const float* depth, const float* nrm, int h, int w, int step, float phi_color,
                  int phi_normal, float inv_phi_z, float* grad, void* stream) {
  if (h > 0 && w > 0) {
    dim3 block(kThreadsX, kThreadsY);
    auto kernel = phi_normal == kDefaultPhiNormal ? atrous_bwd_kernel<kDefaultPhiNormal>
                                                  : atrous_bwd_kernel<0>;
    kernel<<<subgrid_blocks(h, w, step), block, 0, static_cast<cudaStream_t>(stream)>>>(
        gbar, sum_w, rad, var, depth, nrm, h, w, step, phi_color, phi_normal, inv_phi_z, grad);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
