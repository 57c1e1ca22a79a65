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
// K4's design: one thread per output pixel, reading its 25 taps straight
// from device memory (row-major [H, W, C] inputs).  The Pallas kernel staged
// 40-row halo blocks in VMEM because the TPU has no cache; here the taps of
// neighbouring threads overlap and are served by L1/L2, so the DRAM traffic
// is about one read of each input and one write of each output.
// Luminance, clamped depth and vscale are computed in the kernel instead of
// in a separate packing pass.  Bound: DRAM bytes (48 per pixel) and f32 work
// (~25 taps x ~30 ops) are both far below what its load instructions cost:
// it is bound by L1/texture load throughput.
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

__device__ __forceinline__ float lum_of(const float* __restrict__ c) {
  return (__ldg(c) * 0.2126f + __ldg(c + 1) * 0.7152f) + __ldg(c + 2) * 0.0722f;
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

__global__ void atrous_fwd_kernel(const float* __restrict__ rad, const float* __restrict__ var,
                                  const float* __restrict__ depth,
                                  const float* __restrict__ nrm, int h, int w, int step,
                                  float phi_color, int phi_normal, float inv_phi_z,
                                  float* __restrict__ out, float* __restrict__ sum_w_out) {
  const float b3[5] = {1.0f / 16.0f, 1.0f / 4.0f, 3.0f / 8.0f, 1.0f / 4.0f, 1.0f / 16.0f};
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  int64_t p = static_cast<int64_t>(y) * w + x;
  float lum0 = lum_of(rad + 3 * p);
  float z0 = fminf(__ldg(depth + p), 1e8f);
  float n0x = __ldg(nrm + 3 * p), n0y = __ldg(nrm + 3 * p + 1), n0z = __ldg(nrm + 3 * p + 2);
  float vs0 = fmaxf(phi_color * sqrtf(fmaxf(__ldg(var + p), 1e-8f)), 1e-6f);
  float inv_vs0 = 1.0f / fmaxf(vs0, 1e-9f);
  float sr = 0.0f, sg = 0.0f, sb = 0.0f, sw = 0.0f;
  for (int dy = -2; dy <= 2; ++dy) {
    int yy = y + dy * step;
    if (yy < 0 || yy >= h) continue;
    for (int dx = -2; dx <= 2; ++dx) {
      int xx = x + dx * step;
      if (xx < 0 || xx >= w) continue;
      int64_t q = static_cast<int64_t>(yy) * w + xx;
      // Indexed by |offset| as in the JAX package (centre 1/16, outer 3/8).
      float k = b3[abs(dy)] * b3[abs(dx)];
      float zt = fminf(__ldg(depth + q), 1e8f);
      float ndot = (n0x * __ldg(nrm + 3 * q) + n0y * __ldg(nrm + 3 * q + 1)) +
                   n0z * __ldg(nrm + 3 * q + 2);
      float wn = pow_static(fminf(fmaxf(ndot, 0.0f), 1.0f), phi_normal);
      float wz = expf(-fabsf(z0 - zt) * inv_phi_z);
      const float* c = rad + 3 * q;
      float dl = fabsf(lum0 - lum_of(c));
      float wl = expf(-dl * inv_vs0);
      float wt = ((k * wz) * wn) * wl;
      sr = sr + __ldg(c) * wt;
      sg = sg + __ldg(c + 1) * wt;
      sb = sb + __ldg(c + 2) * wt;
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

// K5 tiles the residue subgrid of its step: the taps of step s around
// pixel (x, y) fall on pixels congruent to (x, y) mod s, so a block takes
// kThreadsX x kThreadsY outputs spaced s apart, one residue class, and
// stages their (kThreadsX + 4) x (kThreadsY + 4) neighbourhood.  Each staged
// pixel's own terms are computed once: g = gbar / max(sum_w, 1e-4), its
// luminance, clamped depth, normal and tap vscale max(vscale, 1e-9).  The
// 25-tap transposed stencil then reads them from shared memory, with the
// arithmetic and dy-major order of the plain version, so K5 equals it
// exactly.  Blocks are numbered residue first, so the s*s blocks that share
// a region of the image (and its cache sectors) run side by side.
// kPhiNormal > 0 fixes phi_normal at compile time, so that pow_static
// unrolls into its squarings; 0 takes it at run time.  SVGF's phi_normal
// is 128 unless a caller sets another.
constexpr int kHalo = 2;
constexpr int kDefaultPhiNormal = 128;
constexpr int kTileW = kThreadsX + 2 * kHalo;
constexpr int kTileH = kThreadsY + 2 * kHalo;
constexpr int kTilePts = kTileW * kTileH;

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
  int classes = step * step;
  int res = blockIdx.x % classes;
  int tile = blockIdx.x / classes;
  int tiles_x = ((w + step - 1) / step + kThreadsX - 1) / kThreadsX;
  int rx = res % step, ry = res / step;
  // Subgrid coordinates of the tile's first output.
  int sx0 = (tile % tiles_x) * kThreadsX, sy0 = (tile / tiles_x) * kThreadsY;
  for (int p = threadIdx.y * kThreadsX + threadIdx.x; p < kTilePts; p += kThreadsX * kThreadsY) {
    int px = rx + step * (sx0 + p % kTileW - kHalo);
    int py = ry + step * (sy0 + p / kTileW - kHalo);
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
  int x = rx + step * (sx0 + threadIdx.x);
  int y = ry + step * (sy0 + threadIdx.y);
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

}  // namespace

extern "C" {

int nb_atrous_fwd(const float* rad, const float* var, const float* depth, const float* nrm,
                  int h, int w, int step, float phi_color, int phi_normal, float inv_phi_z,
                  float* out, float* sum_w, void* stream) {
  if (h > 0 && w > 0) {
    dim3 block(kThreadsX, kThreadsY);
    dim3 grid((w + kThreadsX - 1) / kThreadsX, (h + kThreadsY - 1) / kThreadsY);
    atrous_fwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        rad, var, depth, nrm, h, w, step, phi_color, phi_normal, inv_phi_z, out, sum_w);
  }
  return static_cast<int>(cudaGetLastError());
}

int nb_atrous_bwd(const float* gbar, const float* sum_w, const float* rad, const float* var,
                  const float* depth, const float* nrm, int h, int w, int step, float phi_color,
                  int phi_normal, float inv_phi_z, float* grad, void* stream) {
  if (h > 0 && w > 0) {
    // One block per residue class per subgrid tile (atrous_bwd_kernel).
    int tiles_x = ((w + step - 1) / step + kThreadsX - 1) / kThreadsX;
    int tiles_y = ((h + step - 1) / step + kThreadsY - 1) / kThreadsY;
    dim3 block(kThreadsX, kThreadsY);
    auto kernel = phi_normal == kDefaultPhiNormal ? atrous_bwd_kernel<kDefaultPhiNormal>
                                                  : atrous_bwd_kernel<0>;
    kernel<<<step * step * tiles_x * tiles_y, block, 0, static_cast<cudaStream_t>(stream)>>>(
        gbar, sum_w, rad, var, depth, nrm, h, w, step, phi_color, phi_normal, inv_phi_z, grad);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
