// SVGF a-trous forward step, kernel K4.
//
// Replaces the Pallas stencil nebulae_tpu/kernels/pallas_svgf.py:
// _atrous_kernel in mode "fwd" (via _run_stencil / atrous_step_pallas).  One
// dilated 5x5 B3-spline step with the SVGF edge stops
//   wz = exp(-|z0 - z| / (phi_z * step)),  wn = clip(n0 . n, 0, 1)^phi_n,
//   wl = exp(-|lum0 - lum| / vscale0),     vscale0 = max(phi_c sqrt(var0), 1e-6)
// and output sum(c w) / max(sum(w), 1e-4) plus sum(w).  Taps outside the
// image carry zero weight (the Pallas kernel's zero pad has the same
// effect), so they are skipped.
//
// Design: one thread per output pixel, reading its 25 taps straight from
// device memory (row-major [H, W, C] inputs).  The Pallas kernel staged
// 40-row halo blocks in VMEM because the TPU has no cache; here the taps of
// neighbouring threads overlap and are served by L1/L2, so the DRAM traffic
// is about one read of each input and one write of each output.  Luminance,
// clamped depth and the centre variance scale are computed in the kernel
// instead of in a separate packing pass.
//
// Bound: DRAM bytes (48 per pixel) and f32 work (~25 taps x ~30 ops) are
// both far below what the kernel's load instructions cost: it is bound by
// L1/texture load throughput.  A shared-memory tile with a halo is the
// known next step.
//
// Built with --fmad=false and precise expf so that it follows the plain
// PyTorch version's rounding.

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

}  // extern "C"
