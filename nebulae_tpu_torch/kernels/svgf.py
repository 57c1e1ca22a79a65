"""SVGF a-trous step: kernels K4 (forward) and K5 (backward), their plain
PyTorch versions, and the autograd function that joins them.

K4 replaces `nebulae_tpu/kernels/pallas_svgf.py` _atrous_kernel in mode
"fwd" (reached through atrous_step_pallas); K5 replaces the same kernel in
mode "bwd" (reached through _atrous_bwd, the custom VJP).  Inputs keep the
JAX layout: radiance [H, W, 3], variance [H, W], depth [H, W], normal
[H, W, 3]; the step returns (filtered radiance [H, W, 3], sum of weights
[H, W]).  Taps outside the image carry zero weight.  The weights follow the
Pallas kernel's arithmetic: precomputed 1/(phi_z*step), ^phi_n by repeated
squaring, w = ((k*wz)*wn)*wl, taps summed row by row.  Like the JAX
kernel, the tap weight k is B3[|dy|] * B3[|dx|] -- the B3 table indexed by
the offset's magnitude, so the centre gets 1/16 and the outermost taps 3/8
(not the centred spline [1/16, 1/4, 3/8, 1/4, 1/16]); the port keeps it for
parity.

Gradient contract (as in JAX): the edge-stop weights are constants, so the
step is linear in radiance and its VJP is the transposed stencil

    grad_c(q) = sum_o g(q+o) w(q+o, q),   g = gbar / max(sum_w, 1e-4),

with the forward's weight math evaluated around the tap pixel p = q+o --
so the luminance edge stop divides by the tap's vscale, where the forward
multiplies by the centre's 1/vscale.  Variance, depth and normal get no
gradient.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from nebulae_tpu_torch.core.math import luminance
from nebulae_tpu_torch.kernels.build import check, native
from nebulae_tpu_torch.utils.metrics import count
from nebulae_tpu_torch.utils.profiling import span

B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def _pow_static(x, n: int):
    """x**n for a static integer n (phi_normal 128 -> 7 squarings)."""
    acc = None
    base = x
    while n:
        if n & 1:
            acc = base if acc is None else acc * base
        n >>= 1
        if n:
            base = base * base
    return torch.ones_like(x) if acc is None else acc


def _phi(phi):
    return float(phi[0]), int(phi[1]), float(phi[2])


def _guides(radiance, variance, depth, phi_color: float):
    """Luminance, clamped depth and vscale, as the Pallas kernel's _prep."""
    lum = luminance(radiance)
    z = torch.clamp(depth, max=1e8)
    vs = torch.clamp(phi_color * torch.sqrt(torch.clamp(variance, min=1e-8)), min=1e-6)
    return lum, z, vs


def _taps(chans, step: int):
    """The 25 (k, shifted channel stack) pairs of one step, dy-major, over
    a zero pad (a pad tap has a zero normal, so its weight is zero)."""
    h, w = chans.shape[1:]
    r = 2 * step
    pad = F.pad(chans, (r, r, r, r))
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            y0 = r + dy * step
            x0 = r + dx * step
            yield B3[abs(dy)] * B3[abs(dx)], pad[:, y0:y0 + h, x0:x0 + w]


def atrous_step_plain(radiance, variance, depth, normal, step: int, phi):
    """Plain version of K4 as 25 shifted-slice accumulations."""
    phi_color, phi_normal, phi_depth = _phi(phi)
    lum, z, vs0 = _guides(radiance, variance, depth, phi_color)
    inv_vs0 = 1.0 / torch.clamp(vs0, min=1e-9)
    inv_phi_z = 1.0 / (phi_depth * step)
    chans = torch.stack(
        [radiance[..., 0], radiance[..., 1], radiance[..., 2], lum, z,
         normal[..., 0], normal[..., 1], normal[..., 2]]
    )
    _, _, _, lum0, z0, n0x, n0y, n0z = chans
    sum_r = torch.zeros_like(lum0)
    sum_g = torch.zeros_like(lum0)
    sum_b = torch.zeros_like(lum0)
    sum_w = torch.zeros_like(lum0)
    for k, tap in _taps(chans, step):
        ndot = n0x * tap[5] + n0y * tap[6] + n0z * tap[7]
        wn = _pow_static(torch.clamp(ndot, 0.0, 1.0), phi_normal)
        wz = torch.exp(-torch.abs(z0 - tap[4]) * inv_phi_z)
        wl = torch.exp(-torch.abs(lum0 - tap[3]) * inv_vs0)
        wt = k * wz * wn * wl
        sum_r = sum_r + tap[0] * wt
        sum_g = sum_g + tap[1] * wt
        sum_b = sum_b + tap[2] * wt
        sum_w = sum_w + wt
    inv = 1.0 / torch.clamp(sum_w, min=1e-4)
    return torch.stack([sum_r * inv, sum_g * inv, sum_b * inv], dim=-1), sum_w


def atrous_step_bwd_plain(gbar, sum_w, radiance, variance, depth, normal, step: int, phi):
    """Plain version of K5: the transposed stencil, 25 shifted slices over a
    zero pad in dy-major order.  A pad tap has g = 0, so it adds nothing."""
    phi_color, phi_normal, phi_depth = _phi(phi)
    lum, z, vs = _guides(radiance, variance, depth, phi_color)
    inv_phi_z = 1.0 / (phi_depth * step)
    g = gbar / torch.clamp(sum_w, min=1e-4)[..., None]
    chans = torch.stack(
        [g[..., 0], g[..., 1], g[..., 2], lum, z,
         normal[..., 0], normal[..., 1], normal[..., 2], vs]
    )
    _, _, _, lum0, z0, n0x, n0y, n0z, _ = chans
    sum_r = torch.zeros_like(lum0)
    sum_g = torch.zeros_like(lum0)
    sum_b = torch.zeros_like(lum0)
    for k, tap in _taps(chans, step):
        ndot = n0x * tap[5] + n0y * tap[6] + n0z * tap[7]
        wn = _pow_static(torch.clamp(ndot, 0.0, 1.0), phi_normal)
        wz = torch.exp(-torch.abs(z0 - tap[4]) * inv_phi_z)
        wl = torch.exp(-torch.abs(lum0 - tap[3]) / torch.clamp(tap[8], min=1e-9))
        wt = k * wz * wn * wl
        sum_r = sum_r + tap[0] * wt
        sum_g = sum_g + tap[1] * wt
        sum_b = sum_b + tap[2] * wt
    return torch.stack([sum_r, sum_g, sum_b], dim=-1)


def _check(tensors, h: int, w: int, dev):
    for t, c in tensors:
        shape = (h, w, 3) if c == 3 else (h, w)
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"a-trous inputs must be float32 {shape} on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def _ptrs(tensors):
    return [ctypes.c_void_p(t.data_ptr()) for t in tensors]


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def atrous_step_fwd(radiance, variance, depth, normal, step: int, phi):
    """K4 (csrc/atrous.cu) on CUDA tensors, its plain version on CPU ones.
    No autograd: `atrous_step` is the differentiable entry."""
    h, w = radiance.shape[:2]
    dev = radiance.device
    _check(((radiance, 3), (variance, 1), (depth, 1), (normal, 3)), h, w, dev)
    if int(step) < 1:
        raise ValueError(f"a-trous step must be >= 1, got {step}")
    if dev.type == "cpu":
        return atrous_step_plain(radiance, variance, depth, normal, step, phi)
    out = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    sum_w = torch.empty((h, w), dtype=torch.float32, device=dev)
    if h == 0 or w == 0:
        return out, sum_w
    phi_color, phi_normal, phi_depth = _phi(phi)
    ins = [t.contiguous() for t in (radiance, variance, depth, normal)]
    p = _ptrs(ins + [out, sum_w])
    rc = native().lib.nb_atrous_fwd(
        p[0], p[1], p[2], p[3], h, w, int(step), phi_color, phi_normal,
        1.0 / (phi_depth * int(step)), p[4], p[5], _stream(),
    )
    check(rc, "atrous_fwd")
    atrous_step.launches += 1
    return out, sum_w


def atrous_step_bwd(gbar, sum_w, radiance, variance, depth, normal, step: int, phi):
    """K5: the gradient w.r.t. radiance of one a-trous step, given the
    output cotangent `gbar` [H, W, 3] and the forward's sum of weights.
    CUDA tensors launch the kernel (csrc/atrous.cu), CPU tensors run the
    plain version."""
    h, w = radiance.shape[:2]
    dev = radiance.device
    _check(((gbar, 3), (sum_w, 1), (radiance, 3), (variance, 1), (depth, 1), (normal, 3)), h, w, dev)
    if int(step) < 1:
        raise ValueError(f"a-trous step must be >= 1, got {step}")
    if dev.type == "cpu":
        return atrous_step_bwd_plain(gbar, sum_w, radiance, variance, depth, normal, step, phi)
    grad = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    if h == 0 or w == 0:
        return grad
    phi_color, phi_normal, phi_depth = _phi(phi)
    ins = [t.contiguous() for t in (gbar, sum_w, radiance, variance, depth, normal)]
    p = _ptrs(ins + [grad])
    rc = native().lib.nb_atrous_bwd(
        p[0], p[1], p[2], p[3], p[4], p[5], h, w, int(step), phi_color, phi_normal,
        1.0 / (phi_depth * int(step)), p[6], _stream(),
    )
    check(rc, "atrous_bwd")
    atrous_step_bwd.launches += 1
    return grad


class AtrousStep(torch.autograd.Function):
    """One a-trous step with K4 forward and K5 backward (plain versions on
    the CPU).  Only radiance gets a gradient; sum_w is not differentiable."""

    @staticmethod
    def forward(ctx, radiance, variance, depth, normal, step, phi):
        out, sum_w = atrous_step_fwd(radiance, variance, depth, normal, step, phi)
        ctx.save_for_backward(radiance, variance, depth, normal, sum_w)
        ctx.step, ctx.phi = step, phi
        ctx.mark_non_differentiable(sum_w)
        return out, sum_w

    @staticmethod
    def backward(ctx, gbar, _gsum_w):
        radiance, variance, depth, normal, sum_w = ctx.saved_tensors
        grad = None
        if ctx.needs_input_grad[0]:
            grad = atrous_step_bwd(gbar, sum_w, radiance, variance, depth, normal, ctx.step, ctx.phi)
        return grad, None, None, None, None, None


def atrous_step(radiance, variance, depth, normal, step: int, phi):
    """K4: one a-trous step, phi = (phi_color, phi_normal, phi_depth) ->
    (out, sum_w).  Differentiable in radiance through K5 on both devices.
    Runs under the range "nebulae/atrous" and counts the pass and its
    pixels ("atrous.passes", "atrous.pixels")."""
    count("atrous.passes")
    count("atrous.pixels", radiance.shape[0] * radiance.shape[1])
    with span("nebulae/atrous"):
        return AtrousStep.apply(radiance, variance, depth, normal, int(step), tuple(phi))


atrous_step.launches = 0
atrous_step_bwd.launches = 0
