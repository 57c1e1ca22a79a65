"""SVGF a-trous forward step: kernel K4 and its plain PyTorch version.

Replaces `nebulae_tpu/kernels/pallas_svgf.py` (_atrous_kernel, mode "fwd",
reached through atrous_step_pallas).  Inputs keep the JAX layout: radiance
[H, W, 3], variance [H, W], depth [H, W], normal [H, W, 3]; the step
returns (filtered radiance [H, W, 3], sum of weights [H, W]).  Taps outside
the image carry zero weight.  The weights follow the Pallas kernel's
arithmetic: precomputed 1/(phi_z*step) and 1/vscale, ^phi_n by repeated
squaring, w = ((k*wz)*wn)*wl, taps summed row by row.  Like the JAX
kernel, the tap weight k is B3[|dy|] * B3[|dx|] -- the B3 table indexed by
the offset's magnitude, so the centre gets 1/16 and the outermost taps 3/8
(not the centred spline [1/16, 1/4, 3/8, 1/4, 1/16]); the port keeps it for
parity.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from nebulae_tpu_torch.core.math import luminance
from nebulae_tpu_torch.kernels.build import check, native

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


def atrous_step_plain(radiance, variance, depth, normal, step: int, phi):
    """Plain version of K4 as 25 shifted-slice accumulations over a zero pad
    (a pad tap has a zero normal, so its weight is zero)."""
    phi_color, phi_normal, phi_depth = float(phi[0]), int(phi[1]), float(phi[2])
    h, w = radiance.shape[:2]
    r = 2 * step
    lum = luminance(radiance)
    z = torch.clamp(depth, max=1e8)
    vs0 = torch.clamp(phi_color * torch.sqrt(torch.clamp(variance, min=1e-8)), min=1e-6)
    inv_vs0 = 1.0 / torch.clamp(vs0, min=1e-9)
    inv_phi_z = 1.0 / (phi_depth * step)
    chans = torch.stack(
        [radiance[..., 0], radiance[..., 1], radiance[..., 2], lum, z,
         normal[..., 0], normal[..., 1], normal[..., 2]]
    )
    pad = F.pad(chans, (r, r, r, r))
    c0r, c0g, c0b, lum0, z0, n0x, n0y, n0z = chans
    sum_r = torch.zeros_like(lum0)
    sum_g = torch.zeros_like(lum0)
    sum_b = torch.zeros_like(lum0)
    sum_w = torch.zeros_like(lum0)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            k = B3[abs(dy)] * B3[abs(dx)]
            y0 = r + dy * step
            x0 = r + dx * step
            tap = pad[:, y0:y0 + h, x0:x0 + w]
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


def atrous_step(radiance, variance, depth, normal, step: int, phi):
    """K4: one a-trous step.  phi = (phi_color, phi_normal, phi_depth).
    CUDA tensors launch the kernel (csrc/atrous.cu), CPU tensors run the
    plain version."""
    h, w = radiance.shape[:2]
    dev = radiance.device
    shapes = ((radiance, (h, w, 3)), (variance, (h, w)), (depth, (h, w)), (normal, (h, w, 3)))
    for t, shape in shapes:
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"a-trous inputs must be float32 {shape} on {dev}")
    if dev.type == "cpu":
        return atrous_step_plain(radiance, variance, depth, normal, step, phi)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if h == 0 or w == 0:
        return torch.empty((h, w, 3), device=dev), torch.empty((h, w), device=dev)
    ins = [t.contiguous() for t, _ in shapes]
    out = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    sum_w = torch.empty((h, w), dtype=torch.float32, device=dev)
    ptr = [ctypes.c_void_p(t.data_ptr()) for t in (*ins, out, sum_w)]
    rc = native().lib.nb_atrous_fwd(
        ptr[0], ptr[1], ptr[2], ptr[3], h, w, int(step), float(phi[0]), int(phi[1]),
        1.0 / (float(phi[2]) * int(step)), ptr[4], ptr[5],
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
    )
    check(rc, "atrous_fwd")
    atrous_step.launches += 1
    return out, sum_w


atrous_step.launches = 0
