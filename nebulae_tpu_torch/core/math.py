"""Vector helpers on torch tensors, and host-side (numpy) camera matrices.

Counterpart of `nebulae_tpu/core/math.py`; same conventions: right-handed,
Y-up world space, column-vector matrices stored row-major, images
[H, W, C] float32.
"""

from __future__ import annotations

import numpy as np
import torch

from nebulae_tpu_torch.utils.profiling import span_backward


def dot(a, b, keepdims: bool = True):
    """Per-vector dot product, summed left to right (x + y) + z."""
    s = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return s[..., None] if keepdims else s


def powf(x, e: float):
    """x**e through the general power function.  A Python-scalar exponent
    would take PyTorch's special cases (-0.5 -> rsqrt, ...), which round
    differently from XLA's pow; a 0-d tensor exponent does not on the CPU
    (on the card ATen computes x**-0.5 as rsqrtf either way, which kernel
    K9 follows).  Its gradient copies the exponent's zero test to x's
    device and waits for the copy ("nebulae/sync/pow_grad")."""
    return span_backward(torch.pow(x, torch.tensor(e, dtype=x.dtype)), "nebulae/sync/pow_grad")


def _tracks_grad(x) -> bool:
    return x.requires_grad and torch.is_grad_enabled()


def _bound(x, c: float):
    """c as a 0-d CPU tensor, which a binary op takes beside a tensor on any
    device as a scalar: no host-to-device copy, so no stream sync."""
    return torch.tensor(c, dtype=x.dtype)


def clip(x, lo: float, hi: float):
    """jnp.clip with JAX's gradient: at x == lo or x == hi the gradient is
    1/2 (torch.clamp gives 1 there).  Built from torch.maximum/minimum
    against tensor bounds, which split a tie the same way; a tensor that
    carries no gradient takes plain torch.clamp (the same values)."""
    if not _tracks_grad(x):
        return torch.clamp(x, lo, hi)
    return torch.minimum(torch.maximum(x, _bound(x, lo)), _bound(x, hi))


def maximum(x, c: float):
    """jnp.maximum(x, c) with JAX's gradient (1/2 at x == c)."""
    if not _tracks_grad(x):
        return torch.clamp(x, min=c)
    return torch.maximum(x, _bound(x, c))


def normalize(v, eps: float = 1e-12):
    n = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]
    return v * powf(n + eps, -0.5)[..., None]


def shift2d(img, dy: int, dx: int):
    """Clamp-to-edge shift of an [H, W, ...] image:
    out[y, x] = img[clamp(y - dy), clamp(x - dx)]."""
    h, w = img.shape[0], img.shape[1]
    ys = torch.clamp(torch.arange(h, device=img.device) - dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) - dx, 0, w - 1)
    return img[ys][:, xs]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def ipow(x, n: int):
    """x**n for a static integer n by binary exponentiation, in the same
    multiplication order as XLA's integer_pow."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return torch.ones_like(x) if acc is None else acc


def build_orthonormal_basis(n):
    """Branchless (Pixar) tangent/bitangent for unit normals n [..., 3]."""
    nz = n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]], dim=-1)
    bt = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, bt


def oct_encode(n):
    """Unit vectors [..., 3] -> octahedral coordinates in [-1, 1]^2.  Zero
    vectors map to (0, 0), not NaN: dead lanes feed zero normals through
    here."""
    denom = n[..., 0].abs() + n[..., 1].abs() + n[..., 2].abs()
    p = n[..., :2] / maximum(denom[..., None], 1e-12)
    px, py = p[..., 0], p[..., 1]
    wrap_x = (1.0 - py.abs()) * torch.where(px >= 0.0, 1.0, -1.0)
    wrap_y = (1.0 - px.abs()) * torch.where(py >= 0.0, 1.0, -1.0)
    down = n[..., 2] < 0.0
    return torch.stack([torch.where(down, wrap_x, px), torch.where(down, wrap_y, py)], dim=-1)


def luminance(rgb):
    """Rec.709 luma."""
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def look_at(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Right-handed view matrix (world -> camera), numpy float32."""
    eye = np.asarray(eye, np.float64)
    f = target - eye
    f = f / np.linalg.norm(f)
    r = np.cross(f, up)
    r = r / np.linalg.norm(r)
    u = np.cross(r, f)
    m = np.eye(4)
    m[0, :3], m[1, :3], m[2, :3] = r, u, -f
    m[:3, 3] = -m[:3, :3] @ eye
    return m.astype(np.float32)


def perspective(fov_y_rad: float, aspect: float, near: float, far: float) -> np.ndarray:
    """Right-handed perspective projection, numpy float32."""
    f = 1.0 / np.tan(fov_y_rad * 0.5)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = far / (near - far)
    m[2, 3] = near * far / (near - far)
    m[3, 2] = -1.0
    return m
