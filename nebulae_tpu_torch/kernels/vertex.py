"""A path vertex's draws and ray keys: kernel K9, its plain PyTorch twin,
and the rule that picks between them.

K9 (csrc/vertex.cu) replaces no TPU kernel.  On the TPU, XLA's jit fused
the vertex's elementwise chain; eager PyTorch issues each operation as a
launch of its own, ~273 a bounce vertex and ~162 at the last, plus 111 for
each sort key, all at full width.  K9 makes that chain one launch a vertex.

Two forms, each returning (rng_state, dict):

  * bounce (`bounce_vertex`): the 5 draws of a bounce vertex in the RNG
    contract's order (2 sun-disk NEE, 1 lobe roulette, 2 cosine bounce) and
    what they feed: "l", "n_dot_l", "f", "shoot", "origin", "new_d",
    "weight" (the diffuse reflectance over p_d), "rr_continue", "p_d";
  * last (`last_vertex`): the 2 NEE draws of the last vertex: "l",
    "n_dot_l", "f", "shoot" and "origin", the shadow ray's origin
    (DEAD_ORIGIN where the lane does not shoot).

Given the scene box `aabb` (with cfg.sort_rays), each also holds "key", the
walk's ray_sort_key of (origin, new_d) or (origin, l).

The twin (bounce_draws_plain, last_draws_plain, ray_sort_key) is the code
the path tracer ran before K9, unchanged.  The CPU runs it; on the card K9
runs at every vertex.  Where autograd records and an input tracks a
gradient (a train step's materials and sun), K9 runs inside _VertexGrad,
whose backward differentiates the twin, run again on the saved inputs: K9
gives the twin's outputs bit for bit on the card, so the gradient is the
twin's.

Each launch adds 1 to `vertex_kernel.launches` and to the counter
"vertex.kernel", and its lanes to "vertex.kernel_lanes" (utils/metrics.py);
while `vertex_kernel.record` is a list, each launch appends a copy of its
inputs.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch

from nebulae_tpu_torch.core import brdf
from nebulae_tpu_torch.core import rng as nrng
from nebulae_tpu_torch.core.math import clip, dot
from nebulae_tpu_torch.kernels.build import check, native
from nebulae_tpu_torch.tracer.sorting import DEAD_ORIGIN
from nebulae_tpu_torch.utils.metrics import count

SURF_IN = ("position", "normal_g", "normal_s", "albedo")
DIFF_SURF = (*SURF_IN, "roughness", "metalness")
BOUNCE_OUT = ("l", "n_dot_l", "f", "shoot", "origin", "new_d", "weight", "rr_continue", "p_d")
LAST_OUT = ("l", "n_dot_l", "f", "shoot", "origin")


def _morton3(x, y, z):
    """Interleave three 7-bit ints into a 21-bit Morton code."""
    code = torch.zeros_like(x)
    for bit in range(7):
        code = code | (((x >> bit) & 1) << (3 * bit))
        code = code | (((y >> bit) & 1) << (3 * bit + 1))
        code = code | (((z >> bit) & 1) << (3 * bit + 2))
    return code


def ray_sort_key(o, d, aabb_min, aabb_max):
    """int64 key [3 dir octant][21 origin morton][5 dir bucket]."""
    ext = torch.clamp(aabb_max - aabb_min, min=1e-6)
    q = torch.clamp((o - aabb_min) / ext, 0.0, 1.0)
    qi = (q * 127.0).to(torch.int64)
    morton = _morton3(qi[:, 0], qi[:, 1], qi[:, 2])
    octant = (d[:, 0] >= 0).long() + 2 * (d[:, 1] >= 0).long() + 4 * (d[:, 2] >= 0).long()
    dir_bits = (torch.clamp(d[:, 1] * 0.5 + 0.5, 0.0, 1.0) * 30.0).to(torch.int64)
    return (octant << 26) | (morton << 5) | dir_bits


def bounce_draws_plain(surf, view, sun, alive, rng_state):
    """The 5 RNG draws and shading-side math of one path vertex (no rays):
    sun-disk NEE direction and BRDF, lobe Russian roulette, cosine bounce.
    `weight` includes the 1/p_d boost; `rr_continue` gates the bounce."""
    rng_state, u1 = nrng.next_float(rng_state)
    rng_state, u2 = nrng.next_float(rng_state)
    l = brdf.sun_disk_sample(u1, u2, sun.direction[None, :], sun.tan_half_angle)
    n_dot_l = clip(dot(surf["normal_s"], l, False), 0.0, 1.0)
    f = brdf.eval_brdf(surf["normal_s"], view, l, surf["albedo"], surf["roughness"], surf["metalness"])
    rng_state, u_rr = nrng.next_float(rng_state)
    n_dot_v = clip(dot(surf["normal_s"], view, False), 0.0, 1.0)
    p_d = brdf.diffuse_probability(surf["albedo"], surf["metalness"], n_dot_v)
    rr_continue = u_rr < p_d
    rng_state, u3 = nrng.next_float(rng_state)
    rng_state, u4 = nrng.next_float(rng_state)
    new_d = brdf.cosine_hemisphere_sample(u3, u4, surf["normal_s"])
    weight = brdf.diffuse_reflectance(surf["albedo"], surf["metalness"]) / p_d[..., None]
    origin = brdf.offset_ray_origin(surf["position"], surf["normal_g"])
    shoot = alive & (n_dot_l > 0.0)
    pre = {"l": l, "n_dot_l": n_dot_l, "f": f, "shoot": shoot, "origin": origin,
           "new_d": new_d, "weight": weight, "rr_continue": rr_continue, "p_d": p_d}
    return rng_state, pre


def last_draws_plain(surf, view, sun, alive, rng_state):
    """Sun-disk NEE at the last vertex (2 draws), up to its shadow ray: the
    direction, its clamped cosine, the BRDF, the shadow mask and the
    shadow origin (DEAD_ORIGIN off the mask)."""
    rng_state, u1 = nrng.next_float(rng_state)
    rng_state, u2 = nrng.next_float(rng_state)
    l = brdf.sun_disk_sample(u1, u2, sun.direction[None, :], sun.tan_half_angle)
    n_dot_l = clip(dot(surf["normal_s"], l, False), 0.0, 1.0)
    f = brdf.eval_brdf(surf["normal_s"], view, l, surf["albedo"], surf["roughness"], surf["metalness"])
    origin = brdf.offset_ray_origin(surf["position"], surf["normal_g"])
    shoot = alive & (n_dot_l > 0.0)
    origin_sh = torch.where(shoot[..., None], origin, DEAD_ORIGIN)
    return rng_state, {"l": l, "n_dot_l": n_dot_l, "f": f, "shoot": shoot, "origin": origin_sh}


def _kernel_runs(view) -> bool:
    """K9 runs wherever the vertex lives on the card."""
    return view.is_cuda


def bounce_vertex(surf, view, sun, alive, rng_state, aabb=None):
    """A bounce vertex's 5 draws and what they feed, and with `aabb` the
    walk's sort key: K9 on the card, the twin elsewhere."""
    if _kernel_runs(view):
        return _launch(False, surf, view, sun, alive, rng_state, aabb)
    rng_state, pre = bounce_draws_plain(surf, view, sun, alive, rng_state)
    if aabb is not None:
        pre["key"] = ray_sort_key(pre["origin"].detach(), pre["new_d"].detach(), *aabb)
    return rng_state, pre


def last_vertex(surf, view, sun, alive, rng_state, aabb=None):
    """The last vertex's 2 NEE draws up to its shadow ray, and with `aabb`
    the shadow walk's sort key: K9 on the card, the twin elsewhere."""
    if _kernel_runs(view):
        return _launch(True, surf, view, sun, alive, rng_state, aabb)
    rng_state, nee = last_draws_plain(surf, view, sun, alive, rng_state)
    if aabb is not None:
        nee["key"] = ray_sort_key(nee["origin"].detach(), nee["l"].detach(), *aabb)
    return rng_state, nee


# The _VertexGrad inputs (DIFF_SURF, view, sun direction, tan_half_angle,
# by index) each float output depends on, as the twin computes it: an
# output with none that tracks a gradient leaves the graph, as the twin's
# would (a bounce's `new_d`, the next vertex's view, follows normal_s
# alone).  The masks, the state and the key never take part.
_DEPENDS = {"l": (7, 8), "n_dot_l": (2, 7, 8), "f": (2, 3, 4, 5, 6, 7, 8), "origin": (0, 1), "new_d": (2,),
            "weight": (2, 3, 5, 6), "p_d": (2, 3, 5, 6)}


def _unpack(ins):
    """_VertexGrad's flat float inputs -> (surf, view, sun)."""
    return dict(zip(DIFF_SURF, ins[:6])), ins[6], SimpleNamespace(direction=ins[7], tan_half_angle=ins[8])


def _launch(last: bool, surf, view, sun, alive, rng_state, aabb):
    """K9, through _VertexGrad where autograd records and an input tracks
    a gradient (the test `nrc/mlp.py` apply_mlp makes)."""
    ins = (*(surf[k] for k in DIFF_SURF), view, sun.direction, sun.tan_half_angle)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in ins)):
        return vertex_kernel(last, surf, view, sun, alive, rng_state, aabb)
    rng_out, *vals = _VertexGrad.apply(last, aabb, alive, rng_state, *ins)
    names = (*(LAST_OUT if last else BOUNCE_OUT), *(("key",) if aabb is not None else ()))
    return rng_out, dict(zip(names, vals))


class _VertexGrad(torch.autograd.Function):
    """K9 in the forward; the backward runs the twin again on the saved
    inputs and differentiates it."""

    @staticmethod
    def forward(ctx, last, aabb, alive, rng_state, *ins):
        surf, view, sun = _unpack(ins)
        rng_out, out = vertex_kernel(last, surf, view, sun, alive, rng_state, aabb)
        ctx.last = last
        ctx.save_for_backward(alive, rng_state, *ins)
        ctx.set_materialize_grads(False)
        tracks = [t.requires_grad for t in ins]
        ctx.mark_non_differentiable(rng_out, *(v for k, v in out.items()
                                               if not any(tracks[i] for i in _DEPENDS.get(k, ()))))
        return (rng_out, *out.values())

    @staticmethod
    def backward(ctx, _g_rng, *grads):
        alive, rng_state, *ins = ctx.saved_tensors
        need = ctx.needs_input_grad[4:]
        leaves = [t.detach().requires_grad_(n) for t, n in zip(ins, need)]
        with torch.enable_grad():
            _rng, out = (last_draws_plain if ctx.last else bounce_draws_plain)(*_unpack(leaves), alive, rng_state)
        pairs = [(out[k], g) for k, g in zip(LAST_OUT if ctx.last else BOUNCE_OUT, grads)
                 if g is not None and out[k].requires_grad]
        wrt = [t for t in leaves if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs], allow_unused=True)
                   if pairs else [None] * len(wrt))
        return (None, None, None, None, *(next(got) if n else None for n in need))


class _Args(ctypes.Structure):
    """csrc/vertex.cu VertexArgs, field for field."""

    _fields_ = (
        [(k, ctypes.c_void_p) for k in (*SURF_IN, "view", "roughness", "metalness", "alive", "rng_in")]
        + [(f"s_{k}", ctypes.c_longlong)
           for k in (*SURF_IN, "view", "roughness", "metalness", "alive", "rng")]
        + [(k, ctypes.c_void_p) for k in ("sun_dir", "tan_half", "aabb_min", "aabb_max", *BOUNCE_OUT,
                                          "rng_out", "key")]
        + [("n", ctypes.c_longlong)]
    )


def _rows(t, n: int, width: int, what: str):
    """t as float32 [n, width] (or [n]) on the card with a unit column
    stride; returns (tensor, row stride in elements)."""
    shape = (n, width) if width else (n,)
    if t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"K9: {what} must be float32 {shape}, got {t.dtype} {tuple(t.shape)}")
    if width and t.stride(1) != 1:
        t = t.contiguous()
    return t, t.stride(0)


def _lib():
    """The native library, its VertexArgs checked against _Args at first use."""
    lib = native().lib
    if lib is not _lib.checked:
        size = lib.nb_vertex_args_size()
        if size != ctypes.sizeof(_Args):
            raise RuntimeError(f"K9: VertexArgs is {size} bytes, _Args {ctypes.sizeof(_Args)}")
        _lib.checked = lib
    return lib


_lib.checked = None


def _copy(last, surf, view, sun, alive, rng_state, aabb):
    """A launch's inputs, copied, as the record hook keeps them."""

    def c(t):
        return t.detach().clone()

    sun_c = SimpleNamespace(direction=c(sun.direction), tan_half_angle=c(sun.tan_half_angle))
    return (last, {k: c(surf[k]) for k in DIFF_SURF}, c(view), sun_c, c(alive), c(rng_state),
            None if aabb is None else tuple(c(a) for a in aabb))


def vertex_kernel(last: bool, surf, view, sun, alive, rng_state, aabb=None):
    """K9 on CUDA tensors: one launch on the current stream, outputs from
    torch.empty, no wait.  Raises on inputs it does not take and on a
    launch error."""
    n = rng_state.shape[0]
    dev = rng_state.device
    if rng_state.dtype != torch.int64 or rng_state.dim() != 1 or alive.dtype != torch.bool \
            or tuple(alive.shape) != (n,):
        raise ValueError("K9: rng_state must be int64 [N] and alive bool [N]")
    ins = {k: _rows(surf[k], n, 3, k) for k in SURF_IN}
    ins["view"] = _rows(view, n, 3, "view")
    ins["roughness"] = _rows(surf["roughness"], n, 0, "roughness")
    ins["metalness"] = _rows(surf["metalness"], n, 0, "metalness")
    small = [sun.direction.contiguous(), sun.tan_half_angle.contiguous()]
    if aabb is not None:
        small += [a.contiguous() for a in aabb]
    if any(t.device != dev for t, _ in ins.values()) or any(t.device != dev or t.dtype != torch.float32
                                                            for t in small):
        raise ValueError(f"K9: every input must be float32 on {dev}")
    if tuple(sun.direction.shape) != (3,) or sun.tan_half_angle.numel() != 1 \
            or any(a.numel() != 3 for a in small[2:]):
        raise ValueError("K9: the sun's direction and the box's corners must be [3], tan_half_angle one value")
    names = LAST_OUT if last else BOUNCE_OUT
    out = {}
    for k in names:
        if k in ("shoot", "rr_continue"):
            out[k] = torch.empty(n, dtype=torch.bool, device=dev)
        elif k in ("n_dot_l", "p_d"):
            out[k] = torch.empty(n, dtype=torch.float32, device=dev)
        else:
            out[k] = torch.empty((n, 3), dtype=torch.float32, device=dev)
    rng_out = torch.empty(n, dtype=torch.int64, device=dev)
    if aabb is not None:
        out["key"] = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return rng_out, out
    a = _Args(n=n)
    for k, (t, stride) in ins.items():
        setattr(a, k, t.data_ptr())
        setattr(a, f"s_{k}", stride)
    a.alive, a.s_alive = alive.data_ptr(), alive.stride(0)
    a.rng_in, a.s_rng = rng_state.data_ptr(), rng_state.stride(0)
    a.sun_dir, a.tan_half = small[0].data_ptr(), small[1].data_ptr()
    if aabb is not None:
        a.aabb_min, a.aabb_max, a.key = small[2].data_ptr(), small[3].data_ptr(), out["key"].data_ptr()
    for k in names:
        setattr(a, k, out[k].data_ptr())
    a.rng_out = rng_out.data_ptr()
    lib = _lib()
    if vertex_kernel.record is not None:
        vertex_kernel.record.append(_copy(last, surf, view, sun, alive, rng_state, aabb))
    rc = lib.nb_vertex(ctypes.addressof(a), int(last), int(aabb is not None),
                       ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    check(rc, "vertex")
    vertex_kernel.launches += 1
    count("vertex.kernel")
    count("vertex.kernel_lanes", n)
    return rng_out, out


vertex_kernel.launches = 0
vertex_kernel.record = None
