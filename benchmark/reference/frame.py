"""The plain reference of a frame, on a rectangle of the image.

What a frame of the configuration states, written out in plain PyTorch
from the scene's raw arrays: camera rays, closest hits (reference.trace),
the surface with its texture fetch (the reference builds its own box-filtered
mips of the material atlas and picks a level per pixel from the screen-space
uv derivatives), sun-disk next-event estimation, cosine-lobe bounces with
lobe Russian roulette and full texture shading at every vertex, SVGF
(temporal accumulation with its spatial-variance bootstrap, the a-trous
cascade) and ACES.  Every pixel keeps its own random stream: XorShift32
seeded with a Jenkins hash of the pixel and the frame index, drawn in the
configuration's order (2 draws for the sun disk, then 1 for the lobe and 2
for the bounce direction at each vertex before the last).

A region is (r0, r1, c0, c1) in image rows and columns.  Stencils read
across the region's border as they read across the image's (clamped for
the uv derivatives and the bootstrap, zero weight for the a-trous taps), so
the pixels farther than `halo(cfg)` from a border that is not the image's
are exact.  The SVGF history of the frame before (None for a fresh start)
is a whole-image buffer: the reference's own, carried from a fresh start
(`render_region` returns the next one on its region), or a state handed to
it from outside.

`dtype` is the precision of every value computed after the hits; the hits
themselves are float32 in every case.  bfloat16 makes the precision
control.

A scene whose instances move (`RefScene.moved`) is the scene's raw arrays
with each instance's rigid transform applied: positions, vertex normals and
the tangents' xyz turn with it, the tangents' handedness w stays, as the
glTF loader turns a node's tangent frame by the node's matrix.  A rigid
transform turns the whole tangent frame, so a normal-mapped surface shades
the same at every pose.  Face normals are worked out again from the moved
edges at every hit (`RefScene.surface`), and the moved scene gets a tracer
of its own.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from benchmark.reference.trace import ClusterTracer

PI = 3.14159265358979
F0_DIELECTRIC = 0.04
MIP_LEVELS = 4
MAT_HAS_NORMAL_TEX = 1 << 2
_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# random numbers
# ---------------------------------------------------------------------------

def jenkins_hash(x):
    x = x & _U32
    x = (x + (x << 10)) & _U32
    x = x ^ (x >> 6)
    x = (x + (x << 3)) & _U32
    x = x ^ (x >> 11)
    x = (x + (x << 15)) & _U32
    return x


def init_rng(px, py, width: int, frame: int):
    f = torch.tensor(int(frame) & _U32, dtype=torch.int64, device=px.device)
    state = jenkins_hash(((px + py * int(width)) & _U32) ^ jenkins_hash(f))
    return torch.where(state == 0, torch.full_like(state, 0x9E3779B9), state)


def next_float(state, dtype):
    state = state ^ ((state << 13) & _U32)
    state = state ^ (state >> 17)
    state = state ^ ((state << 5) & _U32)
    mant = ((state >> 9) | 0x3F800000).to(torch.int32)
    return state, (mant.view(torch.float32) - 1.0).to(dtype)


# ---------------------------------------------------------------------------
# vectors and shading
# ---------------------------------------------------------------------------

def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def powf(x, e: float):
    return torch.pow(x, torch.tensor(e, dtype=x.dtype))


def normalize(v):
    return v * powf(dot(v, v) + 1e-12, -0.5)[..., None]


def clip(x, lo: float, hi: float):
    """Clamp to [lo, hi] whose gradient at a bound is 1/2, the mean of the
    two one-sided derivatives: the configuration's convention at the kink
    (a clamped material such as metallic 0 sits on it exactly)."""
    if not (x.requires_grad and torch.is_grad_enabled()):
        return torch.clamp(x, lo, hi)
    return torch.minimum(torch.maximum(x, torch.tensor(lo, dtype=x.dtype)), torch.tensor(hi, dtype=x.dtype))


def maximum(x, c: float):
    """max(x, c) with the gradient 1/2 at a tie, as `clip`."""
    if not (x.requires_grad and torch.is_grad_enabled()):
        return torch.clamp(x, min=c)
    return torch.maximum(x, torch.tensor(c, dtype=x.dtype))


def luminance(rgb):
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def ipow(x, n: int):
    """x**n for a whole n >= 1 by repeated squaring."""
    acc = None
    while n:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return acc


def pow5(x):
    return ipow(x, 5)


def srgb_to_linear(c):
    return torch.where(c <= 0.04045, c / 12.92, powf((c + 0.055) / 1.055, 2.4))


def base_f0(albedo, metal):
    return F0_DIELECTRIC * (1.0 - metal[..., None]) + albedo * metal[..., None]


def fresnel(cos_theta, f0):
    return f0 + (1.0 - f0) * pow5(1.0 - clip(cos_theta, 0.0, 1.0))


def eval_brdf(n, v, l, albedo, rough, metal):
    """Lambert plus GGX with Smith's G1 pair, without the cosine."""
    h = normalize(v + l)
    n_l = clip(dot(n, l), 0.0, 1.0)
    n_v = clip(dot(n, v), 0.0, 1.0)
    n_h = clip(dot(n, h), 0.0, 1.0)
    v_h = clip(dot(v, h), 0.0, 1.0)
    alpha = maximum(rough * rough, 1e-3)
    f0 = base_f0(albedo, metal)
    fres = fresnel(v_h[..., None], f0)
    a2 = alpha * alpha
    dd = n_h * n_h * (a2 - 1.0) + 1.0
    ndf = a2 / maximum(PI * dd * dd, 1e-8)
    k = alpha * 0.5
    g = (n_l / maximum(n_l * (1.0 - k) + k, 1e-8)) * (n_v / maximum(n_v * (1.0 - k) + k, 1e-8))
    spec = fres * (ndf * g / maximum(4.0 * n_l * n_v, 1e-8))[..., None]
    kd = (1.0 - fres) * (1.0 - metal[..., None])
    return kd * albedo / PI + spec


def diffuse_probability(albedo, metal, n_v):
    s = luminance(fresnel(n_v[..., None], base_f0(albedo, metal)))
    d = luminance(albedo * (1.0 - metal[..., None]))
    return 1.0 - clip(s / maximum(s + d, 1e-8), 0.1, 0.9)


def onb(n):
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]], -1)
    bt = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], -1)
    return t, bt


def cosine_sample(u1, u2, n):
    r = torch.sqrt(u1)
    phi = 2.0 * PI * u2
    t, b = onb(n)
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    return normalize((r * torch.cos(phi))[..., None] * t + (r * torch.sin(phi))[..., None] * b + z[..., None] * n)


def sun_sample(u1, u2, sun_dir, tan_half):
    t, b = onb(sun_dir)
    r = torch.sqrt(u1) * tan_half
    phi = 2.0 * PI * u2
    return normalize(sun_dir + r[..., None] * (torch.cos(phi)[..., None] * t + torch.sin(phi)[..., None] * b))


# ---------------------------------------------------------------------------
# the scene on the device
# ---------------------------------------------------------------------------

def mip_chain(img: np.ndarray, levels: int = MIP_LEVELS) -> list:
    """Box-filtered 8-bit mips of a [h, w, C] uint8 map: each level halves
    both sides, averaging 2x2 texels and rounding half to even; levels past
    a side of 1 repeat the last."""
    out = [img]
    for _ in range(1, levels):
        h, w = out[-1].shape[:2]
        if min(h, w) < 2:
            out.append(out[-1])
            continue
        if h % 2 or w % 2:
            raise ValueError(f"odd map size {(h, w)}: the reference mips halve exact sizes only")
        s = out[-1].astype(np.int32).reshape(h // 2, 2, w // 2, 2, -1).sum(axis=(1, 3))
        out.append(np.clip(np.rint(s.astype(np.float32) * np.float32(0.25)), 0, 255).astype(np.uint8))
    return out


class RefScene:
    """The scene's raw arrays on a device, with the reference's own
    tracer, mips and sun.  Float tables are held in `dtype`."""

    def __init__(self, sc: dict, sun: dict, device, dtype=torch.float32):
        self.device, self.dtype = device, dtype
        f = self._table
        self._raw = {k: sc[k] for k in ("tri_pos", "tri_nrm", "tri_tan", "instance_of_tri")}
        self._geometry(sc["tri_pos"], sc["tri_nrm"], sc["tri_tan"])
        self.uv = f(sc["tri_uv"])
        self.mat = torch.as_tensor(sc["tri_mat"].astype(np.int64), device=device)
        self.base = f(sc["mat_base_color"])
        self.rough = f(sc["mat_roughness"])
        self.metal = f(sc["mat_metallic"])
        self.emis = f(sc["mat_emissive"])
        self.flags = torch.as_tensor(sc["mat_flags"].astype(np.int64), device=device)
        self.slot = torch.as_tensor(sc["mat_atlas_id"].astype(np.int64), device=device)
        self.aabb_min = f(sc["aabb_min"])
        self.aabb_max = f(sc["aabb_max"])
        # Texels of every slot and level in one [rows, 12] table.
        rows, off, hw = [], [], []
        n = 0
        for a in range(sc["mat_tex"].shape[0]):
            h, w = (int(x) for x in sc["mat_tex_hw"][a])
            o_a, hw_a = [], []
            for lvl in mip_chain(sc["mat_tex"][a, :h, :w]):
                rows.append(lvl.reshape(-1, lvl.shape[-1]))
                o_a.append(n)
                hw_a.append(lvl.shape[:2])
                n += lvl.shape[0] * lvl.shape[1]
            off.append(o_a)
            hw.append(hw_a)
        self.texels = torch.as_tensor(np.concatenate(rows), device=device)
        self.tex_off = torch.as_tensor(np.asarray(off, np.int64), device=device)
        self.tex_hw = torch.as_tensor(np.asarray(hw, np.int64), device=device)
        self.textured = sc["mat_tex"].shape[0] > 0 and sc["textures"].shape[0] > 0
        self.sun_dir = f(sun["direction"])
        self.sun_rad = f(sun["radiance"])
        self.sun_tan = f(sun["tan_half_angle"])
        self.sky = f(sun["sky_color"])

    def _table(self, x):
        """A float32 array on the device, held in `dtype`."""
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device).to(self.dtype)

    def _geometry(self, tri_pos: np.ndarray, tri_nrm: np.ndarray, tri_tan: np.ndarray) -> None:
        """The triangles' arrays on the device, and a tracer over them."""
        f = self._table
        self.tracer = ClusterTracer(torch.as_tensor(tri_pos, device=self.device))
        self.v0 = f(tri_pos[:, 0])
        self.e1 = f(tri_pos[:, 1] - tri_pos[:, 0])
        self.e2 = f(tri_pos[:, 2] - tri_pos[:, 0])
        self.nrm = f(tri_nrm)
        self.tan = f(tri_tan)

    def moved(self, transforms: np.ndarray) -> RefScene:
        """This scene with instance i's triangles moved by the rigid
        transform transforms[i] ([I, 3, 4]: rows are world rows, the last
        column the translation), from the raw arrays it was built from.
        The moved scene shares the texels, mips, materials and sun."""
        geo = move_instances(self._raw, transforms)
        out = copy.copy(self)
        out._geometry(geo["tri_pos"], geo["tri_nrm"], geo["tri_tan"])
        return out

    def texel_rows(self, slot, level, uv):
        """Bilinear, REPEAT-wrapped fetch of the 12 channels at uv from
        level `level` of atlas slot `slot` -> [N, 12] in [0, 1]."""
        hw = self.tex_hw[slot, level]
        h, w = hw[:, 0], hw[:, 1]
        u = uv[:, 0] - torch.floor(uv[:, 0])
        v = uv[:, 1] - torch.floor(uv[:, 1])
        x = u * w.to(u.dtype) - 0.5
        y = v * h.to(u.dtype) - 0.5
        x0f = torch.floor(x)
        y0f = torch.floor(y)
        fx = (x - x0f)[:, None]
        fy = (y - y0f)[:, None]
        x0 = torch.remainder(x0f.long(), w)
        y0 = torch.remainder(y0f.long(), h)
        x1 = torch.remainder(x0 + 1, w)
        y1 = torch.remainder(y0 + 1, h)
        base = self.tex_off[slot, level]

        def tap(yy, xx):
            return self.texels[base + yy * w + xx].to(self.dtype) / 255.0

        top = tap(y0, x0) * (1.0 - fx) + tap(y0, x1) * fx
        bot = tap(y1, x0) * (1.0 - fx) + tap(y1, x1) * fx
        return top * (1.0 - fy) + bot * fy

    def surface(self, tri, u, v, view, level=None):
        """Shading attributes at barycentrics (u, v) on triangles `tri`
        (>= 0), facing `view`."""
        w = (1.0 - u - v)[:, None]
        u_, v_ = u[:, None], v[:, None]
        e1, e2 = self.e1[tri], self.e2[tri]
        pos = self.v0[tri] + u_ * e1 + v_ * e2
        c = self.nrm[tri]
        nrm = normalize(c[:, 0] * w + c[:, 1] * u_ + c[:, 2] * v_)
        c = self.uv[tri]
        uv = c[:, 0] * w + c[:, 1] * u_ + c[:, 2] * v_
        c = self.tan[tri]
        tan4 = c[:, 0] * w + c[:, 1] * u_ + c[:, 2] * v_
        m = self.mat[tri]
        ng = normalize(cross(e1, e2))
        ng = ng * torch.where(dot(ng, nrm) < 0.0, -1.0, 1.0).to(ng.dtype)[:, None]
        albedo = self.base[m, :3]
        rough, metal, emis = self.rough[m], self.metal[m], self.emis[m]
        ns = nrm
        if self.textured:
            lvl = torch.zeros_like(m) if level is None else torch.clamp(level, 0, MIP_LEVELS - 1)
            px = self.texel_rows(self.slot[m], lvl, uv)
            albedo = albedo * srgb_to_linear(px[:, 0:3])
            rough = rough * px[:, 3]
            metal = metal * px[:, 4]
            emis = emis * srgb_to_linear(px[:, 8:11])
            tn = px[:, 5:8] * 2.0 - 1.0
            tangent = normalize(tan4[:, :3] - nrm * dot(tan4[:, :3], nrm)[:, None])
            bitangent = cross(nrm, tangent) * tan4[:, 3:4]
            mapped = normalize(tn[:, 0:1] * tangent + tn[:, 1:2] * bitangent + tn[:, 2:3] * nrm)
            ns = torch.where(((self.flags[m] & MAT_HAS_NORMAL_TEX) != 0)[:, None], mapped, nrm)
        flip = torch.where(dot(ns, view) < 0.0, -1.0, 1.0).to(ns.dtype)[:, None]
        return {"position": pos, "normal_g": ng * flip, "normal_s": ns * flip, "albedo": albedo,
                "roughness": clip(rough, 0.02, 1.0), "metalness": clip(metal, 0.0, 1.0), "emissive": emis}


def move_instances(raw: dict, transforms: np.ndarray) -> dict:
    """Float32 tri_pos, tri_nrm and tri_tan [T, 3, 4] of the raw arrays
    with each triangle's instance's rigid transform applied in float64:
    positions by the whole transform, normals and the tangents' xyz by its
    rotation, the tangents' w kept."""
    m = np.asarray(transforms, np.float64)[np.asarray(raw["instance_of_tri"], np.int64)]
    rot, shift = m[:, None, :, :3], m[:, None, :, 3]

    def turn(v):
        return (rot @ np.asarray(v, np.float64)[..., None])[..., 0]

    tan = np.array(raw["tri_tan"], np.float32)
    tan[..., :3] = turn(tan[..., :3])
    return {"tri_pos": (turn(raw["tri_pos"]) + shift).astype(np.float32),
            "tri_nrm": turn(raw["tri_nrm"]).astype(np.float32), "tri_tan": tan}


# ---------------------------------------------------------------------------
# camera and G-buffer
# ---------------------------------------------------------------------------

def camera_basis(eye, target, fov_y_deg: float, width: int, height: int) -> dict:
    """(eye, right, up, fwd, tan_half, aspect) of a pinhole camera with +Y
    up, float32 as the frame takes them."""
    eye64 = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye64
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    return {"eye": np.asarray(eye, np.float32), "right": right.astype(np.float32), "up": up.astype(np.float32),
            "fwd": fwd.astype(np.float32), "tan_half": np.float32(np.tan(np.deg2rad(fov_y_deg) * 0.5)),
            "aspect": np.float32(width / height)}


def shift2d(img, dy: int, dx: int):
    """out[y, x] = img[clamp(y - dy), clamp(x - dx)] over the array."""
    h, w = img.shape[0], img.shape[1]
    ys = torch.clamp(torch.arange(h, device=img.device) - dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) - dx, 0, w - 1)
    return img[ys][:, xs]


def mip_levels(S: RefScene, tri, u, v, h: int, w: int):
    """Per-pixel mip level [h*w] from the uv footprint of the level-0 map
    at the pixel's neighbours on the same triangle (forward difference,
    else backward; none on the triangle: level 0, or the coarsest inside
    geometry)."""
    t = torch.clamp(tri, min=0)
    c = S.uv[t]
    uvw = (1.0 - u - v)[:, None]
    uv = (c[:, 0] * uvw + c[:, 1] * u[:, None] + c[:, 2] * v[:, None]).reshape(h, w, 2)
    hw = S.tex_hw[S.slot[S.mat[t]], 0].reshape(h, w, 2)
    texel = torch.stack([hw[..., 1], hw[..., 0]], -1).to(uv.dtype)
    img = tri.reshape(h, w)

    def deriv(dy, dx):
        d = shift2d(uv, dy, dx) - uv
        fp = torch.abs(d * texel).amax(-1)
        return torch.where(shift2d(img, dy, dx) == img, fp, -1.0)

    fx = deriv(0, -1)
    fx = torch.where(fx >= 0.0, fx, deriv(0, 1))
    fy = deriv(-1, 0)
    fy = torch.where(fy >= 0.0, fy, deriv(1, 0))
    fp = torch.clamp(torch.maximum(fx, fy), min=1.0)
    level = torch.clamp(torch.floor(torch.log2(fp.float())).long(), 0, MIP_LEVELS - 1)
    interior = ((shift2d(img, 0, -1) >= 0) & (shift2d(img, 0, 1) >= 0)
                & (shift2d(img, -1, 0) >= 0) & (shift2d(img, 1, 0) >= 0))
    level = torch.where((fx < 0.0) & (fy < 0.0) & interior, MIP_LEVELS - 1, level)
    return level.reshape(-1)


def region_pixels(region, device):
    r0, r1, c0, c1 = region
    ys, xs = torch.meshgrid(torch.arange(r0, r1, device=device), torch.arange(c0, c1, device=device), indexing="ij")
    return ys.reshape(-1), xs.reshape(-1)


def gbuffer(S: RefScene, cam: dict, width: int, height: int, region, mips: bool = True, jitter=None):
    """Primary hits and surfaces of the region's pixels: through their
    centres, or at (x + jx, y + jy) with `jitter` = (jx, jy) a pixel."""
    dt, dev = S.dtype, S.device
    ys, xs = region_pixels(region, dev)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    xf, yf = xs.float(), ys.float()
    jx, jy = (0.5, 0.5) if jitter is None else jitter
    u = ((xf + jx) / width * 2.0 - 1.0) * t(cam["tan_half"]) * t(cam["aspect"])
    v = (1.0 - (yf + jy) / height * 2.0) * t(cam["tan_half"])
    d = normalize(u[:, None] * t(cam["right"])[None] + v[:, None] * t(cam["up"])[None] + t(cam["fwd"])[None])
    o = t(cam["eye"]).expand(d.shape)
    hit = S.tracer.closest(o, d)
    valid = hit["tri"] >= 0
    h, w = region[1] - region[0], region[3] - region[2]
    level = mip_levels(S, hit["tri"], hit["u"], hit["v"], h, w) if mips and S.textured else None
    tri = torch.clamp(hit["tri"], min=0)
    surf = S.surface(tri, hit["u"].to(dt), hit["v"].to(dt), -d.to(dt), level)
    vm = valid[:, None]
    gb = {k: torch.where(vm, x, 0.0) for k, x in surf.items() if x.dim() == 2}
    gb["roughness"] = torch.where(valid, surf["roughness"], 1.0)
    gb["metalness"] = torch.where(valid, surf["metalness"], 0.0)
    gb.update(hit=valid, depth=torch.where(valid, hit["t"], float("inf")), view=-d.to(dt), ray_d=d.to(dt),
              xs=xs, ys=ys)
    return gb


# ---------------------------------------------------------------------------
# path tracing
# ---------------------------------------------------------------------------

SURF_KEYS = ("position", "normal_g", "normal_s", "albedo", "roughness", "metalness", "emissive")


def _filled(S: RefScene, n: int, found, surf):
    """Surfaces for all n lanes: the traced ones from `surf`, the others a
    harmless placeholder (they carry no weight)."""
    dt, dev = S.dtype, S.device
    out = {
        "position": torch.zeros((n, 3), dtype=dt, device=dev),
        "normal_g": torch.tensor([0.0, 0.0, 1.0], dtype=dt, device=dev).repeat(n, 1),
        "normal_s": torch.tensor([0.0, 0.0, 1.0], dtype=dt, device=dev).repeat(n, 1),
        "albedo": torch.zeros((n, 3), dtype=dt, device=dev),
        "roughness": torch.ones(n, dtype=dt, device=dev),
        "metalness": torch.zeros(n, dtype=dt, device=dev),
        "emissive": torch.zeros((n, 3), dtype=dt, device=dev),
    }
    for k in SURF_KEYS:
        out[k][found] = surf[k]
    return out


def vertex_draws(S: RefScene, surf, view, alive, rng):
    """Sun-disk NEE direction and BRDF, lobe roulette and the cosine
    bounce of one vertex (5 draws)."""
    dt = S.dtype
    rng, u1 = next_float(rng, dt)
    rng, u2 = next_float(rng, dt)
    l = sun_sample(u1, u2, S.sun_dir[None], S.sun_tan)
    n_l = clip(dot(surf["normal_s"], l), 0.0, 1.0)
    f = eval_brdf(surf["normal_s"], view, l, surf["albedo"], surf["roughness"], surf["metalness"])
    rng, u_rr = next_float(rng, dt)
    n_v = clip(dot(surf["normal_s"], view), 0.0, 1.0)
    p_d = diffuse_probability(surf["albedo"], surf["metalness"], n_v)
    rng, u3 = next_float(rng, dt)
    rng, u4 = next_float(rng, dt)
    new_d = cosine_sample(u3, u4, surf["normal_s"])
    weight = surf["albedo"] * (1.0 - surf["metalness"][:, None]) / p_d[:, None]
    origin = surf["position"] + surf["normal_g"] * 1e-4
    return rng, {"l": l, "n_l": n_l, "f": f, "shoot": alive & (n_l > 0.0), "origin": origin, "new_d": new_d,
                 "weight": weight, "rr": u_rr < p_d, "p_d": p_d}


def trace_vertex(S: RefScene, pre, bounce_lanes):
    """Shadow rays of the `shoot` lanes and bounce rays of `bounce_lanes`
    from each vertex -> (vis, found, hit t, next surfaces)."""
    n = pre["l"].shape[0]
    dt = S.dtype
    idx = torch.nonzero(pre["shoot"])[:, 0]
    occ = torch.zeros(n, dtype=torch.bool, device=S.device)
    occ[idx] = S.tracer.occluded(pre["origin"][idx].float(), pre["l"][idx].float())
    vis = (pre["shoot"] & ~occ).to(dt)
    idx = torch.nonzero(bounce_lanes)[:, 0]
    b = pre["new_d"][idx]
    hit = S.tracer.closest(pre["origin"][idx].float(), b.float())
    got = hit["tri"] >= 0
    found = torch.zeros(n, dtype=torch.bool, device=S.device)
    found[idx[got]] = True
    t_all = torch.full((n,), float("inf"), device=S.device)
    t_all[idx] = hit["t"]
    surf = S.surface(hit["tri"][got], hit["u"][got].to(dt), hit["v"][got].to(dt), -b[got])
    return vis, found, t_all, _filled(S, n, found, surf)


def nee_last(S: RefScene, surf, view, alive, rng):
    """Sun-disk NEE at the last vertex (2 draws) -> (direct, rng)."""
    dt = S.dtype
    rng, u1 = next_float(rng, dt)
    rng, u2 = next_float(rng, dt)
    l = sun_sample(u1, u2, S.sun_dir[None], S.sun_tan)
    n_l = clip(dot(surf["normal_s"], l), 0.0, 1.0)
    f = eval_brdf(surf["normal_s"], view, l, surf["albedo"], surf["roughness"], surf["metalness"])
    origin = surf["position"] + surf["normal_g"] * 1e-4
    shoot = alive & (n_l > 0.0)
    idx = torch.nonzero(shoot)[:, 0]
    occ = torch.zeros_like(shoot)
    occ[idx] = S.tracer.occluded(origin[idx].float(), l[idx].float())
    vis = (shoot & ~occ).to(dt)
    return f * (n_l * vis)[:, None] * S.sun_rad[None], rng


def path_trace(S: RefScene, gb: dict, cfg: dict, rng):
    """Radiance [N, 3] of the G-buffer's pixels: max_bounces - 1 bounce
    vertices and NEE at the last; primary misses show the sky."""
    surf = {k: gb[k] for k in SURF_KEYS}
    n = gb["hit"].shape[0]
    acc = torch.where(gb["hit"][:, None], surf["emissive"], 0.0)
    throughput = torch.ones((n, 3), dtype=S.dtype, device=S.device)
    alive = gb["hit"]
    view = gb["view"]
    for _ in range(int(cfg["max_bounces"]) - 1):
        rng, pre = vertex_draws(S, surf, view, alive, rng)
        alive_b = alive & pre["rr"]
        vis, found, _t, surf = trace_vertex(S, pre, alive_b)
        direct = pre["f"] * (pre["n_l"] * vis)[:, None] * S.sun_rad[None]
        acc = acc + torch.where(alive[:, None], throughput * direct, 0.0)
        throughput = throughput * pre["weight"]
        alive = alive_b
        acc = acc + torch.where((alive & ~found)[:, None], throughput * S.sky[None], 0.0)
        alive = alive & found
        acc = acc + torch.where(alive[:, None], throughput * surf["emissive"], 0.0)
        view = -pre["new_d"]
    direct, rng = nee_last(S, surf, view, alive, rng)
    acc = acc + torch.where(alive[:, None], throughput * direct, 0.0)
    return torch.where(gb["hit"][:, None], acc, S.sky[None])


# ---------------------------------------------------------------------------
# SVGF and ACES
# ---------------------------------------------------------------------------

B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def halo(cfg: dict) -> int:
    """Pixels of a region's border whose outputs a clipped stencil may
    change: the a-trous cascade's reach, the bootstrap's 3 and the uv
    derivatives' 1."""
    return 2 * ((1 << int(cfg["svgf_atrous_passes"])) - 1) + 3 + 1


def svgf_temporal(rad, depth, normal, hist, cfg):
    """-> (accum, moments, variance, histlen) of the region."""
    zc = torch.clamp(depth, max=1e8)
    dz = zc - torch.clamp(hist["depth"], max=1e8)
    sigma = torch.clamp(0.02 * zc, min=cfg["svgf_depth_sigma"])
    w = torch.exp(-(dz * dz) / (2.0 * sigma * sigma)) * torch.clamp(dot(normal, hist["normal"]), 0.0, 1.0)
    alpha = cfg["svgf_temporal_alpha"] * w
    accum = rad + (hist["radiance"] - rad) * alpha[..., None]
    y = luminance(rad)
    y_acc = y + (hist["moments"][..., 0] - y) * alpha
    y2_acc = y * y + (hist["moments"][..., 1] - y * y) * alpha
    variance = torch.clamp(y2_acc - y_acc * y_acc, min=cfg["svgf_variance_eps"])
    histlen = torch.where(w > 0.5, hist["histlen"] + 1.0, 1.0)
    short = histlen < 4.0

    def blur(m1, m2, axis):
        s1, s2, sw = torch.zeros_like(m1), torch.zeros_like(m2), torch.zeros_like(m1)
        for o in range(-3, 4):
            dy, dx = (o, 0) if axis == 0 else (0, o)
            wz = torch.exp(-torch.abs(zc - shift2d(zc, dy, dx)) / max(cfg["svgf_phi_depth"] * 3.0, 1e-6))
            wn = powf(torch.clamp(dot(normal, shift2d(normal, dy, dx)), 0.0, 1.0), float(cfg["svgf_phi_normal"]))
            ww = wz * wn
            s1 = s1 + shift2d(m1, dy, dx) * ww
            s2 = s2 + shift2d(m2, dy, dx) * ww
            sw = sw + ww
        den = torch.clamp(sw, min=1e-6)
        return s1 / den, s2 / den

    m1, m2 = blur(y, y * y, 1)
    m1, m2 = blur(m1, m2, 0)
    spatial = torch.clamp(m2 - m1 * m1, min=cfg["svgf_variance_eps"]) * 4.0
    variance = torch.where(short, torch.maximum(variance, spatial), variance)
    return accum, torch.stack([y_acc, y2_acc], -1), variance, histlen


def atrous(rad, variance, depth, normal, step: int, cfg):
    """One a-trous pass: 5x5 taps at the dilation `step`, each weighted by
    B3[|dy|] * B3[|dx|] and by the depth, normal and luminance edge stops;
    taps outside the region weigh nothing.  The weights are constants of
    the gradient: only the filtered radiance carries one."""
    h, w = rad.shape[:2]
    lum = luminance(rad.detach())
    z = torch.clamp(depth, max=1e8).detach()
    normal = normal.detach()
    variance = variance.detach()
    inv_vs = 1.0 / torch.clamp(torch.clamp(cfg["svgf_phi_color"] * torch.sqrt(torch.clamp(variance, min=1e-8)),
                                           min=1e-6), min=1e-9)
    inv_phi_z = 1.0 / (cfg["svgf_phi_depth"] * step)
    guides = torch.stack([lum, z, normal[..., 0], normal[..., 1], normal[..., 2]]).detach()
    r = 2 * step
    pad = torch.nn.functional.pad(torch.cat([rad.permute(2, 0, 1), guides]), (r, r, r, r))
    sums = torch.zeros((3, h, w), dtype=rad.dtype, device=rad.device)
    sum_w = torch.zeros((h, w), dtype=rad.dtype, device=rad.device)
    n_pow = int(cfg["svgf_phi_normal"])
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            tap = pad[:, r + dy * step:r + dy * step + h, r + dx * step:r + dx * step + w]
            g = tap[3:].detach()
            ndot = torch.clamp(normal[..., 0] * g[2] + normal[..., 1] * g[3] + normal[..., 2] * g[4], 0.0, 1.0)
            wn = ipow(ndot, n_pow)
            wz = torch.exp(-torch.abs(z - g[1]) * inv_phi_z)
            wl = torch.exp(-torch.abs(lum - g[0]) * inv_vs)
            wt = (B3[abs(dy)] * B3[abs(dx)] * wz * wn * wl).detach()
            sums = sums + tap[0:3] * wt
            sum_w = sum_w + wt
    return (sums / torch.clamp(sum_w, min=1e-4)).permute(1, 2, 0)


def aces(hdr):
    """Hill's fitted ACES RRT+ODT."""
    m_in = torch.tensor([[0.59719, 0.35458, 0.04823], [0.07600, 0.90834, 0.01566],
                         [0.02840, 0.13383, 0.83777]], dtype=hdr.dtype, device=hdr.device)
    m_out = torch.tensor([[1.60475, -0.53108, -0.07367], [-0.10208, 1.10813, -0.00605],
                          [-0.00327, -0.07276, 1.07602]], dtype=hdr.dtype, device=hdr.device)
    v = (hdr[..., None, :] * m_in).sum(-1)
    v = (v * (v + 0.0245786) - 0.000090537) / (v * (0.983729 * v + 0.4329510) + 0.238081)
    return torch.clamp((v[..., None, :] * m_out).sum(-1), 0.0, 1.0)


def view_proj(eye, target, fov_y_deg: float, width: int, height: int, near: float = 0.01, far: float = 1000.0):
    """The camera's float32 projection times view matrix (right-handed,
    column vectors, +Y up), and its eye."""
    eye64 = np.asarray(eye, np.float64)
    f = np.asarray(target, np.float32) - eye64
    f = f / np.linalg.norm(f)
    r = np.cross(f, np.array([0.0, 1.0, 0.0], np.float32))
    r = r / np.linalg.norm(r)
    u = np.cross(r, f)
    view = np.eye(4)
    view[0, :3], view[1, :3], view[2, :3] = r, u, -f
    view[:3, 3] = -view[:3, :3] @ eye64
    fy = 1.0 / np.tan(np.deg2rad(fov_y_deg) * 0.5)
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = fy / (width / height)
    proj[1, 1] = fy
    proj[2, 2] = far / (near - far)
    proj[2, 3] = near * far / (near - far)
    proj[3, 2] = -1.0
    return proj @ view.astype(np.float32), np.asarray(eye, np.float32)


def reproject(hist: dict, position, depth, vp, prev_eye, width: int, height: int) -> dict:
    """The history of the whole image sampled bilinearly where the
    region's points were in the previous frame (through its view-projection
    `vp`); taps clamp to the image.  A point behind that camera or off its
    image gets the depth -1e9, which the temporal step rejects.  Pixel
    coordinates are float32 in every precision: they index."""
    dt = position.dtype
    m = torch.as_tensor(vp, device=position.device)
    p = torch.cat([position.float(), torch.ones_like(position[..., :1], dtype=torch.float32)], -1)
    clip_ = torch.stack([p[..., 0] * m[i, 0] + p[..., 1] * m[i, 1] + p[..., 2] * m[i, 2] + p[..., 3] * m[i, 3]
                         for i in range(4)], -1)
    w_c = clip_[..., 3]
    ndc = clip_[..., :3] / torch.where(torch.abs(w_c) < 1e-8, 1.0, w_c)[..., None]
    x = (ndc[..., 0] * 0.5 + 0.5) * width - 0.5
    y = (0.5 - ndc[..., 1] * 0.5) * height - 0.5
    stack = torch.cat([hist["radiance"], hist["depth"][..., None], hist["normal"], hist["moments"],
                       hist["histlen"][..., None]], -1).to(dt)
    ib = (x >= -0.5) & (x <= width - 0.5) & (y >= -0.5) & (y <= height - 0.5)
    x0 = torch.clamp(torch.floor(x), 0, width - 1)
    y0 = torch.clamp(torch.floor(y), 0, height - 1)
    fx = torch.clamp(x - x0, 0.0, 1.0)[..., None].to(dt)
    fy = torch.clamp(y - y0, 0.0, 1.0)[..., None].to(dt)
    xi, yi = x0.long(), y0.long()
    x1, y1 = torch.clamp(xi + 1, max=width - 1), torch.clamp(yi + 1, max=height - 1)
    c = (stack[yi, xi] * (1 - fx) + stack[yi, x1] * fx) * (1 - fy) + (stack[y1, xi] * (1 - fx) + stack[y1, x1] * fx) * fy
    eye = torch.as_tensor(prev_eye, device=position.device).to(dt)
    dep = c[..., 3] - torch.sqrt(dot(position - eye, position - eye)) + torch.clamp(depth, max=1e8)
    valid = ib & (w_c > 1e-8)
    return {"radiance": c[..., 0:3], "depth": torch.where(valid, dep, -1e9), "normal": c[..., 4:7],
            "moments": c[..., 7:9], "histlen": c[..., 9]}


def render_region(S: RefScene, cam: dict, cfg: dict, frame: int, region, hist=None, moved=None,
                  trace=path_trace) -> dict:
    """One frame on `region`: its ldr and next history radiance there.  `hist`
    is the whole image's history before the frame (radiance, depth,
    normal, moments, histlen), None for a fresh start; `moved` the previous
    camera's (view-projection, eye) when the camera moved since, so that the
    history is reprojected, None for a still camera.  `trace(S, gb, cfg,
    rng)` gives the noisy radiance (the path tracer by default)."""
    width, height = int(cfg["width"]), int(cfg["height"])
    h, w = region[1] - region[0], region[3] - region[2]
    gb = gbuffer(S, cam, width, height, region, mips=bool(cfg.get("texture_mips", True)))
    rng = init_rng(gb["xs"], gb["ys"], width, frame)
    rad = trace(S, gb, cfg, rng)
    img = rad.reshape(h, w, 3)
    depth = gb["depth"].reshape(h, w).to(S.dtype)
    normal = gb["normal_s"].reshape(h, w, 3)
    hit = gb["hit"].reshape(h, w)
    if hist is None:
        lum = luminance(img)
        hist = {"radiance": img, "depth": depth, "normal": normal, "moments": torch.stack([lum, lum * lum], -1),
                "histlen": torch.zeros_like(depth)}
    elif moved is not None and cfg.get("svgf_reproject", True):
        hist = reproject(hist, gb["position"].reshape(h, w, 3), depth, moved[0], moved[1], width, height)
    else:
        hist = {k: v[region[0]:region[1], region[2]:region[3]].to(S.device, S.dtype) for k, v in hist.items()}
    accum, moments, variance, histlen = svgf_temporal(img, depth, normal, hist, cfg)
    out = accum
    for i in range(int(cfg["svgf_atrous_passes"])):
        out = atrous(out, variance, depth, normal, 1 << i, cfg)
    out = torch.where(hit[..., None], out, img)
    nxt = {"radiance": accum, "depth": torch.clamp(depth, max=1e8), "normal": normal, "moments": moments,
           "histlen": histlen}
    return {"ldr": aces(out), "radiance": accum, "history": nxt}


def reprojected_taps(S: RefScene, cam: dict, width: int, height: int, region, prev_vp):
    """The rows and columns of the previous frame that the reprojection of
    `region`'s primary hits reads (its bilinear taps), as a region
    (r0, r1, c0, c1); None when no hit lands on that frame's image."""
    gb = gbuffer(S, cam, width, height, region, mips=False)
    m = torch.as_tensor(prev_vp, device=S.device)
    p = torch.cat([gb["position"].float(), torch.ones_like(gb["position"][:, :1], dtype=torch.float32)], -1)
    c = torch.stack([p @ m[i] for i in range(4)], -1)
    w_c = c[:, 3]
    ndc = c[:, :3] / torch.where(torch.abs(w_c) < 1e-8, 1.0, w_c)[:, None]
    x = (ndc[:, 0] * 0.5 + 0.5) * width - 0.5
    y = (0.5 - ndc[:, 1] * 0.5) * height - 0.5
    ok = gb["hit"] & (w_c > 1e-8) & (x >= -0.5) & (x <= width - 0.5) & (y >= -0.5) & (y <= height - 0.5)
    if not bool(ok.any()):
        return None
    x0 = torch.clamp(torch.floor(x[ok]), 0, width - 1).long()
    y0 = torch.clamp(torch.floor(y[ok]), 0, height - 1).long()
    return (int(y0.min()), min(int(y0.max()) + 2, height), int(x0.min()), min(int(x0.max()) + 2, width))


def tile_regions(rng: np.random.Generator, width: int, height: int, tile: int, margin: int):
    """One tile of tile x tile pixels in each quadrant of the image and one
    about its centre (where the camera looks), placed by `rng`, and each
    one's region: the tile grown by `margin` and clipped to the image.
    -> [(tile (r0, r1, c0, c1), region (r0, r1, c0, c1))]."""
    out = []
    spans = [((qy * height // 2, (qy + 1) * height // 2), (qx * width // 2, (qx + 1) * width // 2))
             for qy in range(2) for qx in range(2)]
    spans.append(((height // 2 - tile, height // 2 + tile), (width // 2 - tile, width // 2 + tile)))
    for (y_lo, y_hi), (x_lo, x_hi) in spans:
        y_lo, x_lo = max(y_lo, 0), max(x_lo, 0)
        ty = int(rng.integers(y_lo, max(y_lo + 1, y_hi - tile + 1)))
        tx = int(rng.integers(x_lo, max(x_lo + 1, x_hi - tile + 1)))
        t = (ty, min(ty + tile, height), tx, min(tx + tile, width))
        r = (max(t[0] - margin, 0), min(t[1] + margin, height), max(t[2] - margin, 0), min(t[3] + margin, width))
        out.append((t, r))
    return out


def point_tiles(rng: np.random.Generator, points: np.ndarray, vp: np.ndarray, width: int, height: int, tile: int,
                margin: int, n: int):
    """n tiles of tile x tile pixels, each about the image position (through
    the view-projection `vp`) of a point drawn by `rng` among those of
    `points` [P, 3] that land on the image, shifted to lie inside it, and
    each one's region as tile_regions gives it; none where no point lands on
    the image."""
    p = np.concatenate([np.asarray(points, np.float64), np.ones((len(points), 1))], -1) @ np.asarray(vp, np.float64).T
    w = np.where(p[:, 3] > 1e-8, p[:, 3], 1.0)
    x = (p[:, 0] / w * 0.5 + 0.5) * width
    y = (0.5 - p[:, 1] / w * 0.5) * height
    on = np.nonzero((p[:, 3] > 1e-8) & (x >= 0) & (x < width) & (y >= 0) & (y < height))[0]
    out = []
    for j in (rng.choice(on, size=n) if on.size else []):
        ty = min(max(int(y[j]) - tile // 2, 0), max(height - tile, 0))
        tx = min(max(int(x[j]) - tile // 2, 0), max(width - tile, 0))
        t = (ty, min(ty + tile, height), tx, min(tx + tile, width))
        r = (max(t[0] - margin, 0), min(t[1] + margin, height), max(t[2] - margin, 0), min(t[3] + margin, width))
        out.append((t, r))
    return out
