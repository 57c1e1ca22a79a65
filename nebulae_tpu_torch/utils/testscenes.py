"""Procedural test and benchmark scenes (numpy only, deterministic from a seed).

The JAX package's Sponza-class scene instances the DamagedHelmet asset,
which this repository does not ship, so the port builds its scenes itself:
tessellated, normal-mapped tori (bumpy, some tilted) on a subdivided ground
plane, with generated albedo / metal-roughness / normal maps packed into the
12-channel material atlas and kept in the `textures` stack.  That makes the
frame take the full-texture-shading path at every bounce.

  textured_scene(seed)  ~5k triangles, 64x64 maps: the CPU parity scene.
  bench_scene(seed)     ~139k triangles, 512x512 maps: the size of
                        `helmet_field(3, 3)` for the GPU frame.
  large_scene(seed)     ~247k triangles, the size of `helmet_field(4, 4)`
                        (Sponza-class): past the 160k single-table gate.
  huge_scene(seed)      ~2.05M triangles: JAX's padded tables pass the
                        80 MB byte gate, so "auto" routes it to paging.
  box_scene()           a closed box of 12 untextured triangles: a BVH
                        whose root is a leaf (the one-node tables, K8).
  torus_atrium(...)     a torus_field enclosed by four walls and open to
                        the sky (JAX's helmet_atrium around the tori): the
                        interior where the radiance cache's handoff fires;
                        small_atrium and bench_atrium at textured_scene's
                        and bench_scene's sizes, atrium_camera inside it.
  procedural_envmap()   the 64x128 lat-long sky of JAX's app, for
                        enable_envmap.
"""

from __future__ import annotations

import numpy as np

from nebulae_tpu_torch.core.camera import Camera
from nebulae_tpu_torch.core.scene import (
    MAT_HAS_BASECOLOR_TEX,
    MAT_HAS_METALROUGH_TEX,
    MAT_HAS_NORMAL_TEX,
    FlatScene,
    face_normals,
)


def _srgb_to_linear_np(c):
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _material_maps(rng, size: int):
    """Albedo (RGBA), metal-roughness (G rough, B metal) and normal maps,
    uint8 [size, size, 4] each."""
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    cells = int(rng.integers(4, 9))
    checker = ((xx * cells // size + yy * cells // size) % 2).astype(np.float32)
    c0 = rng.uniform(0.15, 0.9, 3)
    c1 = rng.uniform(0.15, 0.9, 3)
    noise = rng.uniform(-0.08, 0.08, (size, size, 1))
    albedo = np.clip(c0 * (1 - checker[..., None]) + c1 * checker[..., None] + noise, 0, 1)
    rough = np.clip(0.35 + 0.5 * yy / size + rng.uniform(-0.1, 0.1, (size, size)), 0, 1)
    metal = np.where(checker > 0.5, float(rng.uniform(0.0, 1.0) > 0.5), 0.0)
    fx, fy = rng.uniform(2.0, 6.0, 2) * 2 * np.pi / size
    amp = float(rng.uniform(0.3, 0.8))
    gx = amp * np.cos(xx * fx) * fx * size / (2 * np.pi)
    gy = amp * np.cos(yy * fy) * fy * size / (2 * np.pi)
    n = np.stack([-gx * 0.1, -gy * 0.1, np.ones_like(gx)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)

    def u8(x):
        return np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)

    ones = np.ones((size, size, 1))
    alb = u8(np.concatenate([albedo, ones], -1))
    mr = u8(np.stack([np.zeros_like(rough), rough, metal, np.ones_like(rough)], -1))
    nm = u8(np.concatenate([n * 0.5 + 0.5, ones], -1))
    return alb, mr, nm


def _torus(rng, center, R, r, nu, nv, tilt):
    """Bumpy torus: 2*nu*nv triangles with corner normals, UVs, tangents."""
    th = np.arange(nu) * (2 * np.pi / nu)
    ph = np.arange(nv) * (2 * np.pi / nv)
    TH, PH = np.meshgrid(th, ph, indexing="ij")
    k1, k2 = rng.integers(3, 9, 2)
    rr = r * (1.0 + 0.12 * np.sin(k1 * TH) * np.sin(k2 * PH))
    ring = np.stack([R * np.cos(TH), np.zeros_like(TH), R * np.sin(TH)], -1)
    P = np.stack([(R + rr * np.cos(PH)) * np.cos(TH), rr * np.sin(PH),
                  (R + rr * np.cos(PH)) * np.sin(TH)], -1)
    dPdu = np.roll(P, -1, 0) - np.roll(P, 1, 0)
    dPdv = np.roll(P, -1, 1) - np.roll(P, 1, 1)
    N = np.cross(dPdu, dPdv)
    N /= np.linalg.norm(N, axis=-1, keepdims=True)
    N *= np.where(((P - ring) * N).sum(-1, keepdims=True) < 0, -1.0, 1.0)
    T = dPdu / np.linalg.norm(dPdu, axis=-1, keepdims=True)
    c, s = np.cos(tilt), np.sin(tilt)
    rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    P = P @ rot.T + center
    N = N @ rot.T
    T = T @ rot.T

    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    i, j = i.reshape(-1), j.reshape(-1)
    corners = [(i, j), ((i + 1), j), ((i + 1), (j + 1)), (i, (j + 1))]
    tris = [(0, 1, 2), (0, 2, 3)]
    pos, nrm, uv, tan = [], [], [], []
    for tri in tris:
        ci = [corners[k] for k in tri]
        pos.append(np.stack([P[a % nu, b % nv] for a, b in ci], 1))
        nrm.append(np.stack([N[a % nu, b % nv] for a, b in ci], 1))
        tan.append(np.stack([T[a % nu, b % nv] for a, b in ci], 1))
        uv.append(np.stack([np.stack([a * (4.0 / nu), b * (2.0 / nv)], -1) for a, b in ci], 1))
    pos = np.concatenate(pos).astype(np.float32)
    nrm = np.concatenate(nrm).astype(np.float32)
    uv = np.concatenate(uv).astype(np.float32)
    tan = np.concatenate(tan)
    tan = np.concatenate([tan, np.ones(tan.shape[:2] + (1,))], -1).astype(np.float32)
    return pos, nrm, uv, tan


def _ground_plane(lo, hi, y: float, cells: int = 8) -> np.ndarray:
    """Ground quad subdivided into cells x cells tiles (keeps leaf boxes local)."""
    cx, cz = (lo[0] + hi[0]) / 2, (lo[2] + hi[2]) / 2
    ext = max(hi[0] - lo[0], hi[2] - lo[2]) * 1.5
    xs = np.linspace(cx - ext, cx + ext, cells + 1, dtype=np.float32)
    zs = np.linspace(cz - ext, cz + ext, cells + 1, dtype=np.float32)
    tris = []
    for i in range(cells):
        for j in range(cells):
            x0, x1, z0, z1 = xs[i], xs[i + 1], zs[j], zs[j + 1]
            tris.append([[x0, y, z0], [x1, y, z0], [x1, y, z1]])
            tris.append([[x0, y, z0], [x1, y, z1], [x0, y, z1]])
    return np.asarray(tris, np.float32)


def _append_flat_tris(fs: FlatScene, tris: np.ndarray, normal, albedo, rough: float = 0.9,
                      metal: float = 0.0) -> None:
    """Append untextured triangles with one new material and a neutral 1x1
    atlas slot (the JAX package's utils.testscenes._append_flat_tris)."""
    t = tris.shape[0]
    nrm = np.tile(np.asarray(normal, np.float32), (t, 1))
    mat_id = fs.num_materials
    a = np.asarray(albedo, np.float32)
    fs.tri_pos = np.concatenate([fs.tri_pos, tris.astype(np.float32)])
    fs.tri_nrm = np.concatenate([fs.tri_nrm, np.repeat(nrm[:, None, :], 3, axis=1)])
    fs.tri_uv = np.concatenate([fs.tri_uv, np.zeros((t, 3, 2), np.float32)])
    fs.tri_tan = np.concatenate([fs.tri_tan, np.tile(np.array([1, 0, 0, 1], np.float32), (t, 3, 1))])
    fs.tri_mat = np.concatenate([fs.tri_mat, np.full(t, mat_id, np.int32)])
    fs.tri_face_nrm = np.concatenate([fs.tri_face_nrm, nrm])
    fs.mat_base_color = np.concatenate([fs.mat_base_color, [[*a, 1.0]]]).astype(np.float32)
    fs.mat_metallic = np.concatenate([fs.mat_metallic, [metal]]).astype(np.float32)
    fs.mat_roughness = np.concatenate([fs.mat_roughness, [rough]]).astype(np.float32)
    fs.mat_emissive = np.concatenate([fs.mat_emissive, [[0.0, 0.0, 0.0]]]).astype(np.float32)
    fs.mat_tex_ids = np.concatenate([fs.mat_tex_ids, [[-1, -1, -1, -1]]]).astype(np.int32)
    fs.mat_flags = np.concatenate([fs.mat_flags, [0]]).astype(np.int32)
    a_idx = fs.mat_tex.shape[0]
    neutral = np.zeros((1,) + fs.mat_tex.shape[1:], np.uint8)
    neutral[0, 0, 0] = [255, 255, 255, 255, 255, 128, 128, 255, 255, 255, 255, 0]
    fs.mat_tex = np.concatenate([fs.mat_tex, neutral])
    fs.mat_tex_hw = np.concatenate([fs.mat_tex_hw, [[1, 1]]]).astype(np.int32)
    fs.mat_atlas_id = np.concatenate([fs.mat_atlas_id, [a_idx]]).astype(np.int32)
    fs.mat_avg_albedo = np.concatenate([fs.mat_avg_albedo, [a]]).astype(np.float32)
    fs.mat_avg_rough = np.concatenate([fs.mat_avg_rough, [rough]]).astype(np.float32)
    fs.mat_avg_metal = np.concatenate([fs.mat_avg_metal, [metal]]).astype(np.float32)
    fs.mat_avg_emissive = np.concatenate([fs.mat_avg_emissive, [[0.0, 0.0, 0.0]]]).astype(np.float32)
    fs.aabb_min = np.minimum(fs.aabb_min, tris.reshape(-1, 3).min(0).astype(np.float32))
    fs.aabb_max = np.maximum(fs.aabb_max, tris.reshape(-1, 3).max(0).astype(np.float32))
    if fs.instance_of_tri is not None:
        # Appended static geometry becomes its own instance.
        fs.instance_of_tri = np.concatenate(
            [fs.instance_of_tri, np.full(t, fs.instance_of_tri.max() + 1, np.int32)])


def torus_field(seed: int, nx: int, nz: int, nu: int, nv: int, n_materials: int,
                map_size: int, spacing: float = 3.0) -> FlatScene:
    """nx*nz textured, normal-mapped bumpy tori (2*nu*nv triangles each)
    over a subdivided ground plane with its own untextured material.  Each
    torus is one instance and the plane another (`instance_of_tri`), for
    Renderer.update_instances."""
    rng = np.random.default_rng(seed)
    images = []
    atlas = np.zeros((n_materials, map_size, map_size, 12), np.uint8)
    base = np.zeros((n_materials, 4), np.float32)
    metal = np.zeros(n_materials, np.float32)
    rough = np.zeros(n_materials, np.float32)
    avg_albedo = np.zeros((n_materials, 3), np.float32)
    avg_rough = np.zeros(n_materials, np.float32)
    avg_metal = np.zeros(n_materials, np.float32)
    for m in range(n_materials):
        alb, mr, nm = _material_maps(rng, map_size)
        images += [alb, mr, nm]
        atlas[m, ..., 0:3] = alb[..., :3]
        atlas[m, ..., 3] = mr[..., 1]
        atlas[m, ..., 4] = mr[..., 2]
        atlas[m, ..., 5:8] = nm[..., :3]
        atlas[m, ..., 8:11] = 255
        base[m] = [*rng.uniform(0.7, 1.0, 3), 1.0]
        metal[m] = rng.uniform(0.0, 1.0)
        rough[m] = rng.uniform(0.5, 1.0)
        sub = lambda img: img[::4, ::4, :3].astype(np.float32) / 255.0  # noqa: E731
        avg_albedo[m] = base[m, :3] * _srgb_to_linear_np(sub(alb)).mean(axis=(0, 1))
        mr_mean = sub(mr).mean(axis=(0, 1))
        avg_rough[m] = np.clip(rough[m] * mr_mean[1], 0.02, 1.0)
        avg_metal[m] = np.clip(metal[m] * mr_mean[2], 0.0, 1.0)

    parts = []
    for ix in range(nx):
        for iz in range(nz):
            R = float(rng.uniform(0.7, 1.0))
            r = float(rng.uniform(0.25, 0.4))
            center = np.array([(ix - (nx - 1) / 2) * spacing, r * 1.2 + 0.6 * R,
                               (iz - (nz - 1) / 2) * spacing])
            tilt = float(rng.uniform(0.0, 1.2))
            pos, nrm, uv, tan = _torus(rng, center, R, r, nu, nv, tilt)
            mat = np.full(pos.shape[0], (ix * nz + iz) % n_materials, np.int32)
            parts.append((pos, nrm, uv, tan, mat))
    tri_pos = np.concatenate([p[0] for p in parts])
    tri_nrm = np.concatenate([p[1] for p in parts])
    flags = MAT_HAS_BASECOLOR_TEX | MAT_HAS_METALROUGH_TEX | MAT_HAS_NORMAL_TEX
    tex_ids = np.arange(3 * n_materials, dtype=np.int32).reshape(n_materials, 3)
    fs = FlatScene(
        tri_pos=tri_pos,
        tri_nrm=tri_nrm,
        tri_uv=np.concatenate([p[2] for p in parts]),
        tri_tan=np.concatenate([p[3] for p in parts]),
        tri_mat=np.concatenate([p[4] for p in parts]),
        tri_face_nrm=face_normals(tri_pos, tri_nrm),
        mat_base_color=base,
        mat_metallic=metal,
        mat_roughness=rough,
        mat_emissive=np.zeros((n_materials, 3), np.float32),
        mat_tex_ids=np.concatenate([tex_ids, np.full((n_materials, 1), -1, np.int32)], 1),
        mat_flags=np.full(n_materials, flags, np.int32),
        mat_avg_albedo=avg_albedo,
        mat_avg_rough=avg_rough,
        mat_avg_metal=avg_metal,
        mat_avg_emissive=np.zeros((n_materials, 3), np.float32),
        textures=np.stack(images),
        tex_hw=np.full((len(images), 2), map_size, np.int32),
        mat_tex=atlas,
        mat_tex_hw=np.full((n_materials, 2), map_size, np.int32),
        mat_atlas_id=np.arange(n_materials, dtype=np.int32),
        aabb_min=tri_pos.reshape(-1, 3).min(0).astype(np.float32),
        aabb_max=tri_pos.reshape(-1, 3).max(0).astype(np.float32),
        instance_of_tri=np.repeat(np.arange(len(parts), dtype=np.int32), [p[0].shape[0] for p in parts]),
    )
    plane = _ground_plane(fs.aabb_min, fs.aabb_max, float(fs.aabb_min[1]) - 0.2)
    _append_flat_tris(fs, plane, [0, 1, 0], [0.6, 0.6, 0.6])
    return fs


def torus_atrium(seed: int, nx: int, nz: int, nu: int, nv: int, n_materials: int, map_size: int) -> FlatScene:
    """torus_field(seed, nx, nz, nu, nv, n_materials, map_size) enclosed by
    the four walls of JAX's helmet_atrium (8 untextured triangles): their
    top at the field's top plus 0.6 of its height, a 4% margin, red and
    green side walls, open to the sky above."""
    fs = torus_field(seed, nx, nz, nu, nv, n_materials, map_size)
    lo, hi = fs.aabb_min.copy(), fs.aabb_max.copy()
    y0, y1 = float(lo[1]), float(hi[1]) + 0.6 * float(hi[1] - lo[1])
    m = 0.04 * float(max(hi[0] - lo[0], hi[2] - lo[2]))
    x0, x1, z0, z1 = float(lo[0]) - m, float(hi[0]) + m, float(lo[2]) - m, float(hi[2]) + m

    def wall(a, b, c, d):
        return np.array([[a, b, c], [a, c, d]], np.float32)

    walls = [
        (wall([x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0]), [0, 0, 1], [0.7, 0.7, 0.65]),
        (wall([x1, y0, z1], [x0, y0, z1], [x0, y1, z1], [x1, y1, z1]), [0, 0, -1], [0.7, 0.7, 0.65]),
        (wall([x0, y0, z1], [x0, y0, z0], [x0, y1, z0], [x0, y1, z1]), [1, 0, 0], [0.65, 0.2, 0.15]),
        (wall([x1, y0, z0], [x1, y0, z1], [x1, y1, z1], [x1, y1, z0]), [-1, 0, 0], [0.15, 0.55, 0.2]),
    ]
    for tris, n, albedo in walls:
        _append_flat_tris(fs, tris, n, albedo)
    return fs


def small_atrium(seed: int = 0) -> FlatScene:
    """torus_atrium at textured_scene's size (~5k triangles, 64x64 maps)."""
    return torus_atrium(seed, nx=2, nz=1, nu=40, nv=30, n_materials=2, map_size=64)


def bench_atrium(seed: int = 0) -> FlatScene:
    """torus_atrium at bench_scene's size (~139k triangles, 512x512 maps)."""
    return torus_atrium(seed, nx=3, nz=3, nu=110, nv=70, n_materials=3, map_size=512)


def textured_scene(seed: int = 0) -> FlatScene:
    """~5k triangles (two 2400-triangle tori + ground), 64x64 maps: above
    the 4096-triangle brute-force limit, small enough for CPU tests."""
    return torus_field(seed, nx=2, nz=1, nu=40, nv=30, n_materials=2, map_size=64)


def bench_scene(seed: int = 0) -> FlatScene:
    """~139k triangles (nine 15.4k-triangle tori + ground), 512x512 maps:
    the size of the JAX bench's helmet_field(3, 3)."""
    return torus_field(seed, nx=3, nz=3, nu=110, nv=70, n_materials=3, map_size=512)


def large_scene(seed: int = 0) -> FlatScene:
    """~247k triangles (sixteen 15.4k-triangle tori + ground), 512x512 maps."""
    return torus_field(seed, nx=4, nz=4, nu=110, nv=70, n_materials=3, map_size=512)


def huge_scene(seed: int = 0) -> FlatScene:
    """~2.05M triangles (sixty-four 32k-triangle tori + ground), 512x512 maps."""
    return torus_field(seed, nx=8, nz=8, nu=160, nv=100, n_materials=3, map_size=512)


def box_scene() -> FlatScene:
    """A closed unit box of 12 triangles with outward normals, one
    untextured material per face (at most bvh_max_leaf triangles, so the
    BVH is a single leaf)."""
    fs = FlatScene(
        tri_pos=np.zeros((0, 3, 3), np.float32), tri_nrm=np.zeros((0, 3, 3), np.float32),
        tri_uv=np.zeros((0, 3, 2), np.float32), tri_tan=np.zeros((0, 3, 4), np.float32),
        tri_mat=np.zeros(0, np.int32), tri_face_nrm=np.zeros((0, 3), np.float32),
        mat_base_color=np.zeros((0, 4), np.float32), mat_metallic=np.zeros(0, np.float32),
        mat_roughness=np.zeros(0, np.float32), mat_emissive=np.zeros((0, 3), np.float32),
        mat_tex_ids=np.zeros((0, 4), np.int32), mat_flags=np.zeros(0, np.int32),
        mat_avg_albedo=np.zeros((0, 3), np.float32), mat_avg_rough=np.zeros(0, np.float32),
        mat_avg_metal=np.zeros(0, np.float32), mat_avg_emissive=np.zeros((0, 3), np.float32),
        textures=np.zeros((0, 1, 1, 4), np.uint8), tex_hw=np.zeros((0, 2), np.int32),
        mat_tex=np.zeros((0, 1, 1, 12), np.uint8), mat_tex_hw=np.zeros((0, 2), np.int32),
        mat_atlas_id=np.zeros(0, np.int32),
        aabb_min=np.full(3, np.inf, np.float32), aabb_max=np.full(3, -np.inf, np.float32),
    )
    for axis in range(3):
        u, v = (axis + 1) % 3, (axis + 2) % 3
        for side in (0.0, 1.0):
            c = np.zeros((4, 3), np.float32)
            c[:, axis] = side
            c[:, u] = [0, 1, 1, 0]
            c[:, v] = [0, 0, 1, 1]
            normal = np.zeros(3, np.float32)
            normal[axis] = 1.0 if side else -1.0
            quad = np.stack([c[[0, 1, 2]], c[[0, 2, 3]]])
            color = [0.25 + 0.5 * side, 0.3 + 0.2 * axis, 0.8 - 0.5 * side]
            _append_flat_tris(fs, quad, normal, color)
    return fs


def procedural_envmap(height: int = 64, width: int = 128) -> np.ndarray:
    """A lat-long sky [H, W, 3] float32, blue overhead and warm at the
    horizon and below: the procedural map of JAX's app (`--envmap
    procedural`), 64x128 by default."""
    th = np.linspace(0, np.pi, height, dtype=np.float32)[:, None]
    up = np.clip(np.cos(th), 0, 1)
    env = np.zeros((height, width, 3), np.float32)
    env[..., 0] = 0.9 - 0.55 * up
    env[..., 1] = 0.55 + 0.05 * up
    env[..., 2] = 0.35 + 0.55 * up
    return env


def bench_camera(fs: FlatScene, fov_y_deg: float = 60.0) -> Camera:
    """Camera overlooking the field (most rays hit geometry)."""
    lo, hi = fs.aabb_min, fs.aabb_max
    center = (lo + hi) * 0.5
    ext = float(np.max(hi - lo))
    eye = center + np.array([0.55 * ext, 0.45 * ext, 0.85 * ext], np.float32)
    return Camera(eye=eye, target=center, fov_y_deg=fov_y_deg)


def atrium_camera(fs: FlatScene, fov_y_deg: float = 60.0) -> Camera:
    """A camera inside the atrium's walls, near a top corner, looking
    across (JAX's atrium_camera)."""
    lo, hi = fs.aabb_min, fs.aabb_max
    center = (lo + hi) * 0.5
    ext = hi - lo
    eye = np.array([center[0] + 0.38 * ext[0], lo[1] + 0.82 * ext[1], center[2] + 0.40 * ext[2]], np.float32)
    target = np.array([center[0] - 0.2 * ext[0], lo[1] + 0.25 * ext[1], center[2] - 0.25 * ext[2]], np.float32)
    return Camera(eye=eye, target=target, fov_y_deg=fov_y_deg)
