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
  write_gltf(path, fs)  a FlatScene as a .gltf (+ .bin + PNG) or .glb file,
                        under a node hierarchy, for the loader and the app;
                        GltfWriter builds other test files (sparse and
                        interleaved accessors, data URIs, cameras).
"""

from __future__ import annotations

import base64
import json
import struct
from pathlib import Path

import numpy as np

from nebulae_tpu_torch.core.camera import Camera
from nebulae_tpu_torch.core.scene import (
    MAT_DOUBLE_SIDED,
    MAT_HAS_BASECOLOR_TEX,
    MAT_HAS_METALROUGH_TEX,
    MAT_HAS_NORMAL_TEX,
    FlatScene,
    face_normals,
    srgb_to_linear_np,
)


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
        avg_albedo[m] = base[m, :3] * srgb_to_linear_np(sub(alb)).mean(axis=(0, 1))
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


# ---------------------------------------------------------------------------
# glTF files of test scenes
# ---------------------------------------------------------------------------

_COMPONENT = {np.dtype(np.int8): 5120, np.dtype(np.uint8): 5121, np.dtype(np.int16): 5122,
              np.dtype(np.uint16): 5123, np.dtype(np.uint32): 5125, np.dtype(np.float32): 5126}
_TYPE_OF_WIDTH = {1: "SCALAR", 2: "VEC2", 3: "VEC3", 4: "VEC4", 16: "MAT4"}


class GltfWriter:
    """A glTF 2.0 document built from numpy arrays, for test scenes.

    Accessors go to one binary buffer (an external .bin beside a .gltf, the
    BIN chunk of a .glb) or, with data_uri=True, to a second buffer stored
    as a base64 data URI.  Images are uint8 arrays (PNG-encoded by
    utils/png.py) or encoded bytes; a .gltf stores them as files beside it
    (or as data URIs), a .glb in bufferViews.  Each add_* returns the new
    object's index."""

    def __init__(self):
        self.doc: dict = {"asset": {"version": "2.0", "generator": "nebulae_tpu_torch.utils.testscenes"},
                          "scenes": [{"nodes": []}], "scene": 0}
        self._views: list[tuple[bytes, int | None, bool]] = []
        self._images: list[tuple[bytes, bool]] = []

    def _append(self, key: str, obj: dict) -> int:
        self.doc.setdefault(key, []).append(obj)
        return len(self.doc[key]) - 1

    def _view(self, data: bytes, stride: int | None = None, data_uri: bool = False) -> int:
        self._views.append((data, stride, data_uri))
        return len(self._views) - 1

    def add_accessor(self, arr, normalized: bool = False, data_uri: bool = False, sparse=None,
                     minmax: bool = False) -> int:
        """An accessor of arr [N] or [N, C]; `sparse` = (indices, values)
        replaces those rows on top of arr."""
        a = np.ascontiguousarray(arr)
        n_comp = 1 if a.ndim == 1 else a.shape[1]
        acc = {"bufferView": self._view(a.tobytes(), data_uri=data_uri), "componentType": _COMPONENT[a.dtype],
               "count": int(a.shape[0]), "type": _TYPE_OF_WIDTH[n_comp]}
        if normalized:
            acc["normalized"] = True
        if minmax:
            acc["min"] = a.reshape(a.shape[0], -1).min(0).tolist()
            acc["max"] = a.reshape(a.shape[0], -1).max(0).tolist()
        if sparse is not None:
            idx, vals = np.ascontiguousarray(sparse[0]), np.ascontiguousarray(sparse[1], a.dtype)
            acc["sparse"] = {"count": int(idx.shape[0]),
                             "indices": {"bufferView": self._view(idx.tobytes()),
                                         "componentType": _COMPONENT[idx.dtype]},
                             "values": {"bufferView": self._view(vals.tobytes())}}
        return self._append("accessors", acc)

    def add_interleaved(self, arrays) -> list[int]:
        """Accessors of float32 arrays [N, C_i] interleaved in one strided
        bufferView."""
        arrays = [np.asarray(a, np.float32) for a in arrays]
        n = arrays[0].shape[0]
        packed = np.concatenate(arrays, axis=1)
        view = self._view(packed.tobytes(), stride=packed.shape[1] * 4)
        out, off = [], 0
        for a in arrays:
            out.append(self._append("accessors", {"bufferView": view, "byteOffset": off, "componentType": 5126,
                                                  "count": n, "type": _TYPE_OF_WIDTH[a.shape[1]]}))
            off += a.shape[1] * 4
        return out

    def add_image(self, img, data_uri: bool = False, name: str | None = None) -> int:
        from nebulae_tpu_torch.utils import png

        data = bytes(img) if isinstance(img, (bytes, bytearray)) else png.encode_png(np.asarray(img, np.uint8))
        self._images.append((data, data_uri))
        return self._append("images", {"name": name} if name else {})

    def add_sampler(self, wrap_s: int, wrap_t: int | None = None) -> int:
        return self._append("samplers", {"wrapS": wrap_s, "wrapT": wrap_s if wrap_t is None else wrap_t})

    def add_texture(self, image: int, sampler: int | None = None) -> int:
        return self._append("textures", {"source": image} if sampler is None else {"source": image,
                                                                                    "sampler": sampler})

    def add_material(self, material: dict) -> int:
        return self._append("materials", material)

    def add_mesh(self, primitives: list[dict], name: str = "") -> int:
        return self._append("meshes", {"name": name, "primitives": primitives})

    def add_camera(self, camera: dict) -> int:
        return self._append("cameras", camera)

    def add_node(self, root: bool = False, **fields) -> int:
        i = self._append("nodes", fields)
        if root:
            self.doc["scenes"][0]["nodes"].append(i)
        return i

    def save(self, path) -> Path:
        """Write a .glb (one file) or a .gltf (with <stem>.bin and
        <stem>_<i>.png beside it)."""
        path = Path(path)
        glb = path.suffix == ".glb"
        doc = json.loads(json.dumps(self.doc))
        views = list(self._views)
        for i, (data, data_uri) in enumerate(self._images):
            img = doc["images"][i]
            if glb:
                views.append((data, None, False))
                img.update(bufferView=len(views) - 1, mimeType="image/png")
            elif data_uri:
                img["uri"] = "data:image/png;base64," + base64.b64encode(data).decode()
            else:
                img["uri"] = f"{path.stem}_{i}.png"
                (path.parent / img["uri"]).write_bytes(data)
        bufs = [bytearray(), bytearray()]
        doc["bufferViews"] = []
        for data, stride, data_uri in views:
            buf = bufs[1 if data_uri else 0]
            buf.extend(b"\0" * (-len(buf) % 4))
            bv = {"buffer": 1 if data_uri else 0, "byteOffset": len(buf), "byteLength": len(data)}
            if stride:
                bv["byteStride"] = stride
            doc["bufferViews"].append(bv)
            buf.extend(data)
        bufs[0].extend(b"\0" * (-len(bufs[0]) % 4))
        doc["buffers"] = [{"byteLength": len(bufs[0])}]
        if bufs[1]:
            doc["buffers"].append({"byteLength": len(bufs[1]),
                                   "uri": "data:application/octet-stream;base64," + base64.b64encode(bufs[1]).decode()})
        if glb:
            js = json.dumps(doc).encode()
            js += b" " * (-len(js) % 4)
            body = (struct.pack("<II", len(js), 0x4E4F534A) + js
                    + struct.pack("<II", len(bufs[0]), 0x004E4942) + bytes(bufs[0]))
            path.write_bytes(struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body)
        else:
            doc["buffers"][0]["uri"] = f"{path.stem}.bin"
            (path.parent / f"{path.stem}.bin").write_bytes(bytes(bufs[0]))
            path.write_text(json.dumps(doc))
        return path


def trs_matrix(translation=(0.0, 0.0, 0.0), rotation=(0.0, 0.0, 0.0, 1.0), scale=(1.0, 1.0, 1.0)) -> np.ndarray:
    """A glTF node's TRS as a 4x4 float64 matrix (column vectors)."""
    x, y, z, w = rotation
    r = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                  [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                  [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
    m = np.eye(4)
    m[:3, :3] = r @ np.diag(np.asarray(scale, np.float64))
    m[:3, 3] = translation
    return m


def _to_local(world: np.ndarray, pos, nrm, tan):
    """World-space vertices under the node transform `world` -> its local
    positions, normals and tangents (float32)."""
    inv = np.linalg.inv(world)
    lp = pos.astype(np.float64) @ inv[:3, :3].T + inv[:3, 3]
    ln = nrm.astype(np.float64) @ world[:3, :3]
    ln /= np.maximum(np.linalg.norm(ln, axis=-1, keepdims=True), 1e-12)
    lt = tan[:, :3].astype(np.float64) @ inv[:3, :3].T
    lt /= np.maximum(np.linalg.norm(lt, axis=-1, keepdims=True), 1e-12)
    return (lp.astype(np.float32), ln.astype(np.float32),
            np.concatenate([lt, tan[:, 3:4]], axis=1).astype(np.float32))


def scene_materials(fs: FlatScene) -> list[dict]:
    """A FlatScene's materials as write_gltf takes them: factors, flags and
    the maps of its `textures` stack (shared arrays stay shared)."""
    maps = [fs.textures[k, : fs.tex_hw[k, 0], : fs.tex_hw[k, 1]] for k in range(fs.textures.shape[0])]
    out = []
    for m in range(fs.num_materials):
        ids = fs.mat_tex_ids[m]
        out.append({
            "base_color_factor": fs.mat_base_color[m], "metallic": float(fs.mat_metallic[m]),
            "roughness": float(fs.mat_roughness[m]), "emissive_factor": fs.mat_emissive[m],
            "double_sided": bool(fs.mat_flags[m] & MAT_DOUBLE_SIDED),
            **{key: (maps[ids[j]] if ids[j] >= 0 else None)
               for j, key in enumerate(("base_color", "metallic_roughness", "normal", "emissive"))},
        })
    return out


def write_gltf(path, fs: FlatScene, materials: list[dict] | None = None, no_tangent_material: int = 0) -> Path:
    """Write a FlatScene's triangles as a glTF file (.gltf with .bin and PNG
    files beside it, or one .glb); returns the path.

    Each material's triangles become one primitive.  The primitives of the
    last material (the procedural scenes' ground plane) form a second mesh,
    unindexed, under a TRS node; the others one indexed mesh under a node
    with a `matrix`; both nodes hang under a root with a rotation, uniform
    scale and translation, and the vertices are stored in local space so
    that the loader's transforms bring them back to the scene's place (to
    float32 rounding).  The primitive of `no_tangent_material` omits
    TANGENT, so the loader generates its tangents.  `materials` (default:
    scene_materials(fs)) gives each material's factors and maps (uint8
    arrays; one array object used twice is written once)."""
    mats = scene_materials(fs) if materials is None else materials
    w = GltfWriter()
    images: dict[int, int] = {}
    sampler = w.add_sampler(10497)

    def tex(img):
        if img is None:
            return None
        if id(img) not in images:
            images[id(img)] = w.add_texture(w.add_image(img), sampler)
        return {"index": images[id(img)]}

    for m in mats:
        pbr = {"baseColorFactor": [float(x) for x in m["base_color_factor"]],
               "metallicFactor": float(m["metallic"]), "roughnessFactor": float(m["roughness"])}
        mat = {"pbrMetallicRoughness": pbr, "emissiveFactor": [float(x) for x in m["emissive_factor"]],
               "doubleSided": bool(m.get("double_sided", False))}
        for key, where, field in (("base_color", pbr, "baseColorTexture"),
                                  ("metallic_roughness", pbr, "metallicRoughnessTexture"),
                                  ("normal", mat, "normalTexture"), ("emissive", mat, "emissiveTexture")):
            t = tex(m.get(key))
            if t is not None:
                where[field] = t
        w.add_material(mat)

    root = trs_matrix((0.4, -0.1, 0.25), (0.0, np.sin(0.2), 0.0, np.cos(0.2)), (1.25, 1.25, 1.25))
    inner = trs_matrix((-0.3, 0.05, 0.1), (np.sin(-0.15), 0.0, 0.0, np.cos(-0.15)), (0.8, 0.8, 0.8))
    ground = trs_matrix((0.0, 0.02, -0.05), (0.0, 0.0, 0.0, 1.0), (1.1, 1.0, 0.9))
    last = fs.num_materials - 1
    prims: dict[bool, list] = {False: [], True: []}
    for m in range(fs.num_materials):
        sel = fs.tri_mat == m
        if not sel.any():
            continue
        is_ground = m == last
        world = root @ (ground if is_ground else inner)
        pos, nrm, tan = _to_local(world, fs.tri_pos[sel].reshape(-1, 3), fs.tri_nrm[sel].reshape(-1, 3),
                                  fs.tri_tan[sel].reshape(-1, 4))
        attrs = {"POSITION": w.add_accessor(pos, minmax=True), "NORMAL": w.add_accessor(nrm),
                 "TEXCOORD_0": w.add_accessor(fs.tri_uv[sel].reshape(-1, 2))}
        if m != no_tangent_material:
            attrs["TANGENT"] = w.add_accessor(tan)
        prim = {"attributes": attrs, "material": m}
        if not is_ground:
            prim["indices"] = w.add_accessor(np.arange(pos.shape[0], dtype=np.uint32))
        prims[is_ground].append(prim)
    children = [w.add_node(mesh=w.add_mesh(prims[False], "tori"), name="tori",
                           matrix=inner.T.reshape(-1).tolist())]
    if prims[True]:
        t, s = ground[:3, 3], np.diag(ground[:3, :3])
        children.append(w.add_node(mesh=w.add_mesh(prims[True], "ground"), name="ground",
                                   translation=t.tolist(), scale=s.tolist()))
    w.add_node(root=True, name="field", children=children, translation=[0.4, -0.1, 0.25],
               rotation=[0.0, float(np.sin(0.2)), 0.0, float(np.cos(0.2))], scale=[1.25, 1.25, 1.25])
    return w.save(path)
