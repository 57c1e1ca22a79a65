"""The benchmark's scenes, made from the seed with numpy alone.

A frozen copy of the procedural scenes the port's tests use
(`torus_field`, `torus_atrium` and the material maps they carry), so that a
later change to the program's own scene helpers does not move the
yardstick.  `build_scene(spec, seed)` returns the scene as a dict of numpy
arrays under the field names of the program's `FlatScene`; the harness
hands that dict to the program and the plain reference reads the same
arrays.

Layout (T triangles, M materials): tri_pos / tri_nrm [T, 3, 3] float32,
tri_uv [T, 3, 2], tri_tan [T, 3, 4], tri_mat [T] int32; per material the
factors, flags and the index of its 12-channel atlas slot; `mat_tex`
[A, S, S, 12] uint8 holds albedo.rgb | roughness | metallic | normal.xyz |
emissive.rgb | pad of each slot; `textures` the separate maps.
"""

from __future__ import annotations

import numpy as np

MAT_HAS_BASECOLOR_TEX = 1 << 0
MAT_HAS_METALROUGH_TEX = 1 << 1
MAT_HAS_NORMAL_TEX = 1 << 2


def srgb_to_linear_np(c: np.ndarray) -> np.ndarray:
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def face_normals(tri_pos: np.ndarray, tri_nrm: np.ndarray) -> np.ndarray:
    """Geometric normals oriented along the average shading normal."""
    e1 = tri_pos[:, 1] - tri_pos[:, 0]
    e2 = tri_pos[:, 2] - tri_pos[:, 0]
    fn = np.cross(e1, e2)
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)
    flip = (fn * tri_nrm.mean(axis=1)).sum(-1) < 0.0
    return np.where(flip[:, None], -fn, fn).astype(np.float32)


def material_maps(rng, size: int):
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


def torus(rng, center, R, r, nu, nv, tilt):
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
    pos, nrm, uv, tan = [], [], [], []
    for tri in ((0, 1, 2), (0, 2, 3)):
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


def ground_plane(lo, hi, y: float, cells: int = 8) -> np.ndarray:
    """Ground quad subdivided into cells x cells tiles."""
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


def append_flat_tris(sc: dict, tris: np.ndarray, normal, albedo, rough: float = 0.9, metal: float = 0.0) -> None:
    """Append untextured triangles with one new material and a neutral 1x1
    atlas slot; the triangles become one more instance."""
    t = tris.shape[0]
    nrm = np.tile(np.asarray(normal, np.float32), (t, 1))
    mat_id = sc["mat_base_color"].shape[0]
    a = np.asarray(albedo, np.float32)

    def cat(key, rows, dtype):
        sc[key] = np.concatenate([sc[key], np.asarray(rows, dtype)]).astype(dtype)

    cat("tri_pos", tris, np.float32)
    cat("tri_nrm", np.repeat(nrm[:, None, :], 3, axis=1), np.float32)
    cat("tri_uv", np.zeros((t, 3, 2)), np.float32)
    cat("tri_tan", np.tile(np.array([1, 0, 0, 1], np.float32), (t, 3, 1)), np.float32)
    cat("tri_mat", np.full(t, mat_id), np.int32)
    cat("tri_face_nrm", nrm, np.float32)
    cat("mat_base_color", [[*a, 1.0]], np.float32)
    cat("mat_metallic", [metal], np.float32)
    cat("mat_roughness", [rough], np.float32)
    cat("mat_emissive", [[0.0, 0.0, 0.0]], np.float32)
    cat("mat_tex_ids", [[-1, -1, -1, -1]], np.int32)
    cat("mat_flags", [0], np.int32)
    a_idx = sc["mat_tex"].shape[0]
    neutral = np.zeros((1,) + sc["mat_tex"].shape[1:], np.uint8)
    neutral[0, 0, 0] = [255, 255, 255, 255, 255, 128, 128, 255, 255, 255, 255, 0]
    cat("mat_tex", neutral, np.uint8)
    cat("mat_tex_hw", [[1, 1]], np.int32)
    cat("mat_atlas_id", [a_idx], np.int32)
    cat("mat_avg_albedo", [a], np.float32)
    cat("mat_avg_rough", [rough], np.float32)
    cat("mat_avg_metal", [metal], np.float32)
    cat("mat_avg_emissive", [[0.0, 0.0, 0.0]], np.float32)
    sc["aabb_min"] = np.minimum(sc["aabb_min"], tris.reshape(-1, 3).min(0).astype(np.float32))
    sc["aabb_max"] = np.maximum(sc["aabb_max"], tris.reshape(-1, 3).max(0).astype(np.float32))
    cat("instance_of_tri", np.full(t, sc["instance_of_tri"].max() + 1), np.int32)


def torus_field(seed: int, nx: int, nz: int, nu: int, nv: int, n_materials: int, map_size: int,
                spacing: float = 3.0) -> dict:
    """nx*nz textured, normal-mapped bumpy tori (2*nu*nv triangles each)
    over a subdivided ground plane with its own untextured material."""
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
        alb, mr, nm = material_maps(rng, map_size)
        images += [alb, mr, nm]
        atlas[m, ..., 0:3] = alb[..., :3]
        atlas[m, ..., 3] = mr[..., 1]
        atlas[m, ..., 4] = mr[..., 2]
        atlas[m, ..., 5:8] = nm[..., :3]
        atlas[m, ..., 8:11] = 255
        base[m] = [*rng.uniform(0.7, 1.0, 3), 1.0]
        metal[m] = rng.uniform(0.0, 1.0)
        rough[m] = rng.uniform(0.5, 1.0)
        sub_alb = alb[::4, ::4, :3].astype(np.float32) / 255.0
        sub_mr = mr[::4, ::4, :3].astype(np.float32) / 255.0
        avg_albedo[m] = base[m, :3] * srgb_to_linear_np(sub_alb).mean(axis=(0, 1))
        mr_mean = sub_mr.mean(axis=(0, 1))
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
            pos, nrm, uv, tan = torus(rng, center, R, r, nu, nv, tilt)
            mat = np.full(pos.shape[0], (ix * nz + iz) % n_materials, np.int32)
            parts.append((pos, nrm, uv, tan, mat))
    tri_pos = np.concatenate([p[0] for p in parts])
    tri_nrm = np.concatenate([p[1] for p in parts])
    flags = MAT_HAS_BASECOLOR_TEX | MAT_HAS_METALROUGH_TEX | MAT_HAS_NORMAL_TEX
    tex_ids = np.arange(3 * n_materials, dtype=np.int32).reshape(n_materials, 3)
    sc = {
        "tri_pos": tri_pos,
        "tri_nrm": tri_nrm,
        "tri_uv": np.concatenate([p[2] for p in parts]),
        "tri_tan": np.concatenate([p[3] for p in parts]),
        "tri_mat": np.concatenate([p[4] for p in parts]),
        "tri_face_nrm": face_normals(tri_pos, tri_nrm),
        "mat_base_color": base,
        "mat_metallic": metal,
        "mat_roughness": rough,
        "mat_emissive": np.zeros((n_materials, 3), np.float32),
        "mat_tex_ids": np.concatenate([tex_ids, np.full((n_materials, 1), -1, np.int32)], 1),
        "mat_flags": np.full(n_materials, flags, np.int32),
        "mat_avg_albedo": avg_albedo,
        "mat_avg_rough": avg_rough,
        "mat_avg_metal": avg_metal,
        "mat_avg_emissive": np.zeros((n_materials, 3), np.float32),
        "textures": np.stack(images),
        "tex_hw": np.full((len(images), 2), map_size, np.int32),
        "mat_tex": atlas,
        "mat_tex_hw": np.full((n_materials, 2), map_size, np.int32),
        "mat_atlas_id": np.arange(n_materials, dtype=np.int32),
        "aabb_min": tri_pos.reshape(-1, 3).min(0).astype(np.float32),
        "aabb_max": tri_pos.reshape(-1, 3).max(0).astype(np.float32),
        "instance_of_tri": np.repeat(np.arange(len(parts), dtype=np.int32), [p[0].shape[0] for p in parts]),
    }
    plane = ground_plane(sc["aabb_min"], sc["aabb_max"], float(sc["aabb_min"][1]) - 0.2)
    append_flat_tris(sc, plane, [0, 1, 0], [0.6, 0.6, 0.6])
    return sc


def torus_atrium(seed: int, nx: int, nz: int, nu: int, nv: int, n_materials: int, map_size: int) -> dict:
    """torus_field enclosed by four walls (8 untextured triangles), their
    top at the field's top plus 0.6 of its height, a 4% margin, red and
    green side walls, open to the sky above."""
    sc = torus_field(seed, nx, nz, nu, nv, n_materials, map_size)
    lo, hi = sc["aabb_min"].copy(), sc["aabb_max"].copy()
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
        append_flat_tris(sc, tris, n, albedo)
    return sc


KINDS = {"torus_field": torus_field, "torus_atrium": torus_atrium}


def build_scene(spec: dict, seed: int) -> dict:
    """A configuration's "scene" group (its kind and sizes) made from the
    seed: numpy arrays under the program's FlatScene field names."""
    sizes = {k: v for k, v in spec.items() if k != "kind"}
    return KINDS[spec["kind"]](seed, **sizes)


def scene_bytes(sc: dict) -> dict:
    """Triangle and texture bytes of a scene as the configuration states
    them: float32 vertices (36 bytes a triangle) and the uint8 maps (the
    material atlas and the separate maps)."""
    return {
        "triangles": int(sc["tri_pos"].shape[0]),
        "triangle_bytes": int(sc["tri_pos"].shape[0]) * 36,
        "atlas_bytes": int(sc["mat_tex"].nbytes),
        "map_bytes": int(sc["textures"].nbytes),
    }
