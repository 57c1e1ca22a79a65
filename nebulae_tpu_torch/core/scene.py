"""Flat SoA scene tables (host numpy), their device tensors, and glTF scenes.

Counterpart of `nebulae_tpu/core/scene.py`: the same `FlatScene` fields,
the same `device_arrays()` dict (bit for bit, a test checks it),
`pack_geometry_rows`, `extend_atlas_mips`, `quad_pack_atlas`,
`transform_instances`, and the glTF path: `load_scene` -> `flatten_asset`
(the material tables, the texture stack, the 12-channel material atlas
and the texture-averaged materials).  JAX's loader resizes maps with
cv2; `cv_resize` computes cv2.resize's INTER_AREA and INTER_LINEAR on
uint8 maps bit for bit in numpy.  `to_tensors` moves a `device_arrays()`
dict onto a torch device.

Layout (T triangles, M materials): tri_pos/tri_nrm [T, 3, 3] f32,
tri_uv [T, 3, 2], tri_tan [T, 3, 4], tri_mat [T] i32, mat_* [M, ...],
textures [K, TH, TW, 4] u8, mat_tex [A, AH, AW, 12] u8 material atlas.
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass, field, fields
from pathlib import Path

import numpy as np
import torch

from nebulae_tpu_torch.core.gltf import GLTFAsset, MaterialDesc, load_gltf

MAT_HAS_BASECOLOR_TEX = 1 << 0
MAT_HAS_METALROUGH_TEX = 1 << 1
MAT_HAS_NORMAL_TEX = 1 << 2
MAT_HAS_EMISSIVE_TEX = 1 << 3
MAT_DOUBLE_SIDED = 1 << 4

MIP_LEVELS = 4


@dataclass
class FlatScene:
    """Static-shape SoA scene tables (host numpy)."""

    tri_pos: np.ndarray
    tri_nrm: np.ndarray
    tri_uv: np.ndarray
    tri_tan: np.ndarray
    tri_mat: np.ndarray
    tri_face_nrm: np.ndarray
    mat_base_color: np.ndarray
    mat_metallic: np.ndarray
    mat_roughness: np.ndarray
    mat_emissive: np.ndarray
    mat_tex_ids: np.ndarray
    mat_flags: np.ndarray
    mat_avg_albedo: np.ndarray
    mat_avg_rough: np.ndarray
    mat_avg_metal: np.ndarray
    mat_avg_emissive: np.ndarray
    textures: np.ndarray
    tex_hw: np.ndarray
    mat_tex: np.ndarray
    mat_tex_hw: np.ndarray
    mat_atlas_id: np.ndarray
    aabb_min: np.ndarray
    aabb_max: np.ndarray
    instance_of_tri: np.ndarray | None = None

    @property
    def num_triangles(self) -> int:
        return int(self.tri_pos.shape[0])

    @property
    def num_materials(self) -> int:
        return int(self.mat_base_color.shape[0])

    def field_arrays(self) -> dict:
        """The dataclass fields by name (to build the JAX FlatScene in tests)."""
        return {f.name: getattr(self, f.name) for f in fields(self)}

    def device_arrays(self) -> dict:
        """The numpy arrays the frame consumes, with the packed shading rows
        and the mip-extended, quad-packed, flat-row atlas derived here."""
        tri_geom, tri_fast = pack_geometry_rows(
            self.tri_pos, self.tri_nrm, self.tri_uv, self.tri_tan, self.tri_mat,
            self.tri_face_nrm, self.mat_flags, self.mat_atlas_id,
        )
        mtex, mhw, mip_ids = extend_atlas_mips(self.mat_tex, self.mat_tex_hw)
        quad = quad_pack_atlas(mtex, mhw)
        flat_rows = []
        off = np.zeros(mtex.shape[0] + 1, np.int64)
        for i in range(mtex.shape[0]):
            h, w = int(mhw[i, 0]), int(mhw[i, 1])
            flat_rows.append(quad[i, :h, :w].reshape(h * w, quad.shape[-1]))
            off[i + 1] = off[i] + h * w
        if off[-1] >= (1 << 31):
            raise ValueError("atlas rows exceed int32 indexing")
        return {
            "tri_geom": tri_geom,
            "tri_fast": tri_fast,
            "mat_tex_quad": np.concatenate(flat_rows, axis=0),
            "mat_tex_mip_hw": mhw,
            "mat_tex_mip_ids": mip_ids,
            "mat_tex_row_off": off[:-1].astype(np.int32),
            "tri_pos": self.tri_pos,
            "tri_nrm": self.tri_nrm,
            "tri_uv": self.tri_uv,
            "tri_tan": self.tri_tan,
            "tri_mat": self.tri_mat,
            "tri_face_nrm": self.tri_face_nrm,
            "mat_base_color": self.mat_base_color,
            "mat_metallic": self.mat_metallic,
            "mat_roughness": self.mat_roughness,
            "mat_emissive": self.mat_emissive,
            "mat_tex_ids": self.mat_tex_ids,
            "mat_flags": self.mat_flags,
            "mat_avg_albedo": self.mat_avg_albedo,
            "mat_avg_rough": self.mat_avg_rough,
            "mat_avg_metal": self.mat_avg_metal,
            "mat_avg_emissive": self.mat_avg_emissive,
            "textures": self.textures,
            "tex_hw": self.tex_hw,
            "mat_tex": self.mat_tex,
            "mat_tex_hw": self.mat_tex_hw,
            "mat_atlas_id": self.mat_atlas_id,
            "aabb_min": self.aabb_min,
            "aabb_max": self.aabb_max,
        }


def to_tensors(arrays: dict, device) -> dict:
    """numpy arrays -> tensors on `device` (dtypes kept; uint8 stays uint8)."""
    return {k: torch.as_tensor(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


# cv2's interpolation flags, the two the loaders use.
INTER_LINEAR, INTER_AREA = 1, 3
_COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS: fixed-point weights of 8-bit linear resizes
_COEF_ONE = 1 << _COEF_BITS


def _rint_u8(x: np.ndarray) -> np.ndarray:
    """saturate_cast<uchar> of a float: round half to even, then clamp."""
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def _area_fast(src: np.ndarray, h: int, w: int, kx: int, ky: int) -> np.ndarray:
    """Integer-factor area resize (OpenCV's ResizeAreaFast for 8-bit): 2x2
    blocks of 1, 3 or 4 channels round (sum + 2) >> 2, every other block
    sum * (1.f / area) to nearest even."""
    sh, sw, cn = src.shape
    if sh != h * ky or sw != w * kx:
        raise ValueError(f"area-fast resize of {src.shape[:2]} to {(h, w)} needs whole blocks")
    s = src.reshape(h, ky, w, kx, cn).astype(np.int32).sum(axis=(1, 3))
    if kx == 2 and ky == 2 and cn in (1, 3, 4):
        return ((s + 2) >> 2).astype(np.uint8)
    return _rint_u8(s.astype(np.float32) * np.float32(1.0 / (kx * ky)))


def _area_table(ssize: int, dsize: int, scale: float):
    """OpenCV's computeResizeAreaTab: for each output index, the source
    indices and float32 weights it sums, in order -> ([dsize, n] indices,
    [dsize, n] weights), padded with weight 0."""
    rows = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        ent = []
        if sx1 - fsx1 > 1e-3:
            ent.append((sx1 - 1, (sx1 - fsx1) / cell))
        ent += [(sx, 1.0 / cell) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            ent.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        rows.append(ent)
    n = max(len(e) for e in rows)
    idx = np.zeros((dsize, n), np.int64)
    wt = np.zeros((dsize, n), np.float32)
    for dx, ent in enumerate(rows):
        for j, (si, a) in enumerate(ent):
            idx[dx, j], wt[dx, j] = si, a
    return idx, wt


def _area(src: np.ndarray, h: int, w: int, scale_x: float, scale_y: float) -> np.ndarray:
    """OpenCV's ResizeArea for 8-bit at a non-integer factor >= 1 on both
    axes: each row's float32 sums of source texels times their area
    weights, in table order, then those rows summed likewise."""
    xi, xw = _area_table(src.shape[1], w, scale_x)
    yi, yw = _area_table(src.shape[0], h, scale_y)
    s = src.astype(np.float32)
    buf = np.zeros((src.shape[0], w, src.shape[2]), np.float32)
    for j in range(xi.shape[1]):
        buf = buf + s[:, xi[:, j]] * xw[:, j, None]
    out = yw[:, 0, None, None] * buf[yi[:, 0]]
    for j in range(1, yi.shape[1]):
        out = out + yw[:, j, None, None] * buf[yi[:, j]]
    return _rint_u8(out)


def _linear_coeffs(ssize: int, dsize: int, scale: float, inv_scale: float, area_mode: bool, clamp: bool):
    """Source index and fixed-point weights (w0, w1) of each output index
    of OpenCV's 8-bit linear resize (area_mode: INTER_AREA's emulation when
    one axis grows).  `clamp` applies the horizontal edge rule: taps before
    the first or past the last source index take it with weight 1."""
    d = np.arange(dsize, dtype=np.float64)
    if area_mode:
        si = np.floor(d * scale)
        f = ((d + 1) - (si + 1) * inv_scale).astype(np.float32)
        f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    else:
        f = ((d + 0.5) * scale - 0.5).astype(np.float32)
        si = np.floor(f)
        f = (f - si.astype(np.float32)).astype(np.float32)
    si = si.astype(np.int64)
    if clamp:
        f = np.where((si < 0) | (si >= ssize - 1), np.float32(0), f).astype(np.float32)
        si = np.clip(si, 0, ssize - 1)
    w0 = np.rint((np.float32(1) - f) * np.float32(_COEF_ONE)).astype(np.int64)
    w1 = np.rint(f * np.float32(_COEF_ONE)).astype(np.int64)
    return si, w0, w1


def _linear(src: np.ndarray, h: int, w: int, scale_x, scale_y, inv_x, inv_y, area_mode: bool) -> np.ndarray:
    """OpenCV's fixed-point linear resize of 8-bit images: rows weighted in
    integers (weights of 2^11), columns combined as
    ((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16) + 2 >> 2."""
    sh, sw, _ = src.shape
    xs, a0, a1 = _linear_coeffs(sw, w, scale_x, inv_x, area_mode, clamp=True)
    ys, b0, b1 = _linear_coeffs(sh, h, scale_y, inv_y, area_mode, clamp=False)
    s = src.astype(np.int64)
    rows = s[:, xs] * a0[:, None] + s[:, np.minimum(xs + 1, sw - 1)] * a1[:, None]
    r0 = rows[np.clip(ys, 0, sh - 1)] >> 4
    r1 = rows[np.clip(ys + 1, 0, sh - 1)] >> 4
    out = (((b0[:, None, None] * r0) >> 16) + ((b1[:, None, None] * r1) >> 16) + 2) >> 2
    return out.astype(np.uint8)


def cv_resize(img: np.ndarray, h: int, w: int, interpolation: int) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=...) for uint8 [H, W] or
    [H, W, C] maps, INTER_AREA or INTER_LINEAR, bit for bit; the result
    is [h, w, C] (C = 1 for a 2-D map)."""
    src = img if img.ndim == 3 else img[..., None]
    sh, sw = src.shape[:2]
    if (sh, sw) == (h, w):
        return src.copy()
    inv_x, inv_y = w / sw, h / sh
    scale_x, scale_y = 1.0 / inv_x, 1.0 / inv_y
    kx, ky = round(scale_x), round(scale_y)
    area_fast = abs(scale_x - kx) < sys.float_info.epsilon and abs(scale_y - ky) < sys.float_info.epsilon
    if interpolation == INTER_LINEAR and area_fast and kx == 2 and ky == 2:
        interpolation = INTER_AREA
    if interpolation == INTER_AREA and scale_x >= 1 and scale_y >= 1:
        if area_fast:
            return _area_fast(src, h, w, kx, ky)
        return _area(src, h, w, scale_x, scale_y)
    if interpolation not in (INTER_AREA, INTER_LINEAR):
        raise ValueError(f"unsupported interpolation {interpolation}")
    return _linear(src, h, w, scale_x, scale_y, inv_x, inv_y, area_mode=interpolation == INTER_AREA)


def _resize_map(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """A uint8 map at (h, w) as JAX's loader resizes it: INTER_AREA when
    either side shrinks, else INTER_LINEAR; the map itself if the size
    holds.  Always [h, w, C]."""
    if img.shape[0] == h and img.shape[1] == w:
        return img
    interp = INTER_AREA if (img.shape[0] > h or img.shape[1] > w) else INTER_LINEAR
    return cv_resize(img, h, w, interp)


def extend_atlas_mips(atlas: np.ndarray, hw: np.ndarray, levels: int = MIP_LEVELS):
    """Append area-averaged mip slots to the material atlas.  Returns
    (atlas' [A', AH, AW, C], hw' [A', 2], mip_ids [A, levels] i32); levels
    past a slot's smallest size repeat the last one."""
    a = atlas.shape[0]
    mip_ids = np.zeros((a, levels), np.int32)
    mip_ids[:, 0] = np.arange(a)
    extra, extra_hw = [], []
    for i in range(a):
        h, w = int(hw[i, 0]), int(hw[i, 1])
        img = atlas[i, :h, :w]
        prev = i
        for level in range(1, levels):
            if min(h, w) >= 2:
                h, w = max(h // 2, 1), max(w // 2, 1)
                img = _resize_map(img, h, w)
                slot = np.zeros(atlas.shape[1:], atlas.dtype)
                slot[:h, :w] = img
                extra.append(slot)
                extra_hw.append((h, w))
                prev = a + len(extra) - 1
            mip_ids[i, level] = prev
    if not extra:
        return atlas, hw, mip_ids
    atlas2 = np.concatenate([atlas, np.stack(extra)], axis=0)
    hw2 = np.concatenate([hw, np.asarray(extra_hw, np.int32)], axis=0)
    return atlas2, hw2, mip_ids


def quad_pack_atlas(mat_tex: np.ndarray, mat_tex_hw: np.ndarray) -> np.ndarray:
    """Each texel's 2x2 REPEAT-wrap neighbourhood in one row:
    [A, AH, AW, 4C] with channels (p | right | down | diag), wrapped at each
    slot's actual (h, w)."""
    a, ah, aw, c = mat_tex.shape
    quad = np.zeros((a, ah, aw, 4 * c), mat_tex.dtype)
    for i in range(a):
        h, w = int(mat_tex_hw[i, 0]), int(mat_tex_hw[i, 1])
        sub = mat_tex[i, :h, :w]
        right = np.roll(sub, -1, axis=1)
        down = np.roll(sub, -1, axis=0)
        diag = np.roll(right, -1, axis=0)
        quad[i, :h, :w] = np.concatenate([sub, right, down, diag], axis=-1)
    return quad


def pack_geometry_rows(
    tri_pos, tri_nrm, tri_uv, tri_tan, tri_mat, tri_face_nrm, mat_flags, mat_atlas_id
):
    """Per-triangle packed shading rows.

    tri_geom [T, 39] f32: v0(0:3) e1(3:6) e2(6:9) nrm corners(9:18)
        uv corners(18:24) tan corners(24:36) mat(36) flags(37) atlas_id(38).
    tri_fast [T, 13] f32: nrm corners(0:9) face normal(9:12) mat(12).
    The small integers are exact in f32 (< 2^24)."""
    t = tri_pos.shape[0]
    if t == 0:
        return np.zeros((0, 39), np.float32), np.zeros((0, 13), np.float32)
    v0 = tri_pos[:, 0]
    matf = tri_mat.astype(np.float32)
    flagsf = mat_flags[tri_mat].astype(np.float32) if mat_flags.shape[0] else np.zeros(t, np.float32)
    aidf = (
        mat_atlas_id[tri_mat].astype(np.float32) if mat_atlas_id.shape[0] else np.zeros(t, np.float32)
    )
    tri_geom = np.concatenate(
        [
            v0,
            tri_pos[:, 1] - v0,
            tri_pos[:, 2] - v0,
            tri_nrm.reshape(t, 9),
            tri_uv.reshape(t, 6),
            tri_tan.reshape(t, 12),
            matf[:, None],
            flagsf[:, None],
            aidf[:, None],
        ],
        axis=1,
    ).astype(np.float32)
    tri_fast = np.concatenate(
        [tri_nrm.reshape(t, 9), tri_face_nrm, matf[:, None]], axis=1
    ).astype(np.float32)
    return tri_geom, tri_fast


def transform_instances(base_tri_pos, base_tri_nrm, instance_of_tri, transforms):
    """Rigid per-instance 3x4 transforms of instanced triangles (the
    counterpart of nebulae_tpu's transform_instances).  Each triangle maps
    through its instance's matrix; the rotation part also turns the vertex
    normals, which are renormalised (rigid or uniform-scale transforms).

    base_tri_pos / base_tri_nrm [T, 3, 3] and instance_of_tri [T] are
    tensors on one device; transforms [I, 3, 4] (rows are world rows, the
    last column the translation) may be numpy.  Returns (tri_pos, tri_nrm)
    on that device."""
    dev = base_tri_pos.device
    m = torch.as_tensor(np.asarray(transforms, np.float32)).to(dev)[instance_of_tri.long()]
    r, t = m[..., :3], m[..., 3]
    pos = torch.einsum("tij,tvj->tvi", r, base_tri_pos) + t[:, None, :]
    nrm = torch.einsum("tij,tvj->tvi", r, base_tri_nrm)
    nrm = nrm / torch.clamp(torch.linalg.vector_norm(nrm, dim=-1, keepdim=True), min=1e-12)
    return pos, nrm


def face_normals(tri_pos: np.ndarray, tri_nrm: np.ndarray) -> np.ndarray:
    """Geometric normals oriented along the average shading normal."""
    if tri_pos.shape[0] == 0:
        return np.zeros((0, 3), np.float32)
    e1 = tri_pos[:, 1] - tri_pos[:, 0]
    e2 = tri_pos[:, 2] - tri_pos[:, 0]
    fn = np.cross(e1, e2)
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)
    flip = (fn * tri_nrm.mean(axis=1)).sum(-1) < 0.0
    return np.where(flip[:, None], -fn, fn).astype(np.float32)


@dataclass
class Scene:
    """A loaded asset and its flattened tables.  `seconds` holds the load's
    parse_s, decode_s (images) and pack_s (tables, texture stack, atlas)."""

    asset: GLTFAsset
    flat: FlatScene
    seconds: dict = field(default_factory=dict)


def srgb_to_linear_np(c: np.ndarray) -> np.ndarray:
    """The sRGB EOTF on a numpy array, in its own dtype (JAX's numpy path)."""
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _pack_materials(mats: list[MaterialDesc]):
    m = len(mats)
    base = np.zeros((m, 4), np.float32)
    metal = np.zeros(m, np.float32)
    rough = np.zeros(m, np.float32)
    emis = np.zeros((m, 3), np.float32)
    tex = np.full((m, 4), -1, np.int32)
    flags = np.zeros(m, np.int32)
    for i, md in enumerate(mats):
        base[i] = md.base_color_factor
        metal[i] = md.metallic_factor
        rough[i] = md.roughness_factor
        emis[i] = md.emissive_factor
        tex[i] = [md.base_color_tex, md.metallic_roughness_tex, md.normal_tex, md.emissive_tex]
        f = 0
        f |= MAT_HAS_BASECOLOR_TEX if md.base_color_tex >= 0 else 0
        f |= MAT_HAS_METALROUGH_TEX if md.metallic_roughness_tex >= 0 else 0
        f |= MAT_HAS_NORMAL_TEX if md.normal_tex >= 0 else 0
        f |= MAT_HAS_EMISSIVE_TEX if md.emissive_tex >= 0 else 0
        f |= MAT_DOUBLE_SIDED if md.double_sided else 0
        flags[i] = f
    return base, metal, rough, emis, tex, flags


def _capped(shape, max_dim: int | None) -> tuple[int, int]:
    """(h, w) of a map under the max_texture_dim cap, truncated as JAX's."""
    h, w = int(shape[0]), int(shape[1])
    if max_dim is not None and max(h, w) > max_dim:
        s = max_dim / max(h, w)
        h, w = max(1, int(h * s)), max(1, int(w * s))
    return h, w


def _pack_textures(images: list[np.ndarray], max_dim: int | None = None):
    """Stack variable-size images into one zero-padded [K, TH, TW, 4] u8
    array and their (h, w); `max_dim` area-downsamples larger images."""
    if not images:
        return np.zeros((0, 1, 1, 4), np.uint8), np.zeros((0, 2), np.int32)
    proc = []
    for img in images:
        h, w = _capped(img.shape, max_dim)
        proc.append(cv_resize(img, h, w, INTER_AREA) if (h, w) != img.shape[:2] else img)
    th = max(i.shape[0] for i in proc)
    tw = max(i.shape[1] for i in proc)
    stack = np.zeros((len(proc), th, tw, 4), np.uint8)
    hw = np.zeros((len(proc), 2), np.int32)
    for k, img in enumerate(proc):
        stack[k, : img.shape[0], : img.shape[1]] = img
        hw[k] = img.shape[:2]
    return stack, hw


def _pack_material_atlas(mats, images, max_dim: int | None):
    """Each material's maps in one 12-channel texel array (albedo.rgb |
    roughness | metallic | normal.xyz | emissive.rgb | pad), at the largest
    of its capped map sizes; absent maps fill with neutral values.
    Materials with the same map set share a slot.  Returns (atlas
    [A, AH, AW, 12] u8, atlas_hw [A, 2] i32, mat_atlas_id [M] i32)."""
    m = len(mats)
    if m == 0:
        return (
            np.zeros((1, 1, 1, 12), np.uint8),
            np.ones((1, 2), np.int32),
            np.zeros((0,), np.int32),
        )
    slot_of: dict[tuple, int] = {}
    slots = []
    mat_aid = np.zeros(m, np.int32)
    for i, md in enumerate(mats):
        ids = (md.base_color_tex, md.metallic_roughness_tex, md.normal_tex, md.emissive_tex)
        key = tuple(t if 0 <= t < len(images) else -1 for t in ids)
        if key not in slot_of:
            slot_of[key] = len(slots)
            slots.append(key)
        mat_aid[i] = slot_of[key]

    resized: dict[tuple, np.ndarray] = {}

    def fit(t, h, w):  # a map shared by several slots is resized once per size
        if (t, h, w) not in resized:
            resized[(t, h, w)] = _resize_map(images[t], h, w)
        return resized[(t, h, w)]

    packed = []
    for key in slots:
        bc, mr, nm, em = key
        h = w = 1
        for t in key:
            if t >= 0:
                th, tw = _capped(images[t].shape[:2], max_dim)
                h, w = max(h, th), max(w, tw)
        px = np.empty((h, w, 12), np.uint8)
        px[..., 0:3] = fit(bc, h, w)[..., :3] if bc >= 0 else 255
        if mr >= 0:
            mrm = fit(mr, h, w)
            px[..., 3] = mrm[..., 1]  # roughness = G
            px[..., 4] = mrm[..., 2]  # metallic = B
        else:
            px[..., 3:5] = 255
        px[..., 5:8] = fit(nm, h, w)[..., :3] if nm >= 0 else (128, 128, 255)
        px[..., 8:11] = fit(em, h, w)[..., :3] if em >= 0 else 255
        px[..., 11] = 0
        packed.append(px)

    ah = max(p.shape[0] for p in packed)
    aw = max(p.shape[1] for p in packed)
    atlas = np.zeros((len(packed), ah, aw, 12), np.uint8)
    hw = np.zeros((len(packed), 2), np.int32)
    for a, p in enumerate(packed):
        atlas[a, : p.shape[0], : p.shape[1]] = p
        hw[a] = p.shape[:2]
    return atlas, hw, mat_aid


def _average_material_tables(mats, images, base, metal, rough, emis):
    """Texture-averaged ("1x1 mip") material values for fast bounce
    shading: every 4th texel of each map, in float32."""
    avg_albedo = base[:, :3].copy()
    avg_rough = rough.copy()
    avg_metal = metal.copy()
    avg_emissive = emis.copy()

    def tex_mean(idx, stride=4):
        return images[idx][::stride, ::stride, :3].astype(np.float32) / 255.0

    for i, md in enumerate(mats):
        if 0 <= md.base_color_tex < len(images):
            avg_albedo[i] *= srgb_to_linear_np(tex_mean(md.base_color_tex)).mean(axis=(0, 1))
        if 0 <= md.metallic_roughness_tex < len(images):
            mr = tex_mean(md.metallic_roughness_tex).mean(axis=(0, 1))
            avg_rough[i] *= mr[1]
            avg_metal[i] *= mr[2]
        if 0 <= md.emissive_tex < len(images):
            avg_emissive[i] *= srgb_to_linear_np(tex_mean(md.emissive_tex)).mean(axis=(0, 1))
    return (
        avg_albedo.astype(np.float32),
        np.clip(avg_rough, 0.02, 1.0).astype(np.float32),
        np.clip(avg_metal, 0.0, 1.0).astype(np.float32),
        avg_emissive.astype(np.float32),
    )


def flatten_asset(asset: GLTFAsset, max_texture_dim: int | None = None) -> FlatScene:
    """Bake all instances into world-space triangle SoA tables."""
    pos_l, nrm_l, uv_l, tan_l, mat_l = [], [], [], [], []
    for inst in asset.instances:
        p = inst.primitive
        world = inst.world.astype(np.float64)
        nmat = np.linalg.inv(world[:3, :3]).T
        wpos = (p.positions @ world[:3, :3].T + world[:3, 3]).astype(np.float32)
        wnrm = p.normals @ nmat.T
        wnrm = (wnrm / np.maximum(np.linalg.norm(wnrm, axis=-1, keepdims=True), 1e-12)).astype(
            np.float32
        )
        wtan_xyz = p.tangents[:, :3] @ world[:3, :3].T
        wtan_xyz = wtan_xyz / np.maximum(np.linalg.norm(wtan_xyz, axis=-1, keepdims=True), 1e-12)
        wtan = np.concatenate([wtan_xyz, p.tangents[:, 3:4]], axis=-1).astype(np.float32)
        f = p.indices.reshape(-1, 3).astype(np.int64)
        pos_l.append(wpos[f])  # [t, 3, 3]
        nrm_l.append(wnrm[f])
        uv_l.append(p.uvs[f])
        tan_l.append(wtan[f])
        mat_l.append(np.full(f.shape[0], p.material, np.int32))

    tri_pos = np.concatenate(pos_l) if pos_l else np.zeros((0, 3, 3), np.float32)
    tri_nrm = np.concatenate(nrm_l) if nrm_l else np.zeros((0, 3, 3), np.float32)
    tri_uv = np.concatenate(uv_l) if uv_l else np.zeros((0, 3, 2), np.float32)
    tri_tan = np.concatenate(tan_l) if tan_l else np.zeros((0, 3, 4), np.float32)
    tri_mat = np.concatenate(mat_l) if mat_l else np.zeros(0, np.int32)

    base, metal, rough, emis, tex, flags = _pack_materials(asset.materials)
    textures, tex_hw = _pack_textures(asset.images, max_texture_dim)
    mat_tex, mat_tex_hw, mat_atlas_id = _pack_material_atlas(asset.materials, asset.images, max_texture_dim)
    avg_albedo, avg_rough, avg_metal, avg_emissive = _average_material_tables(
        asset.materials, asset.images, base, metal, rough, emis
    )
    return FlatScene(
        tri_pos=tri_pos,
        tri_nrm=tri_nrm,
        tri_uv=tri_uv,
        tri_tan=tri_tan,
        tri_mat=tri_mat,
        tri_face_nrm=face_normals(tri_pos, tri_nrm),
        mat_base_color=base,
        mat_metallic=metal,
        mat_roughness=rough,
        mat_emissive=emis,
        mat_tex_ids=tex,
        mat_flags=flags,
        mat_avg_albedo=avg_albedo,
        mat_avg_rough=avg_rough,
        mat_avg_metal=avg_metal,
        mat_avg_emissive=avg_emissive,
        textures=textures,
        tex_hw=tex_hw,
        mat_tex=mat_tex,
        mat_tex_hw=mat_tex_hw,
        mat_atlas_id=mat_atlas_id,
        aabb_min=asset.aabb_min.astype(np.float32),
        aabb_max=asset.aabb_max.astype(np.float32),
    )


def load_scene(path: str | Path, load_images: bool = True, max_texture_dim: int | None = None) -> Scene:
    """A .gltf or .glb file -> Scene (the asset and its FlatScene), with the
    load's seconds by stage."""
    seconds: dict = {}
    asset = load_gltf(path, load_images=load_images, timings=seconds)
    t0 = time.perf_counter()
    flat = flatten_asset(asset, max_texture_dim)
    seconds["pack_s"] = time.perf_counter() - t0
    return Scene(asset=asset, flat=flat, seconds=seconds)
