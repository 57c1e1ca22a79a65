"""Flat SoA scene tables (host numpy) and their device tensors.

Counterpart of `nebulae_tpu/core/scene.py` without glTF loading: the same
`FlatScene` fields, the same `device_arrays()` dict (bit for bit, a test
checks it), `pack_geometry_rows`, `extend_atlas_mips`, `quad_pack_atlas`
and `transform_instances`.  `to_tensors` moves a `device_arrays()` dict onto a
torch device.

Layout (T triangles, M materials): tri_pos/tri_nrm [T, 3, 3] f32,
tri_uv [T, 3, 2], tri_tan [T, 3, 4], tri_mat [T] i32, mat_* [M, ...],
textures [K, TH, TW, 4] u8, mat_tex [A, AH, AW, 12] u8 material atlas.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

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


def _halve_map(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Exact 2x area downsample of a uint8 map, rounding half to even -- the
    result cv2's INTER_AREA gives for many-channel maps at integer scale."""
    if img.shape[0] != 2 * h or img.shape[1] != 2 * w:
        raise ValueError(
            f"atlas mips need even slot sizes, got {img.shape[:2]} -> {(h, w)}"
        )
    s = img.reshape(h, 2, w, 2, -1).astype(np.float32).sum(axis=(1, 3))
    return np.rint(s * np.float32(0.25)).astype(img.dtype)


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
                img = _halve_map(img, h, w)
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
