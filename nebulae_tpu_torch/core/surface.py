"""Surface reconstruction at a hit point from the flat scene tensors.

Counterpart of `nebulae_tpu/core/surface.py` for the packed-row layout the
port always builds (`tri_geom` plus the quad-packed, mip-extended atlas).
Gradient contract: geometry rows and texture texels are detached; the
material factor tables (`mat_base_color`, `mat_roughness`, `mat_metallic`,
`mat_emissive`) are gathered differentiably.
"""

from __future__ import annotations

import torch

from nebulae_tpu_torch.core.math import clip, cross, dot, normalize, shift2d
from nebulae_tpu_torch.core.scene import MAT_HAS_NORMAL_TEX
from nebulae_tpu_torch.core.texture import sample_bilinear_quad, srgb_to_linear
from nebulae_tpu_torch.utils.profiling import span


def bary_packed(rows, u, v, c: int):
    """Barycentric lerp of a packed corner slice [..., 3c] -> [..., c]."""
    w = (1.0 - u - v)[..., None]
    a0 = rows[..., 0 * c: 1 * c]
    a1 = rows[..., 1 * c: 2 * c]
    a2 = rows[..., 2 * c: 3 * c]
    return a0 * w + a1 * u[..., None] + a2 * v[..., None]


def f32_int(col):
    """Exact small integer carried in an f32 channel -> int64 index."""
    return torch.round(col).long()


def take_rows(table, idx):
    """Non-differentiable row gather (geometry tables)."""
    return table.detach()[idx]


class _GatherRows(torch.autograd.Function):
    """table[idx] whose backward sums the rows' cotangents with one weighted
    bincount over (row, column) pairs.  The backward of plain indexing sorts
    the indices and then walks each run of equal ones serially, and here a
    few material rows take millions of pixels each: on an H100 the 16 gathers
    of a 1080p train step took 5.1 s in that backward.  `index_add_` is no
    cure: its atomics on those few rows serialize."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        flat = grad.reshape(grad.shape[0], -1)
        cols = flat.shape[1]
        bins = (idx[:, None] * cols + torch.arange(cols, device=idx.device)).reshape(-1)
        with span("nebulae/sync/bincount"):
            sums = torch.bincount(bins, weights=flat.reshape(-1), minlength=ctx.rows * cols)
        return sums.reshape((ctx.rows,) + tuple(grad.shape[1:])), None


def gather_rows(table, idx):
    """Differentiable row gather (material tables); idx is a 1-D int64
    tensor of valid rows."""
    return _GatherRows.apply(table, idx)


def mip_level_from_uv(scene: dict, tri_id, u, v, height: int, width: int):
    """Per-pixel atlas mip level from screen-space UV derivatives (forward
    differences, backward where the forward tap leaves the triangle, level 0
    where neither stays on it; sub-pixel interiors take the coarsest
    level).  Returns [H*W] int64."""
    n_levels = int(scene["mat_tex_mip_ids"].shape[1])
    t = torch.clamp(tri_id, 0, scene["tri_pos"].shape[0] - 1).long()
    row = take_rows(scene["tri_geom"], t)
    uv = bary_packed(row[..., 18:24], u, v, 2).reshape(height, width, 2)
    aid = f32_int(row[..., 38])
    tri_img = tri_id.reshape(height, width)
    hw = scene["mat_tex_mip_hw"][aid].reshape(height, width, 2)
    texel = torch.stack([hw[..., 1].to(uv.dtype), hw[..., 0].to(uv.dtype)], dim=-1)

    def deriv(dy, dx):
        d = shift2d(uv, dy, dx) - uv
        same = shift2d(tri_img, dy, dx) == tri_img
        fp = torch.abs(d * texel).amax(dim=-1)
        return torch.where(same, fp, -1.0)

    fx = deriv(0, -1)
    fx = torch.where(fx >= 0.0, fx, deriv(0, 1))
    fy = deriv(-1, 0)
    fy = torch.where(fy >= 0.0, fy, deriv(1, 0))
    fp = torch.clamp(torch.maximum(fx, fy), min=1.0)
    level = torch.clamp(torch.floor(torch.log2(fp)).to(torch.int32), 0, n_levels - 1).long()
    interior = (
        (shift2d(tri_img, 0, -1) >= 0)
        & (shift2d(tri_img, 0, 1) >= 0)
        & (shift2d(tri_img, -1, 0) >= 0)
        & (shift2d(tri_img, 1, 0) >= 0)
    )
    no_tap = (fx < 0.0) & (fy < 0.0)
    level = torch.where(no_tap & interior, n_levels - 1, level)
    return level.reshape(-1)


def has_textures(scene: dict) -> bool:
    return scene["mat_tex"].shape[0] > 0 and scene["textures"].shape[0] > 0


def sample_material_texels(scene: dict, atlas_id, uv):
    """The 12 atlas channels at uv (detached; uint8 texels)."""
    return sample_bilinear_quad(
        scene["mat_tex_quad"], scene["mat_tex_mip_hw"], atlas_id, uv, scene["mat_tex_row_off"]
    )


def normal_mapped(px, nrm, tan4, flags):
    """Shading normal from the atlas normal channels (TBN), or nrm where the
    material has no normal map."""
    has_nm = (flags & MAT_HAS_NORMAL_TEX) != 0
    tn = px[..., 5:8] * 2.0 - 1.0
    tangent = normalize(tan4[..., :3] - nrm * dot(tan4[..., :3], nrm))
    bitangent = cross(nrm, tangent) * tan4[..., 3:4]
    mapped = normalize(tn[..., 0:1] * tangent + tn[..., 1:2] * bitangent + tn[..., 2:3] * nrm)
    return torch.where(has_nm[..., None], mapped, nrm)


def reconstruct_surface(scene: dict, tri_id, u, v, view_dir=None, mip_level=None):
    """Shade-ready attributes at barycentrics (u, v) on tri_id: position,
    normal_g, normal_s, uv, albedo, roughness, metalness, emissive.  Missed
    rays (tri -1) return garbage the caller masks."""
    t = torch.clamp(tri_id, 0, scene["tri_pos"].shape[0] - 1).long()
    row = take_rows(scene["tri_geom"], t)
    v0, e1, e2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
    pos = v0 + u[..., None] * e1 + v[..., None] * e2
    nrm = normalize(bary_packed(row[..., 9:18], u, v, 3))
    uv = bary_packed(row[..., 18:24], u, v, 2)
    tan4 = bary_packed(row[..., 24:36], u, v, 4)
    mat = f32_int(row[..., 36])
    flags = f32_int(row[..., 37])
    atlas_id = f32_int(row[..., 38])

    ng = normalize(cross(e1, e2))
    ng = ng * torch.where(dot(ng, nrm) < 0.0, -1.0, 1.0)
    base = gather_rows(scene["mat_base_color"], mat)
    rough = gather_rows(scene["mat_roughness"], mat)
    metal = gather_rows(scene["mat_metallic"], mat)
    emissive = gather_rows(scene["mat_emissive"], mat)

    albedo = base[..., :3]
    if has_textures(scene):
        mip_ids = scene["mat_tex_mip_ids"]
        aid = atlas_id
        if mip_level is not None:
            lv = torch.clamp(mip_level, 0, mip_ids.shape[1] - 1)
            aid = mip_ids.reshape(-1)[aid * mip_ids.shape[1] + lv].long()
        px = sample_material_texels(scene, aid, uv)
        albedo = albedo * srgb_to_linear(px[..., 0:3])
        rough = rough * px[..., 3]
        metal = metal * px[..., 4]
        emissive = emissive * srgb_to_linear(px[..., 8:11])
        ns = normal_mapped(px, nrm, tan4, flags)
    else:
        ns = nrm

    if view_dir is not None:
        flip = torch.where(dot(ns, view_dir) < 0.0, -1.0, 1.0)
        ns = ns * flip
        ng = ng * flip

    return {
        "position": pos,
        "normal_g": ng,
        "normal_s": ns,
        "uv": uv,
        "albedo": albedo,
        "roughness": clip(rough, 0.02, 1.0),
        "metalness": clip(metal, 0.0, 1.0),
        "emissive": emissive,
    }


def reconstruct_surface_fast(scene: dict, tri_id, u, v, ray_o, ray_d, t):
    """Cheap surface reconstruction for secondary bounces
    (cfg.fast_bounce_shading): position from the ray equation, the shading
    normal interpolated and the geometric normal read from the `tri_fast`
    row, and the material from the texture-averaged `mat_avg_*` tables, with
    no texture fetch.  The keys of reconstruct_surface without uv."""
    tid = torch.clamp(tri_id, 0, scene["tri_pos"].shape[0] - 1).long()
    tcl = torch.clamp(t, 0.0, 1e30)
    pos = ray_o + tcl[..., None] * ray_d
    row = take_rows(scene["tri_fast"], tid)
    nrm = normalize(bary_packed(row[..., 0:9], u, v, 3))
    ng = row[..., 9:12]
    mat = f32_int(row[..., 12])
    flip = torch.where(dot(nrm, -ray_d) < 0.0, -1.0, 1.0)
    ns = nrm * flip
    ng = ng * torch.where(dot(ng, ns) < 0.0, -1.0, 1.0)
    return {
        "position": pos,
        "normal_g": ng,
        "normal_s": ns,
        **average_material(scene, mat),
    }


def average_material(scene: dict, mat):
    """albedo, roughness, metalness and emissive of materials `mat` (int64
    rows) from the texture-averaged tables, clamped as reconstruct_surface
    clamps them."""
    return {
        "albedo": gather_rows(scene["mat_avg_albedo"], mat),
        "roughness": clip(gather_rows(scene["mat_avg_rough"], mat), 0.02, 1.0),
        "metalness": clip(gather_rows(scene["mat_avg_metal"], mat), 0.0, 1.0),
        "emissive": gather_rows(scene["mat_avg_emissive"], mat),
    }
