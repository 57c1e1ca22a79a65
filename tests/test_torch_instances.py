"""Rigid instances that move (Renderer.update_instances) on the port, on the
CPU: the tangent frame turns with the instance.

  * transform_instances turns each tangent's xyz by its instance's
    rotation and keeps its handedness w, leaves the instances whose
    transform is the identity bit-equal, gives the correctly rounded
    vertices (summed in float64, rounded once) and JAX's positions and
    normals (rtol 1e-6 / atol 1e-6, tests/test_torch_refit.py's);
  * a normal-mapped frame after a turning update_instances against the
    reference tracer on a bake whose tangents are turned by hand (rtol 1e-3
    / atol 2e-4 on >= 99.9% of pixels, tests/test_torch_oracle.py's
    test_refit_frames_match_reference); the same frame against the bake
    with load-time tangents fails that hold;
  * after an update the rows of the instances that stayed keep every
    column of tri_geom and tri_fast bit for bit;
  * one update opens one "nebulae/refit" range and one upload sync,
    "nebulae/sync/transforms" (update_instances) or
    "nebulae/sync/geometry" (update_geometry), and advances the refit
    counters; a frame alone opens neither.
"""

import numpy as np
import pytest
import torch

from test_torch_oracle import _reference, hold
from test_torch_ref import one_torch_thread  # noqa: F401  (an autouse fixture)

W, H = 64, 48
TRACED = dict(width=W, height=H, spp=2, max_bounces=3, enable_svgf=False, enable_tonemap=False)


def _moves(fs, angle=0.5):
    """Every second instance but the ground plane (the last) turns `angle`
    about the vertical through the mean of its vertices and slides 0.05 of
    the scene's extent along x; the rest keep the identity."""
    n = int(fs.instance_of_tri.max()) + 1
    out = np.tile(np.eye(3, 4, dtype=np.float64), (n, 1, 1))
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    ext = float((fs.aabb_max - fs.aabb_min).max())
    for i in range(0, n - 1, 2):
        pivot = fs.tri_pos[fs.instance_of_tri == i].reshape(-1, 3).astype(np.float64).mean(0)
        out[i, :, :3] = rot
        out[i, :, 3] = pivot - rot @ pivot + np.array([0.05 * ext, 0.0, 0.0])
    return out.astype(np.float32)


def _baked(fs, m, turn_tangents=True):
    """fs with every triangle moved by hand by its instance's transform:
    positions, normals and (unless turn_tangents is False) the tangents'
    xyz, w kept."""
    import dataclasses

    from nebulae_tpu_torch.core.scene import face_normals

    t = m[fs.instance_of_tri].astype(np.float64)
    rot, shift = t[:, :, :3], t[:, :, 3]
    pos = (np.einsum("tij,tvj->tvi", rot, fs.tri_pos) + shift[:, None]).astype(np.float32)
    nrm = np.einsum("tij,tvj->tvi", rot, fs.tri_nrm).astype(np.float32)
    tan = fs.tri_tan.copy()
    if turn_tangents:
        tan[..., :3] = np.einsum("tij,tvj->tvi", rot, fs.tri_tan[..., :3])
    return dataclasses.replace(fs, tri_pos=pos, tri_nrm=nrm, tri_tan=tan, tri_face_nrm=face_normals(pos, nrm))


@pytest.fixture(scope="module")
def field():
    from nebulae_tpu_torch.config import SunLight
    from nebulae_tpu_torch.utils.testscenes import bench_camera, textured_scene

    fs = textured_scene(0)
    assert (fs.mat_flags[:-1] & 4).all()  # MAT_HAS_NORMAL_TEX on the tori's materials
    return {"fs": fs, "cam": bench_camera(fs), "sun": SunLight.default("cpu")}


def test_transform_instances_turns_the_tangent_frame(field):
    from nebulae_tpu.core.scene import transform_instances as jtransform

    from nebulae_tpu_torch.core.scene import transform_instances

    fs = field["fs"]
    m = _moves(fs)
    inst = fs.instance_of_tri
    pos, nrm, tan = transform_instances(torch.from_numpy(fs.tri_pos), torch.from_numpy(fs.tri_nrm),
                                        torch.from_numpy(fs.tri_tan), torch.from_numpy(inst), m)
    assert tan.shape == fs.tri_tan.shape and tan.dtype == torch.float32
    moving = np.isin(inst, np.nonzero((m != np.eye(3, 4, dtype=np.float32)).any((1, 2)))[0])
    assert 0 < moving.sum() < len(inst)
    want = np.einsum("tij,tvj->tvi", m[inst][:, :, :3].astype(np.float64), fs.tri_tan[..., :3])
    np.testing.assert_allclose(tan[..., :3].numpy(), want, rtol=1e-6, atol=1e-6)
    assert np.abs(tan[moving, :, :3].numpy() - fs.tri_tan[moving, :, :3]).max() > 0.1  # they turned
    np.testing.assert_array_equal(tan[..., 3].numpy(), fs.tri_tan[..., 3])  # handedness kept
    # The instances that stay keep their rows bit for bit.
    for got, base in ((pos, fs.tri_pos), (nrm, fs.tri_nrm), (tan, fs.tri_tan)):
        np.testing.assert_array_equal(got.numpy()[~moving].view(np.int32), base[~moving].view(np.int32))
    # Summed in float64 and rounded once: the correctly rounded vertices.
    np.testing.assert_array_equal(pos.numpy(), _baked(fs, m).tri_pos)
    jpos, jnrm = jtransform(fs.tri_pos, fs.tri_nrm, inst, m)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(nrm.numpy(), np.asarray(jnrm), rtol=1e-6, atol=1e-6)


def test_turned_normal_mapped_frame_matches_reference(field):
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer

    fs, cfg = field["fs"], RenderConfig(**TRACED)
    m = _moves(fs)
    r = Renderer(fs, cfg, device="cpu")
    before = r.render(field["cam"])["hdr"]
    r.update_instances(m)
    out = r.render(field["cam"])
    assert float((out["hdr"] - before).abs().max()) > 1e-3  # it moved
    s = {**field, "arrays": _baked(fs, m).device_arrays()}
    ref, gbuf = _reference(s, cfg, frame=1)
    hold(out, ref, gbuf, 1e-3, 2e-4, "textured field after a turning update_instances")
    # With the load-time tangents the turned tori shade otherwise: a frame
    # that kept them fails the same hold.
    stale, _ = _reference({**s, "arrays": _baked(fs, m, turn_tangents=False).device_arrays()}, cfg, frame=1)
    with pytest.raises(AssertionError):
        hold(out, stale, gbuf, 1e-3, 2e-4, "the same frame against the bake with load-time tangents")


def test_still_instances_keep_their_rows_bit_for_bit(field):
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer

    fs = field["fs"]
    m = _moves(fs)
    r = Renderer(fs, RenderConfig(**TRACED, tracer="bvh", bruteforce_max_tris=0), device="cpu")
    geom, fast = r.scene["tri_geom"].clone(), r.scene["tri_fast"].clone()
    r.update_instances(m)
    still = torch.from_numpy(~np.isin(fs.instance_of_tri, np.arange(0, int(fs.instance_of_tri.max()), 2)))
    assert 0 < int(still.sum()) < still.shape[0]
    for name, before in (("tri_geom", geom), ("tri_fast", fast)):
        after = r.scene[name]
        assert torch.equal(after[still].view(torch.int32), before[still].view(torch.int32)), name
        assert not torch.equal(after[~still], before[~still]), name
    np.testing.assert_array_equal(r.scene["tri_geom"][:, 24:36].numpy(), r.scene["tri_tan"].reshape(-1, 12).numpy())


@pytest.mark.parametrize("kind", ["instances", "geometry"])
def test_update_opens_one_refit_range_and_counts(field, kind):
    from torch.profiler import ProfilerActivity, profile

    from nebulae_tpu_torch.bvh.refit import compute_levels
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.dist.runner import DistRenderer
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.utils.metrics import totals

    assert DistRenderer.update_instances is Renderer.update_instances  # a rank follows the same path
    fs = field["fs"]
    r = Renderer(fs, RenderConfig(width=16, height=12, max_bounces=1, tracer="bvh", bruteforce_max_tris=0),
                 device="cpu")
    m = _moves(fs)

    def update():
        if kind == "instances":
            r.update_instances(m)
        else:
            r.update_geometry(_baked(fs, m).tri_pos)

    def names(fn):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
        return [e.name for e in prof.events()]

    update()  # the first call builds the refit's plan
    before = totals()
    seen = names(update)
    after = totals()
    sync = "nebulae/sync/transforms" if kind == "instances" else "nebulae/sync/geometry"
    assert seen.count("nebulae/refit") == 1 and seen.count(sync) == 1, sorted(set(seen))
    assert not any(n.startswith("nebulae/sync/") and n != sync for n in seen)
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in ("refit.calls", "refit.triangles", "refit.levels")}
    assert delta == {"refit.calls": 1, "refit.triangles": fs.num_triangles, "refit.levels": len(compute_levels(r.bvh))}
    frame = names(lambda: r.render(field["cam"]))
    assert "nebulae/pathtrace" in frame
    assert not {"nebulae/refit", "nebulae/sync/transforms", "nebulae/sync/geometry"} & set(frame)
    assert totals().get("refit.calls") == after["refit.calls"]
