"""A `frames` traffic with a `motion` block: the driver moves the scene's
instances every frame through Renderer.update_instances, and the reference
follows each compared frame with the instances moved by its own hand.

The runs here are the still cell on the moving traffic (`still-dynamic`),
held to the still cell's limits, at the small size.  The small scene has two
tori, so both move; and the slide's period is cut to the chain's 8 frames,
so that the frames the check follows from the fresh start carry one whole
stroke of it."""

import json
import time

import numpy as np
import pytest
import torch

from benchmark import harness, scenes
from benchmark.reference.frame import RefScene, move_instances
from benchmark.tests.conftest import ROOT, SMALL

MOTION = json.loads((ROOT / "benchmark" / "traffic" / "still-dynamic.json").read_text())["motion"]
TINY_FIELD = {"kind": "torus_field", "nx": 4, "nz": 4, "nu": 8, "nv": 6, "n_materials": 2, "map_size": 8}


def rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def slide(k):
    return MOTION["slide_amplitude"] * (1.0 - np.cos(2.0 * np.pi * k / MOTION["slide_period_frames"])) / 2.0


def test_still_instances_keep_the_identity():
    sc = scenes.build_scene(TINY_FIELD, 2**31 + 51)
    m = harness.Motion(MOTION, sc)
    # 16 tori and the ground plane, the last instance (16 = 1 mod 3).
    assert m.n == 17
    assert m.moving.tolist() == [0, 3, 6, 9, 12, 15]
    ident = np.concatenate([np.eye(3), np.zeros((3, 1))], 1)
    assert np.array_equal(m.at(0), np.broadcast_to(ident, (17, 3, 4)))
    for k in (1, 5, 13):
        t = m.at(k)
        still = [i for i in range(17) if i not in m.moving]
        assert np.array_equal(t[still], np.broadcast_to(ident, (len(still), 3, 4)))


def test_moving_instances_turn_about_their_vertex_mean_and_slide():
    sc = scenes.build_scene(TINY_FIELD, 2**31 + 52)
    m = harness.Motion(MOTION, sc)
    centre_x = 0.5 * (float(sc["aabb_min"][0]) + float(sc["aabb_max"][0]))
    assert slide(12) == pytest.approx(0.3) and slide(24) == pytest.approx(0.0, abs=1e-12)
    for i in m.moving:
        verts = sc["tri_pos"][sc["instance_of_tri"] == i].reshape(-1, 3).astype(np.float64)
        pivot = verts.mean(0)
        toward = np.array([-np.sign(pivot[0] - centre_x), 0.0, 0.0])
        for k in (1, 7, 12, 30):
            t = m.at(k)[i].astype(np.float64)
            np.testing.assert_allclose(t[:, :3], rot_y(0.5 * k), atol=1e-6)
            # The pivot keeps its place but for the slide toward the centre.
            np.testing.assert_allclose(t[:, :3] @ pivot + t[:, 3], pivot + slide(k) * toward, atol=2e-6)
            moved = verts @ rot_y(0.5 * k).T + (pivot - rot_y(0.5 * k) @ pivot + slide(k) * toward)
            np.testing.assert_allclose(verts @ t[:, :3].T + t[:, 3], moved, atol=5e-6)


def test_moved_vertices_stay_inside_the_build_box():
    # The cell's own scene: update_geometry keeps the build-time box.
    conf = json.loads((ROOT / "benchmark" / "configs" / "sponza247k-pt4.json").read_text())
    sc = scenes.build_scene(conf["scene"], 2**31 + 53)
    m = harness.Motion(MOTION, sc)
    lo, hi = sc["aabb_min"], sc["aabb_max"]
    for k in range(0, 48, 3):
        pos = move_instances(sc, m.at(k))["tri_pos"].reshape(-1, 3)
        assert (pos >= lo).all() and (pos <= hi).all(), k
    # At any angle: the turn keeps each vertex on its circle about the
    # vertical through the pivot, and the slide adds at most 0.3 along x.
    for i, p in zip(m.moving, m.pivot):
        v = sc["tri_pos"][sc["instance_of_tri"] == i].reshape(-1, 3).astype(np.float64)
        rho = np.sqrt(((v[:, [0, 2]] - p[[0, 2]]) ** 2).sum(-1)).max()
        assert lo[0] <= p[0] - rho - MOTION["slide_amplitude"] and p[0] + rho + MOTION["slide_amplitude"] <= hi[0]
        assert lo[2] <= p[2] - rho and p[2] + rho <= hi[2]


def small_moving(spin: float) -> dict:
    over = json.loads(json.dumps(SMALL["pt4-still"]))
    over["traffic"]["motion"] = {**MOTION, "every": 1, "slide_period_frames": over["traffic"]["check"]["chain_frames"],
                                 "spin_rad_per_frame": spin}
    return over


def moving_bench(bench) -> dict:
    """The still cell on the moving traffic, under the still cell's limits."""
    return {**bench, "workloads": [{**w, "traffic": "still-dynamic"} if w["name"] == "pt4-still" else w
                                   for w in bench["workloads"]]}


def frames_of(bench, traffic: str, spin: float, seed: int):
    if traffic == "still":
        b, over = bench, SMALL["pt4-still"]
    else:
        b, over = moving_bench(bench), small_moving(spin)
    p = harness.prepare(b, "pt4-still", seed, torch.device("cpu"), over)
    return p, harness.Frames(p["prog"], p["traffic"], p["sc"], seed, torch.device("cpu"))


@pytest.mark.parametrize("traffic", ["still", "still-dynamic"])
def test_driver_moves_the_instances_before_each_render(bench, monkeypatch, traffic):
    from nebulae_tpu_torch.engine.renderer import Renderer

    calls = []
    update, render = Renderer.update_instances, Renderer.render

    def spy_update(self, transforms):
        calls.append(("update", np.array(transforms)))
        return update(self, transforms)

    def spy_render(self, camera, sun=None):
        calls.append(("render", None))
        return render(self, camera, sun)

    monkeypatch.setattr(Renderer, "update_instances", spy_update)
    monkeypatch.setattr(Renderer, "render", spy_render)
    _p, frames = frames_of(bench, traffic, MOTION["spin_rad_per_frame"], 2**31 + 54)
    for _ in range(3):
        frames.one()
    if traffic == "still":
        assert frames.motion is None
        assert [c[0] for c in calls] == ["render"] * 3
        return
    assert [c[0] for c in calls] == ["update", "render"] * 3
    for k in range(3):
        assert np.array_equal(calls[2 * k][1], frames.motion.at(k))


def test_program_rows_equal_the_reference_moved_scene(bench):
    p, frames = frames_of(bench, "still-dynamic", MOTION["spin_rad_per_frame"], 2**31 + 55)
    for _ in range(4):
        frames.one()
    scene = frames.prog.renderer.scene
    S = RefScene(p["sc"], p["sun"], "cpu").moved(frames.motion.at(3))
    moved = move_instances(p["sc"], frames.motion.at(3))
    torch.testing.assert_close(scene["tri_pos"], torch.as_tensor(moved["tri_pos"]), rtol=0, atol=1e-6)
    torch.testing.assert_close(scene["tri_geom"][:, 0:9], torch.cat([S.v0, S.e1, S.e2], 1), rtol=0, atol=1e-6)
    torch.testing.assert_close(scene["tri_geom"][:, 9:18], S.nrm.reshape(-1, 9), rtol=0, atol=1e-6)


def run(bench, spin, seed):
    return harness.run_cell(moving_bench(bench), "pt4-still", seed, 0.5, False, "cpu", time.perf_counter(),
                            overrides=small_moving(spin), log=lambda line: None)


def test_sliding_run_is_correct(bench):
    out = run(bench, 0.0, 2**31 + 56)
    assert out["result"]["correct"], out["checks"]
    assert out["result"]["failed"] == 0
    assert out["diagnostics"]["tiles"] == 5 + MOTION["tiles"]


@pytest.mark.xfail(strict=True, raises=AssertionError,
                   reason="the port keeps load-time tangents after a turn: Renderer._build_refit "
                   "(engine/renderer.py) rewrites tri_geom's columns 0:18 but not the tangents' 24:36, and "
                   "transform_instances (core/scene.py) turns positions and normals only, so normal-mapped "
                   "surfaces shade with stale tangents")
def test_turning_run_is_correct(bench):
    out = run(bench, MOTION["spin_rad_per_frame"], 2**31 + 56)
    assert out["result"]["correct"], out["checks"]


def frozen_scene(monkeypatch):
    """The instances never move: update_instances does nothing."""
    from nebulae_tpu_torch.engine.renderer import Renderer

    monkeypatch.setattr(Renderer, "update_instances", lambda self, transforms: None)


def stale_bounds(monkeypatch):
    """The triangles rewritten, the BVH's bounds left at the build pose."""
    import nebulae_tpu_torch.engine.renderer as r

    for name in ("repack_fat4_bounds", "repack_fat_bounds", "repack_node_bounds"):
        monkeypatch.setattr(r, name, lambda *args: None)


@pytest.mark.parametrize("fault", [frozen_scene, stale_bounds])
def test_moving_fault_is_not_correct(bench, monkeypatch, fault):
    fault(monkeypatch)
    out = run(bench, 0.0, 2**31 + 57)
    assert not out["result"]["correct"], out["checks"]


def test_steps_traffic_refuses_motion():
    with pytest.raises(ValueError, match="motion"):
        harness.run_steps(None, {"kind": "steps", "motion": MOTION}, None, None, None, 0, 1.0, False, None, None,
                          0.0)
