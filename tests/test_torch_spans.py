"""The port's profiler ranges and counters (utils/profiling.py, utils/metrics.py).

  * `span` is one shared null context while no profiler records, a
    record_function while one does;
  * a small NRC frame and a train step under profile_trace show the walks'
    ranges ("nebulae/trace/*"), the a-trous passes, the cache's encoding
    and the compaction's sync;
  * the counters advance by H x W closest rays for the primary walk, with
    no more lanes walked than offered, and the app's counter rows (a stream
    beside its metrics rows) carry each frame's counts;
  * on a card (skipped without CUDA): no runtime sync of a small frame, NRC
    frame or step falls inside a "nebulae/" range outside a
    "nebulae/sync/<site>" one.

This file imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json

import pytest
import torch

W, H = 32, 24


def _scene(kind: str):
    from nebulae_tpu_torch.utils.testscenes import atrium_camera, bench_camera, small_atrium, textured_scene

    fs = small_atrium(0) if kind == "atrium" else textured_scene(0)
    return fs, atrium_camera(fs) if kind == "atrium" else bench_camera(fs)


def _step(renderer, cam, device):
    """One train step of the renderer's scene against a grey target."""
    from nebulae_tpu_torch.engine.renderer import init_frame_state
    from nebulae_tpu_torch.engine.train import Adam, make_train_step, split_scene_params
    from nebulae_tpu_torch.passes.gbuffer import make_camera_arrays

    cfg = renderer.cfg
    params, frozen = split_scene_params(renderer.scene)
    params["sun"] = renderer.sun
    step, opt = make_train_step(cfg, frozen, renderer.tables, optimizer=Adam(1e-2), device=device)
    cam_arrays = make_camera_arrays(cam, cfg.width, cfg.height, device)
    target = torch.full((cfg.height, cfg.width, 3), 0.3, device=device)
    out = step(params, opt.init(params), cam_arrays, init_frame_state(cfg, device), target)
    return float(out[3])


def _annotations(events) -> set:
    return {e["name"] for e in events if e.get("cat") == "user_annotation"}


def test_span_is_one_null_context_without_a_profiler():
    from torch.profiler import ProfilerActivity, profile, record_function

    from nebulae_tpu_torch.utils.profiling import span

    off = span("nebulae/a")
    assert off is span("nebulae/b") and isinstance(off, contextlib.nullcontext)
    with off, off:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(span("nebulae/c"), record_function)
    assert span("nebulae/d") is off


def test_nrc_frame_and_step_show_their_spans(tmp_path):
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.utils.profiling import TRACE_FILE, profile_trace

    fs, cam = _scene("atrium")
    nrc = Renderer(fs, RenderConfig(width=W, height=H, max_bounces=4, enable_nrc=True), device="cpu")
    plain = Renderer(fs, RenderConfig(width=W, height=H, max_bounces=4), device="cpu")
    with profile_trace(str(tmp_path / "frame")) as d:
        nrc.render(cam)
    frame = _annotations(json.loads((tmp_path / "frame" / TRACE_FILE).read_text())["traceEvents"])
    with profile_trace(str(tmp_path / "step")):
        _step(plain, cam, "cpu")
    step = _annotations(json.loads((tmp_path / "step" / TRACE_FILE).read_text())["traceEvents"])
    assert d == str(tmp_path / "frame")
    for names in (frame, step):
        assert {"nebulae/trace/closest", "nebulae/trace/combo", "nebulae/atrous", "nebulae/sync/compact",
                "nebulae/svgf", "nebulae/gbuffer"} <= names, sorted(names)
    assert {"nebulae/nrc_encode", "nebulae/nrc_mlp", "nebulae/nrc_train", "nebulae/nrc_query"} <= frame
    assert {"nebulae/backward", "nebulae/optimizer", "nebulae/sync/bincount", "nebulae/sync/pow_grad",
            "nebulae/pathtrace"} <= step


def test_counters_count_primary_rays_lanes_and_passes():
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.utils.metrics import totals

    fs, cam = _scene("field")
    cfg = RenderConfig(width=W, height=H, max_bounces=4)
    r = Renderer(fs, cfg, device="cpu")
    before = totals()
    r.render(cam)
    after = totals()

    def delta(k):
        return after.get(k, 0) - before.get(k, 0)

    assert delta("rays.closest") == H * W  # the primary walk alone casts closest rays
    assert delta("atrous.passes") == cfg.svgf_atrous_passes
    assert delta("atrous.pixels") == cfg.svgf_atrous_passes * H * W
    # One compaction a path vertex, each offered every pixel: the fused
    # shadow and bounce walks, then the last vertex's shadow rays.
    assert delta("lanes.full") == cfg.max_bounces * H * W
    assert 0 < delta("lanes.walked") <= delta("lanes.full")
    assert delta("rays.combo") + delta("rays.any") == delta("lanes.walked")


def test_app_rows_carry_the_frames_counts(tmp_path):
    from nebulae_tpu_torch import app
    from nebulae_tpu_torch.utils.testscenes import textured_scene, write_gltf

    scene = write_gltf(tmp_path / "field.glb", textured_scene(0))
    out = tmp_path / "run"
    assert app.main(["--scene", str(scene), "--device", "cpu", "--width", str(W), "--height", str(H),
                     "--frames", "2", "--bounces", "3", "--out", str(out), "--crash-dir", str(out / "crash")]) == 0
    rows = [json.loads(x) for x in (out / "metrics.counters.jsonl").read_text().splitlines()]
    assert len(rows) == 2
    # The metrics rows keep the JAX app's keys: the counters have their own stream.
    plain = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert not any(k.startswith(("lanes.", "rays.", "atrous.")) for r in plain for k in r)
    for i, row in enumerate(rows, start=1):
        # Counts accumulate across rows, as the metrics rows' "frames" does.
        assert row["step"] == i - 1
        assert row["rays.closest"] == i * H * W
        assert row["atrous.passes"] == i * 4 and row["atrous.pixels"] == i * 4 * H * W
        assert row["lanes.full"] == i * 3 * H * W and 0 < row["lanes.walked"] <= row["lanes.full"]
    assert rows[1]["lanes.walked"] > rows[0]["lanes.walked"]


def test_every_sync_on_the_card_is_named():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from benchmark.chrometrace import Trace, export_events
    from benchmark.program_spans import PROGRAM, SYNC, ranges_named, sync_starts
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.kernels.build import native

    native()
    fs, cam = _scene("atrium")
    kw = {"width": 128, "height": 96, "max_bounces": 4}
    plain = Renderer(fs, RenderConfig(**kw), device="cuda")
    nrc = Renderer(fs, RenderConfig(**kw, enable_nrc=True), device="cuda")
    moved = type(cam)(eye=cam.eye * 0.99, target=cam.target, fov_y_deg=cam.fov_y_deg)
    for r in (plain, nrc):  # the first frames, untraced, build what they build once
        r.render(cam)
    _step(plain, cam, "cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for r in (plain, nrc):
            r.render(cam)  # the history is kept
            r.render(moved)  # the history is reprojected
        _step(plain, cam, "cuda")
        torch.cuda.synchronize()
    tr = Trace(export_events(prof))
    program, named = ranges_named(tr, PROGRAM), ranges_named(tr, SYNC)
    starts = sync_starts(tr)
    assert any(t in named for t in starts)
    unnamed = [t for t in starts if t in program and t not in named]
    assert not unnamed, f"{len(unnamed)} syncs inside nebulae/ ranges outside nebulae/sync/ ones"
