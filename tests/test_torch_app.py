"""The app shell of the port on the CPU, against the JAX package where both have it.

  * OrbitCamera against JAX's; logging, metrics (JSONL rows), golden dumps,
    crash dumps and the heartbeat, FrameWriter (the same PNG pixels as
    JAX's writer), PreviewServer over localhost, FrameTimer, RaysPerSecond
    and profile_trace, mirroring tests/test_utils.py;
  * checkpoints: a round trip of the frame state with the radiance cache
    (its parameter lists and Adam's {count, mu, nu}), and the errors on a
    structure, shape or dtype that differs from the target;
  * the CLI (`python -m nebulae_tpu_torch.app --device cpu`) on a glTF the
    test writes: frames, metrics.jsonl and the heartbeat, --accumulate,
    the control file and apply_controls, resume bit for bit with the cache
    off and on, the dist flags running (2 processes, --mesh, a lone
    --coordinator), and --device left to default raising without CUDA;
  * the port's app against JAX's app.main on one written glTF at 32x32, 2
    frames, 8 bounces, SVGF and ACES, an orbiting camera: the frames'
    sRGB bytes within 1 on >= 99% of pixels and a mean difference below
    0.25 (test_torch_frame.py's rtol 1e-3 / atol 1e-4 on ldr moves an sRGB
    byte by at most 0.33 before rounding).  The one JAX compile here.
"""

import io
import json
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _crash_hook_removed():
    """app.main installs its crash hook (excepthook, faulthandler's log file,
    the state provider) on this process: take it down after each test, as
    JAX's app leaves its own in place too."""
    hook = sys.excepthook
    yield
    from nebulae_tpu_torch.utils import crashdump

    crashdump.uninstall()
    sys.excepthook = hook
    jax_crashdump = sys.modules.get("nebulae_tpu.utils.crashdump")
    if jax_crashdump is not None:
        jax_crashdump._state_provider = None


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    from nebulae_tpu_torch.utils.testscenes import textured_scene, write_gltf

    return write_gltf(tmp_path_factory.mktemp("app") / "field.glb", textured_scene(0))


def _argv(scene_file, out, *extra):
    return ["--scene", str(scene_file), "--device", "cpu", "--width", "32", "--height", "32",
            "--out", str(out), "--crash-dir", str(out / "crash"), *extra]


def _run(scene_file, out, *extra):
    from nebulae_tpu_torch import app

    assert app.main(_argv(scene_file, out, *extra)) == 0
    return sorted(out.glob("frame_*.png"))


def _pixels(paths):
    from nebulae_tpu_torch.utils.png import read_png

    return [read_png(p) for p in paths]


# ---------------------------------------------------------------------------
# Cameras and utilities
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pose", [(3.0, 0.0, 90.0), (5.5, 20.0, 45.0), (0.7, -35.0, 200.0)])
def test_orbit_camera_matches_jax(pose):
    from nebulae_tpu.core.camera import OrbitCamera as JOrbit

    from nebulae_tpu_torch.core.camera import OrbitCamera

    target = np.float32([0.5, -0.2, 1.0])
    p, j = (cls(distance=pose[0], pitch_deg=pose[1], yaw_deg=pose[2], target=target) for cls in (OrbitCamera, JOrbit))
    for step in range(4):
        np.testing.assert_array_equal(p.eye(), j.eye())
        pc, jc = p.camera(), j.camera()
        np.testing.assert_array_equal(pc.eye, jc.eye)
        np.testing.assert_array_equal(pc.view_matrix(), jc.view_matrix())
        for c in (p, j):
            c.rotate(7.5, 40.0 * (step - 1))
            c.zoom(1.3)
        assert (p.yaw_deg, p.pitch_deg, p.distance) == (j.yaw_deg, j.pitch_deg, j.distance)


def test_logging_metrics_and_timers(tmp_path, capsys):
    from nebulae_tpu.utils.metrics import MetricsLogger as JMetrics

    from nebulae_tpu_torch.utils.logging import log_error, log_info, log_warn, neb_assert
    from nebulae_tpu_torch.utils.metrics import MetricsLogger
    from nebulae_tpu_torch.utils.profiling import FrameTimer, RaysPerSecond

    log_info("hello")
    log_warn("careful")
    log_error("bad")
    err = capsys.readouterr().err
    assert "INFO ] hello" in err and "WARN ] careful" in err and "ERROR] bad" in err
    neb_assert(True, "fine")
    with pytest.raises(AssertionError, match="boom"):
        neb_assert(False, "boom")
    rows = {}
    for name, cls in (("port", MetricsLogger), ("jax", JMetrics)):
        m = cls(tmp_path / name / "m.jsonl")
        for i in range(3):
            m.scalar("frame_ms", 10.0 + i)
            m.scalar("nrc_loss", np.float32(0.5))
            m.count("frames")
            m.flush(step=i)
        m.scalar("x", 1)
        m.flush()
        rows[name] = [json.loads(x) for x in (tmp_path / name / "m.jsonl").read_text().splitlines()]
    for a, b in zip(rows["port"], rows["jax"], strict=True):
        a.pop("time"), b.pop("time")
        assert a == b
    assert MetricsLogger(None).flush(step=1)["step"] == 1
    r = RaysPerSecond()
    r.add(1_000_000, 0.5)
    assert abs(r.mrays_s - 2.0) < 1e-6
    t = FrameTimer()
    t.last -= 1.5
    assert t.tick() >= 1.5 and t.frames == 0 and t.fps > 0 and "frametime" in capsys.readouterr().err


def test_golden_roundtrip_with_tensors(tmp_path):
    from nebulae_tpu.utils.golden import load_golden as jload

    from nebulae_tpu_torch.utils.golden import compare_golden, dump_golden, load_golden
    from nebulae_tpu_torch.utils.testscenes import textured_scene

    tree = {"scene": textured_scene(0).device_arrays(), "t": {"x": torch.arange(6.0).reshape(2, 3)}}
    p = tmp_path / "g.npz"
    dump_golden(p, tree)
    assert compare_golden(p, tree) == []
    assert set(load_golden(p)) == set(jload(p))
    np.testing.assert_array_equal(load_golden(p)["t/x"], np.arange(6.0).reshape(2, 3))
    bad = {"scene": dict(tree["scene"]), "t": {"x": tree["t"]["x"] + 1}}
    bad["scene"]["mat_base_color"] = tree["scene"]["mat_base_color"] + 0.5
    del bad["scene"]["tri_pos"]
    problems = compare_golden(p, bad)
    assert any("mat_base_color" in x for x in problems) and any("t/x" in x for x in problems)
    assert "missing key scene/tri_pos" in problems


def test_crashdump_and_heartbeat(tmp_path, monkeypatch):
    from nebulae_tpu_torch.utils import crashdump
    from nebulae_tpu_torch.utils.crashdump import Heartbeat

    monkeypatch.setenv("NEBULAE_TEST", "1")
    monkeypatch.setenv("TORCH_TEST", "2")
    monkeypatch.setenv("JAX_UNRELATED", "3")
    state = {"frame": 7, "reset_history": False, "svgf": {"radiance": torch.ones(2, 3)},
             "nrc": {"params": [{"w": torch.zeros(2, 2), "b": torch.zeros(2)}]}}
    old_hook = sys.excepthook
    try:
        crashdump.install(state_provider=lambda: state, dump_dir=tmp_path / "crash")
        assert sys.excepthook is crashdump._excepthook
        try:
            raise RuntimeError("boom")
        except RuntimeError:
            sys.excepthook(*sys.exc_info())
    finally:
        crashdump.uninstall()
        sys.excepthook = old_hook
    assert crashdump._state_provider is None and crashdump._fault_log is None
    assert crashdump._DUMP_DIR == crashdump._DEFAULT_DUMP_DIR
    meta = json.loads(sorted((tmp_path / "crash").glob("crash_*.json"))[-1].read_text())
    assert meta["reason"] == "RuntimeError" and "boom" in meta["detail"]
    assert meta["env"].get("NEBULAE_TEST") == "1" and meta["env"].get("TORCH_TEST") == "2"
    assert "JAX_UNRELATED" not in meta["env"]
    snap = np.load(sorted((tmp_path / "crash").glob("state_*.npz"))[-1])
    assert int(snap["frame"]) == 7 and snap["svgf/radiance"].shape == (2, 3) and "nrc/params/0/w" in snap

    hb = Heartbeat(tmp_path / "hb", stale_after_s=0.05)
    assert hb.is_stale()
    hb.touch()
    assert not hb.is_stale()
    time.sleep(0.06)
    assert hb.is_stale()


def test_frame_writer_matches_jax(tmp_path):
    """The port's writer on CPU tensors and numpy gives JAX's sRGB bytes
    (JAX writes them with PIL); the heat map equals JAX's."""
    from nebulae_tpu.utils.display import FrameWriter as JWriter
    from nebulae_tpu.utils.display import colorize_map as jcolor
    from nebulae_tpu.utils.display import ldr_to_srgb_u8 as jsrgb

    from nebulae_tpu_torch.utils.display import FrameWriter, colorize_map, ldr_to_srgb_u8

    rng = np.random.default_rng(0)
    frames = [rng.uniform(-0.1, 1.1, (16, 24, 3)).astype(np.float32) for _ in range(3)]
    np.testing.assert_array_equal(ldr_to_srgb_u8(torch.from_numpy(frames[0])), jsrgb(frames[0]))
    w, jw = FrameWriter(tmp_path / "p"), JWriter(tmp_path / "j")
    for i, f in enumerate(frames):
        w.present(torch.from_numpy(f) if i % 2 else f)
        jw.present(f)
    w.flush()
    jw.flush()
    got = _pixels(sorted((tmp_path / "p").glob("frame_*.png")))
    want = _pixels(sorted((tmp_path / "j").glob("frame_*.png")))
    assert len(got) == 3
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
    npy = FrameWriter(tmp_path / "n", fmt="npy")
    npy.present(frames[0])
    npy.flush()
    np.testing.assert_array_equal(np.load(tmp_path / "n" / "frame_00000.npy"), jsrgb(frames[0]))
    heat = rng.uniform(-1, 5, (9, 7)).astype(np.float32)
    np.testing.assert_array_equal(colorize_map(torch.from_numpy(heat)), jcolor(heat))


def test_preview_server_serves_latest_frame():
    from PIL import Image

    from nebulae_tpu_torch.utils.display import PreviewServer, ldr_to_srgb_u8

    srv = PreviewServer(port=0)
    try:
        url = f"http://127.0.0.1:{srv.port}"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{url}/frame.png", timeout=10)
        img = np.zeros((8, 8, 3), np.float32)
        img[:, :4] = [1.0, 0.0, 0.0]
        srv.update(torch.from_numpy(img))
        assert b"frame.png" in urllib.request.urlopen(f"{url}/", timeout=10).read()
        raw = urllib.request.urlopen(f"{url}/frame.png", timeout=10).read()
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(raw))), ldr_to_srgb_u8(img))
        srv.update(np.full((4, 4, 3), 200, np.uint8))
        raw = urllib.request.urlopen(f"{url}/frame.png", timeout=10).read()
        assert np.asarray(Image.open(io.BytesIO(raw))).shape == (4, 4, 3)
    finally:
        srv.close()


def test_profile_trace_on_cpu(tmp_path):
    from nebulae_tpu_torch.utils.profiling import pass_annotation, profile_trace

    with profile_trace(str(tmp_path / "trace")) as d:
        with pass_annotation("nebulae/test_pass"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    events = json.loads((Path(d) / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "nebulae/test_pass" for e in events)
    assert any("mm" in e.get("name", "") for e in events)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_and_mismatch(tmp_path):
    import dataclasses

    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer, init_frame_state
    from nebulae_tpu_torch.utils.checkpoint import latest_step_dir, load_checkpoint, save_checkpoint
    from nebulae_tpu_torch.utils.testscenes import bench_camera, textured_scene

    fs = textured_scene(0)
    cfg = RenderConfig(width=16, height=16, max_bounces=2, enable_nrc=True)
    r = Renderer(fs, cfg, device="cpu")
    r.render(bench_camera(fs))
    state = r.state
    assert state["nrc"]["opt_state"]["count"] > 0 and state["frame"] == 1
    assert latest_step_dir(tmp_path / "ck") is None
    for step in (3, 7):
        d = save_checkpoint(tmp_path / "ck", state, step=step)
    assert d.endswith("step_00000007") and latest_step_dir(tmp_path / "ck") == d
    like = init_frame_state(cfg, "cpu")
    restored = load_checkpoint(d, like)
    assert restored["frame"] == 1 and restored["reset_history"] is False
    assert restored["nrc"]["opt_state"]["count"] == state["nrc"]["opt_state"]["count"]

    def leaves(x, path=""):
        if isinstance(x, dict):
            return [y for k in sorted(x) for y in leaves(x[k], f"{path}/{k}")]
        if isinstance(x, list):
            return [y for i, v in enumerate(x) for y in leaves(v, f"{path}/{i}")]
        return [(path, x)]

    a, b = leaves(state), leaves(restored)
    assert [p for p, _ in a] == [p for p, _ in b] and len(a) > 30
    for (p, x), (_, y) in zip(a, b, strict=True):
        if isinstance(x, torch.Tensor):
            assert y.dtype == x.dtype and y.device == torch.device("cpu")
            torch.testing.assert_close(y, x, rtol=0, atol=0, msg=p)
        else:
            assert type(x) is type(y) and x == y, p
    small = init_frame_state(dataclasses.replace(cfg, width=8), "cpu")
    with pytest.raises(ValueError, match="svgf"):
        load_checkpoint(d, small)
    with pytest.raises(ValueError, match="keys"):
        load_checkpoint(d, init_frame_state(dataclasses.replace(cfg, enable_nrc=False), "cpu"))
    wrong = init_frame_state(cfg, "cpu")
    wrong["nrc"]["params"][0]["w"] = wrong["nrc"]["params"][0]["w"].double()
    with pytest.raises(ValueError, match="float64"):
        load_checkpoint(d, wrong)
    wrong = init_frame_state(cfg, "cpu")
    wrong["frame"] = 0.0
    with pytest.raises(ValueError, match="frame"):
        load_checkpoint(d, wrong)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_app_cli_smoke(tmp_path, scene_file):
    """python -m nebulae_tpu_torch.app on the CPU: frames, the JSONL metrics
    with frame_ms per frame, and the heartbeat."""
    out = tmp_path / "frames"
    res = subprocess.run([sys.executable, "-m", "nebulae_tpu_torch.app", "--scene", str(scene_file), "--device",
                          "cpu", "--width", "32", "--height", "32", "--frames", "2", "--bounces", "2", "--out",
                          str(out), "--no-svgf", "--crash-dir", str(tmp_path / "crash"), "--orbit-speed", "5"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "wrote 2 frames" in res.stderr
    assert len(list(out.glob("frame_*.png"))) == 2
    rows = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == 2 and all("frame_ms" in r for r in rows) and rows[-1]["frames"] == 2
    assert (out / "heartbeat").exists()
    assert (tmp_path / "crash" / "faulthandler.log").exists()


def test_app_accumulate_nrc_envmap_and_animate(tmp_path, scene_file):
    """--accumulate writes one still; the cache's metrics stream with
    --nrc; --envmap (procedural and an image file) and --animate run."""
    from nebulae_tpu_torch.utils.png import write_png

    assert len(_run(scene_file, tmp_path / "still", "--frames", "3", "--bounces", "2", "--accumulate")) == 1
    _run(scene_file, tmp_path / "nrc", "--frames", "2", "--bounces", "3", "--nrc", "--metrics",
         str(tmp_path / "m.jsonl"))
    rows = [json.loads(x) for x in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert all(r["nrc_loss"] > 0 and 0 <= r["nrc_query_frac"] <= 1 for r in rows)
    sky = np.zeros((8, 16, 3), np.uint8)
    sky[:4] = (40, 90, 200)
    write_png(tmp_path / "sky.png", sky)
    for env in ("procedural", str(tmp_path / "sky.png")):
        assert len(_run(scene_file, tmp_path / f"env{len(env)}", "--frames", "1", "--bounces", "2",
                        "--envmap", env)) == 1
    frames = _pixels(_run(scene_file, tmp_path / "anim", "--frames", "2", "--bounces", "2", "--animate", "0.1",
                          "--metrics", "off"))
    assert not (tmp_path / "anim" / "metrics.jsonl").exists() and len(frames) == 2


def test_runtime_controls(tmp_path, scene_file):
    """apply_controls: sun and sky values replace the sun's tensors and
    change the next frame; the other knobs go through update_config; a
    resolution change goes through resize; the control file applies them
    in the loop."""
    import dataclasses

    from nebulae_tpu_torch.app import apply_controls
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.core.scene import load_scene
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.utils.testscenes import bench_camera

    fs = load_scene(scene_file).flat
    cam = bench_camera(fs)
    r = Renderer(fs, RenderConfig(width=32, height=32, max_bounces=2, enable_svgf=False, enable_tonemap=False),
                 device="cpu")
    img0 = r.render(cam)["hdr"].numpy()
    apply_controls(r, {"sun_radiance": [0.0, 0.0, 0.0], "sky_color": [1.0, 0.0, 0.0], "sun_dir": [0, 1, 0],
                       "sun_angle_deg": 2.0})
    assert r.sun.radiance.abs().max() == 0 and float(r.sun.direction[1]) == 1.0
    img1 = r.render(cam)["hdr"].numpy()
    assert np.abs(img1 - img0).max() > 0.05
    apply_controls(r, {"bounces": 1, "spp": 2, "nrc": True, "svgf_alpha": 0.5})
    assert (r.cfg.max_bounces, r.cfg.spp, r.cfg.enable_nrc, r.cfg.svgf_temporal_alpha) == (1, 2, True, 0.5)
    assert "nrc" in r.state and np.isfinite(r.render(cam)["hdr"].numpy()).all()
    with pytest.raises(ValueError):
        r.update_config(dataclasses.replace(r.cfg, width=64))
    r.resize(48, 24)
    assert r.render(cam)["hdr"].shape == (24, 48, 3)

    ctl = tmp_path / "ctl.json"
    ctl.write_text(json.dumps({"sky_color": [0.0, 0.0, 0.0], "sun_radiance": [0, 0, 0], "bounces": 1}))
    dark = _pixels(_run(scene_file, tmp_path / "ctl", "--frames", "1", "--control-file", str(ctl), "--no-svgf"))
    lit = _pixels(_run(scene_file, tmp_path / "lit", "--frames", "1", "--no-svgf", "--bounces", "1"))
    assert dark[0][..., :3].max() < lit[0][..., :3].max()


@pytest.mark.parametrize("nrc", [False, True])
def test_resume_is_bit_consistent(tmp_path, scene_file, nrc):
    """6 frames with a checkpoint after 3, then 3 frames resumed from it:
    the resumed frames equal frames 4-6 byte for byte, and the final
    states are equal."""
    from nebulae_tpu_torch import app
    from nebulae_tpu_torch.utils.checkpoint import load_checkpoint

    extra = ["--bounces", "3"] + (["--nrc"] if nrc else [])
    ck = tmp_path / "ck"
    a = app.run(_argv(scene_file, tmp_path / "a", "--frames", "6", "--checkpoint-dir", str(ck),
                      "--checkpoint-every", "3", *extra))
    b = app.run(_argv(scene_file, tmp_path / "b", "--frames", "3", "--resume", str(ck / "step_00000003"), *extra))
    full = _pixels(sorted((tmp_path / "a").glob("frame_*.png")))
    resumed = _pixels(sorted((tmp_path / "b").glob("frame_*.png")))
    assert sorted(p.name for p in ck.iterdir()) == ["step_00000003", "step_00000006"]
    assert len(full) == 6 and len(resumed) == 3
    for i in range(3):
        np.testing.assert_array_equal(resumed[i], full[3 + i], err_msg=f"frame {i}")
    assert a.state["frame"] == b.state["frame"] == 6
    final = load_checkpoint(ck / "step_00000006", b.state)
    torch.testing.assert_close(final["svgf"]["radiance"], b.state["svgf"]["radiance"], rtol=0, atol=0)
    if nrc:
        assert b.state["nrc"]["opt_state"]["count"] == a.state["nrc"]["opt_state"]["count"] > 0
        for x, y in zip(a.state["nrc"]["ema_params"], b.state["nrc"]["ema_params"], strict=True):
            torch.testing.assert_close(x["w"], y["w"], rtol=0, atol=0)


def test_processes_without_a_process_id_raise(tmp_path, scene_file):
    """--num-processes above 1 without --process-id raises before any
    process meets its peers (every one would otherwise take rank 0)."""
    from nebulae_tpu_torch import app

    with pytest.raises(ValueError, match="needs --process-id"):
        app.run(_argv(scene_file, tmp_path / "run", "--frames", "1", "--num-processes", "2",
                      "--coordinator", "127.0.0.1:1"))


@pytest.mark.parametrize("flags", [["--num-processes", "2", "--process-id", "0"], ["--mesh"],
                                   ["--coordinator", "localhost:1234"]])
def test_dist_flags_run(tmp_path, scene_file, flags):
    """Each dist flag set runs and gives the plain run's frame byte for
    byte: 2 processes (this one rank 0, a subprocess rank 1, meeting at a
    port picked just before the launch), --mesh as a world of one through
    DistRenderer, and a lone --coordinator on the single path, as in JAX's
    app (nebulae_tpu/app.py:166)."""
    import socket

    from nebulae_tpu_torch import app

    extra = ["--frames", "1", "--bounces", "2"]
    plain = _pixels(_run(scene_file, tmp_path / "plain", *extra))
    peer = None
    if "--num-processes" in flags:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        flags = flags + ["--coordinator", f"127.0.0.1:{port}"]
        argv = _argv(scene_file, tmp_path / "run", *extra, *flags)
        argv[argv.index("--process-id") + 1] = "1"
        peer = subprocess.Popen([sys.executable, "-m", "nebulae_tpu_torch.app", *argv], cwd=REPO,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        r = app.run(_argv(scene_file, tmp_path / "run", *extra, *flags))
    finally:
        if peer is not None:
            out = peer.communicate(timeout=120)[0]
    if peer is not None:
        assert peer.returncode == 0, out
        assert (tmp_path / "run" / "metrics.r1.jsonl").exists() and (tmp_path / "run" / "heartbeat.r1").exists()
    assert type(r).__name__ == ("Renderer" if flags[0] == "--coordinator" else "DistRenderer")
    np.testing.assert_array_equal(_pixels(sorted((tmp_path / "run").glob("frame_*.png")))[0], plain[0])


def test_app_needs_cuda_unless_cpu_is_asked_for(tmp_path, scene_file):
    from nebulae_tpu_torch import app

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        app.main(["--scene", str(scene_file), "--out", str(tmp_path), "--frames", "1"])


def test_app_matches_jax(tmp_path, scene_file):
    """The port's app and JAX's app.main on one glTF, 32x32, 2 frames, 8
    bounces, SVGF, ACES and an orbiting camera."""
    from nebulae_tpu import app as japp

    kw = ["--scene", str(scene_file), "--width", "32", "--height", "32", "--frames", "2", "--orbit-speed", "3"]
    assert japp.main(kw + ["--out", str(tmp_path / "j"), "--crash-dir", str(tmp_path / "jc")]) == 0
    port = _pixels(_run(scene_file, tmp_path / "p", "--frames", "2", "--orbit-speed", "3"))
    jax_ = _pixels(sorted((tmp_path / "j").glob("frame_*.png")))
    assert len(port) == len(jax_) == 2
    for p, j in zip(port, jax_, strict=True):
        d = np.abs(p.astype(np.int32) - j.astype(np.int32)).max(-1)
        assert (d <= 1).mean() >= 0.99 and d.mean() < 0.25, (d.max(), (d <= 1).mean(), d.mean())
        assert p[..., :3].std() > 1.0
    rows = [json.loads(x) for x in (tmp_path / "p" / "metrics.jsonl").read_text().splitlines()]
    jrows = [json.loads(x) for x in (tmp_path / "j" / "metrics.jsonl").read_text().splitlines()]
    assert [sorted(r) for r in rows] == [sorted(r) for r in jrows]
