"""The app's multi-process paths (`python -m nebulae_tpu_torch.app
--num-processes N --process-id R --coordinator host:port --device cpu`), on
the CPU over gloo, against the one-process app.

Every process runs on one thread under a 120 s timeout and meets its
peers at a port picked just before the launch.  The PNG files are compared byte for byte:
the sharded frame equals the one-process frame pixel for pixel
(tests/test_torch_dist.py), and rank 0 writes the image gathered from
every rank.
  * 2 and 4 processes, an orbiting camera (SVGF reprojection): frames,
    metrics.jsonl and heartbeat from rank 0, metrics.rR.jsonl and
    heartbeat.rR from the others;
  * --accumulate: the HDR sum gathered before the one tonemap;
  * a control file read by rank 0 and applied on every rank;
  * a 2-process --nrc run killed after its checkpoint lands and resumed
    gives the uninterrupted run's frames (as tests/test_multiprocess.py:
    125-233);
  * a height that does not divide over the processes raises on every rank.
"""

import json
import os
import socket
import sys
import time
from pathlib import Path

import pytest

from nebulae_tpu_torch.dist.dryrun import join, start

TIMEOUT = 120


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    from nebulae_tpu_torch.utils.testscenes import textured_scene, write_gltf

    return write_gltf(tmp_path_factory.mktemp("dist_app") / "field.glb", textured_scene(0))


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(scene_file, out: Path, n: int, *extra) -> list:
    """The app as n processes (a plain one when n == 1)."""
    cmd = [sys.executable, "-m", "nebulae_tpu_torch.app", "--scene", str(scene_file), "--device", "cpu",
           "--width", "32", "--height", "32", "--bounces", "4", "--out", str(out),
           "--crash-dir", str(out / "crash"), *extra]
    port = _port()
    ranks = [[]] if n == 1 else [["--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
                                  "--process-id", str(r)] for r in range(n)]
    return start([cmd + r for r in ranks], {**os.environ, "OMP_NUM_THREADS": "1"})


def _frames(out: Path) -> list:
    return [p.read_bytes() for p in sorted(out.glob("frame_*.png"))]


@pytest.mark.parametrize("n", [2, 4])
def test_multi_process_app_equals_one_process(tmp_path, scene_file, n):
    extra = ("--frames", "3", "--orbit-speed", "3")
    join(_launch(scene_file, tmp_path / "one", 1, *extra) + _launch(scene_file, tmp_path / "many", n, *extra),
         TIMEOUT)
    one, many = _frames(tmp_path / "one"), _frames(tmp_path / "many")
    assert len(one) == 3 and many == one
    out = tmp_path / "many"
    assert len((out / "metrics.jsonl").read_text().splitlines()) == 3 and (out / "heartbeat").exists()
    for r in range(1, n):
        assert len((out / f"metrics.r{r}.jsonl").read_text().splitlines()) == 3, r
        assert (out / f"heartbeat.r{r}").exists(), r


def test_accumulate_and_controls_on_two_processes(tmp_path, scene_file):
    ctl = tmp_path / "ctl.json"
    ctl.write_text(json.dumps({"sky_color": [0.9, 0.2, 0.1], "bounces": 2}))
    runs = {"acc": ("--frames", "2", "--accumulate"), "ctl": ("--frames", "2", "--control-file", str(ctl)),
            "plain": ("--frames", "2")}
    procs = []
    for name, extra in runs.items():
        procs += _launch(scene_file, tmp_path / f"{name}1", 1, *extra)
        if name != "plain":
            procs += _launch(scene_file, tmp_path / f"{name}2", 2, *extra)
    join(procs, TIMEOUT)
    for name, count in (("acc", 1), ("ctl", 2)):
        one = _frames(tmp_path / f"{name}1")
        assert len(one) == count and _frames(tmp_path / f"{name}2") == one, name
    assert _frames(tmp_path / "plain1") != _frames(tmp_path / "ctl1")


def test_killed_nrc_run_resumes_bit_consistent(tmp_path, scene_file):
    """A 2-process --nrc run is killed once its checkpoint after frame 2
    lands; restarted with --resume it renders frames 3 and 4 of an
    uninterrupted 2-process run, byte for byte."""
    ck = tmp_path / "ck"
    step_dir = ck / "step_00000002"
    full = _launch(scene_file, tmp_path / "c", 2, "--nrc", "--frames", "4")
    procs = _launch(scene_file, tmp_path / "a", 2, "--nrc", "--frames", "64", "--checkpoint-dir", str(ck),
                    "--checkpoint-every", "2")
    try:
        deadline = time.time() + TIMEOUT
        while not step_dir.exists():
            assert time.time() < deadline, "checkpoint never landed"
            for p in procs:
                assert p.poll() is None, p.communicate()[0]
            time.sleep(0.2)
    finally:
        for p in reversed(procs):
            p.kill()
        for p in procs:
            p.communicate(timeout=TIMEOUT)
    join(_launch(scene_file, tmp_path / "b", 2, "--nrc", "--frames", "2", "--resume", str(step_dir)) + full,
         TIMEOUT)
    resumed = _frames(tmp_path / "b")
    assert len(resumed) == 2 and resumed == _frames(tmp_path / "c")[2:]


def test_height_that_does_not_divide_raises(tmp_path, scene_file):
    outs = join(_launch(scene_file, tmp_path, 2, "--frames", "1", "--height", "33"), TIMEOUT, check=False)
    for out in outs:
        assert "must divide over the 2 ranks" in out, out
