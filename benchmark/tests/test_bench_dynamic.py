"""The `pt4-dynamic` cell (configuration `sponza247k-anim`, traffic
`still-dynamic`) and its two readers of the scene update, at the small
size on the CPU.

The cell runs from its own files: its configuration's scene kind at the
small size (two tori and the ground plane, both tori moving), its
traffic's turn (0.5 rad a frame) and slide, its limits, on the still
cell's small check.
With the tangent write taken out of the update (the refit then keeps the
load-time tangents, so turned normal-mapped surfaces shade with a stale
tangent frame) it reads not correct.  The readers read 0.0 on a still trace and more than 0 where the
program opened its "nebulae/refit" range."""

import importlib.util
import json
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.chrometrace import Trace, export_events
from benchmark.tests.conftest import ROOT, SMALL

METRICS = Path(__file__).resolve().parents[1] / "metrics"
READERS = ["refit_ms.frame", "refit_host_ms.frame"]


def reader(name):
    spec = importlib.util.spec_from_file_location("d_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def small_dynamic() -> dict:
    """The still cell's small size and check (a chain of 8 frames, the
    compared window frame drawn from the first 12).  The small scene has
    two tori: both move (every instance but the ground plane), with the
    traffic's turn, and the slide's period is cut to the chain's frames."""
    over = json.loads(json.dumps(SMALL["pt4-still"]))
    motion = json.loads((ROOT / "benchmark" / "traffic" / "still-dynamic.json").read_text())["motion"]
    over["traffic"]["motion"] = {**motion, "every": 1, "slide_period_frames": over["traffic"]["check"]["chain_frames"]}
    return over


def run(bench, seed):
    return harness.run_cell(bench, "pt4-dynamic", seed, 0.5, False, "cpu", time.perf_counter(),
                            overrides=small_dynamic(), log=lambda line: None)


def test_cell_files(bench):
    cell = harness.find_cell(bench, "pt4-dynamic")
    conf, traffic, limits = harness.cell_files(bench, cell)
    still, _t, still_limits = harness.cell_files(bench, harness.find_cell(bench, "pt4-still"))
    assert cell["chips"] == 1 and cell["traffic"] == "still-dynamic" and conf["name"] == "sponza247k-anim"
    for group in ("scene", "render", "sun"):
        assert conf[group] == still[group], group
    assert limits == still_limits
    assert traffic["motion"]["spin_rad_per_frame"] == 0.5
    for name in READERS:
        assert harness.cell_metrics(bench, "pt4-dynamic", True).count(name) == 1
        assert name not in harness.cell_metrics(bench, "pt4-still", True)


def test_turning_cell_is_correct(bench):
    out = run(bench, 2**31 + 61)
    assert out["result"]["correct"], out["checks"]
    assert out["result"]["failed"] == 0
    assert out["diagnostics"]["chain"] == 8 and out["diagnostics"]["tiles"] == 5 + 2


def test_stale_tangents_are_not_correct(bench, monkeypatch):
    import nebulae_tpu_torch.engine.renderer as r

    turn = r.transform_instances

    def keep_tangents(*args):
        pos, nrm, _tan = turn(*args)
        return pos, nrm, None  # the refit writes no tangents

    monkeypatch.setattr(r, "transform_instances", keep_tangents)
    out = run(bench, 2**31 + 61)
    assert not out["result"]["correct"], out["checks"]


def _span(name, ts, dur):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": 1}


def _launched(ts, corr, dur):
    return [{"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 2, "args": {"correlation": corr}},
            {"cat": "kernel", "name": "k", "ts": ts + 5, "dur": dur, "args": {"correlation": corr}}]


def test_readers_on_synthetic_frames():
    # Two frames: each an update (20 us of device work launched inside
    # "nebulae/refit", which lasts 100 us on the host), then its path trace.
    still = [_span("nebulae/pathtrace", 200, 300), *_launched(210, 1, 50),
             _span("nebulae/pathtrace", 900, 300), *_launched(910, 2, 50)]
    moving = still + [_span("nebulae/refit", 0, 100), *_launched(10, 3, 20),
                      _span("nebulae/refit", 700, 100), *_launched(710, 4, 20)]
    for name in READERS:
        assert reader(name)({"kind": "frames", "trace": Trace(still), "count": 2}) == 0.0
        assert reader(name)({"kind": "steps", "trace": Trace(moving), "count": 2}) is None
        assert reader(name)({"kind": "frames", "trace": None, "count": 2}) is None
    run_ = {"kind": "frames", "trace": Trace(moving), "count": 2}
    assert reader("refit_ms.frame")(run_) == pytest.approx(40e-3 / 2)
    assert reader("refit_host_ms.frame")(run_) == pytest.approx(200e-3 / 2)


@pytest.mark.parametrize("cell", ["pt4-still", "pt4-dynamic"])
def test_host_reader_on_a_cpu_trace(bench, cell):
    from torch.profiler import ProfilerActivity, profile

    over = SMALL["pt4-still"] if cell == "pt4-still" else small_dynamic()
    p = harness.prepare(bench, cell, 2**31 + 62, torch.device("cpu"), over)
    frames = harness.Frames(p["prog"], p["traffic"], p["sc"], 2**31 + 62, torch.device("cpu"))
    frames.one()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        frames.one()
        frames.one()
    got = reader("refit_host_ms.frame")({"kind": "frames", "trace": Trace(export_events(prof)), "count": 2})
    assert (got > 0.0) if cell == "pt4-dynamic" else (got == 0.0), got
