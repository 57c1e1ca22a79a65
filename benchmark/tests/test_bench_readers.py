"""The per-layer readers on a recorded Chrome trace: one traced 64x48
`pt4-still` frame on the card, trimmed to the events the readers use
(fixtures/trace_small.json.gz), with the values the readers gave there
(fixtures/expected.json)."""

import gzip
import importlib.util
import json
from pathlib import Path

import pytest

from benchmark.chrometrace import Trace

HERE = Path(__file__).resolve().parent
METRICS = HERE.parent / "metrics"
FRAME_METRICS = ["device_idle.frame", "device_ops.frame", "host_syncs.frame", "pathtrace_busy_ms.frame",
                 "svgf_busy_ms.frame", "trace_roofline.frame", "atrous_roofline.frame"]


def reader(name):
    spec = importlib.util.spec_from_file_location("r_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.fixture(scope="module")
def recorded():
    with gzip.open(HERE / "fixtures" / "trace_small.json.gz", "rt") as f:
        fix = json.load(f)
    # One recorded window stands for both traced windows of a run.
    run = {"kind": "frames", "seconds": fix["seconds"], "count": fix["count"], "times": [], "setup_s": 0.0,
           "trace": Trace(fix["events"]), "device_trace": Trace(fix["events"]), "device_seconds": fix["seconds"],
           "device_count": fix["count"], "untraced_item_s": fix["seconds"] / fix["count"], "trace_calls": [tuple(c) for c in fix["trace_calls"]],
           "atrous_calls": [tuple(c) for c in fix["atrous_calls"]], "n_tris": fix["n_tris"],
           "width": fix["width"], "height": fix["height"]}
    return run, json.loads((HERE / "fixtures" / "expected.json").read_text())


@pytest.mark.parametrize("name", FRAME_METRICS)
def test_reader_gives_the_recorded_value(recorded, name):
    run, expected = recorded
    assert reader(name)(run) == pytest.approx(expected[name], rel=1e-9)


@pytest.mark.parametrize("name", ["device_idle.step", "device_ops.step", "backward_busy_ms.step",
                                  "trace_roofline.step", "atrous_roofline.step", "host_syncs.step", "step_ms"])
def test_step_readers_find_nothing_in_a_frame_trace(recorded, name):
    assert reader(name)(recorded[0]) is None


def test_shares_are_shares(recorded):
    run, _ = recorded
    tr = run["trace"]
    assert 0.0 < tr.busy_s() <= run["seconds"]
    for name in ("trace_roofline.frame", "atrous_roofline.frame", "device_idle.frame"):
        assert 0.0 < reader(name)(run) <= 100.0
    assert tr.device_s_in("nebulae/pathtrace") <= tr.busy_s() + 1e-9
    assert sum(v for _n, v in tr.top_device_ops(10)) <= tr.union_s((e["ts"], e["ts"] + e["dur"]) for e in tr.device) * 2
    assert 0 < len(tr.idle_gaps(10)) <= 10


def test_union_of_spans():
    assert Trace.union_s([(0, 10), (5, 15), (20, 30)]) == pytest.approx(25e-6)
    assert Trace.union_s([(0, 10), (2, 3)]) == pytest.approx(10e-6)
    assert Trace.union_s([]) == 0.0


def test_device_time_goes_to_the_launching_range():
    events = [
        {"cat": "user_annotation", "name": "nebulae/svgf", "ts": 0, "dur": 100},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10, "dur": 2, "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 150, "dur": 2, "args": {"correlation": 2}},
        {"cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "ts": 160, "dur": 5},
        {"cat": "kernel", "name": "k1", "ts": 120, "dur": 30, "args": {"correlation": 1}},
        {"cat": "kernel", "name": "k2", "ts": 155, "dur": 10, "args": {"correlation": 2}},
    ]
    tr = Trace(events)
    assert tr.device_s_in("nebulae/svgf") == pytest.approx(30e-6)
    assert tr.busy_s() == pytest.approx(40e-6)
    assert tr.syncs() == 1 and tr.device_ops() == 2
