"""The readers of the program's own ranges (benchmark/program_spans.py) on
synthetic events: which device idle time opens at a named sync, which
syncs are unnamed, the device time launched inside the cache's encoding,
and that a step's reader reads nothing of a frame."""

import importlib.util
from pathlib import Path

import pytest

from benchmark.chrometrace import Trace
from benchmark.program_spans import Spans

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location("s_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def span(name, ts, dur, tid=1):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def sync(ts, name="cudaStreamSynchronize"):
    return {"cat": "cuda_runtime", "name": name, "ts": ts, "dur": 3}


def kernel(ts, dur):
    return {"cat": "kernel", "name": "k", "ts": ts, "dur": dur, "args": {}}


def run(events, kind="frames", count=2):
    return {"kind": kind, "trace": Trace(events), "count": count}


# A frame's path trace from 0 to 400 us.  The device is busy over [10, 100),
# [150, 200) and [260, 300).  The gap at 100 opens while the host waits in
# "nebulae/sync/compact" (90-140): 50 us; the gap at 200 opens while the host
# still launches work (the sync range at 240-270 comes after the device drained): 60 us.
EVENTS = [
    span("nebulae/pathtrace", 0, 400),
    span("nebulae/sync/compact", 90, 50),
    span("nebulae/sync/svgf_short", 240, 30),
    kernel(10, 90), kernel(150, 50), kernel(260, 40),
    sync(95), sync(250),  # named
    sync(220),  # inside nebulae/pathtrace, unnamed
    sync(450),  # outside any nebulae/ range: the harness's own
]


def test_sync_idle_counts_gaps_that_open_inside_a_sync_range():
    assert reader("sync_idle.frame")(run(EVENTS)) == pytest.approx(50.0 / 110.0 * 100.0)


def test_sync_idle_ignores_a_gap_that_opens_outside():
    late = [e for e in EVENTS if e.get("name") != "nebulae/sync/compact"]
    assert reader("sync_idle.frame")(run(late)) == 0.0
    # A gap whose end, not its opening, lies in a sync range is not counted.
    ends_in = late + [span("nebulae/sync/late", 130, 40)]
    assert reader("sync_idle.frame")(run(ends_in)) == 0.0


def test_sync_idle_on_a_device_that_never_idles():
    events = [span("nebulae/pathtrace", 0, 100), span("nebulae/sync/compact", 40, 10), kernel(0, 50),
              kernel(50, 50)]
    assert reader("sync_idle.step")(run(events, "steps")) == 0.0


def test_unnamed_syncs_count_only_unnamed_ones_inside_the_program():
    assert reader("unnamed_syncs.frame")(run(EVENTS, count=2)) == pytest.approx(0.5)
    named_all = [e for e in EVENTS if e.get("ts") != 220]
    assert reader("unnamed_syncs.frame")(run(named_all)) == 0.0
    # Every synchronize call of the runtime counts, as in host_syncs.
    extra = EVENTS + [sync(230, "cudaDeviceSynchronize"), sync(235, "cudaEventSynchronize"),
                      {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 236, "dur": 2}]
    assert reader("unnamed_syncs.frame")(run(extra, count=1)) == 3.0


def test_a_sync_on_another_thread_belongs_to_the_range_it_falls_in():
    # Autograd's device thread syncs while the caller waits in
    # "nebulae/backward".
    events = [span("nebulae/backward", 0, 100, tid=1), span("nebulae/sync/bincount", 20, 10, tid=7),
              sync(25), sync(60)]
    assert reader("unnamed_syncs.step")(run(events, "steps", 1)) == 1.0


def launch(ts, corr):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 2, "args": {"correlation": corr}}


def test_nrc_encode_reads_the_device_time_launched_inside_the_encoding():
    # Two encodings a frame; the kernel launched at 150 lies outside both.
    events = [
        span("nebulae/nrc_query", 0, 300), span("nebulae/nrc_encode", 0, 100), span("nebulae/nrc_encode", 200, 50),
        launch(10, 1), launch(150, 2), launch(210, 3),
        {"cat": "kernel", "name": "cat", "ts": 20, "dur": 30, "args": {"correlation": 1}},
        {"cat": "kernel", "name": "mlp", "ts": 160, "dur": 40, "args": {"correlation": 2}},
        {"cat": "gpu_memcpy", "name": "copy", "ts": 220, "dur": 10, "args": {"correlation": 3}},
    ]
    assert reader("nrc_encode_busy_ms.frame")(run(events, count=2)) == pytest.approx(40e-3 / 2)
    # A program that opens no such range reads 0, not nothing.
    bare = [e for e in events if e.get("name") != "nebulae/nrc_encode"]
    assert reader("nrc_encode_busy_ms.frame")(run(bare)) == 0.0
    assert reader("nrc_encode_busy_ms.frame")(run(events, "steps")) is None


@pytest.mark.parametrize("name", ["sync_idle.step", "unnamed_syncs.step"])
def test_step_readers_read_nothing_of_a_frame(name):
    assert reader(name)(run(EVENTS, "frames")) is None


@pytest.mark.parametrize("name", ["sync_idle.frame", "unnamed_syncs.frame", "sync_idle.step",
                                  "unnamed_syncs.step", "nrc_encode_busy_ms.frame"])
def test_readers_need_the_host_traced_window(name):
    kind = "steps" if name.endswith(".step") else "frames"
    assert reader(name)({"kind": kind, "trace": None, "count": 3}) is None


def test_spans_merge_and_answer_points():
    s = Spans([(10, 20), (15, 30), (40, 50), (50, 55)])
    assert (s.starts, s.ends) == ([10, 40], [30, 55])
    assert 10 in s and 30 in s and 52 in s
    assert 9 not in s and 31 not in s and 56 not in s
    assert 1 not in Spans([])
