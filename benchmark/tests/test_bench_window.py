"""The window arithmetic: a rate is the window over the count, a tail is
the tail of all items."""

import importlib.util
import statistics
from pathlib import Path

import pytest

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run(times, seconds, setup=12.5):
    return {"kind": "frames", "seconds": seconds, "count": len(times), "times": times, "setup_s": setup,
            "trace": None, "trace_calls": [], "atrous_calls": []}


def test_frame_ms_is_window_over_count():
    # The window includes the host's time between frames, so the rate is
    # not the mean of the frames' own times.
    r = run([0.05] * 10, 0.6)
    assert reader("frame_ms")(r) == pytest.approx(60.0)


def test_p90_over_all_frames():
    times = [0.01 * i for i in range(1, 101)]
    r = run(times, sum(times))
    assert reader("frame_p90_ms")(r) == pytest.approx(statistics.quantiles(times, n=10)[8] * 1e3)
    assert reader("frame_p90_ms")(r) == pytest.approx(909.0)


@pytest.mark.parametrize("name", ["frame_ms", "frame_p90_ms"])
def test_no_frames_no_reading(name):
    assert reader(name)(run([], 1.0)) is None


def test_setup_is_read_as_given():
    assert reader("setup_s")(run([0.1], 0.1, setup=17.25)) == 17.25


@pytest.mark.parametrize("name", ["device_idle.frame", "device_ops.frame", "host_syncs.frame",
                                  "pathtrace_busy_ms.frame", "svgf_busy_ms.frame", "trace_roofline.frame",
                                  "atrous_roofline.frame", "device_idle.step", "backward_busy_ms.step"])
def test_per_layer_readers_need_a_trace(name):
    assert reader(name)(run([0.1] * 3, 0.3)) is None
