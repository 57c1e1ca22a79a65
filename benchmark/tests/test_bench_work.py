"""The roofline work counts, from shapes."""

from benchmark.work import atrous, peaks, trace


def test_trace_bytes_per_call():
    # 28 bytes in (origin, direction, extent) and 16 out a closest ray,
    # 1 out an any ray; the triangles once a call.
    assert trace.call_bytes("closest", 10, 100) == 10 * 44 + 100 * 36
    assert trace.call_bytes("any", 10, 100) == 10 * 29 + 100 * 36
    assert trace.call_bytes("combo", 10, 0) == 10 * (12 + 32 + 17)


def test_trace_bytes_of_the_primary_pass():
    n, t = 1920 * 1080, 246_528
    b = trace.call_bytes("closest", n, t)
    assert b == 2_073_600 * 44 + 246_528 * 36
    assert abs(peaks.bound_s(b) - b / 3.35e12) < 1e-15


def test_atrous_pass():
    assert atrous.pass_bytes(1080, 1920) == 1080 * 1920 * 48
    assert atrous.pass_ops(1080, 1920) == 1080 * 1920 * 762
    # Bytes bound the pass at the published peaks.
    b, o = atrous.pass_bytes(1080, 1920), atrous.pass_ops(1080, 1920)
    assert peaks.bound_s(b, o) == b / peaks.HBM_BYTES_PER_S > o / peaks.F32_OPS_PER_S
