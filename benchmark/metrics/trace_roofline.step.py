"""Share of its roofline the ray casting of a step reaches, in % (benchmark/work/trace.py, the published H100 peaks)."""

from benchmark.layers import trace_roofline


def read(run):
    return trace_roofline(run, "steps")
