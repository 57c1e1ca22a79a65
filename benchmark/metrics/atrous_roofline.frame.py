"""Share of its roofline the a-trous passes (K4) of a frame reach, in % (benchmark/work/atrous.py, the published H100 peaks)."""

from benchmark.layers import atrous_roofline


def read(run):
    return atrous_roofline(run, "frames")
