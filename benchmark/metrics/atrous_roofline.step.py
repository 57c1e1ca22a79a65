"""Share of its roofline the a-trous passes of a step reach, forward (K4) and backward (K5), in %."""

from benchmark.layers import atrous_roofline


def read(run):
    return atrous_roofline(run, "steps", backward=True)
