"""Device ms a step launched under the program's "nebulae/backward" range (autograd's backward, K5 included)."""

from benchmark.layers import busy_ms


def read(run):
    return busy_ms(run, "steps", "nebulae/backward")
