"""Device ms a frame launched under the program's "nebulae/pathtrace" range."""

from benchmark.layers import busy_ms


def read(run):
    return busy_ms(run, "frames", "nebulae/pathtrace")
