"""Device ms a frame launched under the cache MLP's range ("nebulae/nrc_mlp")."""

from benchmark.layers import busy_ms


def read(run):
    return busy_ms(run, "frames", "nebulae/nrc_mlp")
