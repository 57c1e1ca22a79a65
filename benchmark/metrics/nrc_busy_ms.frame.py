"""Device ms a frame launched under the cache's training and query ranges ("nebulae/nrc_train", "nebulae/nrc_query"), each operation once."""

from benchmark.layers import busy_ms


def read(run):
    return busy_ms(run, "frames", "nebulae/nrc_train", "nebulae/nrc_query")
