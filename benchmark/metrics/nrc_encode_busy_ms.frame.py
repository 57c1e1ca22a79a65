"""Device ms a frame launched under the cache encoding's range ("nebulae/nrc_encode"): the query's, the
training records' and the self-training queries' encodings (0 where the program opens no such range)."""

from benchmark.program_spans import range_busy_ms


def read(run):
    return range_busy_ms(run, "frames", "nebulae/nrc_encode")
