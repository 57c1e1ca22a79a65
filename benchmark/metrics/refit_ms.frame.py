"""Device ms a frame launched under the scene update's range ("nebulae/refit"): the instance transform,
the triangle rows, the BVH refit and the tables' repacks (0 where the program opens no such range)."""

from benchmark.program_spans import range_busy_ms


def read(run):
    return range_busy_ms(run, "frames", "nebulae/refit")
