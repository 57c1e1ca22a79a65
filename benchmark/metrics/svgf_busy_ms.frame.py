"""Device ms a frame launched under "nebulae/svgf", the reprojection ("nebulae/svgf_reproject", inside it) included."""

from benchmark.layers import busy_ms


def read(run):
    return busy_ms(run, "frames", "nebulae/svgf")
