"""Runtime synchronize calls a frame inside a "nebulae/" range and inside no "nebulae/sync/<site>" range,
in the host-traced window (0 where every wait of the program is named)."""

from benchmark.program_spans import unnamed_syncs


def read(run):
    return unnamed_syncs(run, "frames")
