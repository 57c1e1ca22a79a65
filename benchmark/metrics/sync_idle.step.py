"""Share of the device's idle time in the host-traced window that falls in gaps opening while the host
waits inside a "nebulae/sync/<site>" range, in % (0 where the program names no sync)."""

from benchmark.program_spans import sync_idle


def read(run):
    return sync_idle(run, "steps")
