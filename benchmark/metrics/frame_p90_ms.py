"""90th percentile of the frames of the window, each timed from its render
call to its ldr on the host, in ms (statistics.quantiles' exclusive
method)."""

import statistics


def read(run):
    if run["kind"] != "frames" or len(run["times"]) < 2:
        return None
    return statistics.quantiles(run["times"], n=10)[8] * 1e3
