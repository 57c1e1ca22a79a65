"""Host waits on the device a step (the runtime's synchronize calls), in the device-only traced window."""

from benchmark.layers import host_syncs


def read(run):
    return host_syncs(run, "steps")
