"""Share of an untraced item's wall time in which no operation ran on the device, in %
(the busy time an item from the device-only trace)."""

from benchmark.layers import device_idle


def read(run):
    return device_idle(run, "frames")
