"""Kernels, copies and sets on the device a frame, in the device-only traced window."""

from benchmark.layers import device_ops


def read(run):
    return device_ops(run, "frames")
