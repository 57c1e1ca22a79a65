"""Tracing and profiling (as `nebulae_tpu/utils/profiling.py`).

  * `pass_annotation(name)`: a torch.profiler range (record_function) and,
    on a GPU, an NVTX range around a render pass;
  * `profile_trace(dir)`: torch.profiler over a block, CPU and CUDA
    activity, exported as a Chrome trace to dir/trace.json;
  * `FrameTimer`: frame pacing with a once-a-second log line;
  * `RaysPerSecond`: a rolling rays-per-second counter.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch

from nebulae_tpu_torch.utils.logging import log_info

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def pass_annotation(name: str):
    """Scoped range around a render pass, seen by torch.profiler and by
    NVTX-reading tools."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def profile_trace(log_dir: str = "/tmp/nebulae_trace"):
    """Profile the block (device activity too when a GPU is present) and
    write its Chrome trace to log_dir/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield str(out)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / TRACE_FILE))


class FrameTimer:
    """Frametime and fps with a once-per-second log line."""

    def __init__(self):
        self.last = time.perf_counter()
        self.acc = 0.0
        self.frames = 0
        self.fps = 0.0
        self.frametime_ms = 0.0

    def tick(self) -> float:
        now = time.perf_counter()
        dt = now - self.last
        self.last = now
        self.acc += dt
        self.frames += 1
        if self.acc >= 1.0:
            self.fps = self.frames / self.acc
            self.frametime_ms = 1000.0 * self.acc / self.frames
            log_info(f"frametime {self.frametime_ms:.2f} ms ({self.fps:.1f} fps)")
            self.acc = 0.0
            self.frames = 0
        return dt


class RaysPerSecond:
    """Rolling rays/s counter for benchmark-style reporting."""

    def __init__(self):
        self.total_rays = 0
        self.total_time = 0.0

    def add(self, rays: int, seconds: float):
        self.total_rays += rays
        self.total_time += seconds

    @property
    def mrays_s(self) -> float:
        return self.total_rays / max(self.total_time, 1e-9) / 1e6
