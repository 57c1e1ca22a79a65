"""Tracing and profiling.

  * `span(name)`: a torch.profiler range (record_function) while a
    profiler is recording, else a shared null context.  Every range of the
    port goes through it, so ranges cost a flag test when nothing traces;
  * `span_backward(t, name)`: the same around the backward of t's autograd
    node;
  * `profile_trace(dir)`: torch.profiler over a block, CPU and CUDA
    activity, exported as a Chrome trace to dir/trace.json;
  * `FrameTimer`: frame pacing with a once-a-second log line.

The port's ranges are named "nebulae/<what>": a frame's phases
(engine/renderer.py), the train step's (engine/train.py), the cache MLP
(nrc/mlp.py) and encoding (nrc/encoding.py), each walk of the tracer
("nebulae/trace/closest", "/combo", "/any"; tracer/trace.py), each a-trous
pass ("nebulae/atrous"; kernels/svgf.py), each scene update's refit
("nebulae/refit"; engine/renderer.py), and each place where the host
waits on the device, "nebulae/sync/<site>".
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch
import torch.autograd.profiler as _profiler
from torch.profiler import record_function

from nebulae_tpu_torch.utils.logging import log_info

TRACE_FILE = "trace.json"

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range called `name` while a profiler records, else a
    null context: an unrecorded record_function still costs ~12 us of host
    time, a frame opens ~100 ranges, and the host sets a frame's pace."""
    return record_function(name) if _profiler._is_profiler_enabled else _OFF


def span_backward(t, name: str):
    """t, whose autograd node runs under a profiler range called `name` in
    the backward, where a profiler records while t is made: the range
    opens in the node's pre-hook and closes in its post-hook.  For a wait
    inside PyTorch's own derivative of an operator.  A backward that raises
    inside the node skips the post-hook: its range stays open until the
    graph is freed, and ends there."""
    if not _profiler._is_profiler_enabled or t.grad_fn is None:
        return t
    open_ = []

    def enter(_grad_outputs):
        rf = record_function(name)
        rf.__enter__()
        open_.append(rf)

    def leave(_grad_inputs, _grad_outputs):
        open_.pop().__exit__(None, None, None)

    t.grad_fn.register_prehook(enter)
    t.grad_fn.register_hook(leave)
    return t


@contextlib.contextmanager
def profile_trace(log_dir: str):
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
