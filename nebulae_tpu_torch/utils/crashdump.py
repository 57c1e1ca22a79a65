"""Failure detection and crash dumps (as `nebulae_tpu/utils/crashdump.py`).

`install` sets a process exception hook (`uninstall` removes it) that writes a dump on any uncaught
exception: crash_<time>.json (reason, traceback, pid, argv, and the
environment variables whose names start with TORCH, CUDA or NEBULAE) and,
from a state provider, the frame state's tensors as state_<time>.npz
(through `golden.dump_golden`).  `faulthandler` logs hard crashes beside
them.  `Heartbeat` is a liveness file touched every frame; a peer treats a
stale one as a failed process.
"""

from __future__ import annotations

import faulthandler
import json
import os
import sys
import time
import traceback
from pathlib import Path

import numpy as np

from nebulae_tpu_torch.utils.golden import to_numpy

ENV_PREFIXES = ("TORCH", "CUDA", "NEBULAE")
_DEFAULT_DUMP_DIR = Path(os.environ.get("NEBULAE_CRASH_DIR", "/tmp/nebulae_crash"))
_DUMP_DIR = _DEFAULT_DUMP_DIR
_state_provider = None
_fault_log = None


def install(state_provider=None, dump_dir: str | Path | None = None) -> None:
    """Install the crash tracker.  `state_provider() -> dict` supplies the
    state to snapshot on failure (e.g. `lambda: renderer.state`)."""
    global _state_provider, _DUMP_DIR, _fault_log
    _state_provider = state_provider
    if dump_dir is not None:
        _DUMP_DIR = Path(dump_dir)
    _DUMP_DIR.mkdir(parents=True, exist_ok=True)
    log = open(_DUMP_DIR / "faulthandler.log", "w")
    faulthandler.enable(log)
    if _fault_log is not None:
        _fault_log.close()
    _fault_log = log
    sys.excepthook = _excepthook


def uninstall() -> None:
    """Undo install: the interpreter's own exception hook, no state
    provider, faulthandler on the process's stderr, the default dump
    directory, and the fault log closed."""
    global _state_provider, _DUMP_DIR, _fault_log
    _state_provider = None
    _DUMP_DIR = _DEFAULT_DUMP_DIR
    sys.excepthook = sys.__excepthook__
    faulthandler.enable(sys.__stderr__)
    if _fault_log is not None:
        _fault_log.close()
        _fault_log = None


def _excepthook(exc_type, exc, tb) -> None:
    try:
        write_dump(exc_type.__name__, "".join(traceback.format_exception(exc_type, exc, tb)))
    finally:
        sys.__excepthook__(exc_type, exc, tb)


def write_dump(reason: str, detail: str = "") -> str:
    """Write a crash dump: metadata JSON and, where a state provider is
    installed, the state's arrays.  Returns the JSON's path."""
    _DUMP_DIR.mkdir(parents=True, exist_ok=True)
    stamp = time.strftime("%Y%m%d_%H%M%S")
    meta = {
        "reason": reason,
        "detail": detail,
        "time": stamp,
        "pid": os.getpid(),
        "argv": sys.argv,
        "env": {k: v for k, v in os.environ.items() if k.startswith(ENV_PREFIXES)},
    }
    path = _DUMP_DIR / f"crash_{stamp}.json"
    path.write_text(json.dumps(meta, indent=2))
    if _state_provider is not None:
        try:
            from nebulae_tpu_torch.utils.golden import dump_golden

            dump_golden(_DUMP_DIR / f"state_{stamp}.npz", _to_numpy_tree(_state_provider()))
        except Exception as e:  # the state itself may be poisoned
            (_DUMP_DIR / f"state_{stamp}.failed").write_text(repr(e))
    return str(path)


def _to_numpy_tree(tree):
    """Nested dicts and lists of tensors and Python values -> nested dicts
    of numpy arrays (lists keyed by index)."""
    if isinstance(tree, dict):
        return {str(k): _to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _to_numpy_tree(v) for i, v in enumerate(tree)}
    try:
        return to_numpy(tree)
    except Exception:
        return np.zeros(0)


class Heartbeat:
    """Liveness file: touch() every frame; is_stale() after stale_after_s
    without a touch."""

    def __init__(self, path: str | Path, stale_after_s: float = 60.0):
        self.path = Path(path)
        self.stale_after_s = stale_after_s
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def touch(self):
        self.path.write_text(str(time.time()))

    def is_stale(self) -> bool:
        try:
            last = float(self.path.read_text())
        except (OSError, ValueError):
            return True
        return (time.time() - last) > self.stale_after_s
