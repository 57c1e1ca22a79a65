"""Colored, mutex-guarded console logger (as `nebulae_tpu/utils/logging.py`).

Lines go to stderr as `[  elapsed s LEVEL] message`, colored on a
terminal; NEBULAE_LOG_LEVEL (INFO, WARN, ERROR) drops the lower levels.
`neb_assert` logs a failed assertion and raises AssertionError.
"""

from __future__ import annotations

import os
import sys
import threading
import time

_LOCK = threading.Lock()
_COLORS = {"INFO": "\033[92m", "WARN": "\033[93m", "ERROR": "\033[91m"}
_RESET = "\033[0m"
_T0 = time.monotonic()
_LEVELS = {"INFO": 0, "WARN": 1, "ERROR": 2}
_MIN_LEVEL = _LEVELS.get(os.environ.get("NEBULAE_LOG_LEVEL", "INFO").upper(), 0)


def _log(level: str, msg: str) -> None:
    if _LEVELS[level] < _MIN_LEVEL:
        return
    with _LOCK:
        t = time.monotonic() - _T0
        color = _COLORS[level] if sys.stderr.isatty() else ""
        reset = _RESET if sys.stderr.isatty() else ""
        print(f"{color}[{t:9.3f}s {level:5s}]{reset} {msg}", file=sys.stderr, flush=True)


def log_info(msg: str) -> None:
    _log("INFO", msg)


def log_warn(msg: str) -> None:
    _log("WARN", msg)


def log_error(msg: str) -> None:
    _log("ERROR", msg)


def neb_assert(cond: bool, msg: str = "") -> None:
    if not cond:
        log_error(f"assertion failed: {msg}")
        raise AssertionError(msg)
