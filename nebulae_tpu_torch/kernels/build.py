"""Build and load the port's native library (CUDA kernels + BVH builder).

Every source under `csrc/` is compiled by its own nvcc process, all started
together, for `sm_90a`; the objects are linked into one shared library with
a plain C interface, loaded through ctypes.  The library lands in
`nebulae_tpu_torch/build/`, named by a hash of the sources and flags, so a
changed source is rebuilt and an unchanged one is loaded as it is.  Nothing
is built at import time: the first call that needs the library builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", *ARCH]
# Per-source flags: the kernels must not contract a*b+c into FMAs, so that
# they round like their plain PyTorch versions.
SOURCES = {
    "trace.cu": ["--fmad=false"],
    "atrous.cu": ["--fmad=false"],
    "bvh_builder.cpp": [],
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    "nb_closest_fat4": ([_P, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P], _I),
    "nb_combo_fat4": ([_P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P], _I),
    "nb_any_fat4": ([_P, _P, _P, _I, _P, _P, _I, _I, _P, _P], _I),
    "nb_closest_fat4_slots": ([_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P], _I),
    "nb_combo_fat4_slots": ([_P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I,
                             _P, _P, _P, _P, _P, _P], _I),
    "nb_combo_fat4_group_rays": ([_P], _I),
    "nb_any_fat4_slots": ([_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P], _I),
    "nb_closest_fat": ([_P, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P], _I),
    "nb_combo_fat": ([_P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P], _I),
    "nb_any_fat": ([_P, _P, _P, _I, _P, _P, _I, _I, _P, _P], _I),
    "nb_closest_node": ([_P, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P], _I),
    "nb_any_node": ([_P, _P, _P, _I, _P, _P, _I, _I, _P, _P], _I),
    "nb_atrous_fwd": ([_P, _P, _P, _P, _I, _I, _I, _F, _I, _F, _P, _P, _P], _I),
    "nb_atrous_bwd": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _F, _P, _P], _I),
    "nebulae_build_bvh": ([_P, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                           _P, _P, _P, _P, _P, _P, _P], ctypes.c_int32),
}


class NativeLibrary:
    """The loaded library, its path and how long the build took (0 when an
    existing build was loaded)."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_seconds: float):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on the GPU host only")
    return found


def _digest() -> str:
    h = hashlib.sha256()
    for name, flags in sorted(SOURCES.items()):
        h.update(name.encode())
        h.update(" ".join(COMMON + flags).encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> tuple[Path, float]:
    """Compile every source in parallel and link; returns (path, seconds)."""
    so = BUILD_DIR / f"libnebulae_torch_{_digest()}.so"
    if so.exists():
        return so, 0.0
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    objs, procs = [], []
    for name, flags in SOURCES.items():
        obj = BUILD_DIR / f"{name}.{os.getpid()}.o"
        cmd = [nvcc, *COMMON, *flags, "-c", str(CSRC / name), "-o", str(obj)]
        if verbose and name.endswith(".cu"):
            cmd.insert(1, "-Xptxas=-v")
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        objs.append(obj)
    failed = []
    for name, p in procs:
        out, _ = p.communicate()
        if verbose or p.returncode:
            print(f"[nvcc {name}] rc={p.returncode}\n{out.decode(errors='replace')}", flush=True)
        if p.returncode:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}")
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([nvcc, "-shared", *ARCH, "-o", str(tmp), *map(str, objs)], check=True)
    os.replace(tmp, so)
    for obj in objs:
        obj.unlink(missing_ok=True)
    return so, time.perf_counter() - t0


_loaded: NativeLibrary | None = None


def native(verbose: bool = False) -> NativeLibrary:
    """Build (at first use) and load the library; later calls reuse it."""
    global _loaded
    if _loaded is None:
        path, seconds = build(verbose)
        lib = ctypes.CDLL(str(path))
        for fn, (args, res) in SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = args
            f.restype = res
        _loaded = NativeLibrary(lib, path, seconds)
    return _loaded


def check(rc: int, what: str) -> None:
    """Raise on a CUDA error code returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} after launch")
