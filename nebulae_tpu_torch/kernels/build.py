"""Build and load the port's two native libraries: the CUDA kernels and the
host-only BVH builder.

Every CUDA source under `csrc/` is compiled by its own nvcc process, all
started together, for `sm_90a`; the objects are linked into one shared
library with a plain C interface, loaded through ctypes.  The BVH builder
(`csrc/bvh_builder.cpp`) is host code, compiled by the host C++ compiler
into a library of its own, so that it exists on a machine without CUDA too.
Each library lands in `nebulae_tpu_torch/build/`, named by a hash of its
sources and flags, so a changed source is rebuilt and an unchanged one is
loaded as it is.  Nothing is built at import time: the first call that
needs a library builds it, and a failed build raises.
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
}
# The BVH builder takes the JAX package's flags (native/Makefile).  They let
# the compiler contract a*b+c into an FMA where the host has one, and the
# SAH costs then round as in JAX's library on the same host, so both build
# the same tree.
CXX = "g++"
HOST_SOURCE = "bvh_builder.cpp"
HOST_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++20"]

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
    "nb_group_rays": ([_P], _I),
    "nb_any_fat4_slots": ([_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P], _I),
    "nb_closest_fat": ([_P, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P], _I),
    "nb_combo_fat": ([_P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P], _I),
    "nb_any_fat": ([_P, _P, _P, _I, _P, _P, _I, _I, _P, _P], _I),
    "nb_closest_node": ([_P, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P], _I),
    "nb_any_node": ([_P, _P, _P, _I, _P, _P, _I, _I, _P, _P], _I),
    "nb_atrous_fwd": ([_P, _P, _P, _P, _I, _I, _I, _F, _I, _F, _P, _P, _P], _I),
    "nb_atrous_bwd": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _F, _P, _P], _I),
}
HOST_SIGNATURES = {
    "nebulae_build_bvh": ([_P, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                           _P, _P, _P, _P, _P, _P, _P], ctypes.c_int32),
}


class NativeLibrary:
    """The loaded library, its path and how long the build took (0 when an
    existing build was loaded)."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_seconds: float, flags: list[str]):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds
        self.flags = flags


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on the GPU host only")
    return found


def find_cxx() -> str:
    found = shutil.which(CXX)
    if found is None:
        raise RuntimeError(f"no host C++ compiler ({CXX}) to build the BVH builder")
    return found


def _digest(sources: dict[str, list[str]], tool: str = "") -> str:
    h = hashlib.sha256(tool.encode())
    for name, flags in sorted(sources.items()):
        h.update(name.encode())
        h.update(" ".join(flags).encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _load(path: Path, signatures: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, (args, res) in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = args
        f.restype = res
    return lib


def build(verbose: bool = False) -> tuple[Path, float]:
    """Compile every CUDA source in parallel and link; returns (path, seconds)."""
    so = BUILD_DIR / f"libnebulae_torch_{_digest({n: COMMON + f for n, f in SOURCES.items()})}.so"
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


def build_host() -> tuple[Path, float]:
    """Compile the host-only BVH builder; returns (path, seconds).  The
    name's hash covers what -march=native means to this compiler on this
    host, so a build directory copied to another machine is not reused."""
    cxx = find_cxx()
    target = subprocess.run([cxx, *HOST_FLAGS, "-Q", "--help=target"], capture_output=True, text=True,
                            check=True).stdout
    so = BUILD_DIR / f"libnebulae_host_{_digest({HOST_SOURCE: HOST_FLAGS}, cxx + target)}.so"
    if so.exists():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    p = subprocess.run([cxx, *HOST_FLAGS, "-shared", "-o", str(tmp), str(CSRC / HOST_SOURCE)],
                       capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"{cxx} failed for {HOST_SOURCE} (rc {p.returncode}):\n{p.stdout}{p.stderr}")
    os.replace(tmp, so)
    return so, time.perf_counter() - t0


_loaded: NativeLibrary | None = None
_host: NativeLibrary | None = None


def native(verbose: bool = False) -> NativeLibrary:
    """Build (at first use) and load the CUDA library; later calls reuse it."""
    global _loaded
    if _loaded is None:
        path, seconds = build(verbose)
        _loaded = NativeLibrary(_load(path, SIGNATURES), path, seconds, COMMON)
    return _loaded


def host_native() -> NativeLibrary:
    """Build (at first use) and load the host BVH builder's library, on any
    machine with a C++ compiler; later calls reuse it."""
    global _host
    if _host is None:
        path, seconds = build_host()
        _host = NativeLibrary(_load(path, HOST_SIGNATURES), path, seconds, [find_cxx(), *HOST_FLAGS])
    return _host


def check(rc: int, what: str) -> None:
    """Raise on a CUDA error code returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} after launch")
