"""The CUDA walks of nebulae_tpu_torch/csrc/trace.cu, run on the CPU.

g++ builds trace.cu against tests/cuda_on_cpu.h, which runs each GPU
thread of a block as a std::thread and meets warp collectives at a barrier
per (warp, mask); each launch becomes a loop over its blocks.  Both bodies
of K2 (shadow_closest_fat4), K3 (any_hit_fat4, and its slot-gated K6b
build), K7b (shadow_closest_fat) and K7c (any_hit_fat), and the one body
of K1 (closest_hit_fat4) and K7a (closest_hit_fat), are held to the plain
walks at 1, 31, 33 and 4,097 rays: a partial warp, a warp and a lane, and
a partial block of either body.  tri, t, u, v and occ must be equal: the kernels build with
--fmad=false, and g++ with -ffp-contract=off rounds as they do.  The rays
leave surface points of a ~5k-triangle scene in directions drawn from a
seed, with zero and short caps, dead origins and zero directions.  This is
the check of the group bodies' lane logic that needs no card.
"""

import ctypes
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import nebulae_tpu_torch
from nebulae_tpu_torch.bvh.builder import build_bvh
from nebulae_tpu_torch.kernels import chunks as kc
from nebulae_tpu_torch.kernels import trace as kt
from nebulae_tpu_torch.kernels.build import CXX, SIGNATURES
from nebulae_tpu_torch.passes.gbuffer import camera_rays, make_camera_arrays
from nebulae_tpu_torch.tracer.sorting import DEAD_ORIGIN
from nebulae_tpu_torch.utils.testscenes import bench_camera, textured_scene

TRACE_CU = Path(nebulae_tpu_torch.__file__).parent / "csrc" / "trace.cu"
HEADER = Path(__file__).with_name("cuda_on_cpu.h")
LAUNCH = re.compile(r"(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\s*\(", re.S)
SIZES = (1, 31, 33, 4097)


def _split_top(text: str) -> list[str]:
    """text split at the commas outside parentheses."""
    parts, depth, start = [], 0, 0
    for i, ch in enumerate(text):
        depth += {"(": 1, ")": -1}.get(ch, 0)
        if ch == "," and depth == 0:
            parts.append(text[start:i].strip())
            start = i + 1
    return parts + [text[start:].strip()]


def emulated_source(src: str) -> str:
    """src with each kernel<<<grid, block, 0, stream>>>(args); made
    emu_launch(dim3(grid), dim3(block), [=] { kernel(args); });"""
    out, pos = [], 0
    while m := LAUNCH.search(src, pos):
        depth, i = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(src[i], 0)
            i += 1
        grid, block = _split_top(m.group(2))[:2]
        out += [src[pos:m.start()],
                f"emu_launch(dim3({grid}), dim3({block}), [=] {{ {m.group(1)}({src[m.end():i - 1]}); }})"]
        pos = i
    return "".join(out) + src[pos:]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("emulated")
    src = emulated_source(TRACE_CU.read_text())
    assert src.count("emu_launch(") == TRACE_CU.read_text().count("<<<")
    cpp = out / "trace_emulated.cpp"
    cpp.write_text(src.replace("#include <cuda_runtime.h>", f'#include "{HEADER}"'))
    so = out / "libtrace_emulated.so"
    subprocess.run([CXX, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
                    "-Wno-unknown-pragmas", str(cpp), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    for name, (args, res) in SIGNATURES.items():
        if hasattr(lib, name):  # the entries of trace.cu
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
    return lib


@pytest.fixture(scope="module")
def scene():
    fs = textured_scene(seed=0)
    bvh = build_bvh(fs.tri_pos, max_leaf=15)
    fat4 = kt.tables_to(kt.pack_bvh_fat4(bvh, fs.tri_pos, 8), "cpu")
    fat2 = kt.tables_to(kt.pack_bvh_fat(bvh, fs.tri_pos, 8), "cpu")
    budget = kc.TRI_CHUNK_TABLE_BUDGET
    kc.TRI_CHUNK_TABLE_BUDGET = fat4["fat4nodes"].numel() * 4 + 128 * 40 * 8 * 2
    try:
        chunks = kt.tables_to(kc.pack_bvh_tri_chunks(bvh, fs.tri_pos, 8), "cpu")["tri_chunks"]
    finally:
        kc.TRI_CHUNK_TABLE_BUDGET = budget
    assert len(chunks) >= 3
    cam = make_camera_arrays(bench_camera(fs), 96, 64, "cpu")
    o, d = camera_rays(cam, 96, 64)
    hit = kt.closest_hit_fat4_plain(o, d, fat4)
    points = (o + d * hit["t"][:, None])[hit["tri"] >= 0]
    return fat4, fat2, chunks[len(chunks) // 2], points


def _rays(points, n):
    """n rays from the scene's surface points, a bounce and a shadow
    direction each, with their caps."""
    rng = np.random.default_rng(n)

    def dirs():
        v = rng.normal(size=(n, 3))
        return torch.from_numpy((v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32))

    o = points[torch.from_numpy(rng.integers(0, points.shape[0], n))] + 1e-3 * dirs()
    b, l_ = dirs(), dirs()
    i = torch.arange(n)
    cap_b = torch.where(i % 3 == 1, 0.0, torch.where(i % 5 == 2, 0.7, float("inf")))
    cap_l = torch.where(i % 4 == 2, 0.0, torch.where(i % 6 == 1, 0.5, float("inf")))
    o[i % 7 == 3] = DEAD_ORIGIN
    b[i % 11 == 5] = 0.0
    l_[i % 13 == 6] = 0.0
    return o.contiguous(), b, l_, cap_b, cap_l


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _closest(lib, entry, key, o, d, tab, cap):
    n = o.shape[0]
    t, u, v = torch.empty(n), torch.empty(n), torch.empty(n)
    tri = torch.empty(n, dtype=torch.int32)
    rc = getattr(lib, entry)(_ptr(o), _ptr(d), _ptr(cap), 1, _ptr(tab[key]), _ptr(tab["tris"]),
                             tab["tris"].shape[1], n, _ptr(t), _ptr(tri), _ptr(u), _ptr(v), None)
    assert rc == 0
    return {"t": t, "tri": tri, "u": u, "v": v}


def _any(lib, entry, key, o, d, tab, cap, *gate):
    occ = torch.zeros(o.shape[0], dtype=torch.bool)
    rc = getattr(lib, entry)(_ptr(o), _ptr(d), _ptr(cap), 1, _ptr(tab[key]), _ptr(tab["tris"]),
                             tab["tris"].shape[1], o.shape[0], *gate, _ptr(occ), None)
    assert rc == 0
    return occ


def _combo(lib, entry, key, o, b, l_, tab, cap_b, cap_l):
    n = o.shape[0]
    t, u, v = torch.empty(n), torch.empty(n), torch.empty(n)
    tri = torch.empty(n, dtype=torch.int32)
    occ = torch.zeros(n, dtype=torch.bool)
    rc = getattr(lib, entry)(_ptr(o), _ptr(b), _ptr(l_), _ptr(cap_b), 1, _ptr(cap_l), 1, _ptr(tab[key]),
                             _ptr(tab["tris"]), tab["tris"].shape[1], n, _ptr(t), _ptr(tri), _ptr(u), _ptr(v),
                             _ptr(occ), None)
    assert rc == 0
    return {"t": t, "tri": tri, "u": u, "v": v}, occ


def _same_hit(hit, hit_p):
    for k in ("t", "tri", "u", "v"):
        assert torch.equal(hit[k], hit_p[k]), k


def _same(got, want):
    (hit, occ), (hit_p, occ_p) = got, want
    _same_hit(hit, hit_p)
    assert torch.equal(occ, occ_p), "occ"


# Each walk with each of its bodies: K1 and K7a have one thread per ray only.
CASES = [(k, b) for k in ("K2", "K3", "K3 slots", "K7b", "K7c") for b in ("group", "thread")]
CASES += [("K1", "thread"), ("K7a", "thread")]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kernel, body", CASES)
def test_emulated_walk_equals_plain(lib, scene, kernel, body, n):
    fat4, fat2, chunk, points = scene
    o, b, l_, cap_b, cap_l = _rays(points, n)
    lib.emu_use_group_body(body == "group")
    occ = hit = None
    if kernel in ("K3", "K7c"):
        tab, key, entry, plain = ((fat4, "fat4nodes", "nb_any_fat4", kt.any_hit_fat4_plain) if kernel == "K3"
                                  else (fat2, "fatnodes", "nb_any_fat", kt.any_hit_fat_plain))
        occ = plain(o, l_, tab, cap_l)
        assert torch.equal(_any(lib, entry, key, o, l_, tab, cap_l), occ)
    elif kernel == "K3 slots":
        sr = (chunk["slot_lo"], chunk["slot_hi"])
        occ = kt.any_hit_fat4_plain(o, l_, chunk, cap_l, slot_range=sr)
        assert torch.equal(_any(lib, "nb_any_fat4_slots", "fat4nodes", o, l_, chunk, cap_l, *sr), occ)
    elif kernel in ("K1", "K7a"):
        tab, key, entry, plain = ((fat4, "fat4nodes", "nb_closest_fat4", kt.closest_hit_fat4_plain)
                                  if kernel == "K1" else (fat2, "fatnodes", "nb_closest_fat", kt.closest_hit_fat_plain))
        hit = plain(o, b, tab, cap_b)
        _same_hit(_closest(lib, entry, key, o, b, tab, cap_b), hit)
    elif kernel == "K2":
        hit, occ = kt.shadow_closest_fat4_plain(o, b, l_, fat4, cap_b, cap_l)
        _same(_combo(lib, "nb_combo_fat4", "fat4nodes", o, b, l_, fat4, cap_b, cap_l), (hit, occ))
    else:
        hit, occ = kt.shadow_closest_fat_plain(o, b, l_, fat2, cap_b, cap_l)
        _same(_combo(lib, "nb_combo_fat", "fatnodes", o, b, l_, fat2, cap_b, cap_l), (hit, occ))
    if n == SIZES[-1]:
        # Both outcomes occur, so both are held.
        if occ is not None:
            assert 0 < int(occ.sum()) < n
        if hit is not None:
            assert 0 < int((hit["tri"] >= 0).sum()) < n
