#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nebulae_tpu_torch) on one GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. device   require CUDA; print the card's name and power limit; no TF32
  2. build    nvcc-build the kernels and the native BVH builder
  3. scene    the ~139k-triangle procedural bench scene, BVH, fat4 tables
  4. kernels  K1-K4 against their plain PyTorch versions at main-path shapes
              (1080p primary rays, 2^21 bounce/shadow rays, 1080p a-trous)
  5. slice    Renderer.render at 1920x1080, 1 spp, 4 bounces, full shading,
              SVGF, ACES: 3 warm-up and 5 timed frames, with every kernel's
              launch count read around them; then a 64x64 frame on the GPU
              against the same frame on the CPU through the plain versions
  6. summary  one {"kernels": [...]} line, then the device line last
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WIDTH, HEIGHT, SPP, BOUNCES = 1920, 1080, 1, 4
N_RANDOM = 1 << 21
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
# f32 operations per unit of traversal work (counted from csrc/trace.cu):
# a slab test of one box, a Moller-Trumbore test of one triangle, and the
# per-ray setup; and per a-trous tap, plus the per-pixel a-trous setup.
OPS_BOX, OPS_TRI, OPS_RAY = 25, 54, 12
OPS_TAP, OPS_PIXEL = 30, 12


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_ms(fn, runs: int = 7) -> float:
    """Median device time of fn() over `runs` calls (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def once_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PHASES = ("nebulae/gbuffer", "nebulae/pathtrace", "nebulae/svgf", "nebulae/tonemap")


def _union_ms(spans) -> float:
    """Total length of the union of (start, end) spans in microseconds, in ms."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def profile_frame(render, kernel_names, frame_ms: float) -> None:
    """One frame under torch.profiler, read from its Chrome trace: device
    busy time (union of kernel, copy and set spans), the idle share of the
    unprofiled mean frame time, device time per frame phase (each kernel
    goes to the renderer's record_function range that launched it), the
    port kernels' share, and the costliest kernels."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "frame.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    busy = _union_ms((e["ts"], e["ts"] + e["dur"]) for e in dev)

    def spans(cat):
        return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("cat") == cat and e.get("name") in PHASES]

    ranges, gpu_ranges = spans("user_annotation"), spans("gpu_user_annotation")
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if (e.get("cat") or "").startswith("cuda_") and "correlation" in e.get("args", {})}
    phase_ms = dict.fromkeys(PHASES + ("other",), 0.0)
    by_name: dict[str, list[float]] = {}
    for e in dev:
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        # By the host range around its launch; failing a traced launch, by
        # the device-side copy of the range around the op itself.
        phase = next((n for n, s, t in ranges if ts is not None and s <= ts <= t), None) or next(
            (n for n, s, t in gpu_ranges if s <= e["ts"] <= t), "other")
        phase_ms[phase] += e["dur"] / 1e3
        acc = by_name.setdefault(e["name"], [0.0, 0])
        acc[0] += e["dur"] / 1e3
        acc[1] += 1
    ours = {n: sum(v[0] for k, v in by_name.items() if n in k) for n in kernel_names}
    log(f"profile: frame under the profiler {wall_ms:.2f} ms, device busy {busy:.2f} ms, "
        f"{len(dev)} device ops; idle share {1 - busy / frame_ms:.3f} of the unprofiled "
        f"{frame_ms:.2f} ms frame")
    log("profile: device ms by phase " + json.dumps({k: round(v, 3) for k, v in phase_ms.items()}))
    log(f"profile: port kernels {json.dumps({k: round(v, 3) for k, v in ours.items()})} ms "
        f"= {sum(ours.values()) / busy:.3f} of busy")
    for name, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"profile:   {ms:8.3f} ms  x{count:<4d} {name[:110]}")


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def table_bytes(tables) -> int:
    return sum(tables[k].numel() * tables[k].element_size() for k in ("fat4nodes", "tris"))


def trace_bound(n_rays, tables, work, ray_bytes, out_bytes, n_dirs=1):
    n_bytes = n_rays * (ray_bytes + out_bytes) + table_bytes(tables)
    n_ops = (OPS_BOX * work["box_tests"] + OPS_TRI * work["tri_tests"]
             + OPS_RAY * n_dirs * n_rays)
    return bound_ms(n_bytes, n_ops)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "nebulae_tpu_torch").is_dir():
        print("chip_smoke: nebulae_tpu_torch/ not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    from nebulae_tpu_torch.bvh.cbuilder import build_bvh_native
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.core import brdf
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.kernels import svgf as ksvgf
    from nebulae_tpu_torch.kernels import trace as kt
    from nebulae_tpu_torch.kernels.build import native
    from nebulae_tpu_torch.passes.gbuffer import camera_rays, make_camera_arrays, render_gbuffer
    from nebulae_tpu_torch.tracer.sorting import ray_sort_key
    from nebulae_tpu_torch.utils.testscenes import bench_camera, bench_scene, textured_scene

    # 1. device
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    lib = native(verbose=True)
    log(f"build: {lib.build_seconds:.1f} s -> {lib.path.name}")

    # 3. scene
    t0 = time.perf_counter()
    fs = bench_scene(seed=0)
    log(f"scene: {fs.num_triangles} triangles, generated in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bvh = build_bvh_native(fs.tri_pos, max_leaf=15)
    log(f"bvh: {bvh.num_nodes} nodes in {(time.perf_counter() - t0) * 1e3:.1f} ms (native builder)")
    cfg = RenderConfig(
        width=WIDTH, height=HEIGHT, spp=SPP, max_bounces=BOUNCES, enable_svgf=True,
        enable_tonemap=True, tracer="auto", lean_outputs=True, fast_bounce_shading=False,
        bucket_scheduling=True,
    )
    t0 = time.perf_counter()
    renderer = Renderer(fs, cfg, bvh=bvh)
    tables = renderer.tables
    log(f"tables: {tables['fat4nodes'].shape[0]} fat4 nodes, {tables['tris'].shape[0]} slots, "
        f"{table_bytes(tables)} bytes, stack depth {tables['stack_depth']}, "
        f"renderer set up in {time.perf_counter() - t0:.1f} s")
    scene = renderer.scene
    cam_obj = bench_camera(fs)
    cam = make_camera_arrays(cam_obj, WIDTH, HEIGHT, dev)

    # 4. kernels against their plain versions, at the main path's shapes
    report = {}
    o, d = camera_rays(cam, WIDTH, HEIGHT)
    o, d = o.contiguous(), d.contiguous()
    n_pix = o.shape[0]
    hit_k = kt.closest_hit_fat4(o, d, tables)
    work = {}
    t_plain = once_ms(lambda: work.update(res=kt.closest_hit_fat4_plain(o, d, tables, work=work)))
    hit_p = work.pop("res")
    torch.cuda.synchronize()
    assert torch.equal(hit_k["tri"], hit_p["tri"]), "K1 tri differs from its plain version"
    m = hit_p["tri"] >= 0
    for k in ("t", "u", "v"):
        torch.testing.assert_close(hit_k[k][m], hit_p[k][m], rtol=1e-6, atol=0.0)
    err = max(float((hit_k[k][m] - hit_p[k][m]).abs().max()) for k in ("t", "u", "v"))
    ms = timed_ms(lambda: kt.closest_hit_fat4(o, d, tables))
    b_ms, b_by = trace_bound(n_pix, tables, work, 24, 16)
    report["closest_fat4"] = dict(max_abs_err=err, ms=ms, plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by)
    log(f"K1 closest: {n_pix} rays, hit {float(m.float().mean()):.3f}, kernel {ms:.3f} ms, "
        f"plain {t_plain:.1f} ms, bound {b_ms:.4f} ms ({b_by}), max err {err:.3g}, work {work}")

    # Bounce and shadow rays from primary surface points, as at a path vertex.
    gbuf = render_gbuffer(scene, lambda a, b: kt.closest_hit_fat4(a, b, tables), o, d)
    gen = torch.Generator(device=dev).manual_seed(1234)
    hit_idx = torch.nonzero(gbuf["hit"])[:, 0]
    pick = hit_idx[torch.randint(0, hit_idx.numel(), (N_RANDOM,), device=dev, generator=gen)]
    origin = brdf.offset_ray_origin(gbuf["position"][pick], gbuf["normal_g"][pick])
    u = torch.rand((4, N_RANDOM), device=dev, generator=gen)
    bdir = brdf.cosine_hemisphere_sample(u[0], u[1], gbuf["normal_s"][pick])
    ldir = brdf.sun_disk_sample(u[2], u[3], renderer.sun.direction[None, :], renderer.sun.tan_half_angle)
    order = torch.argsort(ray_sort_key(origin, bdir, scene["aabb_min"], scene["aabb_max"]))
    ro, rb, rl = (x[order].contiguous() for x in (origin, bdir, ldir))

    hk, occ_k = kt.shadow_closest_fat4(ro, rb, rl, tables)
    work = {}
    t_plain = once_ms(lambda: work.update(res=kt.shadow_closest_fat4_plain(ro, rb, rl, tables, work=work)))
    hp, occ_p = work.pop("res")
    assert torch.equal(hk["tri"], hp["tri"]) and torch.equal(occ_k, occ_p), "K2 differs from its plain version"
    m = hp["tri"] >= 0
    for k in ("t", "u", "v"):
        torch.testing.assert_close(hk[k][m], hp[k][m], rtol=1e-6, atol=0.0)
    err = max(float((hk[k][m] - hp[k][m]).abs().max()) for k in ("t", "u", "v"))
    ms = timed_ms(lambda: kt.shadow_closest_fat4(ro, rb, rl, tables))
    b_ms, b_by = trace_bound(N_RANDOM, tables, work, 36, 17, n_dirs=2)
    report["shadow_closest_fat4"] = dict(max_abs_err=err, ms=ms, plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by)
    log(f"K2 combo: {N_RANDOM} rays, bounce hit {float(m.float().mean()):.3f}, occluded "
        f"{float(occ_p.float().mean()):.3f}, kernel {ms:.3f} ms, plain {t_plain:.1f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), max err {err:.3g}, work {work}")

    occ_k = kt.any_hit_fat4(ro, rl, tables)
    work = {}
    t_plain = once_ms(lambda: work.update(res=kt.any_hit_fat4_plain(ro, rl, tables, work=work)))
    occ_p = work.pop("res")
    assert torch.equal(occ_k, occ_p), "K3 differs from its plain version"
    ms = timed_ms(lambda: kt.any_hit_fat4(ro, rl, tables))
    b_ms, b_by = trace_bound(N_RANDOM, tables, work, 24, 1)
    err = float((occ_k.float() - occ_p.float()).abs().max())
    report["any_fat4"] = dict(max_abs_err=err, ms=ms, plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by)
    log(f"K3 any: {N_RANDOM} rays, occluded {float(occ_p.float().mean()):.3f}, kernel {ms:.3f} ms, "
        f"plain {t_plain:.1f} ms, bound {b_ms:.4f} ms ({b_by}), work {work}")

    # K4 on a 1080p frame's guidance buffers with noisy radiance.
    rad = (gbuf["albedo"] * torch.rand((n_pix, 1), device=dev, generator=gen) * 4.0).reshape(HEIGHT, WIDTH, 3)
    var = torch.rand((HEIGHT, WIDTH), device=dev, generator=gen) * 0.05
    depth = gbuf["depth"].reshape(HEIGHT, WIDTH)
    nrm = gbuf["normal_s"].reshape(HEIGHT, WIDTH, 3).contiguous()
    phi = (cfg.svgf_phi_color, cfg.svgf_phi_normal, cfg.svgf_phi_depth)
    k4 = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for step in (1, 2, 4, 8):
        out_k, w_k = ksvgf.atrous_step(rad, var, depth, nrm, step, phi)
        res = {}
        t_plain = once_ms(lambda: res.update(v=ksvgf.atrous_step_plain(rad, var, depth, nrm, step, phi)))
        out_p, w_p = res["v"]
        torch.testing.assert_close(out_k, out_p, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(w_k, w_p, rtol=1e-5, atol=1e-6)
        err = max(float((out_k - out_p).abs().max()), float((w_k - w_p).abs().max()))
        ms = timed_ms(lambda: ksvgf.atrous_step(rad, var, depth, nrm, step, phi))
        b_ms, _ = bound_ms(n_pix * 48, n_pix * (25 * OPS_TAP + OPS_PIXEL))
        log(f"K4 atrous step {step}: kernel {ms:.3f} ms, plain {t_plain:.1f} ms, "
            f"bound {b_ms:.4f} ms, max err {err:.3g}")
        k4["max_abs_err"] = max(k4["max_abs_err"], err)
        k4["ms"] += ms / 4
        k4["plain_ms"] += t_plain / 4
        k4["bound_ms"] += b_ms / 4
    k4["bound_by"] = bound_ms(n_pix * 48, n_pix * (25 * OPS_TAP + OPS_PIXEL))[1]
    report["atrous_fwd"] = k4
    del hit_k, hit_p, hk, hp, gbuf, ro, rb, rl, origin, bdir, ldir, pick, o, d

    # 5. slice: the main path, with every launch count read around it
    wrappers = {
        "closest_fat4": kt.closest_hit_fat4,
        "shadow_closest_fat4": kt.shadow_closest_fat4,
        "any_fat4": kt.any_hit_fat4,
        "atrous_fwd": ksvgf.atrous_step,
    }
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        out = renderer.render(cam_obj)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = renderer.render(cam_obj)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    ldr = out["ldr"]
    assert ldr.shape == (HEIGHT, WIDTH, 3) and bool(torch.isfinite(ldr).all()), "non-finite frame"
    assert float(ldr.std()) > 1e-3, "constant frame"
    missing = [name for name, c in launches.items() if c == 0]
    assert not missing, f"kernels not launched on the main path: {missing}"
    frame_s = sum(times) / len(times)
    rays = WIDTH * HEIGHT * (1 + SPP * (2 * BOUNCES - 1))
    log(f"slice: {frame_s * 1e3:.2f} ms/frame (mean of 5; frames {[round(t * 1e3, 2) for t in times]}), "
        f"{rays / frame_s / 1e6:.2f} Mrays/s, ldr mean {float(ldr.mean()):.4f}, launches {launches}, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_frame(lambda: renderer.render(cam_obj),
                  ("closest_fat4_kernel", "combo_fat4_kernel", "any_fat4_kernel", "atrous_fwd_kernel"),
                  frame_s * 1e3)

    # A small frame on the GPU against the CPU through the plain versions.
    small = textured_scene(seed=0)
    kw = dict(width=64, height=64, max_bounces=BOUNCES, enable_svgf=True, enable_tonemap=True)
    cam_small = bench_camera(small)
    out_g = Renderer(small, RenderConfig(**kw)).render(cam_small)
    out_c = Renderer(small, RenderConfig(**kw), device="cpu").render(cam_small)
    for k in ("hdr", "denoised", "ldr"):
        a, b = out_g[k].cpu(), out_c[k]
        assert bool(torch.isfinite(a).all()), f"small frame {k} not finite"
        close = torch.isclose(a, b, rtol=1e-3, atol=1e-4).all(dim=-1).float().mean()
        assert float(close) >= 0.99, f"small frame {k}: only {float(close):.4f} of pixels agree"
    log(f"small frame: GPU agrees with the CPU plain path (ldr mean |d| "
        f"{float((out_g['ldr'].cpu() - out_c['ldr']).abs().mean()):.3g})")

    # 6. summary
    sources = {
        "closest_fat4": ("nebulae_tpu_torch/csrc/trace.cu", "nebulae_tpu/kernels/pallas_trace.py:1202"),
        "shadow_closest_fat4": ("nebulae_tpu_torch/csrc/trace.cu", "nebulae_tpu/kernels/pallas_trace.py:1415"),
        "any_fat4": ("nebulae_tpu_torch/csrc/trace.cu", "nebulae_tpu/kernels/pallas_trace.py:1311"),
        "atrous_fwd": ("nebulae_tpu_torch/csrc/atrous.cu", "nebulae_tpu/kernels/pallas_svgf.py:81"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        r = report[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None,
        })
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
