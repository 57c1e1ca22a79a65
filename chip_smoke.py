#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nebulae_tpu_torch) on one GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. device   require CUDA; print the card's name and power limit; no TF32
  2. build    nvcc-build the kernels
  3. scene    the ~139k-triangle procedural bench scene, its BVH (the C++
              builder, built with g++ at first use: its flags and seconds
              are logged), fat4 tables
  4. kernels  K1-K5 against their plain PyTorch versions at main-path shapes
              (1080p primary rays, 2^21 bounce/shadow rays, K1, K2 and K3
              on each of their launches in a 1080p frame, 1080p a-trous
              forward and backward at max error 0, with K5's adjoint
              identity against K4); K1, K2 and K3 and their slot-gated
              builds (over the bench scene cut into triangle chunks, K1's
              chained over them at 1080p) at 1, 31, 33 and 4,097 rays (K2
              and K3 also one past their group bodies' limit), with zero
              caps and dead lanes; K4 and K5 on a ragged 1917x1079 frame
              and with phi_normal 64
  5. slice    Renderer.render at 1920x1080, 1 spp, 4 bounces, full shading,
              SVGF, ACES: 3 warm-up and 5 timed frames, with every kernel's
              launch count (K9's too: 4 a frame) read around them, one
              profiled (K9 among the port kernels listed); then a 64x64
              frame on the GPU against the same frame on the CPU through
              the plain versions
  6. train    make_train_step at the same width (MSE to a zero target, Adam
              on the material tables and the sun): 1 warm-up and 3 timed
              steps with params held fixed and the frame state threaded, the
              launch counts read around them (K9's 4 a step, its backward
              the twin's), one step profiled; then a
              64x64 step on the GPU against the CPU through the plain versions
  7. large    scenes past the single-table gate.  The ~247k-triangle
              large_scene on each chunk_mode (auto -> one table, subtree,
              tri, paged): K6b (the slot-gated K1-K3 chained over the tri
              chunks) and K8 (one-node closest and any) against their plain
              versions at the phase-4 shapes, then 1 warm-up and 3 timed
              1080p frames per route, held against auto's frame.  The ~2M
              huge_scene under auto (the paged route, K6a): its kernels
              against their plain versions at full shape, 1 warm-up and 3
              timed frames, one profiled frame, and 1 warm-up and 3 timed
              train steps; its fused and any-hit walks at the stress shapes
              of phase 4.  The same scene and BVH with bvh_wide=2 (fat2
              subtree chunks): 1 + 3 frames held against the paged frames,
              one profiled (K7a, K7b, K7c and K8 apart).  A 12-triangle box
              with tracer="pallas" (the BVH root is a leaf): a 1080p frame
              through K8, held against the brute-force frame, one profiled.
              K8 (one-node closest and any, both bodies of each) against
              its plain versions with max error 0: on each of its launches
              in a box frame and in a 2M bvh_wide=2 frame (the single-leaf
              chunks), over the whole 247k tree at 1080p and 2^21 rays, and
              at the stress sizes over that tree and over the box's leaf.
              A 1080p train step on the tri and subtree routes and on the
              box: launch counts, and a second step profiled (K6b, K6c and
              K8 device ms in a step)
  8. fat2     bvh_wide=2 and dynamic scenes.  The bench scene's fat2 table:
              K7 (fat2 closest, fused and any) against its plain versions
              and against K1-K3 at the phase-4 shapes and at the stress
              shapes (K7b and K7c also one past their group bodies'
              limit), K7b and K7c on each launch of a 1080p fat2 frame, 1
              warm-up and 3
              timed 1080p frames held against the fat4 frame, one profiled
              frame, and 1 warm-up and 3 timed train steps.  The 247k scene
              with bvh_wide=2 (two fat2 subtree chunks): the chained K7
              against its plain versions and 1 + 3 frames held against the
              247k fat4 frame.  update_instances (a third of the tori turn
              and slide) on the bench scene's fat4, fat2 and paged tables
              and on the 247k subtree route (switched to paged): its time
              and one profiled call, 1 + 3 frames held against a rebuild
              on the moved triangles, and a profile of each
  9. options  the bench scene at 1920x1080 with jitter_primary, then
              fast_bounce_shading, then enable_envmap (JAX's app's
              procedural 64x128 sky), then all three: 1 warm-up and 3 timed
              frames with the launch counts read around them (jitter shows
              K1 twice a frame), one profiled frame, 1 warm-up and 3 timed
              train steps, one profiled; and each option's 64x64 frame and
              step on the GPU against the CPU plain path
 10. nrc      the neural radiance cache: the bench scene at 1920x1080 with
              enable_nrc, 3 warm-up and 3 timed frames (nrc_loss and
              nrc_query_frac of each, launch counts: K1 2, K2 3 + 7, K3
              1 + 1 a frame, peak memory), one profiled frame (device ms of
              nrc_train, nrc_query and the MLP's products), K1, K2 and K3
              held against their plain versions on each launch of an NRC
              frame (max error 0); the MLP's two product forms on one
              2,073,600-row query; 1 warm-up and 3 timed train steps with
              the cache, one profiled; bench_atrium (the bench tori in
              four walls) at 1080p, 1 warm-up and 3 timed frames and one
              profiled; 64x64 NRC frames and a step on the GPU against the
              CPU plain path from one cache; the quality probe on the card
              at its defaults (ratio < 1)
 11. app      the app shell on a glTF scene: the ~139k-triangle torus field
              with 9 materials and maps at Sponza's sizes (1024x1024 base
              colour, a 2048x2048 metallic-roughness map under
              --max-texture-dim 1024, a 512x512 normal map, a 1000x750
              emissive map) written as .glb and .gltf + .bin + PNG and
              loaded from both (equal arrays; parse, decode, pack and BVH
              seconds); app.run at its defaults (1920x1080, 1 spp, 8
              bounces, SVGF, ACES) with --orbit-speed 0.5: 3 warm-up and 8
              timed frames (frame_ms from metrics.jsonl, launch counts),
              the 3rd of 3 orbiting frames under --profile (busy ms, the
              reprojection's device ms), K1-K3 held on each launch of one
              app frame; a run of 8 frames checkpointed after 4 and a run
              resumed from it (frames equal byte for byte), without and
              with --nrc; a --bvh-wide 2 frame (K7) and a --tracer bvh
              frame (equal to --tracer pallas); 64x64 app frames on the GPU
              against --device cpu, with GI and with --no-gi
 12. dist     nebulae_tpu_torch.dist on the one card: 2 ranks (this script
              with --dist-worker, gloo with host staging) on the bench
              scene at 1920x1080, 4 bounces, SVGF, ACES: 3 warm-up and 5
              timed frames, still and orbiting, each gathered frame held to
              the single-process frame (byte for byte, or the max error of
              hdr, denoised and ldr logged), each frame's collectives by op
              (bytes on the rank and sent, host ms) from comm's log, one
              frame profiled (its c10d ops counted against the log), K1-K4
              held on each launch of rank 0's frame; 1 warm-up and 3 timed
              2-rank train steps, K5 held on each launch of rank 0's next
              step, the summed gradients against one process's (cosine >=
              0.9999); a 2-rank NRC frame (caches equal by digest, the
              frame within the NRC tolerance); a bvh_wide=2 frame (K7a-c
              held on rank 0's launches) and a 247k subtree frame; a 1-rank
              NCCL world at 1080p (still and orbiting frames against the
              single ones, the collectives' host ms and device ms) and
              running the dry run (nebulae_tpu_torch.dist.dryrun); the app
              as 2 processes at its defaults, 8 frames checkpointed after 4
              and 4 resumed (byte for byte), against 1 process
 13. nrc-routes  the neural radiance cache at 1920x1080 with full
              outputs on every frame option, route and width: the bench
              scene with jitter_primary, fast_bounce_shading, enable_envmap
              and all three (1 warm-up and 3 timed frames each, nrc_loss,
              query share and launch counts; one jitter frame profiled; K1,
              K2 and K3 held on each launch of an all-options frame, the
              training pass's included); the ~247k scene on each chunk_mode
              (1 + 2 frames; the first held against auto's from one cache:
              paged byte for byte, its cache too, tri and subtree at the NRC
              tolerance; K1-K3, K6a, K6b and the K6c chains held on each
              launch of a frame); the bench scene with bvh_wide=2 against
              fat4 (K7a-c on each launch); the ~2M scene paged and with
              bvh_wide=2 (1 + 1 frames each, hit masks equal; K7 and K8 on
              each launch of the fat2 frame); update_instances at 2M on the
              paged table (first call, 3 timed and one profiled call; a
              plain frame against a rebuild); update_instances under the
              cache on the bench scene's fat4 table and the 247k subtree
              route (repacked to paged), NRC frames against a rebuild from
              the same cache; an NRC train step on the 247k subtree route
              (K5 on each launch); 64x64 NRC frames with jitter and the
              env-map sky on the GPU against the CPU plain path
 14. oracle   the reference tracer (nebulae_tpu_torch.ref.tracer, eager
              brute force, no kernel): on the card against itself on the
              CPU (the 64x64 small atrium, defaults and all three options:
              RNG states equal, primary tri equal away from t ties,
              radiance within rtol 1e-5 / atol 1e-6 but for drifted or
              flipped pixels); the card's 64x64 frames (direct, path
              traced under each option, on fat4 through K1-K3 and fat2
              through K7) against the CPU reference tracer; frames at scale
              against the reference tracer on the card (the bench scene at
              256x256, 4 bounces; the ~247k scene at 128x128 on subtree,
              tri and paged; the ~2M scene at 64x64 paged and with
              bvh_wide=2), each frame's launch counts read around it;
              primary visibility of the 1080p bench frame (K1's hit mask
              and depth, every 4th row where the whole frame would take
              the reference past 60 s); and the 64x64 frame's gradients on
              the card (three base colours, the sun's radiance) against
              central differences of the CPU reference tracer.  Each line
              logs its shares, hit-mask differences, max error and the
              frame's and the reference's seconds, and the reference's pair
              tests per second; >= 99.9% of pixels and hit decisions must
              agree
 15. vertex   K9 (the path vertex's draws and ray keys) against its plain
              twin on each of its launches in a 1080p frame (4: three
              bounce vertices and the last) and in a 1080p NRC frame on
              bench_atrium at 8 vertices (16: the query pass's and the
              training walk's), every output bit for bit; the kernel's
              device ms, a call's and the twin's ms (CUDA events) against
              the byte bound; a 1080p train step through K9 (4 launches)
              against the same step with the twin forced: image and loss
              bit for bit, each gradient as close as two twin steps are
              to each other (the backward's atomic sums)
 16. summary  one {"kernels": [...]} line, then the device line last
Each phase logs its seconds; each profile lists every launch of a port
kernel with its grid, block, registers and time.  Imports nothing of JAX or
of the JAX package.

    python3 chip_smoke.py --ab TREE_A TREE_B [--rounds 1] [--runs 21]

compares source trees in one session on one GPU instead.  A TREE is a
directory that holds a `nebulae_tpu_torch/` package: this checkout, or an
unpacked `git archive` of another commit.  One process of this checkout
builds the bench scene's BVH and saves it, with K2's and K3's launches in
one bench-scene frame at each of AB_SIZES and K7b's and K7c's in one 1080p
bvh_wide=2 frame on that BVH, taken through the wrappers' record hooks.
Then each tree runs in turn, A B B A per round, in a fresh process that
builds its kernels, makes phase 4's inputs as phase 4 does on the saved
BVH (so every tree walks the same tree), and times K1 and K7a on the
1080p primary rays (a frame's own launch), K2, K3, K7b and K7c at phase
4's shape (2^21 rays) and on each saved launch, K3, K7b and K7c on
strided subsets of those rays (AB_SWEEP), K8 (closest and any) on each of
its launches in a 1080p box frame and in a 1080p frame of the ~2M scene
with bvh_wide=2 (saved with their one-node tables), and K4 and K5 at steps
1, 2, 4 and 8.  Where the tree's kernel has a group body, each of its launches is
also timed with the other body: split into launches the group body takes,
or padded with dead rays past them; the results must equal the launch's
own.  Prints the card's name and power limit, one JSON line per process,
each tree's medians (K4 and K5 per step; K8's device ms summed over each
frame's launches, and with one thread per ray on every launch where the
tree has a group body) and output digests (K1, K7a, K2, K3, K7b, K7c, K4,
K5 and every saved launch), and which kernels' SASS
(`cuobjdump -sass`) equals the first tree's.
"""

from __future__ import annotations

import hashlib
import json
import math
import re
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
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores
# f32 operations per unit of traversal work (counted from csrc/trace.cu):
# a slab test of one box, a Moller-Trumbore test of one triangle, and the
# per-ray setup; and per a-trous tap, plus the per-pixel a-trous setup.
OPS_BOX, OPS_TRI, OPS_RAY = 25, 54, 12
OPS_TAP, OPS_PIXEL = 30, 12
# K5's f32 operations per tap (the weights as K4, with the luminance stop's
# division) and per pixel (g, luminance, clamped depth and vscale, formed
# once per pixel), counted from csrc/atrous.cu.
OPS_TAP_BWD, OPS_PIXEL_BWD = 30, 14


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
TRAIN_PHASES = PHASES + ("nebulae/backward", "nebulae/optimizer")
# With the radiance cache the frame trains it, then its query pass takes
# the path tracer's place; the MLP runs under "nebulae/nrc_mlp" inside both.
NRC_PHASES = ("nebulae/gbuffer", "nebulae/nrc_train", "nebulae/nrc_query", "nebulae/svgf", "nebulae/tonemap")
NRC_TRAIN_PHASES = NRC_PHASES + ("nebulae/backward", "nebulae/optimizer")
# Matrix-product kernels as the profiler names them (cuBLAS, CUTLASS).
GEMM_NAMES = re.compile(r"gemm|nvjet|cutlass|xmma|sm90_|sm80_", re.IGNORECASE)


def _union_ms(spans) -> float:
    """Total length of the union of (start, end) spans in microseconds, in ms."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def _trace_events(prof) -> list:
    """A finished torch.profiler run's events, from its Chrome trace."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return json.loads(path.read_text())["traceEvents"]


def profile_frame(render, kernel_names, frame_ms: float, phases=PHASES, what: str = "frame",
                  nested=()) -> dict:
    """One frame (or train step) under torch.profiler, read from its Chrome
    trace by profile_report.  Returns the device ms by phase and by nested
    range."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return profile_report(_trace_events(prof), kernel_names, frame_ms, wall_ms, phases, what, nested)


def profile_report(events, kernel_names, frame_ms: float, wall_ms: float, phases=PHASES, what: str = "frame",
                   nested=()) -> dict:
    """A profiled run's Chrome-trace events: device busy time (union of
    kernel, copy and set spans), the idle share of the unprofiled
    `frame_ms`, device time per phase (each kernel goes to the
    record_function range that launched it), the port kernels' share and
    each of their launches, and the costliest kernels.  For each range
    named in `nested` (one that runs inside the phases), the device time of
    the kernels launched inside it, of those the matrix products', and its
    costliest kernels.  Returns the device ms by phase and by nested range,
    the busy ms and each port kernel's launch count."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    busy = _union_ms((e["ts"], e["ts"] + e["dur"]) for e in dev)

    def spans(cat):
        return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("cat") == cat and e.get("name") in phases]

    ranges, gpu_ranges = spans("user_annotation"), spans("gpu_user_annotation")
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if (e.get("cat") or "").startswith("cuda_") and "correlation" in e.get("args", {})}
    phase_ms = dict.fromkeys(tuple(phases) + ("other",), 0.0)
    by_name: dict[str, list[float]] = {}
    inner = {n: [(s, t) for m, s, t in ((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                                        if e.get("cat") == "user_annotation" and "dur" in e) if m == n]
             for n in nested}
    nested_ms = {n: {"ms": 0.0, "products_ms": 0.0, "kernels": {}} for n in nested}
    for e in dev:
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        for n, spans_n in inner.items():
            if ts is not None and any(s <= ts <= t for s, t in spans_n):
                acc_n = nested_ms[n]
                acc_n["ms"] += e["dur"] / 1e3
                acc_n["products_ms"] += e["dur"] / 1e3 if GEMM_NAMES.search(e["name"]) else 0.0
                acc_n["kernels"][e["name"]] = acc_n["kernels"].get(e["name"], 0.0) + e["dur"] / 1e3
        # By the host range around its launch; failing a traced launch, by
        # the device-side copy of the range around the op itself.
        phase = next((n for n, s, t in ranges if ts is not None and s <= ts <= t), None) or next(
            (n for n, s, t in gpu_ranges if s <= e["ts"] <= t), "other")
        phase_ms[phase] += e["dur"] / 1e3
        acc = by_name.setdefault(e["name"], [0.0, 0])
        acc[0] += e["dur"] / 1e3
        acc[1] += 1
    ours = {n: sum(v[0] for k, v in by_name.items() if n in k) for n in kernel_names}
    # Host waits on the device (the closing torch.cuda.synchronize is one),
    # and copies by direction: a blocking copy is a copy and a stream sync.
    syncs = [e["name"] for e in events if (e.get("cat") or "").startswith("cuda_")
             and "Synchronize" in e.get("name", "")]
    copies = [e["name"] for e in events if e.get("cat") == "gpu_memcpy"]
    log(f"profile: {what} under the profiler {wall_ms:.2f} ms, device busy {busy:.2f} ms, "
        f"{len(dev)} device ops; idle share {1 - busy / frame_ms:.3f} of the unprofiled "
        f"{frame_ms:.2f} ms {what}")
    log(f"profile: host syncs {json.dumps({n: syncs.count(n) for n in sorted(set(syncs))})}, "
        f"copies HtoD {sum('HtoD' in n for n in copies)}, DtoH {sum('DtoH' in n for n in copies)}, "
        f"DtoD {sum('DtoD' in n for n in copies)}")
    log("profile: device ms by phase " + json.dumps({k: round(v, 3) for k, v in phase_ms.items()}))
    log(f"profile: port kernels {json.dumps({k: round(v, 3) for k, v in ours.items()})} ms "
        f"= {sum(ours.values()) / busy:.3f} of busy")
    # Each launch of a port kernel in launch order: its grid x block (the
    # lanes it was given, rounded up to a block), its registers, shared
    # memory and the profiler's occupancy estimate, and its time.
    for e in sorted((e for e in dev if any(n in e["name"] for n in kernel_names)), key=lambda e: e["ts"]):
        a = e.get("args", {})
        name = re.search(r"\w+_kernel", e["name"]).group(0) + ("<SlotRange>" if "SlotRange" in e["name"] else "")
        log(f"profile:   launch {name} grid {a.get('grid')} x block {a.get('block')}, "
            f"{a.get('registers per thread')} registers, {a.get('shared memory')} B shared, "
            f"{a.get('warps per SM')} warps per SM, est. occupancy {a.get('est. achieved occupancy %')}%: "
            f"{e['dur'] / 1e3:.4f} ms")
    for name, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"profile:   {ms:8.3f} ms  x{count:<4d} {name[:110]}")
    for n, acc_n in nested_ms.items():
        top = sorted(acc_n["kernels"].items(), key=lambda kv: -kv[1])[:6]
        log(f"profile: inside {n}: device {acc_n['ms']:.3f} ms, of it matrix products {acc_n['products_ms']:.3f} ms; "
            + "; ".join(f"{ms:.3f} ms {k[:70]}" for k, ms in top))
    counts = {n: sum(1 for e in dev if n in e["name"]) for n in kernel_names}
    return {"phases": phase_ms, "busy_ms": busy, "launches": counts,
            "nested": {n: {k: v for k, v in a.items() if k != "kernels"} for n, a in nested_ms.items()}}


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def table_bytes(tables) -> int:
    """Bytes of the traversal tensors in a tables dict, a chunk list
    included; a tensor that several chunks share counts once."""
    import torch

    seen = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            seen[(x.data_ptr(), x.numel())] = x.numel() * x.element_size()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)

    walk(tables)
    return sum(seen.values())


def jax_layout_bytes(tables) -> int:
    """The same tables' bytes in the JAX package's layout (rows padded to
    128; each triangle chunk padded on its own)."""
    from nebulae_tpu_torch.kernels import chunks as kc

    def rows(n):
        return max(-(-n // 128), 1) * 128

    if "chunks" in tables:
        return sum(jax_layout_bytes(c) for c in tables["chunks"])
    if "tri_chunks" in tables:
        return rows(tables["fat4nodes"].shape[0]) * 128 + sum(
            rows(c["tris"].shape[0]) * c["tris"].shape[1] * 40 for c in tables["tri_chunks"])
    tri_bytes = rows(tables["tris"].shape[0]) * tables["tris"].shape[1] * 40
    if "nodes" in tables:
        return rows(tables["nodes"].shape[0]) * 32 + tri_bytes
    if "fatnodes" in tables:
        return rows(tables["fatnodes"].shape[0]) * 64 + tri_bytes
    return kc.jax_table_bytes(tables)


def walked_bytes(tables, work) -> int:
    """The table bytes a walk of this run's rays reads: a row for each node
    visit and a triangle (40 B) for each triangle test, repeats counted,
    and at most the tables' own bytes."""
    rows = next(tables[k] for k in ("fat4nodes", "fatnodes", "nodes") if k in tables)
    row_bytes = rows.shape[1] * rows.element_size()
    return min(table_bytes(tables), work.get("visits", 0) * row_bytes + work.get("tri_tests", 0) * 40)


def trace_bound(n_rays, tables, work, ray_bytes, out_bytes, n_dirs=1):
    n_bytes = n_rays * (ray_bytes + out_bytes) + walked_bytes(tables, work)
    n_ops = (OPS_BOX * work.get("box_tests", 0) + OPS_TRI * work.get("tri_tests", 0)
             + OPS_RAY * n_dirs * n_rays)
    return bound_ms(n_bytes, n_ops)


class PhaseClock:
    """Logs each phase's seconds."""

    def __init__(self):
        self.t = time.perf_counter()

    def done(self, name: str) -> None:
        now = time.perf_counter()
        log(f"phase {name}: {now - self.t:.1f} s")
        self.t = now


def path_rays(scene, closest, sun, cam):
    """1080p primary rays, and N_RANDOM bounce and shadow rays from primary
    surface points as at a path vertex, sorted by ray_sort_key (the shapes
    the main path gives the kernels)."""
    import torch

    from nebulae_tpu_torch.core import brdf
    from nebulae_tpu_torch.kernels.vertex import ray_sort_key
    from nebulae_tpu_torch.passes.gbuffer import camera_rays, render_gbuffer

    o, d = camera_rays(cam, WIDTH, HEIGHT)
    o, d = o.contiguous(), d.contiguous()
    gbuf = render_gbuffer(scene, closest, o, d)
    gen = torch.Generator(device=o.device).manual_seed(1234)
    hit_idx = torch.nonzero(gbuf["hit"])[:, 0]
    pick = hit_idx[torch.randint(0, hit_idx.numel(), (N_RANDOM,), device=o.device, generator=gen)]
    origin = brdf.offset_ray_origin(gbuf["position"][pick], gbuf["normal_g"][pick])
    u = torch.rand((4, N_RANDOM), device=o.device, generator=gen)
    bdir = brdf.cosine_hemisphere_sample(u[0], u[1], gbuf["normal_s"][pick])
    ldir = brdf.sun_disk_sample(u[2], u[3], sun.direction[None, :], sun.tan_half_angle)
    order = torch.argsort(ray_sort_key(origin, bdir, scene["aabb_min"], scene["aabb_max"]))
    ro, rb, rl = (x[order].contiguous() for x in (origin, bdir, ldir))
    return (o, d), (ro, rb, rl), gbuf, gen


class Held:
    """A kernel held against its plain version: max error, kernel ms
    (median of 7), plain ms, bound ms, summed over the passes of a chain."""

    def __init__(self):
        self.err = self.ms = self.plain_ms = self.bound = 0.0
        self.by = None
        self.work = {}

    def add(self, err, ms, plain_ms, bound):
        self.err = max(self.err, err)
        self.ms += ms
        self.plain_ms += plain_ms
        self.bound += bound[0]
        self.by = bound[1]

    def entry(self) -> dict:
        return dict(max_abs_err=self.err, ms=self.ms, plain_ms=self.plain_ms, bound_ms=self.bound,
                    bound_by=self.by)


def _hit_err(hk, hp, what):
    import torch

    assert torch.equal(hk["tri"], hp["tri"]), f"{what}: tri differs from its plain version"
    m = hp["tri"] >= 0
    for k in ("t", "u", "v"):
        torch.testing.assert_close(hk[k][m], hp[k][m], rtol=1e-6, atol=0.0)
    return max(float((hk[k][m] - hp[k][m]).abs().max()) if bool(m.any()) else 0.0 for k in ("t", "u", "v"))


def hold_closest(held, what, kernel, plain, o, d, tables, cap=float("inf")):
    """kernel(o, d, cap) against plain(o, d, cap, work): tri equal, t/u/v
    within rtol 1e-6.  Returns the kernel's hits."""
    hk = kernel(o, d, cap)
    work = {}
    t_plain = once_ms(lambda: work.update(res=plain(o, d, cap, work)))
    err = _hit_err(hk, work.pop("res"), what)
    ms = timed_ms(lambda: kernel(o, d, cap))
    cap_bytes = 4 if hasattr(cap, "shape") else 0
    held.add(err, ms, t_plain, trace_bound(o.shape[0], tables, work, 24 + cap_bytes, 16))
    _merge_work(held.work, work)
    return hk


def hold_any(held, what, kernel, plain, o, d, tables, cap=float("inf")):
    """As hold_closest for occlusion: occ equal.  Returns the kernel's occ."""
    import torch

    occ_k = kernel(o, d, cap)
    work = {}
    t_plain = once_ms(lambda: work.update(res=plain(o, d, cap, work)))
    occ_p = work.pop("res")
    assert torch.equal(occ_k, occ_p), f"{what}: occ differs from its plain version"
    ms = timed_ms(lambda: kernel(o, d, cap))
    cap_bytes = 4 if hasattr(cap, "shape") else 0
    held.add(0.0, ms, t_plain, trace_bound(o.shape[0], tables, work, 24 + cap_bytes, 1))
    _merge_work(held.work, work)
    return occ_k


def hold_combo(held, what, kernel, plain, o, b, l, tables, cap_b=float("inf"), cap_l=float("inf")):
    """As hold_closest for the fused walk: tri and occ equal."""
    import torch

    hk, occ_k = kernel(o, b, l, cap_b, cap_l)
    work = {}
    t_plain = once_ms(lambda: work.update(res=plain(o, b, l, cap_b, cap_l, work)))
    hp, occ_p = work.pop("res")
    err = _hit_err(hk, hp, what)
    assert torch.equal(occ_k, occ_p), f"{what}: occ differs from its plain version"
    ms = timed_ms(lambda: kernel(o, b, l, cap_b, cap_l))
    cap_bytes = 4 * hasattr(cap_b, "shape") + 4 * hasattr(cap_l, "shape")
    held.add(err, ms, t_plain, trace_bound(o.shape[0], tables, work, 36 + cap_bytes, 17, n_dirs=2))
    _merge_work(held.work, work)
    return hk, occ_k


def _same(k, p, what, exact=False):
    """A kernel's result equal to its plain version's: occ equal; tri equal
    and t/u/v within rtol 1e-6, or equal where `exact` (a fused walk gives
    both)."""
    import torch

    if isinstance(k, tuple):
        for a, b in zip(k, p, strict=True):
            _same(a, b, what, exact)
    elif isinstance(k, dict):
        assert _hit_err(k, p, what) == 0.0 or not exact, f"{what}: t, u or v differs from its plain version"
    else:
        assert torch.equal(k, p), f"{what}: occ differs from its plain version"


def stress(tag, kernel, plain, rays, n_caps, two_bodies=True, exact=False, cutoff=None) -> None:
    """kernel(*rays, *caps) against plain(*rays, *caps, {}) at 1, 31, 33 and
    4,097 rays (a partial warp, a warp and a lane, a partial block) and,
    where the kernel has a group body, at one ray more than that body takes
    (`cutoff`, by default group_rays(): a partial block of the
    thread-per-ray body).  The rays are spread over
    the given batch (origin first, then one direction per walk).  Each of
    the n_caps per-ray caps is 0 on some rays (as sorted_shadow_closest
    gives lanes that do not bounce or shoot) and short on others; some
    origins are dead and some first directions zero."""
    import torch

    from nebulae_tpu_torch.kernels.trace import group_rays
    from nebulae_tpu_torch.tracer.sorting import DEAD_ORIGIN

    sizes = (1, 31, 33, 4097) + (((cutoff or group_rays()) + 1,) if two_bodies else ())
    for n in sizes:
        pick = torch.linspace(0, rays[0].shape[0] - 1, n, device=rays[0].device).long()
        rs = [r[pick].clone() for r in rays]
        i = torch.arange(n, device=rs[0].device)
        caps = [torch.where(i % (3 + k) == 1, 0.0, torch.where(i % (3 + k) == 2, 2.0, float("inf")))
                for k in range(n_caps)]
        rs[0][i % 7 == 3] = DEAD_ORIGIN
        rs[1][i % 11 == 5] = 0.0
        _same(kernel(*rs, *caps), plain(*rs, *caps, {}), f"{tag} at {n} rays", exact)
    log(f"{tag} stress: {sizes} rays with zero and short caps and dead lanes equal their plain version"
        + (" (max error 0)" if exact else ""))


def recorded_launches(render, *wrappers) -> list:
    """The inputs of each launch of each wrapper in one render(), through
    the wrappers' record hooks: one list per wrapper, of (o, d, cap) for a
    closest-hit walk and (o, b, l, cap_b, cap_l) for a fused walk."""
    for w in wrappers:
        w.record = []
    try:
        render()
    finally:
        recs = [w.record for w in wrappers]
        for w in wrappers:
            w.record = None
    return recs


def node_launches(render) -> list:
    """Each K8 launch of one render() as (walk, o, d, tables, cap), walk
    "closest" or "any" (walk_launches' records of the two K8 wrappers)."""
    return [(name.split("_")[0], *rays, tables, *caps) for name, rays, caps, tables in walk_launches(render)
            if name.endswith("_node")]


def hold_node_launches(what, recs) -> tuple:
    """Each recorded K8 launch held against its plain version with max
    error 0 (t, tri, u, v and occ equal), timed on its own rays.  Returns
    the closest and any walks' Held, summed over the launches, and logs
    each launch."""
    from nebulae_tpu_torch.kernels import trace as kt

    held = {"closest": Held(), "any": Held()}
    for i, (walk, o, d, tab, cap) in enumerate(recs):
        h = Held()
        if walk == "closest":
            hit = hold_closest(h, f"{what} K8 closest launch {i}", lambda a, b, t: kt.closest_hit_node(a, b, tab, t),
                               lambda a, b, t, w: kt.closest_hit_node_plain(a, b, tab, t, work=w), o, d, tab, cap)
            live = int((hit["tri"] >= 0).sum())
        else:
            occ = hold_any(h, f"{what} K8 any launch {i}", lambda a, b, t: kt.any_hit_node(a, b, tab, t),
                           lambda a, b, t, w: kt.any_hit_node_plain(a, b, tab, t, work=w), o, d, tab, cap)
            live = int(occ.sum())
        assert h.err == 0.0, f"{what} K8 {walk} launch {i}: max error {h.err:.3g}"
        held[walk].add(h.err, h.ms, h.plain_ms, (h.bound, h.by))
        _merge_work(held[walk].work, h.work)
        leaf = tab["nodes"].shape[0] == 1
        log(f"{what} K8 {walk} launch {i}: {o.shape[0]} rays ({'one leaf of' if leaf else 'a tree over'} "
            f"{tab['tris'].shape[0]} slots x {tab['tris'].shape[1]}), {live} hit, kernel {h.ms:.4f} ms, plain "
            f"{h.plain_ms:.1f} ms, bound {h.bound:.5f} ms ({h.by}), work {h.work}; max error 0")
    for walk, h in held.items():
        log(f"{what} K8 {walk} over its {sum(r[0] == walk for r in recs)} launches: kernel {h.ms:.4f} ms, "
            f"plain {h.plain_ms:.1f} ms, bound {h.bound:.5f} ms ({h.by}), work {h.work}")
    return held["closest"], held["any"]


def _merge_work(into, work):
    for k, v in work.items():
        into[k] = into.get(k, 0) + v


def _merge_hits(best, hit):
    import torch

    if best is None:
        return hit
    take = hit["tri"] >= 0
    return {k: torch.where(take, hit[k], best[k]) for k in ("t", "tri", "u", "v")}


def _recording_adam():
    """The train step's Adam, keeping the last gradients for the report."""
    from nebulae_tpu_torch.engine.train import Adam

    class RecordingAdam(Adam):
        def apply(self, params, grads, opt_state):
            self.grads = [g.detach() for g in grads]
            return super().apply(params, grads, opt_state)

    return RecordingAdam()


def _grad_report(opt) -> dict:
    from nebulae_tpu_torch.config import SUN_LEAVES
    from nebulae_tpu_torch.engine.train import TRAINABLE_SCENE_KEYS

    names = list(TRAINABLE_SCENE_KEYS) + [f"sun.{k}" for k in SUN_LEAVES]
    return dict(zip(names, opt.grads))


# Kernel names as the profiler shows them; "combo_fat4", "any_fat4" and
# "combo_fat_" take both bodies of K2, K3 and K7b.
FAT4_KERNELS = ("closest_fat4_kernel", "combo_fat4", "any_fat4", "atrous_fwd_kernel", "vertex_kernel")
FAT2_KERNELS = ("closest_fat_kernel", "combo_fat_", "any_fat_", "atrous_fwd_kernel")
NODE_KERNELS = ("closest_node", "any_node")  # both bodies of each K8 walk


def train_phase(renderer, cam, cfg, wrappers, kernel_names=FAT4_KERNELS, what="train", phases=TRAIN_PHASES,
                nested=()) -> dict:
    """bench.py:107-123 on the port: params held fixed across the timed
    steps, the frame state threaded from step to step.  Returns the launch
    counts of the 4 steps (1 warm-up, 3 timed); logs under `what`."""
    import torch

    from nebulae_tpu_torch.engine.renderer import init_frame_state
    from nebulae_tpu_torch.engine.train import make_train_step, split_scene_params
    from nebulae_tpu_torch.kernels import svgf as ksvgf

    params, frozen = split_scene_params(renderer.scene)
    params["sun"] = renderer.sun
    opt = _recording_adam()
    step, _ = make_train_step(cfg, frozen, renderer.tables, optimizer=opt, device=renderer.device)
    opt_state = opt.init(params)
    state = init_frame_state(cfg, renderer.device)
    target = torch.zeros((HEIGHT, WIDTH, 3), dtype=torch.float32, device=renderer.device)
    counters = {**wrappers, "atrous_bwd": ksvgf.atrous_step_bwd}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _p, _o, state, loss, img = step(params, opt_state, cam, state, target)
    float(loss)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        _p, _o, state, loss, img = step(params, opt_state, cam, state, target)
        float(loss)
        times.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    grads = _grad_report(opt)
    assert bool(torch.isfinite(loss)) and bool(torch.isfinite(img).all()), "non-finite train step"
    for name, g in grads.items():
        assert bool(torch.isfinite(g).all()), f"non-finite gradient of {name}"
    for name in ("mat_base_color", "sun.radiance"):
        assert float(grads[name].abs().max()) > 0.0, f"zero gradient of {name}"
    per_step = {name: c / 4 for name, c in launches.items()}
    assert per_step["atrous_fwd"] == 4 and per_step["atrous_bwd"] == 4, f"a-trous launches {launches}"
    assert per_step.get("vertex", cfg.max_bounces) == cfg.max_bounces, f"K9 launches {launches}"
    missing = [name for name, c in launches.items() if c == 0]
    assert not missing, f"kernels not launched on the train path: {missing}"
    step_s = sum(times) / len(times)
    rays = WIDTH * HEIGHT * (1 + SPP * (2 * BOUNCES - 1))
    log(f"{what}: {step_s * 1e3:.2f} ms/step (mean of 3; steps {[round(t * 1e3, 2) for t in times]}), "
        f"{rays / step_s / 1e6:.2f} Mrays/s fwd+bwd, loss {float(loss):.6f}, "
        f"peak device memory {peak:.2f} GiB, launches per step {per_step}")
    log(f"{what}: gradient norms " + json.dumps(
        {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}))
    profile_frame(lambda: step(params, opt_state, cam, state, target), kernel_names + ("atrous_bwd_kernel",),
                  step_s * 1e3, phases=phases, what=f"{what} step", nested=nested)
    return launches


def small_frame_check(fs, options=None, env_map=None, what="small frame") -> None:
    """A 64x64 frame on the GPU (kernels) against the CPU (plain versions):
    hdr, denoised and ldr on >= 99% of pixels within rtol 1e-3 / atol 1e-4."""
    import torch

    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.utils.testscenes import bench_camera

    cfg = RenderConfig(width=64, height=64, max_bounces=BOUNCES, enable_svgf=True, enable_tonemap=True,
                       **(options or {}))
    cam = bench_camera(fs)
    out_g = Renderer(fs, cfg, env_map=env_map).render(cam)
    out_c = Renderer(fs, cfg, device="cpu", env_map=env_map).render(cam)
    for k in ("hdr", "denoised", "ldr"):
        a, b = out_g[k].cpu(), out_c[k]
        assert bool(torch.isfinite(a).all()), f"{what} {k} not finite"
        close = torch.isclose(a, b, rtol=1e-3, atol=1e-4).all(dim=-1).float().mean()
        assert float(close) >= 0.99, f"{what} {k}: only {float(close):.4f} of pixels agree"
    log(f"{what}: GPU agrees with the CPU plain path (ldr mean |d| "
        f"{float((out_g['ldr'].cpu() - out_c['ldr']).abs().mean()):.3g})")


def small_train_check(fs, options=None, env_map=None, what="small train step", camera=None) -> None:
    """A 64x64 train step on the GPU (kernels) against the CPU (plain
    versions): loss to a relative 1e-3, each gradient to a cosine >= 0.999
    (a gradient that is zero on the CPU must be zero on the GPU: the sky
    colour under enable_envmap).  With enable_nrc both start from the
    same cache (init_cache draws it on the CPU)."""
    import torch

    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer, init_frame_state
    from nebulae_tpu_torch.engine.train import make_train_step, split_scene_params
    from nebulae_tpu_torch.passes.gbuffer import make_camera_arrays
    from nebulae_tpu_torch.utils.testscenes import bench_camera

    cfg = RenderConfig(width=64, height=64, max_bounces=BOUNCES, enable_svgf=True, enable_tonemap=True,
                       **(options or {}))
    res = {}
    for device in ("cuda", "cpu"):
        r = Renderer(fs, cfg, device=device, env_map=env_map)
        params, frozen = split_scene_params(r.scene)
        params["sun"] = r.sun
        opt = _recording_adam()
        step, _ = make_train_step(cfg, frozen, r.tables, optimizer=opt, device=device)
        cam = make_camera_arrays(camera or bench_camera(fs), 64, 64, device)
        target = torch.zeros((64, 64, 3), dtype=torch.float32, device=device)
        _p, _o, _s, loss, _img = step(params, opt.init(params), cam, init_frame_state(cfg, device), target)
        res[device] = (float(loss), {k: g.double().cpu() for k, g in _grad_report(opt).items()})
    (lg, gg), (lc, gc) = res["cuda"], res["cpu"]
    assert abs(lg - lc) <= 1e-3 * abs(lc), f"{what} loss {lg} vs CPU {lc}"
    cos = {}
    for k in gc:
        a, b = gg[k].reshape(-1), gc[k].reshape(-1)
        if not bool(b.any()):
            assert not bool(a.any()), f"{what} gradient {k}: zero on the CPU, not on the GPU"
            cos[k] = "zero on both"
            continue
        cos[k] = float(a @ b / (torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b)))
        assert cos[k] >= 0.999, f"{what} gradient {k}: cosine {cos[k]}"
    log(f"{what}: GPU loss {lg:.6f} vs CPU {lc:.6f}; gradient cosines "
        + json.dumps({k: v if isinstance(v, str) else round(v, 6) for k, v in cos.items()}))


# The triangle-chunk budget for the 247k scene's "tri" renderer.  JAX's
# 13 MB holds its 246,528 triangles in one chunk by pack_bvh_tri_chunks'
# count (slots x G >= triangles), so "tri" falls back to subtree chunks in
# both packages; 10 MB cuts the triangles into two chunks.
TRI_BUDGET_LARGE = 10 * 1024 * 1024
LARGE_ROUTES = {"auto": "single", "subtree": "subtree", "tri": "tri", "paged": "paged"}


def new_wrappers() -> dict:
    """The kernels line's entries added by the large-scene and fat2 phases,
    by the wrapper that counts each one's launches."""
    from nebulae_tpu_torch.kernels import trace as kt

    return {
        "closest_fat": kt.closest_hit_fat,
        "shadow_closest_fat": kt.shadow_closest_fat,
        "any_fat": kt.any_hit_fat,
        "closest_fat4_slots": kt.closest_hit_fat4_slots,
        "shadow_closest_fat4_slots": kt.shadow_closest_fat4_slots,
        "any_fat4_slots": kt.any_hit_fat4_slots,
        "closest_fat4_paged": kt.closest_hit_fat4_paged,
        "shadow_closest_fat4_paged": kt.shadow_closest_fat4_paged,
        "any_fat4_paged": kt.any_hit_fat4_paged,
        "closest_node": kt.closest_hit_node,
        "any_node": kt.any_hit_node,
    }


def _read_launches(launches, n, names):
    """Copy the counts of `names` from a run's counts n (keyed by wrapper
    name) and fail if any of them did not launch."""
    new = new_wrappers()
    for name in names:
        launches[name] = n[new[name].__name__]
    missing = [name for name in names if launches[name] == 0]
    assert not missing, f"kernels not launched on their route: {missing}"


def _zero(wrappers):
    for fn in wrappers.values():
        fn.launches = 0


def _frames(renderer, cam_obj, wrappers, n_timed=3):
    """1 warm-up and n_timed timed frames with the launch counts read
    around them: (outputs of the last frame, mean ms, frame ms, launches)."""
    import torch

    _zero(wrappers)
    out = renderer.render(cam_obj)
    torch.cuda.synchronize()
    times = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        out = renderer.render(cam_obj)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    ldr = out["ldr"]
    assert ldr.shape == (HEIGHT, WIDTH, 3) and bool(torch.isfinite(ldr).all()), "non-finite frame"
    assert float(ldr.std()) > 1e-3, "constant frame"
    return out, sum(times) / len(times), times, launches


def hold_frame(what, out, ref, ref_name):
    """A frame against a reference frame: hit mask equal and >= 99% of
    pixels within rtol 1e-3 / atol 1e-4 (an exact t tie may keep another
    triangle).  Logs the shares."""
    import torch

    assert torch.equal(out["hit"], ref["hit"]), f"{what}: hit mask differs from {ref_name}"
    close = torch.isclose(out["ldr"], ref["ldr"], rtol=1e-3, atol=1e-4).all(dim=-1).float().mean()
    same = (out["ldr"] == ref["ldr"]).all(dim=-1).float().mean()
    assert float(close) >= 0.99, f"{what}: only {float(close):.4f} of pixels agree with {ref_name}"
    log(f"{what}: {float(close):.6f} of pixels within rtol 1e-3 / atol 1e-4 of {ref_name}, "
        f"{float(same):.6f} bit-identical")


def _slot_fns(c):
    """K6b's kernels and plain versions on tri chunk c, as hold_chain takes them."""
    from nebulae_tpu_torch.kernels import trace as kt

    sr = (c["slot_lo"], c["slot_hi"])
    return (lambda a, b, t: kt.closest_hit_fat4_slots(a, b, c, t),
            lambda a, b, t, w: kt.closest_hit_fat4_plain(a, b, c, t, work=w, slot_range=sr),
            lambda a, b, l_, tb, tl: kt.shadow_closest_fat4_slots(a, b, l_, c, tb, tl),
            lambda a, b, l_, tb, tl, w: kt.shadow_closest_fat4_plain(a, b, l_, c, tb, tl, work=w, slot_range=sr),
            lambda a, b, t: kt.any_hit_fat4_slots(a, b, c, t),
            lambda a, b, t, w: kt.any_hit_fat4_plain(a, b, c, t, work=w, slot_range=sr))


def _chunk_fns(c):
    """K1-K3 on a fat4 subtree chunk, K7 on a fat2 one, K8 on a single-leaf
    one (its fused walk is K8 closest then K8 any)."""
    from nebulae_tpu_torch.kernels import trace as kt

    if "fatnodes" in c:
        return (lambda a, b, t: kt.closest_hit_fat(a, b, c, t),
                lambda a, b, t, w: kt.closest_hit_fat_plain(a, b, c, t, work=w),
                lambda a, b, l_, tb, tl: kt.shadow_closest_fat(a, b, l_, c, tb, tl),
                lambda a, b, l_, tb, tl, w: kt.shadow_closest_fat_plain(a, b, l_, c, tb, tl, work=w),
                lambda a, b, t: kt.any_hit_fat(a, b, c, t),
                lambda a, b, t, w: kt.any_hit_fat_plain(a, b, c, t, work=w))
    if "fat4nodes" in c:
        return (lambda a, b, t: kt.closest_hit_fat4(a, b, c, t),
                lambda a, b, t, w: kt.closest_hit_fat4_plain(a, b, c, t, work=w),
                lambda a, b, l_, tb, tl: kt.shadow_closest_fat4(a, b, l_, c, tb, tl),
                lambda a, b, l_, tb, tl, w: kt.shadow_closest_fat4_plain(a, b, l_, c, tb, tl, work=w),
                lambda a, b, t: kt.any_hit_fat4(a, b, c, t),
                lambda a, b, t, w: kt.any_hit_fat4_plain(a, b, c, t, work=w))
    return (lambda a, b, t: kt.closest_hit_node(a, b, c, t),
            lambda a, b, t, w: kt.closest_hit_node_plain(a, b, c, t, work=w),
            lambda a, b, l_, tb, tl: (kt.closest_hit_node(a, b, c, tb), kt.any_hit_node(a, l_, c, tl)),
            lambda a, b, l_, tb, tl, w: (kt.closest_hit_node_plain(a, b, c, tb, work=w),
                                         kt.any_hit_node_plain(a, l_, c, tl, work=w)),
            lambda a, b, t: kt.any_hit_node(a, b, c, t),
            lambda a, b, t, w: kt.any_hit_node_plain(a, b, c, t, work=w))


def hold_chain(tag, chunks, fns, primary, secondary):
    """Each chunk's closest (primary rays), fused (secondary rays) and any
    (shadow rays) held against their plain versions under the caps the
    chains give them: min(best t) for closest, a shadow cap of 0 once
    occluded, occluded rays ejected before the next any pass.  Returns
    three Held and the chains' (closest hits, fused hits, fused occ, any
    occ)."""
    import torch

    from nebulae_tpu_torch.kernels import trace as kt

    (o, d), (ro, rb, rl) = primary, secondary
    held = (Held(), Held(), Held())
    best = best_b = occ_l = occ = None
    for c in chunks:
        closest, closest_p, combo, combo_p, any_k, any_p = fns(c)
        cap = float("inf") if best is None else best["t"]
        best = _merge_hits(best, hold_closest(held[0], f"{tag} closest", closest, closest_p, o, d, c, cap))
        cap_b = float("inf") if best_b is None else best_b["t"]
        cap_l = float("inf") if occ_l is None else torch.where(occ_l, 0.0, float("inf"))
        hb, ol = hold_combo(held[1], f"{tag} fused", combo, combo_p, ro, rb, rl, c, cap_b, cap_l)
        best_b = _merge_hits(best_b, hb)
        occ_l = ol if occ_l is None else occ_l | ol
        o_live = ro if occ is None else torch.where(occ[:, None], 10.0 * kt.DEAD_RAY_ORIGIN, ro)
        oc = hold_any(held[2], f"{tag} any", any_k, any_p, o_live, rl, c)
        occ = oc if occ is None else occ | oc
    return held, (best, best_b, occ_l, occ)


def step_launches(renderer, cam, wrappers, kernel_names=(), what="step") -> dict:
    """One 1080p train step with a renderer's tables and config: its
    launch counts.  With `kernel_names`, a second step timed and a third
    profiled (those kernels' device ms, K5's and the phases')."""
    import torch

    from nebulae_tpu_torch.engine.renderer import init_frame_state
    from nebulae_tpu_torch.engine.train import make_train_step, split_scene_params

    params, frozen = split_scene_params(renderer.scene)
    params["sun"] = renderer.sun
    cfg = renderer.cfg
    step, opt = make_train_step(cfg, frozen, renderer.tables, device=renderer.device)
    target = torch.zeros((HEIGHT, WIDTH, 3), dtype=torch.float32, device=renderer.device)
    opt_state = opt.init(params)
    _zero(wrappers)
    _p, _o, _s, loss, _img = step(params, opt_state, cam, init_frame_state(cfg, renderer.device), target)
    assert bool(torch.isfinite(loss)), "non-finite train step"
    launches = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
    if kernel_names:
        state = init_frame_state(cfg, renderer.device)
        step_ms = once_ms(lambda: float(step(params, opt_state, cam, state, target)[3]))
        profile_frame(lambda: step(params, opt_state, cam, state, target), kernel_names + ("atrous_bwd_kernel",),
                      step_ms, phases=TRAIN_PHASES, what=what)
    return launches


def large_phase(base_cfg) -> tuple[dict, dict]:
    """Phase 7: scenes past the single-table gate.  Returns (report
    entries, launch counts) of K6a, K6b and K8."""
    import dataclasses

    import torch

    from nebulae_tpu_torch.bvh.cbuilder import build_bvh_native
    from nebulae_tpu_torch.engine.renderer import Renderer, init_frame_state
    from nebulae_tpu_torch.kernels import chunks as kc
    from nebulae_tpu_torch.kernels import svgf as ksvgf
    from nebulae_tpu_torch.kernels import trace as kt
    from nebulae_tpu_torch.passes.gbuffer import make_camera_arrays
    from nebulae_tpu_torch.tracer.trace import make_tracer
    from nebulae_tpu_torch.utils.testscenes import bench_camera, box_scene, huge_scene, large_scene

    dev = torch.device("cuda")
    report, launches = {}, {}
    clock = PhaseClock()
    wrappers = {f.__name__: f for f in kt.WRAPPERS}
    wrappers["atrous_fwd"] = ksvgf.atrous_step

    # 7a. The 247k scene on every chunk_mode.
    fs = large_scene(seed=0)
    bvh = build_bvh_native(fs.tri_pos, max_leaf=15)
    cfg = dataclasses.replace(base_cfg, lean_outputs=False)
    default_budget = kc.TRI_CHUNK_TABLE_BUDGET
    log(f"large: {fs.num_triangles} triangles, {bvh.num_nodes} BVH nodes; at the default "
        f"{default_budget} B budget pack_bvh_tri_chunks gives "
        f"{kc.pack_bvh_tri_chunks(bvh, fs.tri_pos, cfg.bvh_tri_group)}")
    renderers = {}
    for mode, route in LARGE_ROUTES.items():
        kc.TRI_CHUNK_TABLE_BUDGET = TRI_BUDGET_LARGE if mode == "tri" else default_budget
        t0 = time.perf_counter()
        r = Renderer(fs, dataclasses.replace(cfg, chunk_mode=mode), bvh=bvh)
        setup = time.perf_counter() - t0
        kc.TRI_CHUNK_TABLE_BUDGET = default_budget
        n_chunks = len(r.tables.get("chunks", r.tables.get("tri_chunks", [])))
        log(f"large: chunk_mode={mode} -> route {r.route}, {n_chunks} chunks, {table_bytes(r.tables)} B "
            f"(JAX layout {jax_layout_bytes(r.tables)} B), set up in {setup:.2f} s")
        assert r.route == route, f"chunk_mode={mode} took route {r.route}, expected {route}"
        renderers[mode] = r
    auto = renderers["auto"]
    cam_obj = bench_camera(fs)
    cam = make_camera_arrays(cam_obj, WIDTH, HEIGHT, dev)
    (o, d), (ro, rb, rl), _, _ = path_rays(
        auto.scene, lambda a, b: kt.closest_hit_fat4(a, b, auto.tables), auto.sun, cam)

    # K6b: the gated K1-K3 chained over the tri route's chunks; K6c: K1-K3
    # (or K8 on a single-leaf chunk) chained over the subtree chunks.
    one = kt.closest_hit_fat4(o, d, auto.tables)
    hs, os_ = kt.shadow_closest_fat4(ro, rb, rl, auto.tables)
    occ_any = kt.any_hit_fat4(ro, rl, auto.tables)
    for tag, mode, fns in (("K6b", "tri", _slot_fns), ("K6c", "subtree", _chunk_fns)):
        chunks = renderers[mode].tables["tri_chunks" if mode == "tri" else "chunks"]
        held, (best, best_b, occ_l, occ) = hold_chain(tag, chunks, fns, (o, d), (ro, rb, rl))
        # The chains end where the single table does.
        assert torch.equal(best["t"], one["t"]), f"{tag} closest chain differs from the single table"
        assert torch.equal(best_b["t"], hs["t"]) and torch.equal(occ_l, os_), f"{tag} fused chain differs"
        assert torch.equal(occ, occ_any), f"{tag} any chain differs"
        for kind, h in zip(("closest", "shadow_closest", "any"), held):
            if tag == "K6b":
                report[f"{kind}_fat4_slots"] = h.entry()
            log(f"{tag} {kind} over {len(chunks)} chunks: kernels {h.ms:.3f} ms, plain {h.plain_ms:.1f} ms, "
                f"bound {h.bound:.4f} ms ({h.by}), max err {h.err:.3g}, work {h.work}")

    # K8's general walk over the same BVH in the one-node layout: the whole
    # tree, a walk no route runs (K8's routes walk one node), held with max
    # error 0 at 1080p, 2^21 rays and the stress sizes (both bodies).
    nodes = kt.tables_to(kt.pack_bvh_nodes(bvh, fs.tri_pos, cfg.bvh_tri_group), dev)
    h8c, h8a = Held(), Held()
    hit = hold_closest(h8c, "K8 closest", lambda a, b, t: kt.closest_hit_node(a, b, nodes, t),
                       lambda a, b, t, w: kt.closest_hit_node_plain(a, b, nodes, t, work=w), o, d, nodes)
    assert torch.equal(hit["t"], one["t"]), "K8 closest differs from K1 in t"
    oc = hold_any(h8a, "K8 any", lambda a, b, t: kt.any_hit_node(a, b, nodes, t),
                  lambda a, b, t, w: kt.any_hit_node_plain(a, b, nodes, t, work=w), ro, rl, nodes)
    assert torch.equal(oc, occ_any), "K8 any differs from K3"
    assert h8c.err == 0.0, f"K8 closest over the 247k tree: max error {h8c.err:.3g}"
    for name, h in (("closest_node", h8c), ("any_node", h8a)):
        log(f"K8 {name} over the whole 247k tree: {h.ms:.3f} ms, plain {h.plain_ms:.1f} ms, bound "
            f"{h.bound:.4f} ms ({h.by}), work {h.work}, stack depth {nodes['stack_depth']}")
    stress("K8 closest 247k tree", lambda a, b, t: kt.closest_hit_node(a, b, nodes, t),
           lambda a, b, t, w: kt.closest_hit_node_plain(a, b, nodes, t, work=w), (ro, rb), 1, exact=True,
           cutoff=kt.node_group_rays())
    stress("K8 any 247k tree", lambda a, b, t: kt.any_hit_node(a, b, nodes, t),
           lambda a, b, t, w: kt.any_hit_node_plain(a, b, nodes, t, work=w), (ro, rl), 1, two_bodies=False,
           exact=True)
    # One trace of each kind through each route's tracer (chains included).
    for mode, r in renderers.items():
        closest, any_hit = make_tracer(r.scene, r.tables, r.cfg, device=dev)
        ms = (timed_ms(lambda: closest(o, d)),
              timed_ms(lambda: closest.combo(ro, rb, rl, float("inf"), float("inf"))),
              timed_ms(lambda: any_hit(ro, rl)))
        log(f"large trace {mode} ({r.route}): closest {ms[0]:.3f} ms (1080p), fused {ms[1]:.3f} ms, "
            f"any {ms[2]:.3f} ms (2^21 rays)")
    del o, d, ro, rb, rl, best, best_b, occ, occ_l, one, hs, os_, occ_any, nodes, hit, oc
    clock.done("large 247k kernels")

    # Frames on each route; tri, subtree and paged against auto's.
    outs = {}
    for mode, r in renderers.items():
        out, mean_ms, times, n = _frames(r, cam_obj, wrappers)
        outs[mode] = {k: out[k] for k in ("ldr", "hit")}
        log(f"large frame {mode} ({r.route}): {mean_ms:.2f} ms/frame (frames {[round(t, 2) for t in times]}), "
            f"launches {json.dumps({k: v for k, v in n.items() if v})}")
        profile_frame(lambda: r.render(cam_obj), ("fat4_", "atrous_fwd_kernel"), mean_ms,
                      what=f"{mode} frame")
        if mode == "tri":
            _read_launches(launches, n, ("closest_fat4_slots", "shadow_closest_fat4_slots", "any_fat4_slots"))
    for mode in ("tri", "subtree"):
        n = step_launches(renderers[mode], cam, wrappers, ("closest_fat4", "combo_fat4", "any_fat4"),
                          f"large {mode} step")
        log(f"large train step {mode}: launches {json.dumps(n)}")
    ref = outs["auto"]
    assert torch.equal(outs["paged"]["ldr"], ref["ldr"]), "paged frame differs from the single-table frame"
    for mode in ("tri", "subtree"):
        hold_frame(f"large frame {mode}", outs[mode], ref, "auto")
    del renderers, auto, outs, ref
    clock.done("large 247k frames")

    # 7b. The ~2M scene under auto: the paged route (K6a).
    fs2 = huge_scene(seed=0)
    t0 = time.perf_counter()
    bvh2 = build_bvh_native(fs2.tri_pos, max_leaf=15)
    r2 = Renderer(fs2, base_cfg, bvh=bvh2)
    setup = time.perf_counter() - t0
    log(f"huge: {fs2.num_triangles} triangles -> route {r2.route}, {table_bytes(r2.tables)} B "
        f"(JAX layout {jax_layout_bytes(r2.tables)} B, gate {kc.SINGLE_TABLE_MAX_BYTES} B), "
        f"stack depth {r2.tables['stack_depth']}, BVH and set-up {setup:.2f} s")
    assert r2.route == "paged", f"the ~2M scene took route {r2.route}"
    cam_obj2 = bench_camera(fs2)
    cam2 = make_camera_arrays(cam_obj2, WIDTH, HEIGHT, dev)
    (o, d), (ro, rb, rl), _, _ = path_rays(
        r2.scene, lambda a, b: kt.closest_hit_fat4_paged(a, b, r2.tables), r2.sun, cam2)
    tab = r2.tables
    for name, fn in (
        ("closest_fat4_paged", lambda h: hold_closest(
            h, "K6a closest", lambda a, b, t: kt.closest_hit_fat4_paged(a, b, tab, t),
            lambda a, b, t, w: kt.closest_hit_fat4_plain(a, b, tab, t, work=w), o, d, tab)),
        ("shadow_closest_fat4_paged", lambda h: hold_combo(
            h, "K6a combo", lambda a, b, l_, tb, tl: kt.shadow_closest_fat4_paged(a, b, l_, tab, tb, tl),
            lambda a, b, l_, tb, tl, w: kt.shadow_closest_fat4_plain(a, b, l_, tab, tb, tl, work=w),
            ro, rb, rl, tab)),
        ("any_fat4_paged", lambda h: hold_any(
            h, "K6a any", lambda a, b, t: kt.any_hit_fat4_paged(a, b, tab, t),
            lambda a, b, t, w: kt.any_hit_fat4_plain(a, b, tab, t, work=w), ro, rl, tab)),
    ):
        h = Held()
        fn(h)
        report[name] = h.entry()
        log(f"K6a {name}: kernel {h.ms:.3f} ms, plain {h.plain_ms:.1f} ms, bound {h.bound:.4f} ms "
            f"({h.by}), max err {h.err:.3g}, work {h.work}")
    stress("K6a", lambda a, b, l_, tb, tl: kt.shadow_closest_fat4_paged(a, b, l_, tab, tb, tl),
           lambda a, b, l_, tb, tl, w: kt.shadow_closest_fat4_plain(a, b, l_, tab, tb, tl, work=w),
           (ro, rb, rl), 2)
    stress("K6a any", lambda a, b, t: kt.any_hit_fat4_paged(a, b, tab, t),
           lambda a, b, t, w: kt.any_hit_fat4_plain(a, b, tab, t, work=w), (ro, rl), 1)
    del o, d, ro, rb, rl
    clock.done("huge kernels")
    paged = {"closest_fat4_paged": kt.closest_hit_fat4_paged,
             "shadow_closest_fat4_paged": kt.shadow_closest_fat4_paged,
             "any_fat4_paged": kt.any_hit_fat4_paged, "atrous_fwd": ksvgf.atrous_step}
    torch.cuda.reset_peak_memory_stats()
    out, mean_ms, times, n = _frames(r2, cam_obj2, wrappers)
    rays = WIDTH * HEIGHT * (1 + SPP * (2 * BOUNCES - 1))
    log(f"huge frame: {mean_ms:.2f} ms/frame (frames {[round(t, 2) for t in times]}), "
        f"{rays / mean_ms / 1e3:.2f} Mrays/s, ldr mean {float(out['ldr'].mean()):.4f}, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches {json.dumps({k: v for k, v in n.items() if v})}")
    _read_launches(launches, n, ("closest_fat4_paged", "shadow_closest_fat4_paged", "any_fat4_paged"))
    assert n["closest_hit_fat4"] == n["shadow_closest_fat4"] == n["any_hit_fat4"] == 0, "resident K1-K3 ran"
    profile_frame(lambda: r2.render(cam_obj2), FAT4_KERNELS, mean_ms, what="huge frame")
    del out
    train_phase(r2, cam2, base_cfg, paged)
    clock.done("huge frames and train")

    # 7b'. The same scene and BVH with bvh_wide=2 under auto: fat2 subtree
    # chunks (K7 chained), its frames held against the paged fat4 frames
    # (both with full outputs, from a fresh frame state).
    r2.update_config(cfg)
    r2.state = init_frame_state(cfg, dev)
    out4, ms4f, times4, _ = _frames(r2, cam_obj2, wrappers)
    del r2
    t0 = time.perf_counter()
    r2f = Renderer(fs2, dataclasses.replace(cfg, bvh_wide=2), bvh=bvh2)
    setup = time.perf_counter() - t0
    chunks = r2f.tables.get("chunks", [])
    log(f"fat2 huge: {fs2.num_triangles} triangles -> route {r2f.route}, {len(chunks)} chunks "
        f"({sum('fatnodes' in c for c in chunks)} fat2, {sum('nodes' in c for c in chunks)} one-node), "
        f"{table_bytes(r2f.tables)} B (JAX layout {jax_layout_bytes(r2f.tables)} B), "
        f"stack depths {sorted({c['stack_depth'] for c in chunks})}, set up in {setup:.2f} s")
    assert r2f.route == "subtree" and any("fatnodes" in c for c in chunks), r2f.route
    torch.cuda.reset_peak_memory_stats()
    out2, ms2f, times2, n = _frames(r2f, cam_obj2, wrappers)
    log(f"fat2 huge frame: {ms2f:.2f} ms/frame (frames {[round(t, 2) for t in times2]}), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; paged fat4 frame {ms4f:.2f} ms (frames "
        f"{[round(t, 2) for t in times4]}); launches {json.dumps({k: v for k, v in n.items() if v})}")
    assert n["closest_hit_fat"] > 0 and n["shadow_closest_fat"] > 0 and n["any_hit_fat"] > 0, "K7 chains idle"
    hold_frame("fat2 huge frame", out2, out4, "the 2M paged fat4 frame")
    # K7a, K7b, K7c and K8 (the one-node chunks) each apart.
    profile_frame(lambda: r2f.render(cam_obj2), FAT2_KERNELS + NODE_KERNELS, ms2f, what="fat2 huge frame")
    # K8 on each of its launches in one frame: the single-leaf chunks.
    recs = node_launches(lambda: r2f.render(cam_obj2))
    assert {r[0] for r in recs} == {"closest", "any"}, "the one-node chunks launched no K8"
    hold_node_launches("fat2 huge frame", recs)
    del out2, out4, r2f, fs2, bvh2, recs
    torch.cuda.empty_cache()
    clock.done("huge fat2 frames")

    # 7c. A BVH whose root is a leaf: the one-node route (K8) at 1080p.
    box = box_scene()
    cam_box = bench_camera(box)
    rb8 = Renderer(box, dataclasses.replace(cfg, tracer="pallas"))
    assert rb8.route == "node", rb8.route
    out, mean_ms, times, n = _frames(rb8, cam_box, wrappers, n_timed=1)
    _read_launches(launches, n, ("closest_node", "any_node"))
    # Against brute force: a ray grazing the box's silhouette can pass the
    # triangle test and fail the leaf's slab test (or the reverse), so a few
    # of the 2M hit decisions may differ.
    # Its second frame, as _frames renders two (SVGF accumulates).
    rbf = Renderer(box, dataclasses.replace(cfg, tracer="bruteforce"))
    rbf.render(cam_box)
    brute = rbf.render(cam_box)
    same_hit = (out["hit"] == brute["hit"]).float().mean()
    close = torch.isclose(out["ldr"], brute["ldr"], rtol=1e-3, atol=1e-4).all(dim=-1).float().mean()
    assert float(same_hit) >= 0.999 and float(close) >= 0.99, "K8 frame differs from brute force"
    log(f"box frame (one-node route): {mean_ms:.2f} ms, hit {float(out['hit'].float().mean()):.3f}; against "
        f"brute force {int((out['hit'] != brute['hit']).sum())} hit decisions differ, {float(close):.6f} "
        f"of pixels agree; launches {json.dumps({k: v for k, v in n.items() if v})}")
    profile_frame(lambda: rb8.render(cam_box), NODE_KERNELS + ("atrous_fwd_kernel",), mean_ms, what="box frame")
    # K8 on each of the box frame's launches (the kernels line's entries),
    # and on the box's one leaf at the stress sizes.
    recs = node_launches(lambda: rb8.render(cam_box))
    report["closest_node"], report["any_node"] = (h.entry() for h in hold_node_launches("box frame", recs))
    leaf = rb8.tables
    o8, d8 = next((r[1], r[2]) for r in recs if r[0] == "closest")
    stress("K8 closest box", lambda a, b, t: kt.closest_hit_node(a, b, leaf, t),
           lambda a, b, t, w: kt.closest_hit_node_plain(a, b, leaf, t, work=w), (o8, d8), 1, exact=True,
           cutoff=kt.node_group_rays())
    stress("K8 any box", lambda a, b, t: kt.any_hit_node(a, b, leaf, t),
           lambda a, b, t, w: kt.any_hit_node_plain(a, b, leaf, t, work=w), (o8, d8), 1, two_bodies=False,
           exact=True)
    del recs, o8, d8
    cam_box_arrays = make_camera_arrays(cam_box, WIDTH, HEIGHT, dev)
    n = step_launches(rb8, cam_box_arrays, wrappers, NODE_KERNELS, "box step")
    log(f"box train step: launches {json.dumps(n)}")
    clock.done("box frame")
    return report, launches


def instance_moves(fs):
    """Per-instance 3x4 transforms for update_instances: every third torus
    turns 0.5 rad about the vertical through its centre and slides 0.3
    along x, inside the scene's extents; the rest and the ground plane (the
    last instance) stay."""
    import numpy as np

    n = int(fs.instance_of_tri.max()) + 1
    moves = np.tile(np.eye(3, 4, dtype=np.float32), (n, 1, 1))
    c, s = np.cos(0.5), np.sin(0.5)
    rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float32)
    for i in range(0, n - 1, 3):
        centre = fs.tri_pos[fs.instance_of_tri == i].reshape(-1, 3).mean(axis=0)
        moves[i, :, :3] = rot
        moves[i, :, 3] = centre + np.float32([0.3, 0.0, 0.0]) - rot @ centre
    return moves


def rebuilt(fs, renderer):
    """A Renderer built from scratch (its own BVH and tables) on a refit
    renderer's triangles, copied back so that the geometry is bit-identical."""
    import dataclasses

    from nebulae_tpu_torch.engine.renderer import Renderer

    host = {k: renderer.scene[k].cpu().numpy() for k in ("tri_pos", "tri_nrm", "tri_tan", "tri_face_nrm")}
    return Renderer(dataclasses.replace(fs, **host), renderer.cfg)


def timed_updates(fn) -> list[float]:
    """1 warm-up and 3 timed calls of fn on the host clock, each closed by a
    sync: the seconds of the warm-up, then the timed ms."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    times = [time.perf_counter() - t0]
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def dynamic_frames(tag, fs, renderer, cam_obj, wrappers):
    """update_instances on a renderer: its seconds, then 1 + 3 frames held
    against a rebuild on the moved triangles and against the frame before
    the move.  Returns the launch counts of the refit frames."""
    import torch

    from nebulae_tpu_torch.engine.renderer import init_frame_state

    route = renderer.route
    before, _, _, _ = _frames(renderer, cam_obj, wrappers)
    moves = instance_moves(fs)
    times = timed_updates(lambda: renderer.update_instances(moves))
    log(f"dynamic {tag}: route {route} -> {renderer.route}; update_instances first call {times[0]:.3f} s, "
        f"then {statistics.mean(times[1:]):.2f} ms (runs {[round(t, 2) for t in times[1:]]})")
    # The refit's device time, idle share and host syncs (the closing
    # synchronize is the only one it should show).
    profile_frame(lambda: renderer.update_instances(moves), (), statistics.mean(times[1:]), phases=(),
                  what="update_instances")
    renderer.state = init_frame_state(renderer.cfg, renderer.device)
    out, mean_ms, ftimes, n = _frames(renderer, cam_obj, wrappers)
    t0 = time.perf_counter()
    ref_r = rebuilt(fs, renderer)
    log(f"dynamic {tag}: rebuild (BVH and tables) {time.perf_counter() - t0:.2f} s, route {ref_r.route}")
    ref, ref_ms, _, _ = _frames(ref_r, cam_obj, wrappers)
    moved = (out["ldr"] != before["ldr"]).any(dim=-1).float().mean()
    assert float(moved) > 0.01, f"dynamic {tag}: the frame did not change after the move"
    log(f"dynamic {tag}: refit frame {mean_ms:.2f} ms (frames {[round(t, 2) for t in ftimes]}), rebuilt "
        f"{ref_ms:.2f} ms; {float(moved):.4f} of pixels changed by the move; launches "
        f"{json.dumps({k: v for k, v in n.items() if v})}")
    hold_frame(f"dynamic {tag}", out, ref, "the rebuild")
    # Refit boxes are looser than a fresh build's: the walks' device time on
    # each (the names match the fat2 and fat4 kernels alike).
    walks = ("closest_fat", "combo_fat", "any_fat")
    profile_frame(lambda: renderer.render(cam_obj), walks, mean_ms, what=f"{tag} refit frame")
    profile_frame(lambda: ref_r.render(cam_obj), walks, ref_ms, what=f"{tag} rebuilt frame")
    del ref_r, before, out, ref
    torch.cuda.empty_cache()
    return n


def fat2_phase(base_cfg, fs, bvh) -> tuple[dict, dict]:
    """Phase 8: bvh_wide=2 (K7) and dynamic scenes.  Returns (report
    entries, launch counts) of K7, counted over the fat2 frames."""
    import dataclasses

    import torch

    from nebulae_tpu_torch.bvh.cbuilder import build_bvh_native
    from nebulae_tpu_torch.engine.renderer import Renderer, init_frame_state
    from nebulae_tpu_torch.kernels import svgf as ksvgf
    from nebulae_tpu_torch.kernels import trace as kt
    from nebulae_tpu_torch.passes.gbuffer import make_camera_arrays
    from nebulae_tpu_torch.utils.testscenes import bench_camera, large_scene

    dev = torch.device("cuda")
    report, launches = {}, {}
    clock = PhaseClock()
    wrappers = {f.__name__: f for f in kt.WRAPPERS}
    wrappers["atrous_fwd"] = ksvgf.atrous_step
    cfg = dataclasses.replace(base_cfg, lean_outputs=False)
    cfg2 = dataclasses.replace(cfg, bvh_wide=2)

    # 8a. K7 against its plain versions over the bench scene's fat2 table.
    t0 = time.perf_counter()
    r2 = Renderer(fs, cfg2, bvh=bvh)
    setup = time.perf_counter() - t0
    tab = r2.tables
    log(f"fat2: route {r2.route}, {tab['fatnodes'].shape[0]} fat2 rows, {tab['tris'].shape[0]} slots, "
        f"{table_bytes(tab)} B (JAX layout {jax_layout_bytes(tab)} B), stack depth {tab['stack_depth']}, "
        f"set up in {setup:.2f} s")
    assert r2.route == "single" and "fatnodes" in tab, f"bvh_wide=2 took route {r2.route}"
    r4 = Renderer(fs, cfg, bvh=bvh)
    t4 = r4.tables
    cam_obj = bench_camera(fs)
    cam = make_camera_arrays(cam_obj, WIDTH, HEIGHT, dev)
    (o, d), (ro, rb, rl), _, _ = path_rays(r2.scene, lambda a, b: kt.closest_hit_fat(a, b, tab), r2.sun, cam)
    held = {}
    for name, tag, fn in (
        ("closest_fat", "K7a closest", lambda h: hold_closest(
            h, "K7a", lambda a, b, t: kt.closest_hit_fat(a, b, tab, t),
            lambda a, b, t, w: kt.closest_hit_fat_plain(a, b, tab, t, work=w), o, d, tab)),
        ("shadow_closest_fat", "K7b fused", lambda h: hold_combo(
            h, "K7b", lambda a, b, l_, tb, tl: kt.shadow_closest_fat(a, b, l_, tab, tb, tl),
            lambda a, b, l_, tb, tl, w: kt.shadow_closest_fat_plain(a, b, l_, tab, tb, tl, work=w),
            ro, rb, rl, tab)),
        ("any_fat", "K7c any", lambda h: hold_any(
            h, "K7c", lambda a, b, t: kt.any_hit_fat(a, b, tab, t),
            lambda a, b, t, w: kt.any_hit_fat_plain(a, b, tab, t, work=w), ro, rl, tab)),
    ):
        h = Held()
        held[name] = fn(h)
        report[name] = h.entry()
        log(f"{tag}: kernel {h.ms:.3f} ms, plain {h.plain_ms:.1f} ms, bound {h.bound:.4f} ms ({h.by}), "
            f"max err {h.err:.3g}, work {h.work}")

    # K7a at the stress shapes (one body), K7b and K7c with both bodies, and
    # K7b and K7c on each launch of one 1080p fat2 frame (the route's own
    # launches: the kernels line reports these).
    def k7a(a, b, t):
        return kt.closest_hit_fat(a, b, tab, t)

    def k7a_plain(a, b, t, w):
        return kt.closest_hit_fat_plain(a, b, tab, t, work=w)

    def k7b(a, b, l_, tb, tl):
        return kt.shadow_closest_fat(a, b, l_, tab, tb, tl)

    def k7b_plain(a, b, l_, tb, tl, w):
        return kt.shadow_closest_fat_plain(a, b, l_, tab, tb, tl, work=w)

    def k7c(a, b, t):
        return kt.any_hit_fat(a, b, tab, t)

    def k7c_plain(a, b, t, w):
        return kt.any_hit_fat_plain(a, b, tab, t, work=w)

    stress("K7a", k7a, k7a_plain, (o, d), 1, two_bodies=False)
    stress("K7b", k7b, k7b_plain, (ro, rb, rl), 2)
    stress("K7c", k7c, k7c_plain, (ro, rl), 1)
    k7b_launches, k7c_launches = recorded_launches(lambda: r2.render(cam_obj), kt.shadow_closest_fat,
                                                   kt.any_hit_fat)
    r2.state = init_frame_state(r2.cfg, r2.device)
    # A record is (rays..., caps...): 3 rays for the fused walk, 2 for any hit.
    for name, tag, hold, walk, plain, n_rays, launches_ in (
            ("shadow_closest_fat", "K7b", hold_combo, k7b, k7b_plain, 3, k7b_launches),
            ("any_fat", "K7c", hold_any, k7c, k7c_plain, 2, k7c_launches)):
        h = Held()
        for i, rec in enumerate(launches_):
            ms = h.ms
            hold(h, f"{tag} frame launch {i}", walk, plain, *rec[:n_rays], tab, *rec[n_rays:])
            log(f"{tag} frame launch {i}: {rec[0].shape[0]} rays, kernel {h.ms - ms:.4f} ms")
        report[name] = h.entry()
        log(f"{tag} on a fat2 frame's {len(launches_)} launch(es): kernel {h.ms:.3f} ms, plain "
            f"{h.plain_ms:.1f} ms, bound {h.bound:.4f} ms ({h.by}), max err {h.err:.3g}, work {h.work}")
    del k7b_launches, k7c_launches
    # The same rays through K1-K3 over the fat4 table: the same t and occ
    # (the two layouts may keep another triangle only at an exact t tie).
    one = kt.closest_hit_fat4(o, d, t4)
    hs, os_ = kt.shadow_closest_fat4(ro, rb, rl, t4)
    assert torch.equal(one["t"], held["closest_fat"]["t"]), "K7a and K1 differ in t"
    assert torch.equal(hs["t"], held["shadow_closest_fat"][0]["t"]) and torch.equal(
        os_, held["shadow_closest_fat"][1]), "K7b and K2 differ"
    assert torch.equal(kt.any_hit_fat4(ro, rl, t4), held["any_fat"]), "K7c and K3 differ"
    ms4 = (timed_ms(lambda: kt.closest_hit_fat4(o, d, t4)), timed_ms(lambda: kt.shadow_closest_fat4(ro, rb, rl, t4)),
           timed_ms(lambda: kt.any_hit_fat4(ro, rl, t4)))
    log(f"fat4 on the same rays: K1 {ms4[0]:.3f} ms, K2 {ms4[1]:.3f} ms, K3 {ms4[2]:.3f} ms; "
        f"tri differs at {int((one['tri'] != held['closest_fat']['tri']).sum())} primary rays (t ties)")
    del o, d, ro, rb, rl, held, one, hs, os_
    clock.done("fat2 kernels")

    # 8b. Frames (the fat2 route's main path) and train steps; the frame
    # against the fat4 frame.
    out4, ms4f, times4, _ = _frames(r4, cam_obj, wrappers)
    out2, ms2f, times2, n = _frames(r2, cam_obj, wrappers)
    log(f"fat2 frame: {ms2f:.2f} ms/frame (frames {[round(t, 2) for t in times2]}); fat4 frame "
        f"{ms4f:.2f} ms (frames {[round(t, 2) for t in times4]}); launches "
        f"{json.dumps({k: v for k, v in n.items() if v})}")
    _read_launches(launches, n, ("closest_fat", "shadow_closest_fat", "any_fat"))
    assert n["closest_hit_fat4"] == n["shadow_closest_fat4"] == n["any_hit_fat4"] == 0, "K1-K3 ran on fat2"
    hold_frame("fat2 frame", out2, out4, "the fat4 frame")
    profile_frame(lambda: r2.render(cam_obj), FAT2_KERNELS, ms2f, what="fat2 frame")
    del out2, out4, r4
    fat2_counts = {k: new_wrappers()[k] for k in ("closest_fat", "shadow_closest_fat", "any_fat")}
    train_phase(r2, cam, dataclasses.replace(base_cfg, bvh_wide=2),
                {**fat2_counts, "atrous_fwd": ksvgf.atrous_step}, kernel_names=FAT2_KERNELS)
    del r2
    torch.cuda.empty_cache()
    clock.done("fat2 frames and train")

    # 8c. The 247k scene with bvh_wide=2 under auto: two fat2 subtree chunks.
    fs_l = large_scene(seed=0)
    bvh_l = build_bvh_native(fs_l.tri_pos, max_leaf=15)
    t0 = time.perf_counter()
    big2 = Renderer(fs_l, cfg2, bvh=bvh_l)
    setup = time.perf_counter() - t0
    chunks = big2.tables.get("chunks", [])
    log(f"fat2 large: {fs_l.num_triangles} triangles -> route {big2.route}, {len(chunks)} chunks "
        f"{[('fatnodes' in c and 'fat2') or 'node' for c in chunks]}, {table_bytes(big2.tables)} B "
        f"(JAX layout {jax_layout_bytes(big2.tables)} B), stack depths {[c['stack_depth'] for c in chunks]}, "
        f"set up in {setup:.2f} s")
    assert big2.route == "subtree" and len(chunks) == 2 and all("fatnodes" in c for c in chunks), big2.route
    big4 = Renderer(fs_l, cfg, bvh=bvh_l)
    assert big4.route == "single", big4.route
    cam_obj_l = bench_camera(fs_l)
    cam_l = make_camera_arrays(cam_obj_l, WIDTH, HEIGHT, dev)
    (o, d), (ro, rb, rl), _, _ = path_rays(
        big4.scene, lambda a, b: kt.closest_hit_fat4(a, b, big4.tables), big4.sun, cam_l)
    held, (best, best_b, occ_l, occ) = hold_chain("K7 chain", chunks, _chunk_fns, (o, d), (ro, rb, rl))
    hs, os_ = kt.shadow_closest_fat4(ro, rb, rl, big4.tables)
    assert torch.equal(best["t"], kt.closest_hit_fat4(o, d, big4.tables)["t"]), "K7 closest chain differs"
    assert torch.equal(best_b["t"], hs["t"]) and torch.equal(occ_l, os_), "K7 fused chain differs"
    assert torch.equal(occ, kt.any_hit_fat4(ro, rl, big4.tables)), "K7 any chain differs"
    for kind, h in zip(("closest", "shadow_closest", "any"), held):
        log(f"K7 chain {kind} over {len(chunks)} chunks: kernels {h.ms:.3f} ms, plain {h.plain_ms:.1f} ms, "
            f"bound {h.bound:.4f} ms ({h.by}), max err {h.err:.3g}, work {h.work}")
    del o, d, ro, rb, rl, best, best_b, occ_l, occ, hs, os_
    out4, ms4f, times4, _ = _frames(big4, cam_obj_l, wrappers)
    out2, ms2f, times2, n = _frames(big2, cam_obj_l, wrappers)
    log(f"fat2 large frame: {ms2f:.2f} ms/frame (frames {[round(t, 2) for t in times2]}); fat4 auto "
        f"{ms4f:.2f} ms (frames {[round(t, 2) for t in times4]}); launches "
        f"{json.dumps({k: v for k, v in n.items() if v})}")
    assert n["closest_hit_fat"] > 0 and n["shadow_closest_fat"] > 0 and n["any_hit_fat"] > 0, "K7 chains idle"
    hold_frame("fat2 large frame", out2, out4, "the 247k auto fat4 frame")
    profile_frame(lambda: big2.render(cam_obj_l), FAT2_KERNELS, ms2f, what="fat2 chunks frame")
    del out2, out4, big2, big4
    torch.cuda.empty_cache()
    clock.done("fat2 large")

    # 8d. Dynamic scenes: update_instances on the bench scene's fat4, fat2
    # and paged tables, then the 247k scene on the subtree route, which the
    # first update switches to paged.
    for tag, route_cfg in (("fat4", cfg), ("fat2", cfg2), ("paged", dataclasses.replace(cfg, chunk_mode="paged"))):
        r = Renderer(fs, route_cfg, bvh=bvh)
        dynamic_frames(tag, fs, r, cam_obj, wrappers)
        del r
    r = Renderer(fs_l, dataclasses.replace(cfg, chunk_mode="subtree"), bvh=bvh_l)
    assert r.route == "subtree", r.route
    n = dynamic_frames("247k subtree", fs_l, r, cam_obj_l, wrappers)
    assert r.route == "paged" and n["closest_hit_fat4_paged"] > 0, f"after the refit: route {r.route}"
    del r
    torch.cuda.empty_cache()
    clock.done("dynamic")
    return report, launches


# The frame options of phase 9, one at a time and all three together.
OPTION_CASES = {
    "jitter_primary": dict(jitter_primary=True),
    "fast_bounce_shading": dict(fast_bounce_shading=True),
    "enable_envmap": dict(enable_envmap=True),
    "all three": dict(jitter_primary=True, fast_bounce_shading=True, enable_envmap=True),
}


def options_phase(base_cfg, fs, bvh) -> dict:
    """Phase 9: the bench scene and config at 1920x1080 with each frame
    option and with all three: 1 warm-up and 3 timed frames with the
    launch counts read around them (K1 twice a frame under jitter at spp
    1), one profiled frame, then 1 warm-up and 3 timed train steps, one
    profiled; and a 64x64 frame and step of each on the GPU against the CPU
    plain path.  The sky of enable_envmap is JAX's app's procedural 64x128
    map.  Returns the launch counts of each option's frames."""
    import dataclasses

    import torch

    from nebulae_tpu_torch.engine.renderer import Renderer, init_frame_state
    from nebulae_tpu_torch.kernels import svgf as ksvgf
    from nebulae_tpu_torch.kernels import trace as kt
    from nebulae_tpu_torch.passes.gbuffer import make_camera_arrays
    from nebulae_tpu_torch.utils.testscenes import bench_camera, procedural_envmap, textured_scene

    env = procedural_envmap()
    r = Renderer(fs, base_cfg, bvh=bvh, env_map=env)
    dev = r.device
    cam_obj = bench_camera(fs)
    cam = make_camera_arrays(cam_obj, WIDTH, HEIGHT, dev)
    wrappers = {"closest_fat4": kt.closest_hit_fat4, "shadow_closest_fat4": kt.shadow_closest_fat4,
                "any_fat4": kt.any_hit_fat4, "atrous_fwd": ksvgf.atrous_step}
    small = textured_scene(seed=0)
    counts = {}
    for name, opts in OPTION_CASES.items():
        cfg = dataclasses.replace(base_cfg, **opts)
        r.update_config(cfg)
        r.state = init_frame_state(cfg, dev)
        torch.cuda.reset_peak_memory_stats()
        out, mean_ms, times, n = _frames(r, cam_obj, wrappers)
        peak = torch.cuda.max_memory_allocated() / 2**30
        missing = [k for k, c in n.items() if c == 0]
        assert not missing, f"{name}: kernels not launched: {missing}"
        per_frame = {k: c / 4 for k, c in n.items()}
        want = 1 + cfg.spp if cfg.jitter_primary else 1
        assert per_frame["closest_fat4"] == want, f"{name}: K1 {per_frame['closest_fat4']} a frame, not {want}"
        counts[name] = n
        log(f"options {name}: {mean_ms:.2f} ms/frame (frames {[round(t, 2) for t in times]}), ldr mean "
            f"{float(out['ldr'].mean()):.4f}, peak device memory {peak:.2f} GiB, launches per frame "
            f"{json.dumps(per_frame)}")
        profile_frame(lambda: r.render(cam_obj), FAT4_KERNELS, mean_ms, what=f"{name} frame")
        del out
        train_phase(r, cam, cfg, wrappers, what=f"options {name} train")
        small_frame_check(small, opts, env, what=f"options {name} small frame")
        small_train_check(small, opts, env, what=f"options {name} small train step")
    return counts


def hold_walk_launches(what, tables, k1s, k2s, k3s, table="fat4") -> None:
    """The closest, fused and any walks over `table` ("fat4": K1, K2, K3;
    "fat": K7a, K7b, K7c) held against their plain versions on each
    recorded launch of a frame (over `tables`), max error 0; logs each
    launch and each kernel's sums."""
    from nebulae_tpu_torch.kernels import trace as kt

    tags = ("K1", "K2", "K3") if table == "fat4" else ("K7a", "K7b", "K7c")
    closest, combo, any_ = (getattr(kt, f"{w}_{table}") for w in ("closest_hit", "shadow_closest", "any_hit"))
    closest_p, combo_p, any_p = (getattr(kt, f"{w}_{table}_plain")
                                 for w in ("closest_hit", "shadow_closest", "any_hit"))
    for tag, launches_, hold, n_caps, kernel, plain in (
            (tags[0], k1s, hold_closest, 1, lambda a, b, t: closest(a, b, tables, t),
             lambda a, b, t, w: closest_p(a, b, tables, t, work=w)),
            (tags[1], k2s, hold_combo, 2, lambda a, b, l_, tb, tl: combo(a, b, l_, tables, tb, tl),
             lambda a, b, l_, tb, tl, w: combo_p(a, b, l_, tables, tb, tl, work=w)),
            (tags[2], k3s, hold_any, 1, lambda a, b, t: any_(a, b, tables, t),
             lambda a, b, t, w: any_p(a, b, tables, t, work=w))):
        h = Held()
        for i, args in enumerate(launches_):
            ms = h.ms
            hold(h, f"{tag} {what} launch {i}", kernel, plain, *args[:-n_caps], tables, *args[-n_caps:])
            log(f"{tag} {what} launch {i}: {args[0].shape[0]} rays, kernel {h.ms - ms:.4f} ms")
        assert h.err == 0.0, f"{tag} on a {what}: max error {h.err}"
        log(f"{tag} on a {what}'s {len(launches_)} launches: max err {h.err:.3g}, kernel {h.ms:.3f} ms, "
            f"plain {h.plain_ms:.1f} ms, bound {h.bound:.4f} ms ({h.by})")


def nrc_frames(r, cam_obj, wrappers, n_warm, n_timed, what, may_idle=("any_fat4",), keep=None):
    """n_warm + n_timed frames of an NRC renderer with the launch counts set
    to 0 just before and read just after; logs each frame's nrc_loss and
    nrc_query_frac and peak memory.  Returns (mean ms of the timed frames,
    the counts).  Every kernel but those of
    `may_idle` must launch: K3 runs at each pass's last vertex, where the
    spread heuristic and the sky leave few paths alive, and a walk with no
    live ray launches nothing.  A `keep` dict receives the first frame's
    outputs."""
    import torch

    _zero(wrappers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, scalars = [], []
    for i in range(n_warm + n_timed):
        t0 = time.perf_counter()
        out = r.render(cam_obj)
        torch.cuda.synchronize()
        if i >= n_warm:
            times.append((time.perf_counter() - t0) * 1e3)
        if i == 0 and keep is not None:
            keep.update(out)
        scalars.append((float(out["nrc_loss"]), float(out["nrc_query_frac"])))
    launches = {name: fn.launches for name, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    ldr = out["ldr"]
    assert ldr.shape == (HEIGHT, WIDTH, 3) and bool(torch.isfinite(ldr).all()), f"{what}: non-finite frame"
    assert float(ldr.std()) > 1e-3, f"{what}: constant frame"
    for loss, qf in scalars:
        assert math.isfinite(loss) and loss > 0.0 and 0.0 < qf < 1.0, f"{what}: nrc_loss {loss}, query_frac {qf}"
    missing = [name for name, c in launches.items() if c == 0 and name not in may_idle]
    assert not missing, f"{what}: kernels not launched: {missing}"
    mean_ms = sum(times) / len(times)
    log(f"{what}: {mean_ms:.2f} ms/frame (timed frames {[round(t, 2) for t in times]}), peak device memory "
        f"{peak:.2f} GiB, launches per frame {json.dumps({k: c / (n_warm + n_timed) for k, c in launches.items()})}")
    log(f"{what}: per frame (nrc_loss, nrc_query_frac) {json.dumps([[round(a, 6), round(b, 6)] for a, b in scalars])}")
    return mean_ms, launches


def _state_to(x, device):
    """A frame state (nested dicts and lists of tensors and Python values)
    with every tensor on `device`."""
    import torch

    if isinstance(x, dict):
        return {k: _state_to(v, device) for k, v in x.items()}
    if isinstance(x, list):
        return [_state_to(v, device) for v in x]
    return x.to(device) if isinstance(x, torch.Tensor) else x


def small_nrc_check(fs, cam_obj, what="nrc small frames", options=None, env_map=None) -> None:
    """Two 64x64 NRC frames (under `options`, with `env_map` as the sky) on
    the GPU (kernels, bf16 tensor-core
    products) against the CPU (plain versions, exact products), each from
    one frame state (cache and SVGF history) copied to both devices: ldr on
    >= 99% of pixels within rtol 1e-2 / atol 1e-3, nrc_loss to a relative
    1e-3, nrc_query_frac within 0.5% (tests/test_torch_nrc_frame.py's
    tolerances against JAX).  Left to run on, the devices' caches part:
    a handful of training paths differ by an ulp-level hit or shading
    difference, and Adam's first steps move a weight by about lr * sign(g)."""
    import torch

    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer

    cfg = RenderConfig(width=64, height=64, max_bounces=BOUNCES, enable_svgf=True, enable_tonemap=True,
                       enable_nrc=True, **(options or {}))
    r_gpu = Renderer(fs, cfg, device="cuda", env_map=env_map)
    r_cpu = Renderer(fs, cfg, device="cpu", env_map=env_map)
    for i in range(2):
        r_gpu.state = _state_to(r_cpu.state, "cuda")
        g = {k: v.cpu() for k, v in r_gpu.render(cam_obj).items()}
        c = r_cpu.render(cam_obj)
        close = torch.isclose(g["ldr"], c["ldr"], rtol=1e-2, atol=1e-3).all(dim=-1).float().mean()
        assert float(close) >= 0.99, f"{what} {i}: only {float(close):.4f} of pixels agree"
        lg, lc = float(g["nrc_loss"]), float(c["nrc_loss"])
        assert abs(lg - lc) <= 1e-3 * abs(lc), f"{what} {i}: nrc_loss {lg} vs CPU {lc}"
        qg, qc = float(g["nrc_query_frac"]), float(c["nrc_query_frac"])
        assert abs(qg - qc) <= 0.005, f"{what} {i}: query_frac {qg} vs CPU {qc}"
        log(f"{what} {i}: GPU agrees with the CPU plain path: {float(close):.6f} of pixels within rtol 1e-2 / "
            f"atol 1e-3, nrc_loss {lg:.6f} vs {lc:.6f}, query_frac {qg:.6f} vs {qc:.6f}")


def nrc_cache_step_check() -> None:
    """One cache step on both devices from one set of records: loss to a
    relative 1e-5, params to a relative L2 error <= 1e-3
    (tests/test_torch_nrc.py's tolerances for one step against JAX)."""
    import torch

    from nebulae_tpu_torch.nrc.cache import init_cache, make_optimizer, train_cache_step
    from nebulae_tpu_torch.nrc.mlp import mlp_leaves

    gen = torch.Generator().manual_seed(7)
    n = 16384
    unit = torch.nn.functional.normalize(torch.randn((2, n, 3), generator=gen), dim=-1)
    rec = {"position": torch.rand((n, 3), generator=gen) * 4.0 - 2.0, "normal": unit[0], "view": unit[1],
           "roughness": torch.rand(n, generator=gen), "albedo": torch.rand((n, 3), generator=gen),
           "metalness": torch.rand(n, generator=gen), "target": torch.rand((n, 3), generator=gen) ** 2 * 9.0,
           "weight": (torch.rand(n, generator=gen) > 0.2).float()}
    lo, hi = torch.full((3,), -2.0), torch.full((3,), 2.0)
    res = {}
    for device in ("cuda", "cpu"):
        state, loss = train_cache_step(_state_to(init_cache(seed=0), device), make_optimizer(1e-2),
                                       _state_to(rec, device), _state_to(lo, device), _state_to(hi, device))
        res[device] = (float(loss), torch.cat([t.cpu().reshape(-1) for t in mlp_leaves(state["params"])]).double())
    (lg, pg), (lc, pc) = res["cuda"], res["cpu"]
    rel = float(torch.linalg.vector_norm(pg - pc) / torch.linalg.vector_norm(pc))
    assert abs(lg - lc) <= 1e-5 * abs(lc) and rel <= 1e-3, f"nrc cache step: loss {lg} vs {lc}, params rel {rel}"
    log(f"nrc cache step on one set of records: GPU loss {lg:.7f} vs CPU {lc:.7f}, params relative L2 {rel:.3g}")


def mlp_forms(r, cam_obj) -> None:
    """The cache MLP on one full-width query (a 1080p G-buffer's primary
    hits encoded, 2,073,600 rows): the forward with aten::mm.dtype (bf16
    operands on the tensor cores, float32 out) against the upcast form
    (float32 products of the upcast operands), their largest difference,
    and the forward and input backward as the train step's query runs them,
    beside the bound."""
    import torch

    from nebulae_tpu_torch.core import brdf
    from nebulae_tpu_torch.nrc.encoding import encode_query
    from nebulae_tpu_torch.nrc.mlp import MM_OUT_DTYPE, apply_mlp, forward_layers, mlp_leaves
    from nebulae_tpu_torch.passes.gbuffer import camera_rays, make_camera_arrays, render_gbuffer
    from nebulae_tpu_torch.tracer.trace import make_tracer

    closest, _ = make_tracer(r.scene, r.tables, r.cfg, device=r.device)
    o, d = camera_rays(make_camera_arrays(cam_obj, WIDTH, HEIGHT, r.device), WIDTH, HEIGHT)
    g = render_gbuffer(r.scene, closest, o, d)
    x = encode_query(g["position"], g["normal_s"], g["view"], g["roughness"], g["albedo"],
                     brdf.base_f0(g["albedo"], g["metalness"]), r.scene["aabb_min"], r.scene["aabb_max"])
    params = r.state["nrc"]["ema_params"]
    leaves = mlp_leaves(params)
    z_dtype = forward_layers(x, leaves)[0]
    z_up = forward_layers(x, leaves, upcast=True)[0]
    diff = float((z_dtype - z_up).abs().max())
    ms_dtype = timed_ms(lambda: forward_layers(x, leaves))
    ms_up = timed_ms(lambda: forward_layers(x, leaves, upcast=True))
    xg = x.detach().requires_grad_(True)

    def fwd_bwd():
        with torch.enable_grad():
            torch.autograd.grad(apply_mlp(params, xg).sum(), xg)

    ms_fb = timed_ms(fwd_bwd)
    n = x.shape[0]
    macs = sum(layer["w"].shape[0] * layer["w"].shape[1] for layer in params)
    bound, by = max((n * (x.shape[1] + 3) * 4 / HBM_BYTES_PER_S * 1e3, "bytes"),
                    (2 * n * macs / BF16_OPS_PER_S * 1e3, "operations"))
    log(f"mlp: torch {torch.__version__}, aten::mm.dtype {'present' if MM_OUT_DTYPE else 'absent'}; "
        f"{n} rows x {x.shape[1]} -> 3: forward {ms_dtype:.3f} ms with aten::mm.dtype, {ms_up:.3f} ms upcast "
        f"(max |dz| {diff:.3g}); forward + input backward {ms_fb:.3f} ms; bound {bound:.4f} ms ({by})")


def nrc_phase(base_cfg, fs, bvh) -> None:
    """Phase 10: the neural radiance cache.  The bench scene at 1920x1080
    with enable_nrc: 3 warm-up and 3 timed frames (each frame's nrc_loss
    and nrc_query_frac, the launch counts, peak memory), one profiled frame
    (device ms of nrc_train, nrc_query and the MLP's products), and K1, K2
    and K3 held against their plain versions on each of their launches in
    one NRC frame.  bench_atrium (the bench tori inside four walls): 1
    warm-up and 3 timed frames and one profiled.  The train step with the
    cache: 1 warm-up and 3 timed steps, one profiled.  64x64 frames and a
    step on the GPU against the CPU plain path, the quality probe on the
    card at its defaults (ratio < 1), and the MLP's two product forms."""
    import dataclasses

    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.kernels import svgf as ksvgf
    from nebulae_tpu_torch.kernels import trace as kt
    from nebulae_tpu_torch.nrc.cache import memory_footprint
    from nebulae_tpu_torch.passes.gbuffer import make_camera_arrays
    from nebulae_tpu_torch.utils.nrc_quality import nrc_quality_probe
    from nebulae_tpu_torch.utils.testscenes import atrium_camera, bench_atrium, bench_camera, small_atrium

    cfg = dataclasses.replace(base_cfg, enable_nrc=True)
    wrappers = {"closest_fat4": kt.closest_hit_fat4, "shadow_closest_fat4": kt.shadow_closest_fat4,
                "any_fat4": kt.any_hit_fat4, "atrous_fwd": ksvgf.atrous_step}
    r = Renderer(fs, cfg, bvh=bvh)
    log(f"nrc: cache bytes {json.dumps(memory_footprint(r.state['nrc']))}")
    cam_obj = bench_camera(fs)
    mean_ms, n = nrc_frames(r, cam_obj, wrappers, 3, 3, "nrc frames")
    # A frame: K1 for the primary and the training G-buffers; K2 at each
    # query and training bounce vertex, K3 at each pass's last vertex (a
    # walk with no live ray launches nothing, so at most these); K4 x4.
    per_frame = {k: c / 6 for k, c in n.items()}
    most = {"closest_fat4": 2, "shadow_closest_fat4": (BOUNCES - 1) + (cfg.nrc_max_path_vertices - 1),
            "any_fat4": 2, "atrous_fwd": cfg.svgf_atrous_passes}
    ok = (per_frame["closest_fat4"] == 2 and per_frame["atrous_fwd"] == most["atrous_fwd"]
          and BOUNCES <= per_frame["shadow_closest_fat4"] <= most["shadow_closest_fat4"]
          and per_frame["any_fat4"] <= most["any_fat4"])
    assert ok, f"nrc frames: launches per frame {per_frame}, at most {most}"
    profile_frame(lambda: r.render(cam_obj), FAT4_KERNELS, mean_ms, phases=NRC_PHASES, what="nrc frame",
                  nested=("nebulae/nrc_mlp",))
    # K1, K2 and K3 on each of their launches in one NRC frame.
    k1s, k2s, k3s = recorded_launches(lambda: r.render(cam_obj), kt.closest_hit_fat4, kt.shadow_closest_fat4,
                                      kt.any_hit_fat4)
    hold_walk_launches("nrc frame", r.tables, k1s, k2s, k3s)
    del k1s, k2s, k3s
    mlp_forms(r, cam_obj)
    cam = make_camera_arrays(cam_obj, WIDTH, HEIGHT, r.device)
    train_phase(r, cam, cfg, wrappers, what="nrc train", phases=NRC_TRAIN_PHASES, nested=("nebulae/nrc_mlp",))
    del r

    fa = bench_atrium(0)
    ra = Renderer(fa, cfg)
    cam_a = atrium_camera(fa)
    log(f"nrc atrium: {fa.num_triangles} triangles")
    mean_a, n_a = nrc_frames(ra, cam_a, wrappers, 1, 3, "nrc atrium frames")
    k3 = n["any_fat4"] + n_a["any_fat4"]
    assert k3 > 0, "K3 launched on no NRC frame of the field or the atrium"
    log(f"nrc: K3 launched {n['any_fat4']} times in 6 field frames, {n_a['any_fat4']} in 4 atrium frames")
    profile_frame(lambda: ra.render(cam_a), FAT4_KERNELS, mean_a, phases=NRC_PHASES, what="nrc atrium frame",
                  nested=("nebulae/nrc_mlp",))
    del ra

    small = small_atrium(0)
    small_nrc_check(small, atrium_camera(small))
    nrc_cache_step_check()
    small_train_check(small, {"enable_nrc": True}, what="nrc small train step", camera=atrium_camera(small))
    t0 = time.perf_counter()
    probe = nrc_quality_probe()
    log(f"nrc probe: {json.dumps(probe)} in {time.perf_counter() - t0:.1f} s")
    assert probe["ratio"] < 1.0, f"nrc probe: the cache does not help at the defaults: {probe}"


# Phase 13: the radiance cache on every frame option, route and width.
# Each traversal wrapper's K number, as the kernels line and PERF.md name it.
WALK_TAGS = {
    "closest_hit_fat4": "K1", "shadow_closest_fat4": "K2", "any_hit_fat4": "K3",
    "closest_hit_fat4_paged": "K6a closest", "shadow_closest_fat4_paged": "K6a fused",
    "any_hit_fat4_paged": "K6a any", "closest_hit_fat4_slots": "K6b closest",
    "shadow_closest_fat4_slots": "K6b fused", "any_hit_fat4_slots": "K6b any",
    "closest_hit_fat": "K7a", "shadow_closest_fat": "K7b", "any_hit_fat": "K7c",
    "closest_hit_node": "K8 closest", "any_hit_node": "K8 any",
}


def walk_launches(render) -> list:
    """Each traversal-kernel launch of one render() as (wrapper name, rays,
    caps, tables), through spies on every wrapper of kernels/trace.py (the
    routes, the chunk chains and the one-node walks look them up when they
    trace).  Calls that launch nothing (no rays, an empty table) are left
    out.  Each wrapper keeps the launches its spy counted."""
    import torch

    from nebulae_tpu_torch.kernels import trace as kt

    recs, spies = [], {}

    def spy(fn):
        name = fn.__name__
        n_caps = 2 if name.startswith("shadow") else 1

        def call(*args):
            before = call.launches
            out = fn(*args)
            if call.launches > before:
                i = next(k for k, a in enumerate(args) if isinstance(a, dict))
                caps = list(args[i + 1:]) + [float("inf")] * (n_caps - len(args[i + 1:]))
                recs.append((name, [a.clone() for a in args[:i]],
                             [c.clone() if torch.is_tensor(c) else c for c in caps], args[i]))
            return out

        # The wrapper counts on, and records to, whatever its module name
        # holds while the spy stands in.
        call.launches, call.record = fn.launches, None
        return call

    try:
        for fn in kt.WRAPPERS:
            spies[fn.__name__] = spy(fn)
            setattr(kt, fn.__name__, spies[fn.__name__])
        render()
    finally:
        for fn in kt.WRAPPERS:
            if fn.__name__ in spies:
                fn.launches = spies[fn.__name__].launches
                setattr(kt, fn.__name__, fn)
    return recs


def hold_launches(what, recs) -> dict:
    """Each launch of walk_launches held against its plain version on its
    own inputs and tables (tri, t, u, v and occ equal: max error 0) and
    timed; logs each wrapper's launches, rays, kernel, plain and bound ms.
    Returns {wrapper name: Held}."""
    from nebulae_tpu_torch.kernels import trace as kt

    held, rays = {}, {}
    for name, ins, caps, tab in recs:
        base = next(b for b in ("closest_hit", "shadow_closest", "any_hit") if name.startswith(b))
        family = "node" if name.endswith("_node") else "fat" if name.endswith("_fat") else "fat4"
        plain = getattr(kt, f"{base}_{family}_plain")
        extra = {"slot_range": (int(tab["slot_lo"]), int(tab["slot_hi"]))} if name.endswith("_slots") else {}
        kernel = getattr(kt, name)
        h = held.setdefault(name, Held())
        tag = f"{what} {WALK_TAGS[name]} launch {rays.get(name, (0, 0))[0]}"
        if base == "closest_hit":
            hold_closest(h, tag, lambda a, b, t: kernel(a, b, tab, t),
                         lambda a, b, t, w: plain(a, b, tab, t, work=w, **extra), *ins, tab, *caps)
        elif base == "shadow_closest":
            hold_combo(h, tag, lambda a, b, l_, tb, tl: kernel(a, b, l_, tab, tb, tl),
                       lambda a, b, l_, tb, tl, w: plain(a, b, l_, tab, tb, tl, work=w, **extra), *ins, tab, *caps)
        else:
            hold_any(h, tag, lambda a, b, t: kernel(a, b, tab, t),
                     lambda a, b, t, w: plain(a, b, tab, t, work=w, **extra), *ins, tab, *caps)
        n, r = rays.get(name, (0, 0))
        rays[name] = (n + 1, r + ins[0].shape[0])
    for name, h in held.items():
        assert h.err == 0.0, f"{what} {WALK_TAGS[name]}: max error {h.err}"
        log(f"{what} {WALK_TAGS[name]} ({name}) on its {rays[name][0]} launches ({rays[name][1]} rays): "
            f"max err 0, kernel {h.ms:.3f} ms, plain {h.plain_ms:.1f} ms, bound {h.bound:.4f} ms ({h.by})")
    return held


def _route_wrappers(suffix: str, node=False) -> dict:
    """The launch counters of one table family's walks ("fat4", "fat4_paged",
    "fat4_slots", "fat"; with `node` K8's too) and K4's."""
    from nebulae_tpu_torch.kernels import svgf as ksvgf
    from nebulae_tpu_torch.kernels import trace as kt

    out = {f"{w}_{suffix}": getattr(kt, f"{f}_{suffix}")
           for w, f in (("closest", "closest_hit"), ("shadow_closest", "shadow_closest"), ("any", "any_hit"))}
    if node:
        out.update(closest_node=kt.closest_hit_node, any_node=kt.any_hit_node)
    return {**out, "atrous_fwd": ksvgf.atrous_step}


def hold_nrc_frame(what, out, ref, ref_name) -> None:
    """An NRC frame against a reference NRC frame from the same cache: hit
    mask equal, ldr on >= 99% of pixels within rtol 1e-2 / atol 1e-3,
    nrc_loss to a relative 1e-3, nrc_query_frac within 0.5% (the NRC
    tolerance of tests/test_torch_nrc_frame.py)."""
    import torch

    assert torch.equal(out["hit"], ref["hit"]), f"{what}: hit mask differs from {ref_name}"
    close = torch.isclose(out["ldr"], ref["ldr"], rtol=1e-2, atol=1e-3).all(dim=-1).float().mean()
    same = (out["ldr"] == ref["ldr"]).all(dim=-1).float().mean()
    loss, ref_loss = float(out["nrc_loss"]), float(ref["nrc_loss"])
    qf, ref_qf = float(out["nrc_query_frac"]), float(ref["nrc_query_frac"])
    assert float(close) >= 0.99, f"{what}: only {float(close):.4f} of pixels agree with {ref_name}"
    assert abs(loss - ref_loss) <= 1e-3 * abs(ref_loss), f"{what}: nrc_loss {loss} vs {ref_loss} ({ref_name})"
    assert abs(qf - ref_qf) <= 0.005, f"{what}: nrc_query_frac {qf} vs {ref_qf} ({ref_name})"
    log(f"{what}: hit mask equal to {ref_name}'s, {float(close):.6f} of pixels within rtol 1e-2 / atol 1e-3, "
        f"{float(same):.6f} bit-identical; nrc_loss {loss:.6f} vs {ref_loss:.6f}, query_frac {qf:.6f} vs {ref_qf:.6f}")


def _cache_digest(state) -> str:
    from nebulae_tpu_torch.nrc.mlp import mlp_leaves

    c = state["nrc"]
    return _digest(*mlp_leaves(c["params"]), *mlp_leaves(c["ema_params"]), *mlp_leaves(c["opt_state"]["mu"]),
                   *mlp_leaves(c["opt_state"]["nu"]))


def nrc_routes_phase(base_cfg, fs, bvh) -> None:
    """Phase 13: the radiance cache on every frame option, chunk_mode route
    and width, and after a refit, at 1920x1080 with full outputs.  Every
    renderer starts from a fresh state (init_cache(seed=0)), so frames of
    two renderers compare from one cache."""
    import dataclasses

    import torch

    from nebulae_tpu_torch.bvh.cbuilder import build_bvh_native
    from nebulae_tpu_torch.engine.renderer import Renderer, init_frame_state
    from nebulae_tpu_torch.engine.train import make_train_step, split_scene_params
    from nebulae_tpu_torch.kernels import chunks as kc
    from nebulae_tpu_torch.kernels import svgf as ksvgf
    from nebulae_tpu_torch.passes.gbuffer import make_camera_arrays
    from nebulae_tpu_torch.utils.testscenes import (
        atrium_camera, bench_camera, huge_scene, large_scene, procedural_envmap, small_atrium,
    )

    clock = PhaseClock()
    dev = torch.device("cuda")
    cfg = dataclasses.replace(base_cfg, enable_nrc=True, lean_outputs=False)
    env = procedural_envmap()
    cam_obj = bench_camera(fs)

    # 13a. The bench scene with the cache under each frame option: K1 runs
    # for the primary G-buffer, each sample's jittered one and the training
    # pass's.
    r = Renderer(fs, cfg, bvh=bvh, env_map=env)
    for name, opts in OPTION_CASES.items():
        c = dataclasses.replace(cfg, **opts)
        r.update_config(c)
        r.state = init_frame_state(c, dev)
        mean_ms, n = nrc_frames(r, cam_obj, _route_wrappers("fat4"), 1, 3, f"nrc-routes {name}")
        want = 2 + (c.spp if c.jitter_primary else 0)
        assert n["closest_fat4"] == 4 * want, f"nrc-routes {name}: K1 {n['closest_fat4'] / 4} a frame, not {want}"
        if name == "jitter_primary":
            profile_frame(lambda: r.render(cam_obj), FAT4_KERNELS, mean_ms, phases=NRC_PHASES,
                          what="nrc jitter frame", nested=("nebulae/nrc_mlp",))
    # K1-K3 on each launch of one frame with all three options, the
    # training pass's included.
    hold_launches("nrc all-options frame", walk_launches(lambda: r.render(cam_obj)))
    del r
    clock.done("nrc-routes options")

    # 13b. The 247k scene on each chunk_mode, its NRC frames held against
    # auto's (the single table) from one cache; K6a, K6b and K6c (K1-K3
    # chained over the subtree chunks) on each launch of one frame.
    fs_l = large_scene(seed=0)
    bvh_l = build_bvh_native(fs_l.tri_pos, max_leaf=15)
    cam_l = bench_camera(fs_l)
    suffix = {"auto": "fat4", "subtree": "fat4", "tri": "fat4_slots", "paged": "fat4_paged"}
    firsts, digests = {}, {}
    default_budget = kc.TRI_CHUNK_TABLE_BUDGET
    for mode, route in LARGE_ROUTES.items():
        kc.TRI_CHUNK_TABLE_BUDGET = TRI_BUDGET_LARGE if mode == "tri" else default_budget
        try:
            r = Renderer(fs_l, dataclasses.replace(cfg, chunk_mode=mode), bvh=bvh_l)
        finally:
            kc.TRI_CHUNK_TABLE_BUDGET = default_budget
        assert r.route == route, f"chunk_mode={mode} took route {r.route}"
        keep = {}
        nrc_frames(r, cam_l, _route_wrappers(suffix[mode]), 1, 2, f"nrc-routes 247k {mode} ({route})",
                   may_idle=(f"any_{suffix[mode]}",), keep=keep)
        firsts[mode] = {k: keep[k] for k in ("hit", "ldr", "nrc_loss", "nrc_query_frac")}
        digests[mode] = _cache_digest(r.state)
        hold_launches(f"nrc 247k {mode} frame", walk_launches(lambda: r.render(cam_l)))
        del r, keep
    ref = firsts["auto"]
    for k in ("hit", "ldr", "nrc_loss", "nrc_query_frac"):
        assert torch.equal(firsts["paged"][k], ref[k]), f"247k paged NRC frame differs from auto's in {k}"
    assert digests["paged"] == digests["auto"], "247k paged cache differs from auto's after 3 frames"
    log(f"nrc-routes 247k paged: NRC frame equal to auto's byte for byte, cache after 3 frames too "
        f"(digests {json.dumps(digests)})")
    for mode in ("tri", "subtree"):
        hold_nrc_frame(f"nrc-routes 247k {mode}", firsts[mode], ref, "auto")
    del firsts, ref
    clock.done("nrc-routes 247k")

    # 13c. The bench scene's fat2 table (K7) against its fat4 table.
    ref = Renderer(fs, cfg, bvh=bvh).render(cam_obj)
    r = Renderer(fs, dataclasses.replace(cfg, bvh_wide=2), bvh=bvh)
    assert r.route == "single" and "fatnodes" in r.tables, r.route
    keep = {}
    nrc_frames(r, cam_obj, _route_wrappers("fat"), 1, 2, "nrc-routes fat2", may_idle=("any_fat",), keep=keep)
    hold_nrc_frame("nrc-routes fat2 139k", keep, ref, "the fat4 NRC frame")
    hold_launches("nrc fat2 frame", walk_launches(lambda: r.render(cam_obj)))
    del r, ref, keep
    clock.done("nrc-routes fat2")

    # 13d. The ~2M scene on the paged route (K6a) and with bvh_wide=2
    # (fat2 subtree chunks: K7, and K8 on the single-leaf chunks).
    t0 = time.perf_counter()
    fs2 = huge_scene(seed=0)
    bvh2 = build_bvh_native(fs2.tri_pos, max_leaf=15)
    cam2 = bench_camera(fs2)
    rp = Renderer(fs2, cfg, bvh=bvh2)
    log(f"nrc-routes huge: {fs2.num_triangles} triangles, route {rp.route}, scene, BVH and tables "
        f"{time.perf_counter() - t0:.1f} s")
    assert rp.route == "paged", rp.route
    keep_p = {}
    nrc_frames(rp, cam2, _route_wrappers("fat4_paged"), 1, 1, "nrc-routes 2M paged", may_idle=("any_fat4_paged",),
               keep=keep_p)
    keep_p = {k: keep_p[k] for k in ("hit", "ldr", "nrc_loss", "nrc_query_frac")}
    rf = Renderer(fs2, dataclasses.replace(cfg, bvh_wide=2), bvh=bvh2)
    chunks = rf.tables.get("chunks", [])
    log(f"nrc-routes 2M fat2: route {rf.route}, {len(chunks)} chunks ({sum('fatnodes' in c for c in chunks)} "
        f"fat2, {sum('nodes' in c for c in chunks)} one-node)")
    assert rf.route == "subtree" and any("nodes" in c for c in chunks), rf.route
    keep_f = {}
    nrc_frames(rf, cam2, _route_wrappers("fat", node=True), 1, 1, "nrc-routes 2M fat2",
               may_idle=("any_fat", "any_node"), keep=keep_f)
    assert torch.equal(keep_f["hit"], keep_p["hit"]), "2M fat2 NRC frame: hit mask differs from the paged frame"
    log(f"nrc-routes 2M fat2: hit mask equal to the paged NRC frame's; nrc_loss {float(keep_f['nrc_loss']):.6f} "
        f"vs {float(keep_p['nrc_loss']):.6f}, query_frac {float(keep_f['nrc_query_frac']):.6f} vs "
        f"{float(keep_p['nrc_query_frac']):.6f}")
    hold_launches("nrc 2M fat2 frame", walk_launches(lambda: rf.render(cam2)))
    del rf, keep_f, keep_p, chunks
    torch.cuda.empty_cache()
    clock.done("nrc-routes 2M")

    # 13e. Refit at 2M on the paged fat4 table (a plain frame: the refit
    # against a rebuild at the frame tolerance).
    moves2 = instance_moves(fs2)
    times = timed_updates(lambda: rp.update_instances(moves2))
    log(f"nrc-routes 2M update_instances (paged fat4): first call {times[0]:.3f} s, then "
        f"{statistics.mean(times[1:]):.2f} ms (runs {[round(t, 2) for t in times[1:]]})")
    profile_frame(lambda: rp.update_instances(moves2), (), statistics.mean(times[1:]), phases=(),
                  what="2M update_instances")
    plain = dataclasses.replace(cfg, enable_nrc=False)
    rp.update_config(plain)
    rp.state = init_frame_state(plain, dev)
    paged = _route_wrappers("fat4_paged")
    out, mean_ms, ftimes, _ = _frames(rp, cam2, paged, n_timed=1)
    t0 = time.perf_counter()
    ref_r = rebuilt(fs2, rp)
    log(f"nrc-routes 2M rebuild (BVH and tables) {time.perf_counter() - t0:.2f} s, route {ref_r.route}")
    ref, ref_ms, _, _ = _frames(ref_r, cam2, paged, n_timed=1)
    log(f"nrc-routes 2M refit frame {mean_ms:.2f} ms, rebuilt {ref_ms:.2f} ms")
    hold_frame("nrc-routes 2M refit", out, ref, "the rebuild")
    del rp, ref_r, out, ref, fs2, bvh2
    torch.cuda.empty_cache()
    clock.done("nrc-routes 2M refit")

    # 13f. Refit under the cache: the bench scene's fat4 table and the 247k
    # subtree route (repacked to paged), NRC frames against a rebuild from
    # the same cache.
    subtree = dataclasses.replace(cfg, chunk_mode="subtree")
    for tag, fs_, bvh_, cam_, c in (("139k fat4", fs, bvh, cam_obj, cfg),
                                     ("247k subtree", fs_l, bvh_l, cam_l, subtree)):
        r = Renderer(fs_, c, bvh=bvh_)
        route, cache, aabb = r.route, r.state["nrc"], r.scene["aabb_min"].clone()
        moves = instance_moves(fs_)
        times = timed_updates(lambda: r.update_instances(moves))
        assert r.state["nrc"] is cache and torch.equal(r.scene["aabb_min"], aabb), f"{tag}: refit lost the cache"
        assert r.route == ("paged" if route == "subtree" else route), r.route
        r.state = init_frame_state(c, dev)
        out = r.render(cam_)
        ref_r = rebuilt(fs_, r)
        ref = ref_r.render(cam_)
        log(f"nrc-routes refit {tag}: route {route} -> {r.route}, update_instances first call {times[0]:.3f} s, "
            f"then {statistics.mean(times[1:]):.2f} ms; rebuild route {ref_r.route}")
        hold_nrc_frame(f"nrc-routes refit {tag}", out, ref, "the rebuild")
        del r, ref_r, out, ref
    clock.done("nrc-routes refit")

    # 13g. One NRC train step on the 247k subtree route, K5 on its launches.
    r = Renderer(fs_l, subtree, bvh=bvh_l)
    params, frozen = split_scene_params(r.scene)
    params["sun"] = r.sun
    opt = _recording_adam()
    step, _ = make_train_step(r.cfg, frozen, r.tables, optimizer=opt, device=dev)
    target = torch.zeros((HEIGHT, WIDTH, 3), dtype=torch.float32, device=dev)
    recs, uninstall = _spy(ksvgf, "atrous_step_bwd")
    try:
        t0 = time.perf_counter()
        _p, _o, _s, loss, img = step(params, opt.init(params), make_camera_arrays(cam_l, WIDTH, HEIGHT, dev),
                                     init_frame_state(r.cfg, dev), target)
        float(loss)
        step_ms = (time.perf_counter() - t0) * 1e3
    finally:
        uninstall()
    grads = _grad_report(opt)
    assert bool(torch.isfinite(loss)) and bool(torch.isfinite(img).all()), "non-finite NRC train step"
    for name, g in grads.items():
        assert bool(torch.isfinite(g).all()), f"non-finite gradient of {name}"
    assert len(recs) == cfg.svgf_atrous_passes, f"K5 launched {len(recs)} times"
    err = 0.0
    for a in recs:
        err = max(err, float((ksvgf.atrous_step_bwd(*a) - ksvgf.atrous_step_bwd_plain(*a)).abs().max()))
    assert err == 0.0, f"nrc 247k subtree step: K5 max error {err}"
    log(f"nrc-routes 247k subtree train step: {step_ms:.2f} ms (first step), loss {float(loss):.6f}, gradients "
        f"finite; K5 on its {len(recs)} launches max err 0")
    del r, params, frozen, opt, step, recs, img, fs_l, bvh_l
    torch.cuda.empty_cache()
    clock.done("nrc-routes step")

    # 13h. 64x64 NRC frames with jitter and the env-map sky on the GPU
    # against the CPU plain path.
    small = small_atrium(0)
    small_nrc_check(small, atrium_camera(small), what="nrc-routes small frames (jitter, env map)",
                    options=dict(jitter_primary=True, enable_envmap=True), env_map=env)
    clock.done("nrc-routes small")


# Phase 11: the app on a glTF scene.  3 warm-up and 8 timed frames.
APP_WARM, APP_TIMED = 3, 8


def app_field_files(tmp: Path) -> tuple[Path, Path]:
    """The ~139k-triangle torus field (bench_scene's geometry, 8 torus
    materials and the ground) written by write_gltf as field.glb and as
    field.gltf with field.bin and PNG files, with maps at Sponza's sizes:
    a 1024x1024 base colour map for each of 7 materials, one 2048x2048
    metallic-roughness map (halved by --max-texture-dim 1024), one 512x512
    normal map (upsampled into every slot) and one 1000x750 emissive map
    (the 8th material's slot is 750x1000; its mips reach 375 -> 187 rows,
    a non-integer area resize).  The torus of material 0 has no TANGENT."""
    import numpy as np

    from nebulae_tpu_torch.utils import testscenes as ts

    fs = ts.torus_field(0, nx=3, nz=3, nu=110, nv=70, n_materials=8, map_size=8)
    rng = np.random.default_rng(11)
    normal = ts._material_maps(rng, 512)[2]
    mr = ts._material_maps(rng, 2048)[1]
    yy, xx = np.mgrid[0:750, 0:1000]
    glow = ((np.sin(xx / 37.0) * np.cos(yy / 23.0)) * 0.5 + 0.5) * 255.0
    emissive = np.stack([glow, glow * 0.8, 255.0 - glow, np.full_like(glow, 255.0)], -1).astype(np.uint8)
    mats = ts.scene_materials(fs)
    for m in range(8):
        mats[m].update(base_color=ts._material_maps(rng, 1024)[0] if m < 7 else None,
                       metallic_roughness=mr if m < 7 else None, normal=normal,
                       emissive=emissive if m == 7 else None)
    mats[7]["emissive_factor"] = np.float32([2.0, 1.6, 1.0])
    return ts.write_gltf(tmp / "field.glb", fs, mats), ts.write_gltf(tmp / "field.gltf", fs, mats)


def _frames_of(out: Path) -> list:
    from nebulae_tpu_torch.utils.png import read_png

    return [read_png(p) for p in sorted(out.glob("frame_*.png"))]


def _u8_close(a, b, what: str) -> list:
    """8-bit frames from two devices: the share of pixels whose channels
    all differ by at most 1 must be >= 0.99 and the mean of each pixel's
    largest difference < 0.25, as tests/test_torch_app.py holds the port to
    JAX (the frame checks' rtol 1e-3 / atol 1e-4 on ldr move an sRGB byte
    by at most 0.33 before rounding).  Returns [share, mean]."""
    import numpy as np

    assert a.shape == b.shape, f"{what}: shapes {a.shape} and {b.shape}"
    d = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(-1)
    share, mean = float((d <= 1).mean()), float(d.mean())
    assert share >= 0.99 and mean < 0.25, f"{what}: {share:.4f} of pixels within 1 level, mean difference {mean:.4f}"
    return [share, mean]


def last_frame_events(events, first: str = "nebulae/gbuffer") -> list:
    """The Chrome-trace events of a profiled run of several frames that
    belong to its last frame: host events from the last `first` range on,
    and device events launched from then on (by their launch's
    correlation; an untraced launch by the device event's own start)."""
    cut = max(e["ts"] for e in events if e.get("cat") == "user_annotation" and e.get("name") == first)
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if (e.get("cat") or "").startswith("cuda_") and "correlation" in e.get("args", {})}

    def when(e):
        if e.get("cat") in DEVICE_CATS:
            return launch_ts.get(e.get("args", {}).get("correlation"), e.get("ts", cut - 1))
        return e.get("ts", cut - 1)

    return [e for e in events if when(e) >= cut]


def app_phase(smi: str) -> dict:
    """Phase 11: the app (`nebulae_tpu_torch.app.run`, the loop of `main`)
    on a ~139k-triangle glTF at its defaults: 1920x1080, 1 spp, 8 bounces,
    SVGF, ACES, an orbiting camera.  Writes the scene as .glb and .gltf and
    loads both (equal arrays; seconds by stage and the BVH build); times
    3 + 8 frames (frame_ms from metrics.jsonl, launch counts around the
    run); profiles 3 orbiting frames (--profile) and reads the 3rd, whose
    history is reprojected; holds K1-K3 on each launch of one
    app frame; resumes from a checkpoint without and with --nrc (the resumed
    frames equal the uninterrupted run's, byte for byte); renders a
    --bvh-wide 2 frame (K7) and a --tracer bvh frame (equal to --tracer
    pallas); and holds 64x64 app frames on the GPU, with GI and without, to
    --device cpu.  Returns the numbers it logs."""
    import tempfile

    import torch

    from nebulae_tpu_torch.utils import crashdump

    try:
        with tempfile.TemporaryDirectory() as tmp:
            return _app_phase(smi, Path(tmp))
    finally:
        crashdump.uninstall()  # the app installed its crash hook on this process
        torch.cuda.empty_cache()


def _app_phase(smi: str, tmp: Path) -> dict:
    import numpy as np
    import torch

    from nebulae_tpu_torch import app
    from nebulae_tpu_torch.bvh.cbuilder import build_bvh_native
    from nebulae_tpu_torch.core.scene import load_scene
    from nebulae_tpu_torch.kernels import svgf as ksvgf
    from nebulae_tpu_torch.kernels import trace as kt
    from nebulae_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from nebulae_tpu_torch.utils.testscenes import textured_scene, write_gltf

    res = {"device": smi}
    fat4 = {"closest_fat4": kt.closest_hit_fat4, "shadow_closest_fat4": kt.shadow_closest_fat4,
            "any_fat4": kt.any_hit_fat4, "atrous_fwd": ksvgf.atrous_step}
    t0 = time.perf_counter()
    glb, gltf = app_field_files(tmp)
    res["write_s"] = time.perf_counter() - t0
    scenes = {}
    for path in (glb, gltf):
        t0 = time.perf_counter()
        scenes[path.suffix] = load_scene(path, max_texture_dim=1024)
        log(f"app load {path.name}: {time.perf_counter() - t0:.3f} s ("
            + ", ".join(f"{k} {v:.3f}" for k, v in scenes[path.suffix].seconds.items()) + ")")
    a, b = (scenes[k].flat.field_arrays() for k in (".glb", ".gltf"))
    for k, v in a.items():
        assert (v is None and b[k] is None) or np.array_equal(v, b[k]), f"app load: {k} differs, .glb vs .gltf"
    fs = scenes[".glb"].flat
    res["load_s"] = dict(scenes[".glb"].seconds)
    t0 = time.perf_counter()
    fs.device_arrays()
    res["load_s"]["atlas_mips_quad_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bvh = build_bvh_native(fs.tri_pos, max_leaf=15)
    res["load_s"]["bvh_s"] = time.perf_counter() - t0
    log(f"app scene: {fs.num_triangles} triangles, {fs.num_materials} materials, {fs.textures.shape[0]} "
        f"maps, atlas {fs.mat_tex.shape} (slots {fs.mat_tex_hw.tolist()}); .glb and .gltf loads equal; "
        f"seconds {json.dumps({k: round(v, 3) for k, v in res['load_s'].items()})}, {bvh.num_nodes} BVH nodes")
    del scenes, a, b, bvh
    common = ["--scene", str(glb), "--crash-dir", str(tmp / "crash")]

    # The app at its defaults with an orbiting camera.
    out = tmp / "run"
    _zero(fat4)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = app.run(common + ["--frames", str(APP_WARM + APP_TIMED), "--orbit-speed", "0.5", "--out", str(out)])
    run_s = time.perf_counter() - t0
    n = {k: f.launches for k, f in fat4.items()}
    rows = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    frames = _frames_of(out)
    assert len(rows) == len(frames) == APP_WARM + APP_TIMED and (out / "heartbeat").exists(), "app outputs"
    assert all(float(f[..., :3].std()) > 1.0 for f in frames), "app: a constant frame"
    per_frame = {k: c / len(rows) for k, c in n.items()}
    cfg = r.cfg
    assert (cfg.width, cfg.height, cfg.max_bounces, cfg.spp) == (1920, 1080, 8, 1) and r.route == "single"
    assert per_frame["closest_fat4"] == 1 and per_frame["atrous_fwd"] == cfg.svgf_atrous_passes, per_frame
    assert 1 <= per_frame["shadow_closest_fat4"] <= cfg.max_bounces - 1, per_frame
    timed = [row["frame_ms"] for row in rows[APP_WARM:]]
    res["frame_ms"] = {"median": statistics.median(timed), "min": min(timed), "max": max(timed),
                       "all": timed}
    res["launches_per_frame"] = per_frame
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"app frames ({smi}): frame_ms median {res['frame_ms']['median']:.2f} (min {min(timed):.2f}, max "
        f"{max(timed):.2f}; timed {[round(t, 2) for t in timed]}; warm-up "
        f"{[round(x['frame_ms'], 2) for x in rows[:APP_WARM]]}), run {run_s:.1f} s with the load, peak "
        f"{res['peak_gib']:.2f} GiB, launches per frame {json.dumps(per_frame)}")
    del r

    # Three orbiting frames under the profiler (--profile), the third read:
    # its SVGF history exists and the moved camera reprojects it, as on
    # every timed frame above.  Then K1-K3 on each launch of one app frame.
    prof_dir = tmp / "prof"
    app.run(common + ["--frames", "3", "--orbit-speed", "0.5", "--out", str(tmp / "prof_out"),
                      "--profile", str(prof_dir)])
    events = last_frame_events(json.loads((prof_dir / "trace.json").read_text())["traceEvents"])
    prof_ms = json.loads((tmp / "prof_out" / "metrics.jsonl").read_text().splitlines()[-1])["frame_ms"]
    rep = profile_report(events, FAT4_KERNELS, res["frame_ms"]["median"], prof_ms, what="app frame (3rd, orbiting)",
                         nested=("nebulae/svgf_reproject",))
    reproject_ms = rep["nested"]["nebulae/svgf_reproject"]["ms"]
    assert reproject_ms > 0, "the profiled app frame reprojected no history"
    res["profile"] = {"busy_ms": rep["busy_ms"], "launches": rep["launches"], "reproject_ms": reproject_ms,
                      "phases": {k: round(v, 3) for k, v in rep["phases"].items()}}
    log(f"app profile ({smi}): 3rd orbiting frame busy {rep['busy_ms']:.2f} ms, of it reprojection "
        f"{reproject_ms:.3f} ms, launches {json.dumps(rep['launches'])}")
    held = {}

    def record():
        held["r"] = app.run(common + ["--frames", "1", "--out", str(tmp / "held")])

    k1s, k2s, k3s = recorded_launches(record, kt.closest_hit_fat4, kt.shadow_closest_fat4, kt.any_hit_fat4)
    hold_walk_launches("app frame", held.pop("r").tables, k1s, k2s, k3s)
    res["held_launches"] = [len(k1s), len(k2s), len(k3s)]
    del k1s, k2s, k3s

    # Resume: 8 frames with a checkpoint after 4, then 4 frames resumed
    # from it; without and with the radiance cache, no orbit.
    res["resume"] = {}
    for tag, extra in (("plain", []), ("nrc", ["--nrc"])):
        ck, out_a, out_b = tmp / f"ck_{tag}", tmp / f"a_{tag}", tmp / f"b_{tag}"
        ra = app.run(common + extra + ["--frames", "8", "--checkpoint-dir", str(ck), "--checkpoint-every", "4",
                                       "--out", str(out_a)])
        app.run(common + extra + ["--frames", "4", "--resume", str(ck / "step_00000004"), "--out", str(out_b)])
        fa, fb = _frames_of(out_a), _frames_of(out_b)
        assert len(fa) == 8 and len(fb) == 4
        for i in range(4):
            assert np.array_equal(fa[4 + i], fb[i]), f"resume {tag}: frame {i} differs from frame {4 + i}"
        ms = [json.loads(x)["frame_ms"] for x in (out_a / "metrics.jsonl").read_text().splitlines()][APP_WARM:]
        size = sum(f.stat().st_size for f in (ck / "step_00000004").iterdir())
        t0 = time.perf_counter()
        d = save_checkpoint(tmp / f"ck2_{tag}", ra.state, step=0)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        load_checkpoint(d, ra.state)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        res["resume"][tag] = {"bytes": size, "save_s": save_s, "load_s": load_s,
                              "frame_ms": {"median": statistics.median(ms), "min": min(ms), "max": max(ms)}}
        log(f"app resume {tag} ({smi}): frames 5-8 of the run equal the 4 resumed frames byte for byte; "
            f"checkpoint {size} bytes, save {save_s:.3f} s, load {load_s:.3f} s; the run's frames "
            f"{APP_WARM + 1}-8 (still camera) frame_ms median {statistics.median(ms):.2f} "
            f"({[round(t, 2) for t in ms]})")
        del ra

    # K7 in the app (--bvh-wide 2), and "bvh" against "pallas".
    fat2 = {"closest_fat": kt.closest_hit_fat, "shadow_closest_fat": kt.shadow_closest_fat,
            "any_fat": kt.any_hit_fat}
    _zero(fat2)
    app.run(common + ["--frames", "1", "--bvh-wide", "2", "--out", str(tmp / "fat2")])
    n2 = {k: f.launches for k, f in fat2.items()}
    assert n2["closest_fat"] == 1 and n2["shadow_closest_fat"] >= 1, f"--bvh-wide 2: launches {n2}"
    for tracer in ("pallas", "bvh"):
        app.run(common + ["--frames", "1", "--tracer", tracer, "--out", str(tmp / tracer)])
    f_p, f_b, f_2 = (_frames_of(tmp / k)[0] for k in ("pallas", "bvh", "fat2"))
    assert np.array_equal(f_p, f_b), "--tracer bvh frame differs from --tracer pallas"
    res["fat2_launches"] = n2
    res["fat2_vs_fat4_equal_px"] = float((f_2 == f_p).all(-1).mean())
    log(f"app --bvh-wide 2: launches {json.dumps(n2)}, {res['fat2_vs_fat4_equal_px']:.4f} of pixels equal to "
        "the fat4 frame; --tracer bvh frame equals --tracer pallas")

    # 64x64 app frames on the GPU against --device cpu (the plain
    # versions), with GI and direct light only.
    small = write_gltf(tmp / "small.glb", textured_scene(0))
    res["small"] = {}
    k3 = kt.any_hit_fat4.launches
    for tag, extra in (("gi", []), ("direct", ["--no-gi"])):
        for dev in ("cuda", "cpu"):
            app.run(["--scene", str(small), "--crash-dir", str(tmp / "crash"), "--width", "64", "--height", "64",
                     "--frames", "2", "--out", str(tmp / f"s_{tag}_{dev}"), "--device", dev] + extra)
        shares = [_u8_close(g, c, f"64x64 app frame {i} ({tag})") for i, (g, c) in enumerate(
            zip(_frames_of(tmp / f"s_{tag}_cuda"), _frames_of(tmp / f"s_{tag}_cpu"), strict=True))]
        res["small"][tag] = shares
        log(f"app 64x64 {tag}: GPU against the CPU plain path, [share of pixels within 1 level, mean "
            f"difference] {shares}")
    assert n["any_fat4"] + kt.any_hit_fat4.launches - k3 > 0, "K3 launched on no app frame"
    log(f"app: {json.dumps({k: v for k, v in res.items() if k != 'device'})} ({smi})")
    return res


# Phase 12: distribution.  Two ranks on the one card, each a process of
# this script (--dist-worker), over gloo with host staging (one GPU for two
# ranks: NCCL refuses a device twice); then a world of one over NCCL.  The
# worker holds kernels with this script's hold_* helpers, so it lives here;
# it starts and ends through nebulae_tpu_torch.dist.dryrun's spawn and join.
DIST_RANKS, DIST_WARM, DIST_TIMED, DIST_STEPS = 2, 3, 5, 3
DIST_TIMEOUT = 300
DIST_PARTS = ("still", "hold", "orbit", "step", "nrc", "fat2", "large")


def _dist_setup(world, fs, bvh, **options):
    """The bench configuration (lean outputs off, so the frame's hdr and
    denoised buffers can be compared too) on a DistRenderer of `world`."""
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.dist.runner import DistRenderer

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=SPP, max_bounces=BOUNCES, enable_svgf=True,
                       enable_tonemap=True, **options)
    if world is None:
        from nebulae_tpu_torch.engine.renderer import Renderer

        return cfg, Renderer(fs, cfg, bvh=bvh)
    return cfg, DistRenderer(fs, cfg, world, bvh=bvh)


def _dist_frames(world, r, cams, n_warm, what):
    """n_warm + the rest of `cams` as frames; the timed frames' ms and each
    one's collectives (comm's log).  Returns (last outputs, times, stats)."""
    import torch

    from nebulae_tpu_torch.dist.stats import collective_stats

    times, stats = [], []
    for i, cam in enumerate(cams):
        n0 = len(world.log) if world is not None else 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = r.render(cam)
        torch.cuda.synchronize()
        if i >= n_warm:
            times.append((time.perf_counter() - t0) * 1e3)
            if world is not None:
                stats.append(collective_stats(list(world.log)[n0:]))
    log(f"{what}: frames {[round(t, 2) for t in times]} ms, mean {statistics.mean(times):.2f}")
    return out, times, stats


def _mean_stats(stats) -> dict:
    """Per-frame means of collective_stats by op: count, bytes of the
    results on the rank, bytes the rank sent, host ms."""
    fields = ("count", "bytes", "sent", "ms")
    ops = sorted({k for s in stats for k in s if not k.startswith("total")})
    out = {op: {f: statistics.mean(s.get(op, {}).get(f, 0) for s in stats) for f in fields} for op in ops}
    out["tags"] = {}
    for s in stats:
        for op in ops:
            for tag, b in s.get(op, {}).get("tags", {}).items():
                out["tags"][tag] = out["tags"].get(tag, 0) + b / len(stats)
    for f in ("bytes", "sent", "ms"):
        out[f"total_{f}"] = statistics.mean(s[f"total_{f}"] for s in stats)
    return out


def _gathered(world, out) -> dict:
    """The frame's image outputs gathered from every rank, on the host."""
    import torch

    from nebulae_tpu_torch.dist.runner import present_gather

    return {k: present_gather(world, out[k].to(torch.uint8) if k == "hit" else out[k]).cpu()
            for k in ("hdr", "denoised", "ldr", "hit")}


def _spy(module, name: str):
    """Record the inputs of each call of module.name while installed;
    returns (records, uninstall).  A wrapper counts its launches on
    whatever its module's name holds, so the spy carries the count and
    hands what it gained back to the wrapper."""
    real, recs = getattr(module, name), []

    def spy(*args):
        recs.append(tuple(a.detach().clone() if hasattr(a, "detach") else a for a in args))
        return real(*args)

    spy.launches = start = real.launches
    setattr(module, name, spy)

    def uninstall():
        setattr(module, name, real)
        real.launches += spy.launches - start

    return recs, uninstall


def _hold_exact(what, kernel, plain, recs) -> float:
    """kernel(*a) against plain(*a) on each record, every output at max
    error 0; logs the launches' shapes.  Returns the max error."""
    err = 0.0
    for a in recs:
        ks, ps = kernel(*a), plain(*a)
        for k, p in zip(ks if isinstance(ks, tuple) else (ks,), ps if isinstance(ps, tuple) else (ps,),
                        strict=True):
            err = max(err, float((k - p).abs().max()))
    assert err == 0.0, f"{what}: max error {err}"
    log(f"{what}: {len(recs)} launches on {[tuple(a[0].shape) for a in recs]} "
        f"(the rank's rows and their halo), max err {err:.3g}")
    return err


def _collective_device_ms(events) -> float:
    """Device ms (union of spans) of the work that c10d ops launched: the
    device events whose launch, by correlation, lies in a c10d:: op's host
    span."""
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name", "").startswith("c10d::") and "dur" in e]
    corr = {e["args"]["correlation"] for e in events
            if (e.get("cat") or "").startswith("cuda_") and "correlation" in e.get("args", {})
            and any(a <= e["ts"] <= b for a, b in spans)}
    return _union_ms((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") in DEVICE_CATS and "dur" in e and e.get("args", {}).get("correlation") in corr)


def dist_worker(argv) -> int:
    """One rank of phase 12 on the bench scene at 1080p through a
    DistRenderer, the parts of DIST_PARTS that --parts names: still frames
    (one profiled), K1-K4 held on each launch of rank 0's frame, orbiting
    frames, train steps (K5 held on each launch of rank 0's step), an NRC
    frame, a bvh_wide=2 frame (K7a-c held on rank 0's launches) and a
    frame of the 247k scene on the subtree route.  Rank 0 saves the
    gathered frames, the summed gradients and a JSON summary to --out."""
    import argparse

    import torch
    from torch.profiler import ProfilerActivity, profile

    from nebulae_tpu_torch.bvh.cbuilder import build_bvh_native
    from nebulae_tpu_torch.dist.dryrun import cameras, step_inputs
    from nebulae_tpu_torch.dist.mesh import init_distributed
    from nebulae_tpu_torch.dist.runner import replicas_equal
    from nebulae_tpu_torch.dist.stats import collective_stats
    from nebulae_tpu_torch.engine.train import flatten_params, loss_and_grads, make_train_step
    from nebulae_tpu_torch.kernels import svgf as ksvgf
    from nebulae_tpu_torch.kernels import trace as kt
    from nebulae_tpu_torch.passes import svgf as psvgf
    from nebulae_tpu_torch.utils.testscenes import bench_camera, bench_scene, large_scene

    p = argparse.ArgumentParser("chip_smoke.py --dist-worker")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--init-method", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--parts", default=",".join(DIST_PARTS))
    args = p.parse_args(argv)
    parts = args.parts.split(",")
    torch.backends.cuda.matmul.allow_tf32 = False
    world = init_distributed(None, args.world_size, args.rank, device="cuda", init_method=args.init_method,
                             timeout_s=DIST_TIMEOUT)
    lead = world.rank == 0
    tag = f"dist {world.backend} rank {world.rank} of {world.size}"
    res, saved = {"rank": world.rank, "backend": world.backend}, {}
    try:
        t0 = time.perf_counter()
        fs = bench_scene(seed=0)
        bvh = build_bvh_native(fs.tri_pos, max_leaf=15)
        cfg, r = _dist_setup(world, fs, bvh)
        res["setup_s"] = time.perf_counter() - t0
        still = [bench_camera(fs)] * (DIST_WARM + DIST_TIMED)
        fat4 = {"closest_fat4": kt.closest_hit_fat4, "shadow_closest_fat4": kt.shadow_closest_fat4,
                "any_fat4": kt.any_hit_fat4, "atrous_fwd": ksvgf.atrous_step}
        _zero(fat4)
        out, times, stats = _dist_frames(world, r, still, DIST_WARM, f"{tag} still")
        res["still"] = {"ms": times, "collectives": _mean_stats(stats),
                        "launches": {k: f.launches / len(still) for k, f in fat4.items()}}
        missing = [k for k, f in fat4.items() if f.launches == 0]
        assert not missing, f"kernels not launched on {tag}'s frames: {missing}"
        saved["still"] = _gathered(world, out)

        # One still frame under the profiler: device busy, the collectives'
        # device work (NCCL's; gloo's runs on the host, its staging copies
        # outside the c10d ops), and the c10d ops the profiler saw against
        # comm's log.
        n0 = len(world.log)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            r.render(still[0])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - w0) * 1e3
        events = _trace_events(prof)
        c10d = sorted(e["name"] for e in events if e.get("name", "").startswith("c10d::"))
        logged = sorted(e["op"] for e in list(world.log)[n0:])
        coll_ms = _collective_device_ms(events)
        rep = profile_report(events, FAT4_KERNELS, statistics.mean(times), wall, what=f"{tag} still frame")
        res["profile"] = {"busy_ms": rep["busy_ms"], "wall_ms": wall, "phases": rep["phases"],
                          "collective_device_ms": coll_ms, "c10d_events": len(c10d), "logged": len(logged),
                          "c10d_names": sorted(set(c10d))}
        log(f"{tag} profiled still frame: busy {rep['busy_ms']:.2f} ms, collectives' device work {coll_ms:.4f} ms, "
            f"c10d ops {len(c10d)}, logged {len(logged)}")
        assert len(c10d) == len(logged), f"profiler saw {c10d}, comm logged {logged}"

        if "hold" in parts:
            # K1-K4 on each launch of this rank's frame, held against their
            # plain versions (max error 0); every rank renders, rank 0 holds.
            k4s, uninstall = _spy(psvgf, "atrous_step")
            try:
                k1s, k2s, k3s = recorded_launches(lambda: r.render(still[0]), kt.closest_hit_fat4,
                                                  kt.shadow_closest_fat4, kt.any_hit_fat4)
            finally:
                uninstall()
            if lead:
                hold_walk_launches("rank 0 frame", r.tables, k1s, k2s, k3s)
                _hold_exact("K4 on rank 0's frame", ksvgf.atrous_step, ksvgf.atrous_step_plain, k4s)
                res["held"] = [len(k1s), len(k2s), len(k3s), len(k4s)]
            del k1s, k2s, k3s, k4s

        if "orbit" in parts:
            # Orbiting frames: the history is reprojected, gathered whole.
            _, r_orbit = _dist_setup(world, fs, bvh)
            out, times, stats = _dist_frames(world, r_orbit, cameras(fs, DIST_WARM + DIST_TIMED, 0.5), DIST_WARM,
                                             f"{tag} orbit")
            res["orbit"] = {"ms": times, "collectives": _mean_stats(stats)}
            saved["orbit"] = _gathered(world, out)
            del r_orbit

        if "step" in parts:
            # Train steps: params fixed, the state threaded; a further step
            # records K5's inputs (untimed: the records are copies), held on
            # rank 0; then the summed loss and gradients from a fresh state,
            # for the single step.
            params, frozen, cam, state, target = step_inputs(r, cfg, still[0], world)
            step, opt = make_train_step(cfg, frozen, r.tables, device=world.device, world=world)
            opt_state = opt.init(params)
            times, stats = [], []
            ksvgf.atrous_step_bwd.launches = 0
            for i in range(1 + DIST_STEPS):
                n0 = len(world.log)
                torch.cuda.synchronize()
                s0 = time.perf_counter()
                new_params, new_opt, state, loss, _ = step(params, opt_state, cam, state, target)
                float(loss)
                if i:
                    times.append((time.perf_counter() - s0) * 1e3)
                    stats.append(collective_stats(list(world.log)[n0:]))
            n_k5 = ksvgf.atrous_step_bwd.launches
            assert replicas_equal(world, (flatten_params(new_params), new_opt)), "params differ between ranks"
            assert n_k5 == 4 * (1 + DIST_STEPS), f"K5 launched {n_k5} times on the 2-rank steps"
            log(f"{tag} train: steps {[round(t, 2) for t in times]} ms, loss {float(loss):.6f}, K5 {n_k5} launches")
            res["step"] = {"ms": times, "collectives": _mean_stats(stats), "k5_launches": n_k5}
            k5s, uninstall = _spy(ksvgf, "atrous_step_bwd")
            try:
                float(step(params, opt_state, cam, state, target)[3])
            finally:
                uninstall()
            assert len(k5s) == 4, f"K5 launched {len(k5s)} times on the recorded step"
            if lead:
                _hold_exact("K5 on rank 0's step", ksvgf.atrous_step_bwd, ksvgf.atrous_step_bwd_plain, k5s)
                res["held"] = res.get("held", []) + [len(k5s)]
            del k5s
            p0, f0, c0, s0_, t0_ = step_inputs(r, cfg, still[0], world)
            loss, grads, _, _ = loss_and_grads(p0, f0, r.tables, c0, s0_, t0_, cfg, device=world.device,
                                               world=world)
            saved["loss"], saved["grads"] = loss.cpu(), [g.cpu() for g in grads]
            del step, opt, state, params, opt_state, new_params, new_opt

        if "nrc" in parts:
            # The radiance cache: every rank trains it; DistRenderer.render
            # holds the caches equal by digest.
            _, r_nrc = _dist_setup(world, fs, bvh, enable_nrc=True)
            out, times, _ = _dist_frames(world, r_nrc, [still[0]] * 2, 1, f"{tag} nrc")
            res["nrc"] = {"ms": times, "query_frac": float(out["nrc_query_frac"])}
            saved["nrc"] = _gathered(world, out)
            del r_nrc

        if "fat2" in parts:
            # bvh_wide=2 (K7): one timed frame, then K7a-c on each launch of
            # a second one, held on rank 0.
            fat2 = {"closest_fat": kt.closest_hit_fat, "shadow_closest_fat": kt.shadow_closest_fat,
                    "any_fat": kt.any_hit_fat}
            _zero(fat2)
            _, r2 = _dist_setup(world, fs, bvh, bvh_wide=2)
            out, times, _ = _dist_frames(world, r2, [still[0]], 0, f"{tag} bvh_wide=2")
            res["fat2"] = {"ms": times, "launches": {k: f.launches for k, f in fat2.items()}}
            assert fat2["closest_fat"].launches == 1 and fat2["shadow_closest_fat"].launches >= 1, res["fat2"]
            saved["fat2"] = _gathered(world, out)
            k7s = recorded_launches(lambda: r2.render(still[0]), kt.closest_hit_fat, kt.shadow_closest_fat,
                                    kt.any_hit_fat)
            if lead:
                hold_walk_launches("rank 0 bvh_wide=2 frame", r2.tables, *k7s, table="fat")
                res["held_fat2"] = [len(k) for k in k7s]
            del r2, k7s

        if "large" in parts:
            lf = large_scene(seed=0)
            _, r3 = _dist_setup(world, lf, build_bvh_native(lf.tri_pos, max_leaf=15), chunk_mode="subtree")
            out, times, _ = _dist_frames(world, r3, [bench_camera(lf)], 0, f"{tag} 247k {r3.route}")
            res["large"] = {"ms": times, "route": r3.route}
            saved["large"] = _gathered(world, out)
        if lead:
            torch.save(saved, Path(args.out) / "rank0.pt")
            (Path(args.out) / "rank0.json").write_text(json.dumps(res))
    finally:
        world.close()
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _same_frame(what, got, ref) -> dict:
    """A gathered 2-rank frame against the single-process frame: the hit
    mask equal and >= 99% of pixels within rtol 1e-3 / atol 1e-4; logs
    whether it is equal byte for byte and, if not, the max error of each
    buffer (hdr before SVGF, denoised after, ldr after ACES), which says
    which stage first differs."""
    import torch

    errs = {k: float((got[k].float() - ref[k].float()).abs().max()) for k in ("hdr", "denoised", "ldr", "hit")}
    assert errs["hit"] == 0.0, f"{what}: hit mask differs from the single process's"
    close = float(torch.isclose(got["ldr"], ref["ldr"], rtol=1e-3, atol=1e-4).all(-1).float().mean())
    assert close >= 0.99, f"{what}: {close:.4f} of pixels within rtol 1e-3 / atol 1e-4"
    first = next((k for k in ("hdr", "denoised", "ldr") if errs[k] > 0), None)
    log(f"{what}: " + ("equal to the single-process frame byte for byte" if first is None else
                       f"not equal: max error {json.dumps(errs)}; first differs in {first}; {close:.6f} of "
                       "pixels within rtol 1e-3 / atol 1e-4"))
    return {"exact": first is None, "max_err": errs, "close": close}


def _coll(c) -> str:
    """One frame's or step's collectives, short: by op count, bytes of
    the results on the rank, bytes sent, host ms."""
    return "; ".join(f"{op} x{v['count']:g}: {v['bytes']:,.0f} B on the rank, {v['sent']:,.0f} B sent, "
                     f"{v['ms']:.2f} ms" for op, v in c.items() if isinstance(v, dict) and "count" in v)


def dist_phase(smi: str) -> dict:
    """Phase 12: the port's distribution on the card.  The single-process
    references first, in this process; then 2 ranks (this script with
    --dist-worker) on the bench scene at 1080p; a 1-rank NCCL world at
    1080p (still and orbiting frames) and the 1-rank NCCL dry run
    (nebulae_tpu_torch.dist.dryrun); and the app as 2 processes,
    checkpointed after 4 of 8 frames and resumed, against 1 process."""
    import tempfile

    import torch

    with tempfile.TemporaryDirectory() as tmp:
        try:
            return _dist_phase(smi, Path(tmp))
        finally:
            torch.cuda.empty_cache()


def _dist_phase(smi: str, tmp: Path) -> dict:
    import numpy as np
    import torch

    from nebulae_tpu_torch.bvh.cbuilder import build_bvh_native
    from nebulae_tpu_torch.dist.dryrun import cameras, join, spawn, start, step_inputs
    from nebulae_tpu_torch.engine.train import loss_and_grads
    from nebulae_tpu_torch.utils.png import read_png
    from nebulae_tpu_torch.utils.testscenes import bench_camera, bench_scene, large_scene, write_gltf

    res = {"device": smi}
    # The single-process references, from the same BVH build (the C++
    # builder is deterministic) and the same camera sequences.
    fs = bench_scene(seed=0)
    bvh = build_bvh_native(fs.tri_pos, max_leaf=15)
    cfg, r = _dist_setup(None, fs, bvh)
    still = [bench_camera(fs)] * (DIST_WARM + DIST_TIMED)
    out, times, _ = _dist_frames(None, r, still, DIST_WARM, "single still (reference)")
    ref = {"still": {k: out[k].cpu() for k in ("hdr", "denoised", "ldr", "hit")}}
    res["single_still_ms"] = times
    _, ro = _dist_setup(None, fs, bvh)
    out, times, _ = _dist_frames(None, ro, cameras(fs, DIST_WARM + DIST_TIMED, 0.5), DIST_WARM,
                                 "single orbit (reference)")
    ref["orbit"] = {k: out[k].cpu() for k in ("hdr", "denoised", "ldr", "hit")}
    res["single_orbit_ms"] = times
    p0, f0, c0, s0, t0 = step_inputs(r, cfg, still[0], None)
    loss, grads, _, _ = loss_and_grads(p0, f0, r.tables, c0, s0, t0, cfg, device=r.device)
    ref["loss"], ref["grads"] = loss.cpu(), [g.cpu() for g in grads]
    for tag, options, scene, b in (("nrc", {"enable_nrc": True}, fs, bvh), ("fat2", {"bvh_wide": 2}, fs, bvh)):
        _, rr = _dist_setup(None, scene, b, **options)
        o = rr.render(still[0])
        if tag == "nrc":  # the ranks' second NRC frame
            o = rr.render(still[0])
        ref[tag] = {k: o[k].cpu() for k in ("hdr", "denoised", "ldr", "hit")}
    lf = large_scene(seed=0)
    _, rl = _dist_setup(None, lf, build_bvh_native(lf.tri_pos, max_leaf=15), chunk_mode="subtree")
    o = rl.render(bench_camera(lf))
    ref["large"] = {k: o[k].cpu() for k in ("hdr", "denoised", "ldr", "hit")}
    del r, ro, rr, rl, out, o, p0, f0, c0, s0, t0, grads
    torch.cuda.empty_cache()
    worker = [sys.executable, str(ROOT / "chip_smoke.py"), "--dist-worker"]

    def ranks(n, out, what, init_method, *extra):
        (tmp / out).mkdir()
        t_start = time.perf_counter()
        texts = join(spawn(n, ["--out", str(tmp / out), *extra], init_method, cmd=worker), DIST_TIMEOUT)
        for rank, text in enumerate(texts):
            for line in text.splitlines():
                log(f"[{what} rank {rank}] {line}")
        return (time.perf_counter() - t_start, torch.load(tmp / out / "rank0.pt", weights_only=True),
                json.loads((tmp / out / "rank0.json").read_text()))

    # Two ranks on the card.
    res["ranks_s"], got, w = ranks(DIST_RANKS, "gloo", "gloo", (tmp / "store").as_uri())
    assert w["backend"] == "gloo", w["backend"]
    res["ranks"] = w
    for tag in ("still", "orbit", "fat2", "large"):
        res[f"{tag}_vs_single"] = _same_frame(f"dist {tag} frame (2 ranks, {smi})", got[tag], ref[tag])
    # The NRC frame within the NRC tolerance (PERF.md section 2): on the
    # card each rank's cache MLP multiplies its own rows, another M.
    nrc_close = float(torch.isclose(got["nrc"]["ldr"], ref["nrc"]["ldr"], rtol=1e-2, atol=1e-3)
                      .all(-1).float().mean())
    assert nrc_close >= 0.99, f"dist NRC frame: {nrc_close:.4f} of pixels within rtol 1e-2 / atol 1e-3"
    res["nrc_vs_single"] = {"close": nrc_close, "max_err": float((got["nrc"]["ldr"] - ref["nrc"]["ldr"]).abs().max())}
    rel = abs(float(got["loss"]) - float(ref["loss"])) / abs(float(ref["loss"]))
    cos = []
    for a, b in zip(got["grads"], ref["grads"]):
        a, b = a.double().reshape(-1), b.double().reshape(-1)
        cos.append(1.0 if float(b.norm()) == 0.0 and float(a.norm()) == 0.0 else
                   float(a @ b / (a.norm() * b.norm())))
    assert rel <= 1e-5 and min(cos) >= 0.9999, f"dist gradients: loss rel {rel:.3g}, cosines {cos}"
    res["grads_vs_single"] = {"loss_rel": rel, "cosines": cos}
    med = statistics.median
    log(f"dist summary ({smi}): medians single still {med(res['single_still_ms']):.2f} ms, 2-rank still "
        f"{med(w['still']['ms']):.2f} ms (rank 0 busy {w['profile']['busy_ms']:.2f} ms), orbit "
        f"{med(res['single_orbit_ms']):.2f} -> {med(w['orbit']['ms']):.2f} ms, 2-rank step "
        f"{med(w['step']['ms']):.2f} ms, NRC {med(w['nrc']['ms']):.2f} ms; collectives a still frame "
        f"{_coll(w['still']['collectives'])}; an orbiting frame {_coll(w['orbit']['collectives'])}; a step "
        f"{_coll(w['step']['collectives'])}; by tag (bytes on the rank) still "
        f"{json.dumps(w['still']['collectives']['tags'])}, step {json.dumps(w['step']['collectives']['tags'])}; "
        f"gradients against one process: loss rel {rel:.3g}, min cosine {min(cos):.8f}; NRC frame "
        f"{nrc_close:.6f} of pixels within rtol 1e-2 / atol 1e-3, max error "
        f"{res['nrc_vs_single']['max_err']:.3g}; K1-K5 held on rank 0's launches {w['held']}, K7a-c on its "
        f"bvh_wide=2 frame {w['held_fat2']}; launches a rank-frame {json.dumps(w['still']['launches'])}, on the "
        f"bvh_wide=2 frame {json.dumps(w['fat2']['launches'])}, 247k route {w['large']['route']}; profiler c10d "
        f"ops {w['profile']['c10d_events']} = comm log {w['profile']['logged']}")

    # A world of one on NCCL at 1080p: still and orbiting frames through
    # DistRenderer against the single frames, collectives on the device.
    res["nccl_s"], got, w = ranks(1, "nccl", "nccl", f"tcp://127.0.0.1:{_free_port()}", "--parts", "still,orbit")
    assert w["backend"] == "nccl", w["backend"]
    res["nccl"] = w
    for tag in ("still", "orbit"):
        res[f"nccl_{tag}_vs_single"] = _same_frame(f"dist NCCL world of one, {tag} frame ({smi})", got[tag],
                                                   ref[tag])
    log(f"dist NCCL world of one ({res['nccl_s']:.1f} s, {smi}): medians still {med(w['still']['ms']):.2f} ms "
        f"(single {med(res['single_still_ms']):.2f}), orbit {med(w['orbit']['ms']):.2f} ms (single "
        f"{med(res['single_orbit_ms']):.2f}); busy {w['profile']['busy_ms']:.2f} ms, of it the collectives' "
        f"device work {w['profile']['collective_device_ms']:.4f} ms in the profiled still frame; collectives a "
        f"still frame {_coll(w['still']['collectives'])}; an orbiting frame {_coll(w['orbit']['collectives'])} "
        f"(host ms: NCCL's calls enqueue on the stream and return)")

    # The dry run (an NRC frame, the sharded frame against one process, a
    # train step) through DistRenderer on NCCL, as dryrun_multichip.
    t_start = time.perf_counter()
    (text,) = join(start([[sys.executable, "-m", "nebulae_tpu_torch.dist.dryrun", "--rank", "0", "--world-size",
                           "1", "--coordinator", f"127.0.0.1:{_free_port()}", "--dryrun"]]), DIST_TIMEOUT)
    assert "backend nccl" in text and "dryrun(1): loss=" in text, text
    res["dryrun_s"] = time.perf_counter() - t_start
    log(f"dist NCCL dry run ({res['dryrun_s']:.1f} s): " + " | ".join(
        x.strip() for x in text.splitlines() if "backend" in x or "dryrun(" in x))

    # The app as 2 processes: 8 frames checkpointed after 4, against 1
    # process, then 4 frames resumed from the checkpoint.
    t_start = time.perf_counter()
    glb = write_gltf(tmp / "bench.glb", fs)
    app = [sys.executable, "-m", "nebulae_tpu_torch.app", "--scene", str(glb), "--crash-dir", str(tmp / "crash")]

    def apps(out, *extra):
        port = _free_port()
        return [app + ["--out", str(tmp / out), "--num-processes", "2", "--process-id", str(i), "--coordinator",
                       f"127.0.0.1:{port}", *extra] for i in range(2)]

    ck = tmp / "app_ck"
    join(start(apps("app_a", "--frames", "8", "--checkpoint-dir", str(ck), "--checkpoint-every", "4")
               + [app + ["--out", str(tmp / "app_one"), "--frames", "8"]]), DIST_TIMEOUT)
    join(start(apps("app_b", "--frames", "4", "--resume", str(ck / "step_00000004"))), DIST_TIMEOUT)
    fa, fb, f1 = ([read_png(p) for p in sorted((tmp / d).glob("frame_*.png"))] for d in ("app_a", "app_b", "app_one"))
    assert len(fa) == 8 and len(fb) == 4 and len(f1) == 8
    for i in range(4):
        assert np.array_equal(fa[4 + i], fb[i]), f"app resume: frame {i} differs from frame {4 + i}"
    same = [bool(np.array_equal(a, b)) for a, b in zip(fa, f1)]
    if not all(same):
        res["app_vs_one"] = [_u8_close(a, b, f"2-process app frame {i}") for i, (a, b) in enumerate(zip(fa, f1))]
    res["app_s"] = time.perf_counter() - t_start
    ms = [json.loads(x)["frame_ms"] for x in (tmp / "app_a" / "metrics.jsonl").read_text().splitlines()]
    log(f"dist app ({res['app_s']:.1f} s, {smi}): 2 processes at 1080p, 8 bounces: frames 5-8 equal the 4 resumed "
        f"frames byte for byte; equal to the 1-process frames byte for byte: {same}; rank 0 frame_ms "
        f"{[round(t, 2) for t in ms]}; rank 1 wrote {sorted(p.name for p in (tmp / 'app_a').glob('*.r1*'))}")
    return res


# ---------------------------------------------------------------------------
# Phase 14: the reference tracer
# ---------------------------------------------------------------------------

ORACLE_FLOOR = 0.999  # share of pixels and of hit decisions that must agree
ORACLE_DRIFT = 1e-4  # relative error past which a pixel's path took another turn
REF_ROWS_LIMIT_S = 60.0  # past this predicted time, the 1080p G-buffer holds every 4th row


class RefPairs:
    """Times the reference tracer's calls made under `run` and counts their
    ray-triangle pair tests (rays x triangles of each intersect call)."""

    def __init__(self):
        from nebulae_tpu_torch.ref import tracer as rt

        self.rt, self.pairs, self.seconds, self.orig, self.active = rt, 0, 0.0, {}, False
        for name in ("intersect_closest", "intersect_any"):
            fn = self.orig[name] = getattr(rt, name)

            def counted(o, d, tri_pos, *a, _fn=fn, **k):
                if self.active:
                    self.pairs += int(o.shape[0]) * int(tri_pos.shape[0])
                return _fn(o, d, tri_pos, *a, **k)

            setattr(rt, name, counted)

    def run(self, fn):
        """fn()'s result and seconds (device synchronised)."""
        self.active = True
        try:
            out, s = _seconds(fn)
        finally:
            self.active = False
        self.seconds += s
        return out, s

    def close(self):
        for name, fn in self.orig.items():
            setattr(self.rt, name, fn)


def _seconds(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _ref_outliers(got, ref):
    """(drifted, flipped) pixel counts of two [H, W, 3] reference images
    outside rtol 1e-5 / atol 1e-6, split at ORACLE_DRIFT relative, and the
    max abs error."""
    import torch

    bad = ~torch.isclose(got, ref, rtol=1e-5, atol=1e-6).all(dim=-1)
    rel = ((got - ref).abs() / ref.abs().clamp(min=1e-6)).amax(dim=-1)
    flipped = bad & (rel > ORACLE_DRIFT)
    return int((bad & ~flipped).sum()), int(flipped.sum()), float((got - ref).abs().max())


def _hits_agree(what, g, c):
    """Closest hits on the card (g) against the CPU (c): hit masks equal,
    tri equal away from t ties within 1e-6 relative, t, u and v within
    rtol 1e-5 / atol 1e-6."""
    import torch

    g = {k: v.cpu() for k, v in g.items()}
    hit = c["tri"] >= 0
    assert torch.equal(g["tri"] >= 0, hit), f"{what}: hit masks differ"
    for k in ("t", "u", "v"):
        torch.testing.assert_close(g[k][hit], c[k][hit], rtol=1e-5, atol=1e-6, msg=f"{what}: {k}")
    differ = hit & (g["tri"] != c["tri"])
    tie = (g["t"][differ] - c["t"][differ]).abs() <= 1e-6 * c["t"][differ].abs()
    assert bool(tie.all()), f"{what}: tri differs away from a tie"
    return int(differ.sum())


def hold_oracle(what, out, ref, gbuf, rtol, atol, frame_s, ref_s, rows=None):
    """A frame's hdr and primary hits against the reference tracer's image
    and G-buffer (any devices): >= ORACLE_FLOOR of pixels within rtol /
    atol and of hit decisions equal.  Logs the shares, the hit-mask
    differences, the max error and both seconds (ref_s 0: a reference
    made for an earlier line)."""
    import torch

    hdr = out["hdr"].float().cpu()
    h, w = hdr.shape[0], hdr.shape[1]
    ref = ref.float().cpu().reshape(h, w, 3)
    hit, ref_hit = out["hit"].cpu().reshape(-1), gbuf["hit"].cpu().reshape(-1)
    close = torch.isclose(hdr, ref, rtol=rtol, atol=atol).all(dim=-1).reshape(-1)
    hit_share = float((hit == ref_hit).float().mean())
    px_share = float(close.float().mean())
    err = float((hdr - ref).abs().max())
    outl = torch.nonzero(~close)[:, 0][:4].tolist()
    log(f"oracle {what}: {px_share:.6f} of pixels within rtol {rtol:g} / atol {atol:g}, hit masks differ on "
        f"{int((hit != ref_hit).sum())} of {h * w}, max abs err {err:.3g}, frame {frame_s:.3f} s, "
        + (f"reference {ref_s:.3f} s" if ref_s else "reference as on a line above")
        + (f"; first outliers at {[divmod(i, w) for i in outl]}" if outl else ""))
    assert px_share >= ORACLE_FLOOR and hit_share >= ORACLE_FLOOR, \
        f"{what}: {px_share:.6f} of pixels and {hit_share:.6f} of hit decisions agree with the reference"


def _frame(r, cam_obj, wrappers, expect, what):
    """One frame of Renderer r with the launch counts zeroed before it and
    read after: every wrapper in `expect` must have launched.  Returns
    (outputs, seconds, launches)."""
    _zero(wrappers)
    out, s = _seconds(lambda: r.render(cam_obj))
    n = {name: fn.launches for name, fn in wrappers.items() if fn.launches}
    missing = [e for e in expect if not n.get(e)]
    assert not missing, f"{what}: kernels not launched: {missing} (launched {n})"
    return out, s, n


def oracle_phase(fs_bench, bvh_bench) -> None:
    """Phase 14: the port's reference tracer on the card against itself on
    the CPU, the card's frames against the CPU reference tracer, the card's
    frames at scale against the reference tracer on the card, and the
    gradients on the card against central differences of the CPU
    reference tracer."""
    import dataclasses

    import torch

    from nebulae_tpu_torch.bvh.cbuilder import build_bvh_native
    from nebulae_tpu_torch.config import RenderConfig, SunLight
    from nebulae_tpu_torch.engine.renderer import Renderer, init_frame_state, render_frame
    from nebulae_tpu_torch.kernels import chunks as kc
    from nebulae_tpu_torch.kernels import trace as kt
    from nebulae_tpu_torch.passes.gbuffer import camera_rays, make_camera_arrays
    from nebulae_tpu_torch.ref import tracer as rt
    from nebulae_tpu_torch.utils.testscenes import (
        atrium_camera, bench_camera, huge_scene, large_scene, procedural_envmap, small_atrium,
    )

    dev = torch.device("cuda")
    clock = PhaseClock()
    wrappers = {f.__name__: f for f in kt.WRAPPERS}
    fat4 = ("closest_hit_fat4", "shadow_closest_fat4", "any_hit_fat4")
    fat2 = ("closest_hit_fat", "shadow_closest_fat", "any_hit_fat")
    counter = RefPairs()
    try:
        # 14a. The reference tracer on the card against itself on the CPU.
        fs = small_atrium(0)
        cam_obj = atrium_camera(fs)
        env = procedural_envmap()
        arrays = {**fs.device_arrays(), "env_map": env}
        on_card = {k: torch.as_tensor(v).to(dev) for k, v in arrays.items()}
        sun_c, sun_g = SunLight.default("cpu"), SunLight.default(dev)
        s = 64
        base = RenderConfig(width=s, height=s, spp=2, max_bounces=3, enable_svgf=False, enable_tonemap=False)
        options = {
            "defaults": {}, "jitter": dict(jitter_primary=True), "fast": dict(fast_bounce_shading=True),
            "envmap": dict(enable_envmap=True),
            "all": dict(jitter_primary=True, fast_bounce_shading=True, enable_envmap=True),
        }
        cpu_ref = {}
        for name in ("defaults", "all"):
            cfg = dataclasses.replace(base, **options[name])
            (img_g, st_g), t_g = counter.run(lambda: rt.path_trace(on_card, cam_obj, cfg, sun_g, device=dev,
                                                                  return_rng=True))
            (img_c, st_c), t_c = _seconds(lambda: rt.path_trace(arrays, cam_obj, cfg, sun_c, device="cpu",
                                                              return_rng=True))
            cpu_ref[name] = img_c
            assert torch.equal(st_g.cpu(), st_c), f"reference {name}: RNG states differ between card and CPU"
            # The same primary rays on both devices (each device's pow
            # rounds a direction differently in its last bit).
            o_c, d_c = camera_rays(make_camera_arrays(cam_obj, s, s, "cpu"), s, s)
            ties = _hits_agree(f"reference {name} primary hits",
                               rt.intersect_closest(o_c.to(dev), d_c.to(dev), on_card["tri_pos"], device=dev),
                               rt.intersect_closest(o_c, d_c, arrays["tri_pos"], device="cpu"))
            drifted, flipped, err = _ref_outliers(img_g.cpu(), img_c)
            log(f"oracle reference card vs CPU {name} ({s}x{s}, spp 2, 3 bounces): RNG states equal, tri differs "
                f"on {ties} t ties, of {s * s} pixels {drifted} drifted and {flipped} flipped past rtol 1e-5 / atol "
                f"1e-6, max abs err {err:.3g}; card {t_g:.3f} s, CPU {t_c:.3f} s")
            assert flipped <= 1e-3 * s * s and drifted <= 5e-3 * s * s, f"reference {name}: card vs CPU"
        clock.done("oracle reference card vs CPU")

        # 14b. The card's frames (K1-K3 on fat4, K7 on fat2) against the
        # CPU reference tracer.
        cfg_d = RenderConfig(width=s, height=s, enable_gi=False, enable_svgf=False, enable_tonemap=False)
        r = Renderer(fs, cfg_d, env_map=env)
        out, t_f, _ = _frame(r, cam_obj, wrappers, ("closest_hit_fat4", "any_hit_fat4"), "direct")
        ref, t_r = _seconds(lambda: rt.render_direct(arrays, cam_obj, cfg_d, sun_c, device="cpu"))
        gbuf = rt.render_gbuffer(arrays, cam_obj, s, s, texture_mips=True, device="cpu")
        hold_oracle("direct atrium on fat4 (K1, K3) vs CPU reference", out, ref, gbuf, 1e-4, 1e-4, t_f, t_r)
        for name, opts in options.items():
            cfg = dataclasses.replace(base, **opts)
            r.update_config(cfg)
            r.state = init_frame_state(cfg, dev)
            out, t_f, n = _frame(r, cam_obj, wrappers, fat4, f"path-traced {name}")
            t_r = 0.0
            if name not in cpu_ref:
                cpu_ref[name], t_r = _seconds(lambda: rt.path_trace(arrays, cam_obj, cfg, sun_c, device="cpu"))
            hold_oracle(f"path-traced atrium {name} on fat4 (launches {n}) vs CPU reference", out, cpu_ref[name],
                        gbuf, 1e-3, 2e-4, t_f, t_r)
        r2 = Renderer(fs, dataclasses.replace(base, bvh_wide=2), env_map=env)
        assert "fatnodes" in r2.tables, r2.route
        out, t_f, n = _frame(r2, cam_obj, wrappers, fat2, "fat2")
        hold_oracle(f"path-traced atrium defaults on fat2 (launches {n}) vs CPU reference", out, cpu_ref["defaults"],
                    gbuf, 1e-3, 2e-4, t_f, 0.0)
        del r, r2
        clock.done("oracle frames vs CPU reference")

        # 14c. Frames at scale against the reference tracer on the card.
        def at_scale(tag, fs_s, cam_s, renderers, cfg):
            arrays_s = renderers[0][1].scene
            (ref_s, t_r) = counter.run(lambda: rt.path_trace(arrays_s, cam_s, cfg, renderers[0][1].sun, device=dev))
            gbuf_s = rt.render_gbuffer(arrays_s, cam_s, cfg.width, cfg.height, texture_mips=cfg.texture_mips,
                                       device=dev)
            for name, rr, expect in renderers:
                out_s, t_f, n = _frame(rr, cam_s, wrappers, expect, f"{tag} {name}")
                hold_oracle(f"{tag} on {name} (launches {n}) vs the reference on the card", out_s, ref_s, gbuf_s,
                            1e-3, 2e-4, t_f, t_r)
                t_r = 0.0

        cfg_b = RenderConfig(width=256, height=256, max_bounces=BOUNCES, enable_svgf=False, enable_tonemap=False)
        pairs0, sec0 = counter.pairs, counter.seconds
        rb = Renderer(fs_bench, cfg_b, bvh=bvh_bench)
        at_scale(f"bench {fs_bench.num_triangles} tris 256x256", fs_bench, bench_camera(fs_bench),
                 [("fat4", rb, fat4)], cfg_b)
        rate = (counter.pairs - pairs0) / (counter.seconds - sec0)
        log(f"oracle reference on the card: {counter.pairs - pairs0} pair tests in "
            f"{counter.seconds - sec0:.3f} s on the bench scene, {rate / 1e9:.3f} G pair tests/s")
        del rb
        clock.done("oracle bench 256")

        fs_l = large_scene(seed=0)
        bvh_l = build_bvh_native(fs_l.tri_pos, max_leaf=15)
        cfg_l = dataclasses.replace(cfg_b, width=128, height=128)
        default_budget = kc.TRI_CHUNK_TABLE_BUDGET
        routes = []
        for mode, suffix in (("subtree", ""), ("tri", "_slots"), ("paged", "_paged")):
            kc.TRI_CHUNK_TABLE_BUDGET = TRI_BUDGET_LARGE if mode == "tri" else default_budget
            try:
                rl = Renderer(fs_l, dataclasses.replace(cfg_l, chunk_mode=mode), bvh=bvh_l)
            finally:
                kc.TRI_CHUNK_TABLE_BUDGET = default_budget
            assert rl.route == mode, (mode, rl.route)
            routes.append((mode, rl, tuple(f + suffix for f in fat4)))
        at_scale(f"large {fs_l.num_triangles} tris 128x128", fs_l, bench_camera(fs_l), routes, cfg_l)
        del routes, rl, fs_l, bvh_l
        clock.done("oracle large 128")

        fs_h = huge_scene(seed=0)
        bvh_h = build_bvh_native(fs_h.tri_pos, max_leaf=15)
        cfg_h = dataclasses.replace(cfg_b, width=64, height=64)
        rp = Renderer(fs_h, cfg_h, bvh=bvh_h)
        rf = Renderer(fs_h, dataclasses.replace(cfg_h, bvh_wide=2), bvh=bvh_h)
        assert rp.route == "paged" and rf.route == "subtree", (rp.route, rf.route)
        at_scale(f"huge {fs_h.num_triangles} tris 64x64", fs_h, bench_camera(fs_h),
                 [("paged", rp, tuple(f + "_paged" for f in fat4)),
                  ("fat2 subtree", rf, fat2 + ("closest_hit_node",))], cfg_h)
        del rp, rf, fs_h, bvh_h
        torch.cuda.empty_cache()
        clock.done("oracle huge 64")

        # 14d. Primary visibility of the 1080p bench frame: K1's hit mask
        # and depth against the reference G-buffer on the card.
        cfg_p = RenderConfig(width=WIDTH, height=HEIGHT, max_bounces=1, enable_svgf=False, enable_tonemap=False)
        rp = Renderer(fs_bench, cfg_p, bvh=bvh_bench)
        cam_b = bench_camera(fs_bench)
        out, t_f, n = _frame(rp, cam_b, wrappers, ("closest_hit_fat4",), "1080p primary")
        predicted = WIDTH * HEIGHT * fs_bench.num_triangles / rate
        step = 4 if predicted > REF_ROWS_LIMIT_S else 1
        o, d = camera_rays(make_camera_arrays(cam_b, WIDTH, HEIGHT, dev), WIDTH, HEIGHT)
        rows = torch.arange(0, HEIGHT, step, device=dev)
        sel = (rows[:, None] * WIDTH + torch.arange(WIDTH, device=dev)[None]).reshape(-1)
        hit_r, t_r = counter.run(lambda: rt.intersect_closest(o[sel], d[sel], rp.scene["tri_pos"], device=dev))
        hit = out["hit"].reshape(-1)[sel]
        depth = out["depth"].reshape(-1)[sel]
        ref_hit = hit_r["tri"] >= 0
        same = float((hit == ref_hit).float().mean())
        both = hit & ref_hit
        dshare = float(torch.isclose(depth[both], hit_r["t"][both], rtol=1e-5, atol=0.0).float().mean())
        derr = float((depth[both] - hit_r["t"][both]).abs().max())
        log(f"oracle 1080p primary visibility of the bench frame (K1, launches {n}): "
            + ("every 4th row held (" if step > 1 else "every row held (")
            + f"{sel.numel()} rays; the whole frame would take ~{predicted:.0f} s at the measured rate), "
            f"hit masks agree on {same:.6f} ({int((hit != ref_hit).sum())} differ), depth within rtol 1e-5 on "
            f"{dshare:.6f} of hits, max abs depth err {derr:.3g}; frame {t_f:.3f} s, reference {t_r:.3f} s")
        assert same >= ORACLE_FLOOR and dshare >= ORACLE_FLOOR, "1080p primary visibility against the reference"
        del rp, o, d, out
        clock.done("oracle 1080p primary")

        # 14e. Gradients on the card against central differences of the CPU
        # reference tracer: d mean(hdr) / d mat_base_color and sun.radiance.
        cfg_g = RenderConfig(width=s, height=s, max_bounces=2, enable_svgf=False, enable_tonemap=False)
        rg = Renderer(fs, cfg_g)
        bc = rg.scene["mat_base_color"].clone().requires_grad_(True)
        rad = rg.sun.radiance.clone().requires_grad_(True)
        sun = SunLight(rg.sun.direction, rad, rg.sun.tan_half_angle, rg.sun.sky_color)
        _zero(wrappers)
        (g_bc, g_rad), t_g = _seconds(lambda: torch.autograd.grad(render_frame(
            {**rg.scene, "mat_base_color": bc}, rg.tables, sun, make_camera_arrays(cam_obj, s, s, dev),
            init_frame_state(cfg_g, dev), cfg_g)[0]["hdr"].mean(), [bc, rad]))
        assert all(wrappers[k].launches for k in fat4), "the gradient's frame did not launch K1-K3"
        g_bc, g_rad = g_bc.cpu(), g_rad.cpu()
        eps, worst = 1e-3, 0.0
        plain = fs.device_arrays()
        t0 = time.perf_counter()
        for kind, idx in [("mat_base_color", (0, 0)), ("mat_base_color", (1, 1)), ("mat_base_color", (2, 2)),
                          ("radiance", 0), ("radiance", 1), ("radiance", 2)]:
            losses = []
            for sign in (1.0, -1.0):
                if kind == "radiance":
                    rr = sun_c.radiance.clone()
                    rr[idx] += sign * eps
                    loss_in = (plain, SunLight(sun_c.direction, rr, sun_c.tan_half_angle, sun_c.sky_color))
                else:
                    b = plain["mat_base_color"].copy()
                    b[idx] += sign * eps
                    loss_in = ({**plain, "mat_base_color": b}, sun_c)
                losses.append(float(rt.path_trace(loss_in[0], cam_obj, cfg_g, loss_in[1], device="cpu").double().mean()))
            fd = (losses[0] - losses[1]) / (2 * eps)
            got = float(g_rad[idx] if kind == "radiance" else g_bc[idx])
            worst = max(worst, abs(got - fd) / max(1.0, abs(fd)))
            log(f"oracle gradient d mean(hdr) / d {kind}{list(idx) if kind != 'radiance' else [idx]}: card {got:.6g}, "
                f"CPU reference central difference {fd:.6g}")
            assert abs(got - fd) < 2e-3 * max(1.0, abs(fd)), f"gradient {kind} {idx}: card {got}, fd {fd}"
        assert float(g_bc.abs().max()) > 1e-4 and bool((g_rad > 0).all()), "gradients vanish"
        log(f"oracle gradients ({s}x{s}, 2 bounces): worst |g - fd| / max(1, |fd|) {worst:.3g} (bound 2e-3); "
            f"card forward and backward {t_g:.3f} s, CPU central differences {time.perf_counter() - t0:.3f} s")
        clock.done("oracle gradients")
        log(f"oracle reference on the card in all: {counter.pairs} pair tests in {counter.seconds:.3f} s, "
            f"{counter.pairs / counter.seconds / 1e9:.3f} G pair tests/s")
    finally:
        counter.close()


# ---------------------------------------------------------------------------
# Phase 15: the vertex kernel (K9)
# ---------------------------------------------------------------------------

# Device-memory bytes of a K9 lane: the bounce form reads 77 (five rows of
# 3 floats, roughness, metalness, alive, the int64 state) and writes 86
# (five rows, two floats, two masks, the state, the key); the last form
# writes 57 (three rows, a float, a mask, the state, the key).  No key: 8
# fewer.
VERTEX_LANE_BYTES = {False: 77 + 86, True: 77 + 57}


def vertex_launches(render) -> list:
    """The inputs of each K9 launch of one render(), through its record
    hook, as (last, surf, view, sun, alive, rng_state, aabb)."""
    from nebulae_tpu_torch.kernels import vertex as kv

    kv.vertex_kernel.record = []
    try:
        render()
    finally:
        recs, kv.vertex_kernel.record = kv.vertex_kernel.record, None
    return recs


def kernel_device_ms(fn, runs: int = 7) -> float:
    """Device ms of one launch of fn(), apart from its wrapper's host work:
    CUDA events around `runs` launches that the host queues while the
    device sleeps (torch.cuda._sleep), so that the events time the
    launches back to back; the mean of the runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms at the H100's clocks, past the host's queueing
    a.record()
    for _ in range(runs):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / runs


def hold_vertex(what, rec) -> dict:
    """K9 on a recorded launch against its twin: states, masks, keys and
    float outputs compared bit for bit (each output's differing lanes);
    one call's ms with its wrapper's host work and the twin's (CUDA
    events, median of 7), and the byte bound.  The entry's "kernel"
    relaunches it, for kernel_device_ms."""
    import torch

    from nebulae_tpu_torch.kernels import vertex as kv

    last, surf, view, sun, alive, state, aabb = rec
    n = int(state.shape[0])

    def kernel():
        return kv.vertex_kernel(last, surf, view, sun, alive, state, aabb)

    def plain():
        rng, out = (kv.last_draws_plain if last else kv.bounce_draws_plain)(surf, view, sun, alive, state)
        if aabb is not None:
            out["key"] = kv.ray_sort_key(out["origin"], out["l"] if last else out["new_d"], *aabb)
        return rng, out

    with torch.no_grad():
        rng_k, out_k = kernel()
        rng_p, out_p = plain()
        diff = {"rng": int((rng_k != rng_p).sum())}
        for k, w in out_p.items():
            g = out_k[k]
            if w.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            diff[k] = int((g != w).reshape(n, -1).any(1).sum())
        call_ms = timed_ms(kernel)
        plain_ms = timed_ms(plain)
    bound = n * (VERTEX_LANE_BYTES[last] - (0 if aabb is not None else 8)) / HBM_BYTES_PER_S * 1e3
    return {"what": what, "form": "last" if last else "bounce", "n": n, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "diff": diff, "kernel": kernel,
            "differing": sum(diff.values())}


def log_held_vertices(held) -> None:
    """Each held launch's line, with the kernel's device ms."""
    for h in held:
        h["ms"] = ms = kernel_device_ms(h.pop("kernel"))
        log(f"{h['what']}: {h['form']} form, {h['n']} lanes, kernel {ms:.4f} ms (a call with its wrapper "
            f"{h['call_ms']:.4f}), plain {h['plain_ms']:.3f} ms, bound {h['bound_ms']:.4f} ms (bytes), "
            f"kernel/bound {ms / h['bound_ms'] if h['bound_ms'] else 0:.2f}; lanes differing "
            f"{json.dumps(h['diff'])}")


def hold_train_step(r, cfg, cam_obj) -> bool:
    """A 1080p train step through K9 (its backward runs the twin again)
    against the same step with the twin forced, run twice: the image and
    the loss bit for bit, and each gradient as close as the twin's two
    steps are to each other (bit for bit where they are).  Logs K9's
    launches in the step and each gradient's largest differences."""
    import torch

    from nebulae_tpu_torch.engine.renderer import init_frame_state
    from nebulae_tpu_torch.engine.train import make_train_step, split_scene_params
    from nebulae_tpu_torch.kernels import vertex as kv
    from nebulae_tpu_torch.passes.gbuffer import make_camera_arrays

    params, frozen = split_scene_params(r.scene)
    params["sun"] = r.sun
    cam = make_camera_arrays(cam_obj, WIDTH, HEIGHT, r.device)
    target = torch.zeros((HEIGHT, WIDTH, 3), dtype=torch.float32, device=r.device)

    def run():
        opt = _recording_adam()
        step, _ = make_train_step(cfg, frozen, r.tables, optimizer=opt, device=r.device)
        _p, _o, _s, loss, img = step(params, opt.init(params), cam, init_frame_state(cfg, r.device), target)
        return loss.detach(), img.detach(), _grad_report(opt)

    before = kv.vertex_kernel.launches
    k9 = run()
    n = kv.vertex_kernel.launches - before
    kernel_runs = kv._kernel_runs
    kv._kernel_runs = lambda view: False
    try:
        twin_a, twin_b = run(), run()
    finally:
        kv._kernel_runs = kernel_runs
    assert kv.vertex_kernel.launches == before + n
    same = torch.equal(k9[0], twin_a[0]) and torch.equal(k9[1], twin_a[1])
    worst = {}
    for name, g in k9[2].items():
        d_k9 = float((g - twin_a[2][name]).abs().max())
        d_twin = float((twin_b[2][name] - twin_a[2][name]).abs().max())
        worst[name] = (d_k9, d_twin)
        same = same and (d_k9 == 0.0 if d_twin == 0.0 else d_k9 <= 10.0 * d_twin)
    log(f"vertex: a {WIDTH}x{HEIGHT} train step: {n} K9 launches; against the twin's step: image and loss "
        f"{'bit-equal' if torch.equal(k9[1], twin_a[1]) and torch.equal(k9[0], twin_a[0]) else 'DIFFER'}, "
        f"largest gradient differences (K9 - twin, twin - twin) {json.dumps(worst)}")
    assert n == cfg.max_bounces, f"K9 launches in a train step: {n}"
    return same


def vertex_phase(base_cfg, fs, bvh) -> dict:
    """Phase 15: K9 against its twin on every launch of a 1080p frame of
    the main path (4 bounces: 3 bounce vertices and the last) and of an NRC
    frame (8 vertices: the query pass's 7 + 1 and the training walk's
    7 + 1) on bench_atrium, and a 1080p train step through K9 against the
    same step through the twin; launches per frame and step logged.
    Returns the summary's K9 entry."""
    import dataclasses

    import torch

    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.kernels import vertex as kv
    from nebulae_tpu_torch.utils.metrics import totals
    from nebulae_tpu_torch.utils.testscenes import atrium_camera, bench_atrium, bench_camera

    r = Renderer(fs, base_cfg, bvh=bvh)
    cam_obj = bench_camera(fs)
    r.render(cam_obj)
    before, lanes = kv.vertex_kernel.launches, totals().get("vertex.kernel_lanes", 0)
    recs = vertex_launches(lambda: r.render(cam_obj))
    per_frame = kv.vertex_kernel.launches - before
    log(f"vertex: a {WIDTH}x{HEIGHT} frame at {base_cfg.max_bounces} bounces: {per_frame} K9 launches, "
        f"{totals().get('vertex.kernel_lanes', 0) - lanes} lanes")
    assert per_frame == base_cfg.max_bounces == len(recs), f"K9 launches a frame: {per_frame}"
    held = [hold_vertex(f"vertex frame launch {i}", rec) for i, rec in enumerate(recs)]
    log_held_vertices(held)
    del recs

    held_step = hold_train_step(r, base_cfg, cam_obj)
    del r
    torch.cuda.empty_cache()

    fa = bench_atrium(seed=0)
    cfg = dataclasses.replace(base_cfg, enable_nrc=True, max_bounces=8, nrc_max_path_vertices=8)
    ra = Renderer(fa, cfg)
    cam_a = atrium_camera(fa)
    ra.render(cam_a)
    before = kv.vertex_kernel.launches
    recs = vertex_launches(lambda: ra.render(cam_a))
    per_frame = kv.vertex_kernel.launches - before
    log(f"vertex: a {WIDTH}x{HEIGHT} NRC frame at {cfg.max_bounces} vertices on bench_atrium: {per_frame} K9 "
        f"launches ({[rec[5].shape[0] for rec in recs]} lanes)")
    assert per_frame == cfg.max_bounces + cfg.nrc_max_path_vertices == len(recs), f"K9 NRC launches {per_frame}"
    held_nrc = [hold_vertex(f"vertex NRC frame launch {i}", rec) for i, rec in enumerate(recs)]
    log_held_vertices(held_nrc)
    del recs, ra
    torch.cuda.empty_cache()

    differing = sum(h["differing"] for h in held + held_nrc)
    log(f"vertex: {len(held) + len(held_nrc)} launches held: {differing} lanes differ from the twin's (states, "
        f"masks, keys and float outputs compared bit for bit)")
    assert differing == 0, "K9 differs from its plain twin"
    assert held_step, "a train step through K9 differs from the twin's"
    return {"max_abs_err": 0.0, "ms": sum(h["ms"] for h in held), "plain_ms": sum(h["plain_ms"] for h in held),
            "bound_ms": sum(h["bound_ms"] for h in held), "bound_by": "bytes"}


def bench_renderer(width=WIDTH, height=HEIGHT, bvh=None):
    """The ~139k-triangle bench scene's BVH (the C++ builder, unless one is
    given) and a Renderer of the main path's configuration -> (fs, bvh,
    cfg, renderer)."""
    from nebulae_tpu_torch.bvh.cbuilder import build_bvh_native
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.utils.testscenes import bench_scene

    fs = bench_scene(seed=0)
    if bvh is None:
        bvh = build_bvh_native(fs.tri_pos, max_leaf=15)
    cfg = RenderConfig(
        width=width, height=height, spp=SPP, max_bounces=BOUNCES, enable_svgf=True,
        enable_tonemap=True, tracer="auto", lean_outputs=True, fast_bounce_shading=False,
        bucket_scheduling=True,
    )
    return fs, bvh, cfg, Renderer(fs, cfg, bvh=bvh)


def atrous_inputs(gbuf, gen):
    """A 1080p frame's guidance buffers with noisy radiance: (rad, var,
    depth, normal)."""
    import torch

    dev = gbuf["albedo"].device
    rad = (gbuf["albedo"] * torch.rand((HEIGHT * WIDTH, 1), device=dev, generator=gen) * 4.0).reshape(
        HEIGHT, WIDTH, 3)
    var = torch.rand((HEIGHT, WIDTH), device=dev, generator=gen) * 0.05
    return rad, var, gbuf["depth"].reshape(HEIGHT, WIDTH), gbuf["normal_s"].reshape(HEIGHT, WIDTH, 3).contiguous()


# --ab: the same kernels of several source trees, timed in one session.
AB_SIZES = ((1920, 1080), (2560, 1440), (3840, 2160))


BVH_FIELDS = ("node_lo", "node_hi", "node_first", "node_count", "node_skip", "node_right", "tri_index")


def ab_capture(path: str) -> None:
    """Save the bench scene's BVH, K2's and K3's launches in one bench-scene
    frame at each of AB_SIZES, K7b's and K7c's launches in one 1080p
    bvh_wide=2 frame on the same BVH, and K8's launches, each with its
    one-node tables, in one 1080p frame of the box (the one-node route) and
    of the ~2M scene with bvh_wide=2 (its single-leaf subtree chunks)."""
    import dataclasses

    import torch

    from nebulae_tpu_torch.bvh.cbuilder import build_bvh_native
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.kernels import trace as kt
    from nebulae_tpu_torch.utils.testscenes import bench_camera, box_scene, huge_scene

    fs, bvh, cfg, renderer = bench_renderer()
    k2, k3 = {}, {}
    for w, h in AB_SIZES:
        renderer.resize(w, h)
        k2[f"{w}x{h}"], k3[f"{w}x{h}"] = recorded_launches(
            lambda: renderer.render(bench_camera(fs)), kt.shadow_closest_fat4, kt.any_hit_fat4)
    fat2 = Renderer(fs, dataclasses.replace(cfg, bvh_wide=2), bvh=bvh)
    k7b, k7c = recorded_launches(lambda: fat2.render(bench_camera(fs)), kt.shadow_closest_fat, kt.any_hit_fat)
    del fat2
    box = box_scene()
    k8_box = node_launches(lambda: Renderer(box, dataclasses.replace(cfg, tracer="pallas")).render(bench_camera(box)))
    huge = huge_scene(seed=0)
    r2f = Renderer(huge, dataclasses.replace(cfg, bvh_wide=2), bvh=build_bvh_native(huge.tri_pos, max_leaf=15))
    k8_huge = node_launches(lambda: r2f.render(bench_camera(huge)))

    def keep(recs):
        return [(walk, o, d, {k: tab[k] for k in ("nodes", "tris", "stack_depth")}, cap)
                for walk, o, d, tab, cap in recs]

    torch.save({"bvh": {k: torch.from_numpy(getattr(bvh, k)) for k in BVH_FIELDS},
                "frames": k2, "k3_frames": k3, "k7b_frame": k7b, "k7c_frame": k7c,
                "k8_box": keep(k8_box), "k8_huge": keep(k8_huge)}, path)


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _leaves(x) -> list:
    """The tensors of a walk's result (a tensor, a hit dict, or a tuple of
    them) in order."""
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, tuple):
        return [t for v in x for t in _leaves(v)]
    return [x]


def _cat(parts):
    """Results of consecutive launches joined as one launch's."""
    import torch

    first = parts[0]
    if isinstance(first, dict):
        return {k: _cat([p[k] for p in parts]) for k in first}
    if isinstance(first, tuple):
        return tuple(_cat([p[i] for p in parts]) for i in range(len(first)))
    return torch.cat(parts)


def _head(x, n):
    if isinstance(x, dict):
        return {k: _head(v, n) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_head(v, n) for v in x)
    return x[:n]


def _other_body(walk, most, rays, caps):
    """The launch walk(*rays, *caps) run by the body it does not take: split
    into launches of at most `most` rays (the group body) when it holds
    more, else padded with dead rays to most + 1 (one thread per ray).
    -> (name, fn giving the launch's own rays' results)."""
    import torch

    n = rays[0].shape[0]
    per_ray = [torch.is_tensor(c) and c.dim() > 0 for c in caps]
    if n > most:
        size = -(-n // -(-n // most))

        def split():
            return _cat([walk(*(r[i:i + size] for r in rays),
                              *(c[i:i + size] if p else c for c, p in zip(caps, per_ray)))
                         for i in range(0, n, size)])
        return "group", split
    pad = most + 1 - n
    dev = rays[0].device
    rays2 = [torch.cat([rays[0], torch.full((pad, 3), 1.0e14, device=dev)])]
    rays2 += [torch.cat([r, torch.zeros((pad, 3), device=dev)]) for r in rays[1:]]
    caps2 = [torch.cat([c, torch.zeros(pad, device=dev)]) if p else c for c, p in zip(caps, per_ray)]
    return "thread", lambda: _head(walk(*rays2, *caps2), n)


_PORT_KERNEL = re.compile(r"(closest|combo|any)_\w*kernel")


def device_ms(fn, runs: int) -> tuple[float, int]:
    """The device time of the port's kernels in one fn() call, from a
    profiler trace of `runs` calls: the wrapper's host enqueue, which
    CUDA events around a launch of a few thousand rays mostly measure, is
    left out.  -> (ms, sessions that recorded no launch and were run
    again)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # A profiler session now and then records no device events at all (seen
    # once in ~150 sessions of one process): such a session is run again,
    # and the row says so.
    seen = set()
    for empty in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        events = _trace_events(prof)
        durs = [e["dur"] for e in events
                if e.get("cat") == "kernel" and _PORT_KERNEL.search(e.get("name", ""))]
        if durs:
            return sum(durs) / runs / 1e3, empty
        seen |= {(e.get("cat"), e.get("name", "")[:60]) for e in events if e.get("cat") in DEVICE_CATS}
    raise RuntimeError(f"five profiler sessions recorded no launch of a port kernel; device events {sorted(seen)}")


def _ab_launch(walk, n_rays, args, most, runs) -> dict:
    """One launch's row: its lanes, output digest, median ms (CUDA events)
    and device ms (profiler), and where `most` is given the same for the
    other body, whose results must be equal."""
    import torch

    out = walk(*args)
    row = {"lanes": args[0].shape[0], "digest": _digest(*_leaves(out)),
           "ms": timed_ms(lambda: walk(*args), runs)}
    row["dev_ms"], row["dev_empty_sessions"] = device_ms(lambda: walk(*args), runs)
    if most:
        name, fn = _other_body(walk, most, args[:n_rays], args[n_rays:])
        assert all(torch.equal(a, b) for a, b in zip(_leaves(out), _leaves(fn()))), \
            f"the {name} body differs on a {row['lanes']}-ray launch"
        row[f"{name}_ms"] = timed_ms(fn, runs)
        row[f"{name}_dev_ms"], row[f"{name}_dev_empty_sessions"] = device_ms(fn, runs)
    return row


# --ab: K3's, K7b's and K7c's bodies on strided subsets of phase 4's sorted
# rays, to place the cutoff between them.
AB_SWEEP = (1 << 17, 1 << 18, 1 << 19, 1 << 20)
K8_SWEEP = (1 << 12, 1 << 14, 1 << 15, 1 << 16, 1 << 18)


def ab_child(tree: str, path: str, runs: int) -> dict:
    """Build `tree`'s kernels and time them: on phase 4's inputs, made as
    phase 4 makes them, and on the saved launches of K2, K3, K7b and K7c
    (each also with its other body where the tree's kernel has two)."""
    sys.path.insert(0, tree)
    import dataclasses

    import torch

    from nebulae_tpu_torch.bvh.builder import FlatBVH
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.kernels import svgf as ksvgf
    from nebulae_tpu_torch.kernels import trace as kt
    from nebulae_tpu_torch.kernels.build import native
    from nebulae_tpu_torch.passes.gbuffer import make_camera_arrays
    from nebulae_tpu_torch.utils.testscenes import bench_camera

    assert Path(kt.__file__).resolve().is_relative_to(Path(tree).resolve()), kt.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lib = native()
    saved = torch.load(path)
    bvh = FlatBVH(**{k: v.numpy() for k, v in saved["bvh"].items()})
    fs, _, cfg, renderer = bench_renderer(bvh=bvh)
    tables = renderer.tables
    fat2 = Renderer(fs, dataclasses.replace(cfg, bvh_wide=2), bvh=bvh).tables
    cam = make_camera_arrays(bench_camera(fs), WIDTH, HEIGHT, "cuda")
    (o, d), (ro, rb, rl), gbuf, gen = path_rays(
        renderer.scene, lambda a, b: kt.closest_hit_fat4(a, b, tables), renderer.sun, cam)
    rad, var, depth, nrm = atrous_inputs(gbuf, gen)
    del gbuf
    res = {"tree": tree, "build_s": lib.build_seconds}
    # K2's cutoff (combo_group_rays in trees where only K2 had a group
    # body); K3 and K7b take it where the tree's library holds their group
    # kernels.
    most = (getattr(kt, "group_rays", None) or kt.combo_group_rays)()
    res["group_rays"] = most
    names = " ".join(sass(tree))
    most_k3 = most if "any_fat4_group_kernel" in names else None
    most_k7b = most if "combo_fat_group_kernel" in names else None
    most_k7c = most if "any_fat_group_kernel" in names else None

    def k2(a, b, l_, tb=float("inf"), tl=float("inf")):
        return kt.shadow_closest_fat4(a, b, l_, tables, tb, tl)

    def k3(a, b, t=float("inf")):
        return kt.any_hit_fat4(a, b, tables, t)

    def k7b(a, b, l_, tb=float("inf"), tl=float("inf")):
        return kt.shadow_closest_fat(a, b, l_, fat2, tb, tl)

    def k7c(a, b, t=float("inf")):
        return kt.any_hit_fat(a, b, fat2, t)

    hit, occ = k2(ro, rb, rl)
    res["k2_digest"] = _digest(hit["t"], hit["tri"], hit["u"], hit["v"], occ)
    res["k2_phase4_ms"] = timed_ms(lambda: k2(ro, rb, rl), runs)
    # K1 and K7a (one body each) on the 1080p primary rays, a frame's own
    # launch, over the fat4 and the fat2 table.
    for name, walk in (("k1", lambda a, b: kt.closest_hit_fat4(a, b, tables)),
                       ("k7a", lambda a, b: kt.closest_hit_fat(a, b, fat2))):
        row = _ab_launch(walk, 2, (o, d), None, runs)
        res[f"{name}_digest"], res[f"{name}_ms"], res[name] = row["digest"], row["ms"], row
    for name, walk, n_rays, args, two in (("k3", k3, 2, (ro, rl), most_k3),
                                          ("k7b", k7b, 3, (ro, rb, rl), most_k7b),
                                          ("k7c", k7c, 2, (ro, rl), most_k7c)):
        row = _ab_launch(walk, n_rays, args, two, runs)
        res[f"{name}_digest"] = row["digest"]
        res[f"{name}_phase4_ms"] = row["ms"]
        res[f"{name}_phase4"] = row
        sweep = []
        for n in AB_SWEEP:
            pick = torch.linspace(0, ro.shape[0] - 1, n, device=ro.device).long()
            sweep.append(_ab_launch(walk, n_rays, tuple(x[pick].contiguous() for x in args), two, runs))
        res[f"{name}_sweep"] = sweep
    res["k2_frames"] = {size: [_ab_launch(k2, 3, c, most, runs) for c in launches]
                        for size, launches in saved["frames"].items()}
    res["k3_frames"] = {size: [_ab_launch(k3, 2, c, most_k3, runs) for c in launches]
                        for size, launches in saved["k3_frames"].items()}
    res["k7b_frame"] = [_ab_launch(k7b, 3, c, most_k7b, runs) for c in saved["k7b_frame"]]
    res["k7c_frame"] = [_ab_launch(k7c, 2, c, most_k7c, runs) for c in saved["k7c_frame"]]
    # K8 on each saved launch over its own one-node tables (both walks have
    # a group body where the tree's library holds one).
    # Each walk's largest launch is also run on strided subsets (K8_SWEEP),
    # with both bodies where the walk has two, to place the cutoff between
    # them: the tree's own cutoff for its closest-hit group body.
    most_k8 = {"closest": kt.node_group_rays() if "closest_node_group_kernel" in names else None,
               "any": most if "any_node_group_kernel" in names else None}
    for key in ("k8_box", "k8_huge"):
        rows, sweep = [], []
        for walk, o8, d8, tab, cap in saved[key]:
            fn = kt.closest_hit_node if walk == "closest" else kt.any_hit_node
            row = _ab_launch(lambda a, b, t, fn=fn, tab=tab: fn(a, b, tab, t), 2, (o8, d8, cap), most_k8[walk],
                             runs)
            rows.append({"walk": walk, **row})
        for walk in ("closest", "any"):
            _, o8, d8, tab, cap = max((r for r in saved[key] if r[0] == walk), key=lambda r: r[1].shape[0])
            fn = kt.closest_hit_node if walk == "closest" else kt.any_hit_node
            for n in (m for m in K8_SWEEP if m < o8.shape[0]):
                pick = torch.linspace(0, o8.shape[0] - 1, n, device=o8.device).long()
                cap_n = cap[pick] if torch.is_tensor(cap) and cap.dim() > 0 else cap
                row = _ab_launch(lambda a, b, t, fn=fn, tab=tab: fn(a, b, tab, t), 2,
                                 (o8[pick].contiguous(), d8[pick].contiguous(), cap_n), most_k8[walk], runs)
                sweep.append({"walk": walk, **row})
        res[key], res[f"{key}_sweep"] = rows, sweep
    phi = (cfg.svgf_phi_color, cfg.svgf_phi_normal, cfg.svgf_phi_depth)
    gen = torch.Generator(device="cuda").manual_seed(99)
    digests = {"k4": [], "k5": []}
    for step in (1, 2, 4, 8):
        out_k, w_k = ksvgf.atrous_step(rad, var, depth, nrm, step, phi)
        digests["k4"].append(_digest(out_k, w_k))
        y = torch.randn((HEIGHT, WIDTH, 3), device="cuda", generator=gen)
        digests["k5"].append(_digest(ksvgf.atrous_step_bwd(y, w_k, rad, var, depth, nrm, step, phi)))
        res[f"k5_step{step}_ms"] = timed_ms(
            lambda: ksvgf.atrous_step_bwd(y, w_k, rad, var, depth, nrm, step, phi), runs)
        res[f"k4_step{step}_ms"] = timed_ms(lambda: ksvgf.atrous_step(rad, var, depth, nrm, step, phi), runs)
    for k, ds in digests.items():
        res[f"{k}_digest"] = hashlib.sha256("".join(ds).encode()).hexdigest()[:16]
    for k in ("k5", "k4"):
        res[f"{k}_ms"] = sum(res[f"{k}_step{s}_ms"] for s in (1, 2, 4, 8)) / 4
    return res


_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def sass(tree: str) -> dict[str, list[str]]:
    """Each kernel of the tree's newest built library -> its instructions
    (the anonymous namespace, named from a hash of its file, made one)."""
    lib = max((Path(tree) / "nebulae_tpu_torch" / "build").glob("libnebulae_torch_*.so"),
              key=lambda p: p.stat().st_mtime)
    out = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            name = _ANON.sub("ANON", line.split("Function : ", 1)[1].strip())
            funcs[name] = []
        elif name is not None and (m := _INSN.search(line)):
            funcs[name].append(m.group(1))
    return funcs


def ab_main(argv) -> int:
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(prog="chip_smoke.py --ab")
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=1, help="A B B A rounds")
    ap.add_argument("--runs", type=int, default=21, help="timed launches per median")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    order = []
    for _ in range(args.rounds):
        order += args.trees + args.trees[::-1]

    def child(*cmd) -> str:
        p = subprocess.run([sys.executable, __file__, *cmd], capture_output=True, text=True)
        if p.returncode:
            print(p.stdout[-4000:], p.stderr[-4000:], sep="\n", file=sys.stderr)
            raise RuntimeError(f"{cmd}: exit {p.returncode}")
        return p.stdout

    results = []
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "inputs.pt")
        child("--ab-capture", path)
        for tree in order:
            line = [ln for ln in child("--ab-child", tree, path, str(args.runs)).splitlines()
                    if ln.startswith("{")][-1]
            results.append(json.loads(line))
            log(line)
    keys = ("k1_ms", "k7a_ms", "k2_phase4_ms", "k3_phase4_ms", "k7b_phase4_ms", "k7c_phase4_ms", "k4_ms", "k5_ms",
            *(f"k{k}_step{s}_ms" for k in (4, 5) for s in (1, 2, 4, 8)))

    def rows_median(rs, get):
        """Per-launch rows across a tree's runs: each ms the median, the
        empty profiler sessions summed, the rest as the first run has it."""
        def merge(k, vals):
            if k.endswith("ms"):
                return statistics.median(vals)
            return sum(vals) if k.endswith("empty_sessions") else vals[0]
        return [{k: merge(k, [get(r)[i][k] for r in rs]) for k in row if k != "digest"}
                for i, row in enumerate(get(rs[0]))]

    for tree in args.trees:
        rs = [r for r in results if r["tree"] == tree]
        summary = {k: statistics.median(r[k] for r in rs) for k in keys}
        summary["group_rays"] = rs[0]["group_rays"]
        for name in ("k1", "k7a"):
            summary[name] = rows_median(rs, lambda r: [r[name]])[0]
        for name in ("k3", "k7b", "k7c"):
            summary[f"{name}_phase4"] = rows_median(rs, lambda r: [r[f"{name}_phase4"]])[0]
            summary[f"{name}_sweep"] = rows_median(rs, lambda r: r[f"{name}_sweep"])
        for size in rs[0]["k2_frames"]:
            summary[f"k2 {size}"] = rows_median(rs, lambda r: r["k2_frames"][size])
            summary[f"k3 {size}"] = rows_median(rs, lambda r: r["k3_frames"][size])
        for name in ("k7b", "k7c"):
            summary[f"{name} 1920x1080 fat2"] = rows_median(rs, lambda r: r[f"{name}_frame"])
        for key, what in (("k8_box", "k8 box frame"), ("k8_huge", "k8 2M fat2 frame")):
            rows = rows_median(rs, lambda r: r[key])
            summary[what] = rows
            summary[f"{what} sweep"] = rows_median(rs, lambda r: r[f"{key}_sweep"])
            for walk in ("closest", "any"):
                mine = [row for row in rows if row["walk"] == walk]
                summary[f"{what} {walk} dev_ms"] = sum(row["dev_ms"] for row in mine)
                if any("thread_dev_ms" in row for row in mine):
                    # The same launches with one thread per ray on each.
                    summary[f"{what} {walk} thread-only dev_ms"] = sum(
                        row.get("thread_dev_ms", row["dev_ms"]) for row in mine)
        summary["digests"] = sorted({
            (*(r[f"{k}_digest"] for k in ("k1", "k7a", "k2", "k3", "k7b", "k7c", "k4", "k5")),
             *(c["digest"] for f in ("k2_frames", "k3_frames") for rows in r[f].values() for c in rows),
             *(c["digest"] for f in ("k7b_frame", "k7c_frame", "k8_box", "k8_huge") for c in r[f]))
            for r in rs})
        log(f"{tree}: {json.dumps(summary)}")
    base = sass(args.trees[0])
    for tree in args.trees[1:]:
        other = sass(tree)
        same = sorted(k for k in base if other.get(k) == base[k])
        differ = sorted((set(base) | set(other)) - set(same))
        log(f"sass {tree} against {args.trees[0]}: same {json.dumps(same)}; differ {json.dumps(differ)}")
    log(smi)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "nebulae_tpu_torch").is_dir():
        print("chip_smoke: nebulae_tpu_torch/ not found beside this script", file=sys.stderr)
        return 2
    argv = sys.argv[1:]
    if argv[:1] == ["--ab-child"]:
        print(json.dumps(ab_child(argv[1], argv[2], int(argv[3]))), flush=True)
        return 0
    sys.path.insert(0, str(ROOT))
    if argv[:1] == ["--dist-worker"]:
        return dist_worker(argv[1:])
    if argv[:1] == ["--ab-capture"]:
        ab_capture(argv[1])
        return 0
    if argv[:1] == ["--ab"]:
        return ab_main(argv[1:])
    if argv:
        print(__doc__, file=sys.stderr)
        return 2

    from nebulae_tpu_torch.kernels import chunks as kc
    from nebulae_tpu_torch.kernels import svgf as ksvgf
    from nebulae_tpu_torch.kernels import trace as kt
    from nebulae_tpu_torch.kernels import vertex as kv
    from nebulae_tpu_torch.kernels.build import host_native, native
    from nebulae_tpu_torch.passes.gbuffer import make_camera_arrays
    from nebulae_tpu_torch.utils.testscenes import bench_camera, textured_scene

    # 1. device
    clock = PhaseClock()
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
    clock.done("device")
    lib = native(verbose=True)
    log(f"build: {lib.build_seconds:.1f} s -> {lib.path.name}")
    clock.done("build")

    # 3. scene
    t0 = time.perf_counter()
    fs, bvh, cfg, renderer = bench_renderer()
    tables = renderer.tables
    builder = host_native()
    log(f"scene: BVH builder {builder.path.name} ({' '.join(builder.flags)}), built in "
        f"{builder.build_seconds:.2f} s")
    log(f"scene: {fs.num_triangles} triangles, {bvh.num_nodes} BVH nodes (C++ builder); tables: "
        f"{tables['fat4nodes'].shape[0]} fat4 nodes, {tables['tris'].shape[0]} slots, "
        f"{table_bytes(tables)} bytes, stack depth {tables['stack_depth']}; "
        f"set up in {time.perf_counter() - t0:.1f} s")
    scene = renderer.scene
    cam_obj = bench_camera(fs)
    cam = make_camera_arrays(cam_obj, WIDTH, HEIGHT, dev)
    clock.done("scene")

    # 4. kernels against their plain versions, at the main path's shapes
    report = {}
    (o, d), (ro, rb, rl), gbuf, gen = path_rays(
        scene, lambda a, b: kt.closest_hit_fat4(a, b, tables), renderer.sun, cam)
    n_pix = o.shape[0]

    def k1(a, b, t):
        return kt.closest_hit_fat4(a, b, tables, t)

    def k1_plain(a, b, t, w):
        return kt.closest_hit_fat4_plain(a, b, tables, t, work=w)

    h = Held()
    k1_hit = hold_closest(h, "K1", k1, k1_plain, o, d, tables)
    log(f"K1 closest: {n_pix} rays, hit {float((k1_hit['tri'] >= 0).float().mean()):.3f}, kernel {h.ms:.3f} ms, "
        f"plain {h.plain_ms:.1f} ms, bound {h.bound:.4f} ms ({h.by}), max err {h.err:.3g}, work {h.work}")
    # K1, K2 and K3 on the main path's own launches: those of one 1080p
    # frame, each held against its plain version on the inputs the frame
    # gave it.
    k1_launches, k2_launches, k3_launches = recorded_launches(
        lambda: renderer.render(cam_obj), kt.closest_hit_fat4, kt.shadow_closest_fat4, kt.any_hit_fat4)
    h = Held()
    for i, (a, b, t) in enumerate(k1_launches):
        ms = h.ms
        hold_closest(h, f"K1 frame launch {i}", k1, k1_plain, a, b, tables, t)
        log(f"K1 frame launch {i}: {a.shape[0]} rays, kernel {h.ms - ms:.4f} ms")
    report["closest_fat4"] = h.entry()
    log(f"K1 on a frame's {len(k1_launches)} launch(es): kernel {h.ms:.3f} ms, plain {h.plain_ms:.1f} ms, "
        f"bound {h.bound:.4f} ms ({h.by}), max err {h.err:.3g}, work {h.work}")
    stress("K1", k1, k1_plain, (o, d), 1, two_bodies=False)
    del k1_launches

    # Bounce and shadow rays from primary surface points, as at a path vertex.
    def k2(a, b, l_, tb, tl):
        return kt.shadow_closest_fat4(a, b, l_, tables, tb, tl)

    def k2_plain(a, b, l_, tb, tl, w):
        return kt.shadow_closest_fat4_plain(a, b, l_, tables, tb, tl, work=w)

    h = Held()
    hit, occ = hold_combo(h, "K2", k2, k2_plain, ro, rb, rl, tables)
    log(f"K2 combo: {N_RANDOM} rays (the group bodies take up to {kt.group_rays()}), bounce hit "
        f"{float((hit['tri'] >= 0).float().mean()):.3f}, occluded {float(occ.float().mean()):.3f}, "
        f"kernel {h.ms:.3f} ms, plain {h.plain_ms:.1f} ms, bound {h.bound:.4f} ms ({h.by}), "
        f"max err {h.err:.3g}, work {h.work}")
    h = Held()
    for i, (a, b, l_, tb, tl) in enumerate(k2_launches):
        ms = h.ms
        hold_combo(h, f"K2 frame launch {i}", k2, k2_plain, a, b, l_, tables, tb, tl)
        log(f"K2 frame launch {i}: {a.shape[0]} rays, kernel {h.ms - ms:.4f} ms")
    report["shadow_closest_fat4"] = h.entry()
    log(f"K2 on a frame's {len(k2_launches)} launches: kernel {h.ms:.3f} ms, plain {h.plain_ms:.1f} ms, "
        f"bound {h.bound:.4f} ms ({h.by}), max err {h.err:.3g}, work {h.work}")
    del k2_launches

    # The fused walk at the stress shapes, on the one table (K2) and on the
    # 139k scene's triangle chunks under a 5 MB budget (its SlotRange build);
    # there also K1's SlotRange build at the stress shapes and chained over
    # the chunks on the 1080p primary rays, which must end at K1's hits.
    stress("K2", k2, k2_plain, (ro, rb, rl), 2)
    budget = kc.TRI_CHUNK_TABLE_BUDGET
    kc.TRI_CHUNK_TABLE_BUDGET = 5 * 1024 * 1024
    try:
        tri_chunks = kt.tables_to(kc.pack_bvh_tri_chunks(bvh, fs.tri_pos, cfg.bvh_tri_group), dev)["tri_chunks"]
    finally:
        kc.TRI_CHUNK_TABLE_BUDGET = budget
    h, best = Held(), None
    for c in tri_chunks:
        closest, closest_p, combo, combo_p, _, _ = _slot_fns(c)
        tag = f"K6b chunk [{c['slot_lo']}, {c['slot_hi']}) of {len(tri_chunks)}"
        stress(tag, combo, combo_p, (ro, rb, rl), 2)
        stress(f"{tag} any", *_slot_fns(c)[4:], (ro, rl), 1)
        stress(f"{tag} closest", closest, closest_p, (o, d), 1, two_bodies=False)
        cap = float("inf") if best is None else best["t"]
        best = _merge_hits(best, hold_closest(h, f"{tag} closest", closest, closest_p, o, d, c, cap))
    assert torch.equal(best["t"], k1_hit["t"]) and torch.equal(best["tri"] >= 0, k1_hit["tri"] >= 0), \
        "K6b closest chain over the 5 MB chunks differs from K1"
    log(f"K6b closest chained over {len(tri_chunks)} chunks at 1080p: kernels {h.ms:.3f} ms, plain "
        f"{h.plain_ms:.1f} ms, max err {h.err:.3g}; ends at K1's t")
    del best, k1_hit

    def k3(a, b, t):
        return kt.any_hit_fat4(a, b, tables, t)

    def k3_plain(a, b, t, w):
        return kt.any_hit_fat4_plain(a, b, tables, t, work=w)

    h = Held()
    occ = hold_any(h, "K3", k3, k3_plain, ro, rl, tables)
    log(f"K3 any: {N_RANDOM} rays, occluded {float(occ.float().mean()):.3f}, "
        f"kernel {h.ms:.3f} ms, plain {h.plain_ms:.1f} ms, bound {h.bound:.4f} ms ({h.by}), work {h.work}")
    h = Held()
    for i, (a, b, t) in enumerate(k3_launches):
        ms = h.ms
        hold_any(h, f"K3 frame launch {i}", k3, k3_plain, a, b, tables, t)
        log(f"K3 frame launch {i}: {a.shape[0]} rays, kernel {h.ms - ms:.4f} ms")
    report["any_fat4"] = h.entry()
    log(f"K3 on a frame's {len(k3_launches)} launch(es): kernel {h.ms:.3f} ms, plain {h.plain_ms:.1f} ms, "
        f"bound {h.bound:.4f} ms ({h.by}), work {h.work}")
    stress("K3", k3, k3_plain, (ro, rl), 1)
    del k3_launches

    # K4 on a 1080p frame's guidance buffers with noisy radiance.
    rad, var, depth, nrm = atrous_inputs(gbuf, gen)
    phi = (cfg.svgf_phi_color, cfg.svgf_phi_normal, cfg.svgf_phi_depth)
    k4 = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for step in (1, 2, 4, 8):
        out_k, w_k = ksvgf.atrous_step(rad, var, depth, nrm, step, phi)
        res = {}
        t_plain = once_ms(lambda: res.update(v=ksvgf.atrous_step_plain(rad, var, depth, nrm, step, phi)))
        out_p, w_p = res["v"]
        err = max(float((out_k - out_p).abs().max()), float((w_k - w_p).abs().max()))
        assert err == 0.0, f"K4 step {step}: max error {err:.3g} against its plain version"
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

    # K5 on the same inputs: against its plain version, and the adjoint
    # identity <K4(x), y> = <x, K5(y; x)> (weights frozen at x), in float64.
    k5 = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0)
    k5_bytes, k5_ops = n_pix * 60, n_pix * (25 * OPS_TAP_BWD + OPS_PIXEL_BWD)
    for step in (1, 2, 4, 8):
        out_k, w_k = ksvgf.atrous_step(rad, var, depth, nrm, step, phi)
        y = torch.randn((HEIGHT, WIDTH, 3), device=dev, generator=gen)
        g_k = ksvgf.atrous_step_bwd(y, w_k, rad, var, depth, nrm, step, phi)
        res = {}
        t_plain = once_ms(lambda: res.update(
            v=ksvgf.atrous_step_bwd_plain(y, w_k, rad, var, depth, nrm, step, phi)))
        err = float((g_k - res["v"]).abs().max())
        assert err == 0.0, f"K5 step {step}: max error {err:.3g} against its plain version"
        lhs = float((out_k.double() * y.double()).sum())
        rhs = float((rad.double() * g_k.double()).sum())
        adj = abs(lhs - rhs) / max(abs(lhs), abs(rhs))
        assert adj <= 1e-5, f"K5 step {step}: adjoint identity off by {adj:.3g}"
        ms = timed_ms(lambda: ksvgf.atrous_step_bwd(y, w_k, rad, var, depth, nrm, step, phi))
        b_ms, b_by = bound_ms(k5_bytes, k5_ops)
        log(f"K5 atrous bwd step {step}: kernel {ms:.3f} ms, plain {t_plain:.1f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), max err {err:.3g}, adjoint rel err {adj:.3g}")
        k5["max_abs_err"] = max(k5["max_abs_err"], err)
        k5["ms"] += ms / 4
        k5["plain_ms"] += t_plain / 4
        k5["bound_ms"] += b_ms / 4
    k5["bound_by"] = bound_ms(k5_bytes, k5_ops)[1]
    report["atrous_bwd"] = k5
    # K4 and K5 on a ragged 1917x1079 frame, so that every tile edge of
    # every step is cut: max error 0, and K5's adjoint identity against K4.
    rh, rw = 1079, 1917
    rrad = torch.rand((rh, rw, 3), device=dev, generator=gen) * 2.0
    rvar = torch.rand((rh, rw), device=dev, generator=gen) * 0.05
    rdep = 3.0 + torch.rand((rh, rw), device=dev, generator=gen) * 0.01
    rnrm = torch.nn.functional.normalize(
        torch.randn((rh, rw, 3), device=dev, generator=gen) * 0.05 + torch.tensor([0.0, 0.0, 1.0], device=dev), dim=-1)
    def k4_err(x, v, z, n, step, phi_):
        """K4 on (x, v, z, n) and its max error against its plain version."""
        out_, w_ = ksvgf.atrous_step(x, v, z, n, step, phi_)
        out_p, w_p = ksvgf.atrous_step_plain(x, v, z, n, step, phi_)
        return out_, w_, max(float((out_ - out_p).abs().max()), float((w_ - w_p).abs().max()))

    for step in (1, 2, 4, 8):
        out_r, w_r, err4 = k4_err(rrad, rvar, rdep, rnrm, step, phi)
        assert err4 == 0.0, f"K4 ragged step {step}: max error {err4:.3g}"
        y_r = torch.randn((rh, rw, 3), device=dev, generator=gen)
        g_r = ksvgf.atrous_step_bwd(y_r, w_r, rrad, rvar, rdep, rnrm, step, phi)
        err = float((g_r - ksvgf.atrous_step_bwd_plain(y_r, w_r, rrad, rvar, rdep, rnrm, step, phi)).abs().max())
        lhs = float((out_r.double() * y_r.double()).sum())
        rhs = float((rrad.double() * g_r.double()).sum())
        adj = abs(lhs - rhs) / max(abs(lhs), abs(rhs))
        assert err == 0.0 and adj <= 1e-5, f"K5 ragged step {step}: max error {err:.3g}, adjoint {adj:.3g}"
        log(f"K4 / K5 ragged {rw}x{rh} step {step}: max err {err4:.3g} / {err:.3g}, adjoint rel err {adj:.3g}")
    # K4's and K5's builds for a phi_normal other than SVGF's 128 (taken at
    # run time).
    phi64 = (phi[0], 64, phi[2])
    _, w_r, err4 = k4_err(rrad, rvar, rdep, rnrm, 2, phi64)
    g_r = ksvgf.atrous_step_bwd(y_r, w_r, rrad, rvar, rdep, rnrm, 2, phi64)
    err = float((g_r - ksvgf.atrous_step_bwd_plain(y_r, w_r, rrad, rvar, rdep, rnrm, 2, phi64)).abs().max())
    assert err4 == 0.0 and err == 0.0, f"K4 / K5 with phi_normal 64: max error {err4:.3g} / {err:.3g}"
    log(f"K4 / K5 ragged step 2 with phi_normal 64: max err {err4:.3g} / {err:.3g}")
    del rrad, rvar, rdep, rnrm, out_r, w_r, y_r, g_r
    # Through autograd on the card: the step stays in the graph, and its
    # backward is K5.
    x = rad.clone().requires_grad_(True)
    out_k, w_k = ksvgf.atrous_step(x, var, depth, nrm, 2, phi)
    assert out_k.requires_grad and out_k.grad_fn is not None, "a-trous output cut off from the graph"
    n_bwd = ksvgf.atrous_step_bwd.launches
    (g_auto,) = torch.autograd.grad(out_k, x, y)
    assert ksvgf.atrous_step_bwd.launches == n_bwd + 1, "autograd did not launch K5"
    torch.testing.assert_close(g_auto, ksvgf.atrous_step_bwd(y, w_k, rad, var, depth, nrm, 2, phi),
                               rtol=0.0, atol=0.0)
    log("K5 through autograd: output requires grad, backward launched K5, same result")
    del x, out_k, w_k, g_k, g_auto, y, res
    del hit, occ, gbuf, ro, rb, rl, o, d
    clock.done("kernels")

    # 5. slice: the main path, with every launch count read around it
    wrappers = {
        "closest_fat4": kt.closest_hit_fat4,
        "shadow_closest_fat4": kt.shadow_closest_fat4,
        "any_fat4": kt.any_hit_fat4,
        "atrous_fwd": ksvgf.atrous_step,
        "vertex": kv.vertex_kernel,
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
    assert launches["vertex"] == 8 * cfg.max_bounces, f"K9 launches in 8 frames: {launches['vertex']}"
    frame_s = sum(times) / len(times)
    rays = WIDTH * HEIGHT * (1 + SPP * (2 * BOUNCES - 1))
    log(f"slice: {frame_s * 1e3:.2f} ms/frame (mean of 5; frames {[round(t * 1e3, 2) for t in times]}), "
        f"{rays / frame_s / 1e6:.2f} Mrays/s, ldr mean {float(ldr.mean()):.4f}, launches {launches}, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    seen = profile_frame(lambda: renderer.render(cam_obj), FAT4_KERNELS, frame_s * 1e3)["launches"]
    assert seen["vertex_kernel"] == cfg.max_bounces, f"the profiled frame lists {seen['vertex_kernel']} K9 launches"

    # A small frame on the GPU against the CPU through the plain versions.
    small_frame_check(textured_scene(seed=0))
    clock.done("slice")

    # 6. train: the inverse-rendering step at the same width
    del out, ldr
    train_launches = train_phase(renderer, cam, cfg, wrappers)
    small_train_check(textured_scene(seed=0))
    clock.done("train")

    # 7. large: scenes past the single-table gate, every chunk_mode route
    del renderer, scene, tables
    torch.cuda.empty_cache()
    large_report, large_launches = large_phase(cfg)
    report.update(large_report)
    launches.update(large_launches)
    clock.t = time.perf_counter()

    # 8. fat2 and dynamic: bvh_wide=2 (K7) and refit on every single-table route
    fat2_report, fat2_launches = fat2_phase(cfg, fs, bvh)
    report.update(fat2_report)
    launches.update(fat2_launches)
    clock.t = time.perf_counter()

    # 9. options: primary jitter, fast bounce shading and the env-map sky
    options_phase(cfg, fs, bvh)
    clock.done("options")

    # 10. nrc: the neural radiance cache in the frame and the train step
    nrc_phase(cfg, fs, bvh)
    clock.done("nrc")

    # 11. app: a glTF scene through the app shell
    torch.cuda.empty_cache()
    app_phase(smi)
    clock.done("app")

    # 12. dist: row-sharded frames, train steps, NRC and the app over ranks
    dist_phase(smi)
    clock.done("dist")

    # 13. nrc-routes: the cache on every frame option, route and width, and
    # after a refit
    nrc_routes_phase(cfg, fs, bvh)
    clock.done("nrc-routes")

    # 14. oracle: the reference tracer, and the frames and gradients held to it
    oracle_phase(fs, bvh)
    clock.done("oracle")

    # 15. vertex: K9 on every launch of a frame and an NRC frame, and a step
    report["vertex"] = vertex_phase(cfg, fs, bvh)
    clock.done("vertex")

    # 16. summary
    sources = {
        "closest_fat4": ("nebulae_tpu_torch/csrc/trace.cu", "nebulae_tpu/kernels/pallas_trace.py:1202"),
        "shadow_closest_fat4": ("nebulae_tpu_torch/csrc/trace.cu", "nebulae_tpu/kernels/pallas_trace.py:1415"),
        "any_fat4": ("nebulae_tpu_torch/csrc/trace.cu", "nebulae_tpu/kernels/pallas_trace.py:1311"),
        "atrous_fwd": ("nebulae_tpu_torch/csrc/atrous.cu", "nebulae_tpu/kernels/pallas_svgf.py:81"),
        "atrous_bwd": ("nebulae_tpu_torch/csrc/atrous.cu", "nebulae_tpu/kernels/pallas_svgf.py:221"),
        # K6b: the slot_range builds, launched by the tri-chunk walks.
        "closest_fat4_slots": ("nebulae_tpu_torch/csrc/trace.cu", "nebulae_tpu/kernels/pallas_trace.py:374"),
        "shadow_closest_fat4_slots": ("nebulae_tpu_torch/csrc/trace.cu",
                                      "nebulae_tpu/kernels/pallas_trace.py:408"),
        "any_fat4_slots": ("nebulae_tpu_torch/csrc/trace.cu", "nebulae_tpu/kernels/pallas_trace.py:393"),
        # K6a: the paged=True builds (_paged_fetch, :1184).
        "closest_fat4_paged": ("nebulae_tpu_torch/csrc/trace.cu", "nebulae_tpu/kernels/pallas_trace.py:1382"),
        "shadow_closest_fat4_paged": ("nebulae_tpu_torch/csrc/trace.cu",
                                      "nebulae_tpu/kernels/pallas_trace.py:1542"),
        "any_fat4_paged": ("nebulae_tpu_torch/csrc/trace.cu", "nebulae_tpu/kernels/pallas_trace.py:1401"),
        # K8: the one-node kernels.
        "closest_node": ("nebulae_tpu_torch/csrc/trace.cu", "nebulae_tpu/kernels/pallas_trace.py:794"),
        "any_node": ("nebulae_tpu_torch/csrc/trace.cu", "nebulae_tpu/kernels/pallas_trace.py:881"),
        # K7: the fat2 kernels.
        "closest_fat": ("nebulae_tpu_torch/csrc/trace.cu", "nebulae_tpu/kernels/pallas_trace.py:958"),
        "shadow_closest_fat": ("nebulae_tpu_torch/csrc/trace.cu", "nebulae_tpu/kernels/pallas_trace.py:1563"),
        "any_fat": ("nebulae_tpu_torch/csrc/trace.cu", "nebulae_tpu/kernels/pallas_trace.py:1044"),
        # K9 replaces no TPU kernel: XLA fused the vertex's eager chain.
        "vertex": ("nebulae_tpu_torch/csrc/vertex.cu", None),
    }
    # K1-K4 and K9 counted over the forward frames, K5 over the train
    # steps; K6b over the 247k tri route's frames, K6a over the ~2M scene's
    # frames, K8 over the box scene's frame, K7 over the bench scene's fat2
    # frames.
    launches["atrous_bwd"] = train_launches["atrous_bwd"]
    kernels = []
    for name, (src, replaces) in sources.items():
        r = report[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None,
        })
    clock.done("summary")
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
