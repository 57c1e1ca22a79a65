"""Application shell: CLI entry point and render loop (as `nebulae_tpu/app.py`).

Parse the arguments, load a glTF scene, run the frame loop with an orbiting
camera, present each frame to an output directory, stream JSONL metrics
(and beside them, in <metrics>.counters.jsonl, the program's counters that
each frame advanced, summed from the first frame: lanes, rays and a-trous
passes; utils/metrics.py), touch a heartbeat file, checkpoint the frame
state every N frames and resume from a checkpoint.  Runs on the GPU unless `--device cpu` is given.
`run(argv)` is the loop and returns its Renderer; `main(argv)` is the
command's entry point.

Usage:
    python -m nebulae_tpu_torch.app --scene /path/to/scene.gltf --frames 64 \
        --width 1920 --height 1080 --nrc --out /tmp/frames

Multi-process runs (`--num-processes N --process-id R --coordinator
host:port`, one command per rank) render row-sharded frames through
dist.runner.DistRenderer; rank 0 presents the gathered image and writes the
checkpoints, and rank R > 0 writes metrics.rR.jsonl and heartbeat.rR.
`--mesh` alone is a world of one through the same path.  A `--coordinator`
without `--num-processes` above 1 runs the single-process path, as JAX's
app does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np

def build_arg_parser() -> argparse.ArgumentParser:
    """JAX's app flags, names and defaults, and --device."""
    p = argparse.ArgumentParser("nebulae_tpu_torch", description=__doc__)
    p.add_argument("--scene", required=True, help="glTF 2.0 scene (.gltf/.glb)")
    p.add_argument("--device", default=None,
                   help="torch device to render on (default: the GPU; 'cpu' runs the plain versions)")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--spp", type=int, default=1)
    p.add_argument("--bounces", type=int, default=8)
    p.add_argument("--nrc", action="store_true", help="enable the neural radiance cache")
    p.add_argument("--no-svgf", action="store_true")
    p.add_argument("--no-gi", action="store_true", help="direct lighting only")
    p.add_argument("--envmap", default=None,
                   help="lat-long environment map image for IBL sky, or 'procedural'")
    p.add_argument("--tracer", default="auto", choices=["auto", "bruteforce", "bvh", "pallas"],
                   help="'pallas' and 'bvh' walk the BVH tables with the traversal kernels; "
                        "'auto' goes brute force on small scenes")
    p.add_argument("--out", default="/tmp/nebulae_frames")
    p.add_argument("--orbit-speed", type=float, default=0.0, help="deg/frame camera orbit")
    p.add_argument("--accumulate", action="store_true",
                   help="progressive still: average all frames' HDR (each frame advances "
                        "the RNG stream) and present one converged image at the end")
    p.add_argument("--animate", type=float, default=0.0, metavar="AMPL",
                   help="dynamic-scene demo: bob the geometry by AMPL x scene height "
                        "per frame cycle (BVH refit per frame, no rebuild)")
    p.add_argument("--distance-scale", type=float, default=2.2)
    p.add_argument("--max-texture-dim", type=int, default=1024)
    p.add_argument("--sun-dir", default=None, help="x,y,z toward the sun")
    p.add_argument("--sun-radiance", default=None, help="r,g,b")
    p.add_argument("--sun-angle-deg", type=float, default=None, help="sun disk diameter")
    p.add_argument("--sky-color", default=None, help="r,g,b constant sky")
    p.add_argument("--throughput-threshold", type=float, default=0.0)
    p.add_argument("--svgf-alpha", type=float, default=0.9)
    p.add_argument("--nrc-lr", type=float, default=1e-2)
    p.add_argument("--fast-bounce-shading", action="store_true")
    p.add_argument("--no-texture-mips", action="store_true",
                   help="disable primary-pass texture mip selection (UV-derivative LOD)")
    p.add_argument("--nrc-raw-radiance", action="store_true",
                   help="train the cache on raw outgoing radiance instead of the "
                        "demodulated (irradiance) target")
    p.add_argument("--bvh-wide", type=int, default=4, choices=[2, 4],
                   help="fat traversal table width (children vs grandchildren per visit)")
    p.add_argument("--chunk-mode", default="auto", choices=["auto", "subtree", "paged", "tri"],
                   help="large-scene table route (auto picks; paged = one table, "
                        "refittable at any size)")
    p.add_argument("--preview", type=int, default=None, metavar="PORT",
                   help="serve the latest frame at http://127.0.0.1:PORT/ "
                        "(live view; pair with --control-file for knobs)")
    p.add_argument("--bucket-scheduling", action="store_true",
                   help="a TPU scheduling knob: accepted, changes no output")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=64)
    p.add_argument("--resume", default=None, help="checkpoint dir to restore state from")
    p.add_argument("--profile", default=None,
                   help="capture a torch.profiler Chrome trace of the loop to DIR/trace.json")
    p.add_argument("--control-file", default=None,
                   help="JSON file polled every frame for runtime knob changes: sun_dir/"
                        "sun_radiance/sun_angle_deg/sky_color, and spp/bounces/gi/svgf/"
                        "svgf_alpha/nrc/nrc_lr/nrc_train_iterations/throughput_threshold "
                        "through Renderer.update_config")
    p.add_argument("--metrics", default=None,
                   help="JSONL metrics stream path (default <out>/metrics.jsonl; the program's counters "
                        "go beside it, to <stem>.counters.jsonl; 'off' disables both)")
    p.add_argument("--crash-dir", default=None,
                   help="crash-dump directory (default $NEBULAE_CRASH_DIR or /tmp/nebulae_crash)")
    p.add_argument("--heartbeat", default=None,
                   help="liveness file touched every frame (default <out>/heartbeat)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0's rendezvous (multi-process runs)")
    p.add_argument("--num-processes", type=int, default=1,
                   help="total processes in the multi-process run (1 = single process)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank in the multi-process run")
    p.add_argument("--mesh", action="store_true",
                   help="render through the row-sharded path (implied by --num-processes > 1); "
                        "height must divide the number of processes")
    return p


def _vec3(values) -> np.ndarray:
    v = np.asarray([float(x) for x in values], np.float32)
    if v.shape != (3,):
        raise ValueError(f"expected 3 components, got {values!r}")
    return v


def _sun_with(sun, controls: dict):
    """`sun` with the sun and sky entries of `controls` applied."""
    import torch

    dev = sun.direction.device

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32).to(dev)

    if "sun_dir" in controls:
        d = _vec3(controls["sun_dir"])
        sun = dataclasses.replace(sun, direction=t(d / np.linalg.norm(d)))
    if "sun_radiance" in controls:
        sun = dataclasses.replace(sun, radiance=t(_vec3(controls["sun_radiance"])))
    if "sun_angle_deg" in controls:
        half = np.tan(np.deg2rad(float(controls["sun_angle_deg"])) * 0.5)
        sun = dataclasses.replace(sun, tan_half_angle=t(np.float32(half)))
    if "sky_color" in controls:
        sun = dataclasses.replace(sun, sky_color=t(_vec3(controls["sky_color"])))
    return sun


CONTROL_FIELDS = {
    "spp": "spp", "bounces": "max_bounces", "gi": "enable_gi",
    "svgf": "enable_svgf", "svgf_alpha": "svgf_temporal_alpha",
    "nrc": "enable_nrc", "nrc_lr": "nrc_learning_rate",
    "nrc_train_iterations": "nrc_train_iterations",
    "throughput_threshold": "throughput_threshold",
}


def apply_controls(renderer, controls: dict) -> None:
    """Apply a runtime-control dict to a live Renderer: sun and sky values
    replace the sun's tensors; the other knobs go through
    Renderer.update_config."""
    renderer.sun = _sun_with(renderer.sun, controls)
    updates = {f: controls[k] for k, f in CONTROL_FIELDS.items() if k in controls}
    if updates:
        renderer.update_config(dataclasses.replace(renderer.cfg, **updates))


def _env_map(spec: str) -> np.ndarray:
    """'procedural' (JAX's app's 64x128 sky) or an image file -> linear
    [H, W, 3] float32."""
    if spec == "procedural":
        from nebulae_tpu_torch.utils.testscenes import procedural_envmap

        return procedural_envmap()
    from nebulae_tpu_torch.core.gltf import decode_image_bytes
    from nebulae_tpu_torch.core.scene import srgb_to_linear_np

    img = decode_image_bytes(Path(spec).read_bytes(), spec)[..., :3].astype(np.float32) / 255.0
    return srgb_to_linear_np(img).astype(np.float32)


def run(argv=None):
    """The app's loop on `argv` (the command line when None); returns the
    Renderer after the last frame."""
    args = build_arg_parser().parse_args(argv)
    # Multi-process bring-up precedes any device use.
    world = None
    if args.num_processes > 1 or args.mesh:
        from nebulae_tpu_torch.dist.mesh import init_distributed

        if args.num_processes > 1 and args.process_id is None:
            raise ValueError(f"--num-processes {args.num_processes} needs --process-id (this process's rank)")
        world = init_distributed(args.coordinator, args.num_processes, args.process_id or 0, device=args.device)
    try:
        return _run(args, world)
    finally:
        if world is not None:
            world.close()


def _run(args, world):
    import torch

    from nebulae_tpu_torch.config import RenderConfig, SunLight
    from nebulae_tpu_torch.core.camera import OrbitCamera
    from nebulae_tpu_torch.core.scene import load_scene
    from nebulae_tpu_torch.device import resolve_device
    from nebulae_tpu_torch.dist.runner import DistRenderer, present_gather
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.utils import crashdump
    from nebulae_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from nebulae_tpu_torch.utils.crashdump import Heartbeat
    from nebulae_tpu_torch.utils.display import FrameWriter
    from nebulae_tpu_torch.utils.logging import log_info
    from nebulae_tpu_torch.utils.metrics import MetricsLogger, totals
    from nebulae_tpu_torch.utils.profiling import FrameTimer, profile_trace

    device = resolve_device(args.device) if world is None else world.device
    is_host0 = world is None or world.rank == 0
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU (plain versions)"
    log_info(f"device: {device} ({name})")
    log_info(f"loading {args.scene}")
    scene = load_scene(args.scene, max_texture_dim=args.max_texture_dim)
    fs = scene.flat
    log_info(f"scene: {fs.num_triangles} tris, {fs.num_materials} materials, {fs.textures.shape[0]} textures; "
             + ", ".join(f"{k} {v:.3f}" for k, v in scene.seconds.items()))

    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        spp=args.spp,
        max_bounces=args.bounces,
        enable_gi=not args.no_gi,
        enable_svgf=not args.no_svgf,
        enable_nrc=args.nrc,
        enable_envmap=args.envmap is not None,
        tracer=args.tracer,
        throughput_threshold=args.throughput_threshold,
        svgf_temporal_alpha=args.svgf_alpha,
        nrc_learning_rate=args.nrc_lr,
        fast_bounce_shading=args.fast_bounce_shading,
        texture_mips=not args.no_texture_mips,
        nrc_learn_irradiance=not args.nrc_raw_radiance,
        bvh_wide=args.bvh_wide,
        chunk_mode=args.chunk_mode,
        bucket_scheduling=args.bucket_scheduling,
    )
    controls = {}
    if args.sun_dir:
        controls["sun_dir"] = args.sun_dir.split(",")
    if args.sun_radiance:
        controls["sun_radiance"] = args.sun_radiance.split(",")
    if args.sun_angle_deg is not None:
        controls["sun_angle_deg"] = args.sun_angle_deg
    if args.sky_color:
        controls["sky_color"] = args.sky_color.split(",")
    sun = _sun_with(SunLight.default(device), controls)
    env = _env_map(args.envmap) if args.envmap else None
    t0 = time.perf_counter()
    if world is None:
        renderer = Renderer(fs, cfg, sun=sun, device=device, env_map=env)
    else:
        renderer = DistRenderer(fs, cfg, world, sun=sun, env_map=env)
        log_info(f"world: rank {world.rank} of {world.size} ({world.backend}), rows {world.rows(cfg.height)}")
    log_info(f"renderer: route {renderer.route}, set up in {time.perf_counter() - t0:.3f} s")
    if args.nrc:
        from nebulae_tpu_torch.nrc.cache import memory_footprint

        fp = memory_footprint(renderer.state["nrc"])
        log_info("nrc cache footprint: " + ", ".join(f"{k} {v / 1024:.1f} KiB" for k, v in fp.items()))
    if args.resume:
        renderer.state = load_checkpoint(args.resume, renderer.state, world=world)
        log_info(f"resumed state from {args.resume}")

    lo, hi = fs.aabb_min, fs.aabb_max
    cam = OrbitCamera(
        distance=args.distance_scale * float(np.max(hi - lo)),
        pitch_deg=20.0,
        yaw_deg=45.0,
        target=(lo + hi) * 0.5,
    )
    writer = FrameWriter(args.out)
    timer = FrameTimer()
    preview = None
    if args.preview is not None and is_host0:
        from nebulae_tpu_torch.utils.display import PreviewServer

        preview = PreviewServer(port=args.preview)
        log_info(f"live preview: http://127.0.0.1:{preview.port}/")

    crashdump.install(state_provider=lambda: renderer.state, dump_dir=args.crash_dir)
    # Each rank past 0 keeps its own metrics stream and liveness file.
    sfx = "" if is_host0 else f".r{world.rank}"
    metrics_path = args.metrics or str(Path(args.out) / f"metrics{sfx}.jsonl")
    metrics = MetricsLogger(None if metrics_path == "off" else metrics_path)
    # The program's counters go to a stream of their own, so the metrics
    # rows keep the JAX app's format.
    counters = MetricsLogger(None if metrics_path == "off" else Path(metrics_path).with_suffix(".counters.jsonl"))
    heartbeat = Heartbeat(args.heartbeat or Path(args.out) / f"heartbeat{sfx}")

    base_tri_pos = np.asarray(fs.tri_pos) if args.animate else None
    ctrl_state = {"mtime": 0.0}
    accum: dict = {}

    def read_controls():
        try:
            mtime = Path(args.control_file).stat().st_mtime
        except OSError:
            return None
        if mtime <= ctrl_state["mtime"]:
            return None
        ctrl_state["mtime"] = mtime
        try:
            return json.loads(Path(args.control_file).read_text())
        except (OSError, ValueError) as e:
            log_info(f"control file unreadable: {e}")
            return None

    def poll_controls():
        if not args.control_file:
            return
        ctl = read_controls() if is_host0 else None
        if world is not None:
            # Rank 0 reads the file and every rank applies what it read, so
            # the ranks' configurations change on the same frame.
            from nebulae_tpu_torch.dist.comm import broadcast_json

            ctl = broadcast_json(world, ctl)
        if ctl is None:
            return
        apply_controls(renderer, ctl)
        log_info(f"applied runtime controls: {sorted(ctl)}")

    def loop():
        for i in range(args.frames):
            poll_controls()
            if args.orbit_speed:
                cam.rotate(args.orbit_speed, 0.0)
            if args.animate:
                # Rigid vertical bob inside the build-time AABB: a refit of
                # the BVH and the tables per frame.
                phase = 2.0 * np.pi * i / max(args.frames, 1)
                off = np.array([0.0, args.animate * float(hi[1] - lo[1]) * np.sin(phase), 0.0], np.float32)
                renderer.update_geometry(base_tri_pos + off)
            before = totals()
            t0 = time.perf_counter()
            out = renderer.render(cam.camera())
            if args.accumulate:
                # Progressive still: average the raw (pre-denoise) HDR; each
                # frame's RNG stream differs.  Tonemapped once after the loop.
                accum["hdr"] = out["hdr"] if "hdr" not in accum else accum["hdr"] + out["hdr"]
            else:
                # Rank 0 presents the whole image, gathered from every rank.
                ldr = present_gather(world, out["ldr"])
                if is_host0:
                    writer.present(ldr)
                if preview is not None:
                    preview.update(ldr)
            timer.tick()
            heartbeat.touch()
            metrics.scalar("frame_ms", (time.perf_counter() - t0) * 1e3)
            if args.nrc:
                metrics.scalar("nrc_loss", float(out["nrc_loss"]))
                metrics.scalar("nrc_query_frac", float(out["nrc_query_frac"]))
            metrics.count("frames")
            metrics.flush(step=i)
            for name, n in totals().items():
                if n != before.get(name, 0):
                    counters.count(name, n - before.get(name, 0))
            counters.flush(step=i)
            if args.checkpoint_dir and (i + 1) % args.checkpoint_every == 0:
                save_checkpoint(args.checkpoint_dir, renderer.state, step=i + 1, world=world)

    try:
        if args.profile:
            with profile_trace(args.profile):
                loop()
        else:
            loop()
        if args.accumulate and "hdr" in accum:
            from nebulae_tpu_torch.passes.tonemap import aces_tonemap

            hdr = present_gather(world, accum["hdr"])
            if is_host0:
                writer.present(aces_tonemap(hdr / args.frames))
            writer.flush()
            log_info(f"wrote 1 accumulated still ({args.frames} frames) to {args.out}")
        else:
            writer.flush()
            log_info(f"wrote {args.frames} frames to {args.out}")
    finally:
        if preview is not None:
            preview.close()
    return renderer


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
