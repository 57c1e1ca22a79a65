"""Multi-rank dry run of the distributed path, and the per-rank worker.

The twin of `__graft_entry__.py::dryrun_multichip`: `dryrun(world)` renders
an NRC-on DistRenderer frame and gathers it with present_gather, renders
an NRC-off frame on the ranks and holds it to the single-process frame
(every pixel equal), and runs one full train step (forward, backward, the
gradient sums, Adam) on the same sharding.  `record(world, ...)` renders
frames of the procedural textured scene and runs a train step, and
returns what rank 0 writes for a comparison.

Every rank runs the same command:

    python -m nebulae_tpu_torch.dist.dryrun --rank R --world-size N \\
        --init-method file:///tmp/store [--device cpu] [--dryrun | --out DIR ...]

(`--coordinator host:port` in place of --init-method meets at rank 0's TCP
store.)  With --out, rank 0 writes DIR/result.npz (the gathered frames,
the summed loss and gradients, the parameters after one step) and
DIR/stats.json (each frame's and the step's collectives).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from nebulae_tpu_torch.config import RenderConfig
from nebulae_tpu_torch.core.camera import OrbitCamera
from nebulae_tpu_torch.dist.mesh import World, init_distributed
from nebulae_tpu_torch.dist.runner import DistRenderer, present_gather, replicas_equal
from nebulae_tpu_torch.dist.stats import collective_stats, shard_balance
from nebulae_tpu_torch.engine.renderer import Renderer, init_frame_state
from nebulae_tpu_torch.engine.train import flatten_params, loss_and_grads, make_train_step, split_scene_params
from nebulae_tpu_torch.passes.gbuffer import make_camera_arrays
from nebulae_tpu_torch.utils.logging import log_info
from nebulae_tpu_torch.utils.testscenes import textured_scene

# The outputs gathered from every frame.
FRAME_KEYS = ("hdr", "denoised", "ldr", "hit")


def cameras(fs, frames: int, orbit_deg: float = 0.0) -> list:
    """`frames` cameras around the scene's centre, each `orbit_deg` on from
    the last (one pose repeated when 0)."""
    lo, hi = fs.aabb_min, fs.aabb_max
    orbit = OrbitCamera(distance=0.9 * float(np.max(hi - lo)), pitch_deg=30.0, yaw_deg=35.0,
                        target=(lo + hi) * 0.5)
    out = []
    for i in range(frames):
        if i:
            orbit.rotate(orbit_deg, 0.0)
        out.append(orbit.camera())
    return out


def train_target(cfg: RenderConfig, seed: int = 1) -> np.ndarray:
    """A fixed [H, W, 3] target image for the train step."""
    return np.random.default_rng(seed).uniform(0.0, 0.5, (cfg.height, cfg.width, 3)).astype(np.float32)


def step_inputs(renderer: Renderer, cfg: RenderConfig, cam, world: World | None):
    """(params, frozen, cam arrays, fresh state, target) for a step on the
    renderer's scene: the rank's rows of the state and target."""
    params, frozen = split_scene_params(renderer.scene)
    params["sun"] = renderer.sun
    target = torch.from_numpy(train_target(cfg)).to(renderer.device)
    state = init_frame_state(cfg, renderer.device, world)
    if world is not None:
        r0, r1 = world.rows(cfg.height)
        target = target[r0:r1]
    return params, frozen, make_camera_arrays(cam, cfg.width, cfg.height, renderer.device), state, target


def record(world: World, cfg: RenderConfig, frames: int, orbit_deg: float, step: bool, seed: int = 0):
    """Frames of textured_scene(seed) through a DistRenderer, then (with
    `step`) the summed loss and gradients of render_loss and one full
    train step.  Returns (arrays, stats): the gathered frames, each rank's
    rows, the loss, gradients and stepped params as numpy, and the
    collectives of each frame and of the step."""
    fs = textured_scene(seed)
    r = DistRenderer(fs, cfg, world)
    arrays, stats = {}, {}
    cams = cameras(fs, frames, orbit_deg)
    for i, cam in enumerate(cams):
        n0 = len(world.log)
        out = r.render(cam)
        stats[f"frame{i}"] = collective_stats(list(world.log)[n0:])
        for k in FRAME_KEYS:
            img = out[k].to(torch.uint8) if k == "hit" else out[k]
            arrays[f"frame{i}_{k}"] = present_gather(world, img).cpu().numpy()
        arrays[f"frame{i}_nrc_query_frac"] = np.float32(out["nrc_query_frac"].item())
        if cfg.enable_nrc:
            arrays[f"frame{i}_nrc_loss"] = np.float32(out["nrc_loss"].item())
            arrays[f"frame{i}_nrc"] = np.concatenate(
                [t.detach().float().cpu().numpy().reshape(-1) for layer in r.state["nrc"]["params"]
                 for t in layer.values()])
    arrays["balance"] = np.array(shard_balance(world, out["ldr"])["rows"])
    if step:
        params, frozen, cam, state, target = step_inputs(r, cfg, cams[0], world)
        n0 = len(world.log)
        loss, grads, _, _ = loss_and_grads(params, frozen, r.tables, cam, state, target, cfg,
                                           device=world.device, world=world)
        stats["grads"] = collective_stats(list(world.log)[n0:])
        arrays["loss"] = np.float32(loss.item())
        for i, g in enumerate(grads):
            arrays[f"grad{i}"] = g.cpu().numpy()
        train_step, opt = make_train_step(cfg, frozen, r.tables, device=world.device, world=world)
        new_params, new_opt, _, _, _ = train_step(params, opt.init(params), cam, state, target)
        if not replicas_equal(world, (flatten_params(new_params), new_opt)):
            raise RuntimeError("params or Adam's state differ between ranks after the step")
        for i, p in enumerate(flatten_params(new_params)):
            arrays[f"param{i}"] = p.cpu().numpy()
    return arrays, stats


def dryrun(world: World, width: int = 128) -> float:
    """The production distributed path at a small size (16 rows a rank):
    an NRC-on DistRenderer frame and its present_gather, an NRC-off frame
    equal to the single-process frame, and one full train step.  Returns
    the step's loss."""
    fs = textured_scene(0)
    cfg = RenderConfig(width=width, height=16 * world.size, max_bounces=3, enable_nrc=True)
    cam = cameras(fs, 1)[0]
    dr = DistRenderer(fs, cfg, world)
    img = present_gather(world, dr.render(cam)["ldr"])
    if img.shape != (cfg.height, width, 3) or not bool(torch.isfinite(img).all()):
        raise RuntimeError(f"NRC frame: shape {tuple(img.shape)} or non-finite values")

    cfg_off = dataclasses.replace(cfg, enable_nrc=False)
    sharded = present_gather(world, DistRenderer(fs, cfg_off, world, bvh=dr.bvh).render(cam)["ldr"])
    single = Renderer(fs, cfg_off, bvh=dr.bvh, device=world.device).render(cam)["ldr"]
    if not torch.equal(sharded, single):
        err = float((sharded - single).abs().max())
        raise RuntimeError(f"sharded frame differs from the single-process frame: max error {err:.3g}")

    params, frozen, cam_a, state, target = step_inputs(dr, cfg, cam, world)
    train_step, opt = make_train_step(cfg, frozen, dr.tables, device=world.device, world=world)
    _, _, _, loss, img = train_step(params, opt.init(params), cam_a, state, target)
    if not np.isfinite(loss.item()) or img.shape != (cfg.height // world.size, width, 3):
        raise RuntimeError(f"train step: loss {loss.item()}, image {tuple(img.shape)}")
    return loss.item()


def start(cmds: list, env: dict | None = None) -> list:
    """Start every command at once from the repo's root; returns the
    processes (stdout and stderr joined into one pipe).  Ranks, apps and
    other workers all start here and end in `join`."""
    return [subprocess.Popen(c, cwd=Path(__file__).resolve().parents[2], env=env, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for c in cmds]


def spawn(n: int, args: list, init_method: str, device=None, env: dict | None = None,
          cmd: list | None = None) -> list:
    """Start `cmd` (this module by default) as ranks 0..n-1 of a world
    meeting at `init_method`, each with `args`; returns the processes."""
    dev = [] if device is None else ["--device", str(device)]
    cmd = cmd or [sys.executable, "-m", "nebulae_tpu_torch.dist.dryrun"]
    return start([[*cmd, "--rank", str(r), "--world-size", str(n), "--init-method", init_method, *dev, *args]
                  for r in range(n)], env)


def join(procs: list, timeout: float, check: bool = True) -> list:
    """Each process's output once all have ended, each within `timeout` s;
    one that outlives its time raises, and so (with `check`) does one
    that fails; none is left running."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if check and p.returncode:
            raise RuntimeError(f"process {r} ({' '.join(map(str, p.args[:4]))} ...) exited with "
                               f"{p.returncode}:\n{out}")
    return outs


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("nebulae_tpu_torch.dist.dryrun", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--init-method", default=None, help="init_process_group URL, e.g. file:///tmp/store")
    p.add_argument("--coordinator", default=None, help="host:port of rank 0's TCP store")
    p.add_argument("--device", default=None, help="'cpu', or the GPU by default")
    p.add_argument("--timeout", type=float, default=120.0, help="seconds before a collective fails")
    p.add_argument("--dryrun", action="store_true", help="run the dry run and print its loss")
    p.add_argument("--out", default=None, help="record frames and a step; rank 0 writes DIR/result.npz")
    p.add_argument("--width", type=int, default=32)
    p.add_argument("--height", type=int, default=32)
    p.add_argument("--frames", type=int, default=2)
    p.add_argument("--orbit", type=float, default=0.0, help="degrees between frames")
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--nrc", action="store_true")
    p.add_argument("--no-svgf", action="store_true")
    p.add_argument("--step", action="store_true", help="also the loss, its gradients and one train step")
    return p


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    world = init_distributed(args.coordinator, args.world_size, args.rank, device=args.device,
                             init_method=args.init_method, timeout_s=args.timeout)
    try:
        t0 = time.perf_counter()
        if args.dryrun:
            loss = dryrun(world)
            log_info(f"dryrun({world.size}): loss={loss:.6f} OK (DistRenderer + sharded train step, "
                     f"{time.perf_counter() - t0:.1f} s)")
        if args.out:
            cfg = RenderConfig(width=args.width, height=args.height, max_bounces=args.bounces,
                               enable_svgf=not args.no_svgf, enable_nrc=args.nrc)
            arrays, stats = record(world, cfg, args.frames, args.orbit, args.step)
            if world.rank == 0:
                out = Path(args.out)
                out.mkdir(parents=True, exist_ok=True)
                np.savez(out / "result.npz", **arrays)
                (out / "stats.json").write_text(json.dumps(stats))
    finally:
        world.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
