"""One run of one cell: set-up, the measured (or traced) window, the check.

Everything a cell needs is found by name: the workload in BENCHMARK.json
names its configuration (`configs/<name>.json` through the entry's
`file`) and its traffic mix (`traffic/<name>.json`); its limits are in
`limits/<workload>.json`; each metric is read by `metrics/<metric>.py`.
The traffic's `kind` picks the driver and the check (`frames`, `steps`);
a `frames` traffic may carry a `motion` block, which moves the scene's
instances every frame (`Motion`).

The program under test is nebulae_tpu_torch: it gets the scene's arrays as
a FlatScene, the render configuration and the sun, and is driven through
`Renderer.render` or the step of `engine.train.make_train_step`.  Nothing
here imports JAX or the JAX package.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import scenes
from benchmark.chrometrace import Trace, export_events

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def find_cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def cell_files(bench: dict, cell: dict) -> tuple[dict, dict, dict]:
    """(configuration, traffic, limits) of a cell, read from their files."""
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return (load_json(ROOT / conf["file"]), load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
            load_json(HERE / "limits" / f"{cell['name']}.json"))


def metric_reader(name: str):
    """The `read(run)` function of metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[str]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on): those that list the cell, or that list no cells."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m["name"] for m in group if workload in m.get("workloads", [workload])]


class Stages:
    """Named seconds of the set-up, in order."""

    def __init__(self):
        self.seconds: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, device=None):
        t0 = time.perf_counter()
        yield
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize()
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0


def sun_of(spec: dict) -> dict:
    """The configuration's sun, its direction normalised in float32."""
    d = np.asarray(spec["direction"], np.float32)
    d = d / np.sqrt((d * d).sum(dtype=np.float32))
    return {"direction": d.astype(np.float32), "radiance": np.asarray(spec["radiance"], np.float32),
            "tan_half_angle": np.float32(spec["tan_half_angle"]), "sky_color": np.asarray(spec["sky_color"], np.float32)}


class CameraPath:
    """A camera about the vertical axis through the scene's centre.  With
    R half the larger horizontal extent of the scene's box and a the
    azimuth, the eye is at (cx + r R cos a, y, cz + r R sin a), y = lo_y +
    (its "ext_y") * ext_y + (its "radius") * R; the target likewise.  The
    azimuth starts at azimuth0_deg (plus a uniform draw from the seed when
    azimuth_from_seed) and turns azimuth_step_rad a frame."""

    def __init__(self, spec: dict, aabb_min, aabb_max, seed: int):
        lo, hi = np.asarray(aabb_min, np.float64), np.asarray(aabb_max, np.float64)
        self.spec = spec
        self.c = (lo + hi) * 0.5
        self.lo_y = lo[1]
        self.ext_y = hi[1] - lo[1]
        self.R = 0.5 * max(hi[0] - lo[0], hi[2] - lo[2])
        a0 = np.deg2rad(float(spec.get("azimuth0_deg", 0.0)))
        if spec.get("azimuth_from_seed", False):
            a0 += float(np.random.default_rng([seed, 2]).uniform(0.0, 2.0 * np.pi))
        self.a0 = a0
        self.fov = float(spec.get("fov_y_deg", 60.0))

    def _point(self, radius: float, height: dict, a: float):
        y = self.lo_y + float(height.get("ext_y", 0.0)) * self.ext_y + float(height.get("radius", 0.0)) * self.R
        return np.array([self.c[0] + radius * self.R * np.cos(a), y, self.c[2] + radius * self.R * np.sin(a)],
                        np.float32)

    def at(self, k: int):
        """(eye, target) of frame k."""
        a = self.a0 + float(self.spec.get("azimuth_step_rad", 0.0)) * k
        s = self.spec
        return (self._point(float(s["eye_radius"]), s["eye_height"], a),
                self._point(float(s["target_radius"]), s["target_height"], a))


class Motion:
    """Rigid motion of the scene's instances, from a `frames` traffic's
    "motion" block.  Instance i moves when i % every == first and it is not
    one of the last `still_last` instances (those of the flat triangles
    appended after a field's tori); every other instance keeps the identity.  At frame k a
    moving instance turns by spin_rad_per_frame * k about spin_axis through
    its pivot, the mean of its vertices in the scene the seed built, and
    slides by slide_amplitude * (1 - cos(2 pi k / slide_period_frames)) / 2
    along slide_axis toward the centre of the scene's build-time box.  At
    frame 0 every transform is the identity.  The transforms depend on the
    frame index alone.  The check adds `tiles` tiles about the moving
    instances' triangles as frame 0 shows them."""

    def __init__(self, spec: dict, sc: dict):
        inst = np.asarray(sc["instance_of_tri"], np.int64)
        n = int(inst.max()) + 1
        ids = np.arange(n)
        self.n = n
        self.moving = ids[(ids % int(spec["every"]) == int(spec["first"])) & (ids < n - int(spec["still_last"]))]
        corners = np.asarray(sc["tri_pos"], np.float64).sum(axis=1)
        count = 3.0 * np.bincount(inst, minlength=n)
        pivot = np.stack([np.bincount(inst, corners[:, c], minlength=n) for c in range(3)], -1) / count[:, None]
        self.pivot = pivot[self.moving]
        self.centroids = np.asarray(sc["tri_pos"], np.float64)[np.isin(inst, self.moving)].mean(axis=1)
        centre = (np.asarray(sc["aabb_min"], np.float64) + np.asarray(sc["aabb_max"], np.float64)) * 0.5
        axis = np.asarray(spec["slide_axis"], np.float64)
        axis = axis / np.linalg.norm(axis)
        self.toward = -np.sign((self.pivot - centre) @ axis)[:, None] * axis
        spin = np.asarray(spec["spin_axis"], np.float64)
        self.spin_axis = spin / np.linalg.norm(spin)
        self.spec = spec

    def at(self, k: int) -> np.ndarray:
        """Frame k's transforms [I, 3, 4] float32: rows are world rows, the
        last column the translation."""
        s = self.spec
        a = float(s["spin_rad_per_frame"]) * k
        x, y, z = self.spin_axis
        cross = np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
        rot = np.eye(3) + np.sin(a) * cross + (1.0 - np.cos(a)) * (cross @ cross)
        slide = float(s["slide_amplitude"]) * (1.0 - np.cos(2.0 * np.pi * k / float(s["slide_period_frames"]))) * 0.5
        out = np.zeros((self.n, 3, 4))
        out[:, :, :3] = np.eye(3)
        out[self.moving, :, :3] = rot
        out[self.moving, :, 3] = self.pivot - self.pivot @ rot.T + slide * self.toward
        return out.astype(np.float32)

    def tiles(self, rng: np.random.Generator, path: CameraPath, width: int, height: int, tile: int, margin: int):
        """The check's tiles on the moving instances: about triangles drawn
        by `rng` among theirs that frame 0's camera puts on the image."""
        from benchmark.reference.frame import point_tiles, view_proj

        vp, _eye = view_proj(*path.at(0), path.fov, width, height)
        return point_tiles(rng, self.centroids, vp, width, height, tile, margin, int(self.spec["tiles"]))


class Program:
    """The system under test, built from the benchmark's arrays."""

    def __init__(self, sc: dict, render: dict, sun: dict, device, stages: Stages):
        from nebulae_tpu_torch.bvh.cbuilder import build_bvh_for
        from nebulae_tpu_torch.config import RenderConfig, SunLight
        from nebulae_tpu_torch.core.scene import FlatScene
        from nebulae_tpu_torch.engine.renderer import Renderer

        self.cfg = RenderConfig(**render)
        fs = FlatScene(**sc)
        with stages.stage("bvh_s", device):
            bvh = build_bvh_for(device, fs.tri_pos, max_leaf=self.cfg.bvh_max_leaf)
        with stages.stage("tables_and_uploads_s", device):
            self.sun = SunLight(*(torch.as_tensor(sun[k]).to(device)
                                  for k in ("direction", "radiance", "tan_half_angle", "sky_color")))
            self.renderer = Renderer(fs, self.cfg, sun=self.sun, bvh=bvh, device=device)
        if device.type == "cuda":
            from nebulae_tpu_torch.kernels.build import native

            with stages.stage("kernels_s", device):
                native()


class Probes:
    """Counts taken at the program's layer boundaries in a traced run: each
    call of the tracer's callables (kind, rays) and of the a-trous step
    (height, width), each inside a host range of its own
    ("benchmark/trace", "benchmark/atrous") so that the trace attributes
    their device time."""

    def __init__(self):
        self.trace_calls: list[tuple[str, int]] = []
        self.atrous_calls: list[tuple[int, int]] = []
        self.on = False
        self._undo = []

    def install(self):
        from torch.profiler import record_function

        import nebulae_tpu_torch.engine.renderer as renderer_mod
        import nebulae_tpu_torch.passes.svgf as svgf_mod

        probes = self
        make_tracer = renderer_mod.make_tracer
        atrous_step = svgf_mod.atrous_step

        def counted(kind, fn):
            def call(o, *args, **kw):
                if probes.on:
                    probes.trace_calls.append((kind, int(o.shape[0])))
                with record_function("benchmark/trace"):
                    return fn(o, *args, **kw)
            return call

        def make_tracer_counted(*args, **kw):
            closest, any_hit = make_tracer(*args, **kw)
            c = counted("closest", closest)
            c.combo = counted("combo", closest.combo)
            return c, counted("any", any_hit)

        def atrous_counted(radiance, *args, **kw):
            if probes.on:
                probes.atrous_calls.append((int(radiance.shape[0]), int(radiance.shape[1])))
            with record_function("benchmark/atrous"):
                return atrous_step(radiance, *args, **kw)

        renderer_mod.make_tracer = make_tracer_counted
        svgf_mod.atrous_step = atrous_counted
        self._undo = [(renderer_mod, "make_tracer", make_tracer), (svgf_mod, "atrous_step", atrous_step)]

    def remove(self):
        for mod, name, fn in self._undo:
            setattr(mod, name, fn)
        self._undo = []


class Frames:
    """The `frames` traffic: Renderer.render back to back, each frame
    presented (its ldr copied to the host) before the next is issued.  With
    a `motion` block, each frame first moves the instances to its pose
    (Renderer.update_instances), inside the frame's time."""

    def __init__(self, prog: Program, traffic: dict, sc: dict, seed: int, device):
        from nebulae_tpu_torch.core.camera import Camera

        self.Camera = Camera
        self.prog = prog
        self.path = CameraPath(traffic["camera"], sc["aabb_min"], sc["aabb_max"], seed)
        self.motion = Motion(traffic["motion"], sc) if "motion" in traffic else None
        cfg = prog.cfg
        self.host = torch.empty((cfg.height, cfg.width, 3), dtype=torch.float32,
                                pin_memory=device.type == "cuda")
        self.count = 0

    def one(self) -> float:
        """Render and present frame `count`; its seconds."""
        eye, target = self.path.at(self.count)
        pose = None if self.motion is None else self.motion.at(self.count)
        t0 = time.perf_counter()
        if pose is not None:
            self.prog.renderer.update_instances(pose)
        out = self.prog.renderer.render(self.Camera(eye=eye, target=target, fov_y_deg=self.path.fov))
        self.host.copy_(out["ldr"])
        self.last_loss = out["nrc_loss"]
        dt = time.perf_counter() - t0
        self.count += 1
        return dt


class Keep:
    """What the check needs of the frames it compares: frames 0 to
    chain - 1 (from the fresh start) and the window's frame `drawn`.  Of
    each: its camera, its presented image and next history radiance on the
    tiles, the cache's weights after it and its training loss; of the
    drawn frame also the program's SVGF history before it."""

    def __init__(self, frames: Frames, tiles, chain: int, drawn: int):
        self.frames = frames
        self.tiles = tiles
        self.chain = chain
        self.drawn = drawn
        self.kept: dict[int, dict] = {}

    def frame(self) -> float:
        """One frame, kept when the check compares it."""
        f = self.frames
        k = f.count
        before = f.prog.renderer.state if k == self.drawn else None
        dt = f.one()
        if k < self.chain or k == self.drawn:
            state = f.prog.renderer.state
            eye, target = f.path.at(k)
            self.kept[k] = {"eye": eye, "target": target,
                            "ldr": [f.host[t[0]:t[1], t[2]:t[3]].clone() for t, _r in self.tiles],
                            "hist": [_crop(state["svgf"]["radiance"], t).clone() for t, _r in self.tiles],
                            "cache": _cache_copy(state), "loss": f.last_loss,
                            "before": None if before is None or k < self.chain else _history_copy(before)}
        return dt


def _crop(img, r):
    return img[r[0]:r[1], r[2]:r[3]]


def _paste(part: dict, region, height: int, width: int) -> dict:
    """A whole-image history holding `part` on `region` and zeros elsewhere."""
    out = {}
    for k, v in part.items():
        full = torch.zeros((height, width) + tuple(v.shape[2:]), dtype=v.dtype, device=v.device)
        full[region[0]:region[1], region[2]:region[3]] = v
        out[k] = full
    return out


def _hull(a, b):
    return (min(a[0], b[0]), max(a[1], b[1]), min(a[2], b[2]), max(a[3], b[3]))


def _grow(r, n: int, height: int, width: int):
    return (max(r[0] - n, 0), min(r[1] + n, height), max(r[2] - n, 0), min(r[3] + n, width))


def chain_regions(scene, path: CameraPath, cfg: dict, tiles, chain: int) -> list:
    """The region each tile is rendered on at each frame of the chain
    ([frame][tile]): its own region at every frame, and at an earlier frame
    also the pixels that the later frame's reprojection reads (grown by
    one, so that their uv derivatives, and so their history, are exact).
    `scene(k)` is the reference's scene at frame k."""
    from benchmark.reference import frame as ref

    width, height = int(cfg["width"]), int(cfg["height"])
    out = [[None] * len(tiles) for _ in range(chain)]
    need = [region for _tile, region in tiles]
    for k in range(chain - 1, -1, -1):
        for i in range(len(tiles)):
            out[k][i] = need[i]
        if k == 0:
            break
        moved = _moved(path, k, cfg)
        if moved is None:
            need = [region for _tile, region in tiles]
            continue
        cam = ref.camera_basis(*path.at(k), path.fov, width, height)
        for i, (_tile, region) in enumerate(tiles):
            taps = ref.reprojected_taps(scene(k), cam, width, height, need[i], moved[0])
            need[i] = region if taps is None else _hull(region, _grow(taps, 1, height, width))
    return out


def _moved(path: CameraPath, k: int, cfg: dict):
    """The previous camera's (view-projection, eye) when the camera moved
    before frame k and the history is reprojected, else None."""
    from benchmark.reference import frame as ref

    if k == 0 or not cfg.get("svgf_reproject", True):
        return None
    pe, pt = path.at(k - 1)
    e, t = path.at(k)
    if np.array_equal(pe, e) and np.array_equal(pt, t):
        return None
    return ref.view_proj(pe, pt, path.fov, int(cfg["width"]), int(cfg["height"]))


class Poses:
    """The reference's scene at each frame: the scene itself where nothing
    moves, else the scene moved to frame k's pose (one pose held at a
    time), with the ray-triangle tests of all their tracers counted."""

    def __init__(self, S, motion: Motion | None):
        self.S, self.motion = S, motion
        self.k, self.at_k, self.done = None, None, 0

    def __call__(self, k: int):
        if self.motion is None:
            return self.S
        if k != self.k:
            self.done += 0 if self.at_k is None else self.at_k.tracer.pair_tests
            self.k, self.at_k = k, self.S.moved(self.motion.at(k))
        return self.at_k

    @property
    def pair_tests(self) -> int:
        return self.S.tracer.pair_tests + self.done + (0 if self.at_k is None else self.at_k.tracer.pair_tests)


def reference_tiles(keep: Keep, sc: dict, sun: dict, conf: dict, device, dtype=torch.float32) -> dict:
    """The reference on every kept frame, computed in `dtype`, from its own
    state: its ldr and next history radiance on the tiles ({(frame, tile):
    {"ldr", "radiance"}}), and where the configuration runs the cache, the
    cache after each kept frame ({frame: cache}), its training loss, and
    the cache it starts from.  The cache trains on every frame from a fresh
    one.  The chain's frames carry the reference's own SVGF history from a
    fresh start; the window's drawn frame takes the program's history before
    it as its input.  Where the traffic moves the instances, every frame is
    traced against the reference's own scene moved to that frame's pose."""
    from benchmark.reference import frame as ref
    from benchmark.reference import nrc

    cfg = conf["render"]
    width, height = int(cfg["width"]), int(cfg["height"])
    scene = Poses(ref.RefScene(sc, sun, device, dtype), keep.frames.motion)
    path = keep.frames.path
    seconds = {}

    def cam(k):
        return ref.camera_basis(*path.at(k), path.fov, width, height)

    t0 = time.perf_counter()
    caches, losses, init = {}, {}, None
    if cfg.get("enable_nrc", False):
        cache = nrc.init_cache(device)
        init = cache
        for k in range(max(keep.kept) + 1):
            cache, loss = nrc.train_pass(scene(k), cam(k), cfg, k, cache)
            if k in keep.kept:
                caches[k], losses[k] = cache, loss
    seconds["cache_s"] = time.perf_counter() - t0

    def tracer(k):
        if not caches:
            return ref.path_trace
        params = caches[k]["ema_params"]
        return lambda S_, gb, cfg_, rng: nrc.query_pass(S_, gb, cfg_, rng, params)

    def render(k, i, region, hist):
        tile = keep.tiles[i][0]
        o = ref.render_region(scene(k), cam(k), cfg, k, region, hist, _moved(path, k, cfg), tracer(k))
        inner = (tile[0] - region[0], tile[1] - region[0], tile[2] - region[2], tile[3] - region[2])
        tiles[(k, i)] = {"ldr": _crop(o["ldr"], inner).float(), "radiance": _crop(o["radiance"], inner).float()}
        return o["history"]

    t0 = time.perf_counter()
    tiles = {}
    regions = chain_regions(scene, path, cfg, keep.tiles, keep.chain)
    hists = [None] * len(keep.tiles)
    for k in range(keep.chain):
        for i in range(len(keep.tiles)):
            hists[i] = _paste(render(k, i, regions[k][i], hists[i]), regions[k][i], height, width)
    hists = None
    if keep.drawn >= keep.chain:
        before = keep.kept[keep.drawn]["before"]
        for i, (_tile, region) in enumerate(keep.tiles):
            render(keep.drawn, i, region, before)
    seconds["frames_s"] = time.perf_counter() - t0
    return {"tiles": tiles, "caches": caches, "losses": losses, "init": init, "pair_tests": scene.pair_tests,
            "seconds": seconds}


def program_tiles(keep: Keep, device) -> dict:
    """The program's presented ldr and next history radiance on the same
    tiles."""
    return {(k, i): {"ldr": kf["ldr"][i].to(device), "radiance": kf["hist"][i].to(device)}
            for k, kf in keep.kept.items() for i in range(len(keep.tiles))}


def cache_gap(init: dict, cand: dict, ref: dict, key: str) -> float:
    """How far the cache's `key` leaves ("params" or "ema_params") lie from
    the reference's, against how far training has moved the reference's
    from where both started: ||cand - ref|| / ||ref - init|| over all
    leaves."""
    num = den = 0.0
    for li, lc, lr in zip(init[key], cand[key], ref[key]):
        for n in ("w", "b"):
            num += float(((lc[n].float() - lr[n].float()) ** 2).sum())
            den += float(((lr[n].float() - li[n].float()) ** 2).sum())
    return (num / max(den, 1e-30)) ** 0.5


def compare(cand: dict, ref: dict) -> dict:
    """The numbers compared: the mean absolute ldr error over all tiles'
    values, and the history radiance's summed absolute error relative to
    its summed magnitude; per frame the mean ldr error; diagnostics."""
    errs, num, den, per_frame = [], 0.0, 0.0, {}
    for key, r in ref.items():
        d = (cand[key]["ldr"] - r["ldr"]).abs().reshape(-1)
        errs.append(d)
        num += float((cand[key]["radiance"] - r["radiance"]).abs().sum())
        den += float(r["radiance"].abs().sum())
        per_frame[key[0]] = max(per_frame.get(key[0], 0.0), float(d.mean()))
    e = torch.cat(errs)
    return {"ldr_err_mean": float(e.mean()), "hist_err_rel": num / max(den, 1e-12),
            "ldr_err_max": float(e.max()), "ldr_share_over_1_255": float((e > 1.0 / 255.0).float().mean()),
            "per_frame": per_frame}


def compare_caches(keep: Keep, ref: dict, cand: dict | None = None) -> dict:
    """The cache's numbers, where the configuration runs one: over the kept
    frames, the worst gap of the EMA weights (which render) from the
    reference's, the same of the trained weights, and the training loss's
    relative gap.  `cand` replaces the program's caches and losses (the
    control's)."""
    if not ref["caches"]:
        return {}
    ema = params = loss = 0.0
    for k, rc in ref["caches"].items():
        got = keep.kept[k]["cache"] if cand is None else cand["caches"][k]
        got_loss = keep.kept[k]["loss"] if cand is None else float(cand["losses"][k])
        ema = max(ema, cache_gap(ref["init"], got, rc, "ema_params"))
        params = max(params, cache_gap(ref["init"], got, rc, "params"))
        r_loss = float(ref["losses"][k])
        loss = max(loss, abs(got_loss - r_loss) / max(abs(r_loss), 1e-12))
    return {"cache_err": ema, "cache_params_err": params, "nrc_loss_err": loss}


def check_frames(keep: Keep, sc: dict, sun: dict, conf: dict, limits: dict, device) -> dict:
    """The reference on every kept frame's tiles, against the program."""
    t0 = time.perf_counter()
    ref = reference_tiles(keep, sc, sun, conf, device)
    c = compare(program_tiles(keep, device), ref["tiles"])
    c.update(compare_caches(keep, ref))
    readings = {k: c[k] for k in ("ldr_err_mean", "hist_err_rel", "cache_err") if k in c}
    diag = {"ldr_err_max": c["ldr_err_max"], "ldr_share_over_1_255": c["ldr_share_over_1_255"],
            **{k: c[k] for k in ("cache_params_err", "nrc_loss_err") if k in c},
            "frames_checked": sorted(keep.kept), "chain": keep.chain, "tiles": len(keep.tiles),
            "reference_s": time.perf_counter() - t0, **{"reference_" + k: v for k, v in ref["seconds"].items()},
            "pair_tests": ref["pair_tests"]}
    failed = sum(1 for w in c["per_frame"].values() if w > limits.get("ldr_err_mean", float("inf")))
    return {"readings": readings, "diagnostics": diag, "failed_frames": failed}


def _cache_copy(state: dict) -> dict | None:
    """A copy of a frame state's radiance cache weights in the reference's
    layout (None without one)."""
    if "nrc" not in state:
        return None
    c = state["nrc"]

    def layers(ps):
        return [{k: t.detach().clone() for k, t in layer.items()} for layer in ps]

    return {"params": layers(c["params"]), "ema_params": layers(c["ema_params"])}


def _history_copy(state: dict) -> dict:
    """A copy of a frame state's SVGF history."""
    h = state["svgf"]
    return {k: h[k].clone() for k in ("radiance", "depth", "normal", "moments", "histlen")}


def _window(one, seconds: float | None, n: int | None, activities=None):
    """Items back to back: for `seconds` (n None) or n of them, under the
    profiler with `activities` when given -> (times, window seconds,
    events or None)."""
    prof = None
    if activities is not None:
        from torch.profiler import profile

        prof = profile(activities=activities)
        prof.__enter__()
    times = []
    t0 = time.perf_counter()
    while True:
        times.append(one())
        if n is not None and len(times) >= n:
            break
        if n is None and time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    events = None
    if prof is not None:
        prof.__exit__(None, None, None)
        events = export_events(prof)
    return times, window_s, events


def measure(one, traffic: dict, unit: str, seconds: float, trace: bool, probes: Probes) -> dict:
    """The measured window (trace off), or the traced run (trace on):
    `idle_<unit>` items untraced, timed; as many under a trace of the
    device's activity alone, which gives each item's device busy time, its
    operations and syncs (the profiler slows the host's issue, not the
    device's operations, so busy per item over the untraced item's wall
    time is the device's busy share); then `trace_<unit>` items under a
    trace of the host's operators and ranges too, which attributes device
    time to the ranges that launched it."""
    if not trace:
        load = os.getloadavg()[0]
        times, window_s, _ = _window(one, seconds, None)
        return {"seconds": window_s, "count": len(times), "times": times, "trace": None, "device_trace": None,
                "host_load": [load, os.getloadavg()[0]]}
    from torch.profiler import ProfilerActivity

    n = int(traffic["idle_" + unit])
    _times, untraced_s, _ = _window(one, None, n)
    times_a, window_a, events_a = _window(one, None, n, [ProfilerActivity.CUDA])
    probes.on = True
    times_b, window_b, events_b = _window(one, None, int(traffic["trace_" + unit]),
                                          [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    probes.on = False
    return {"seconds": window_b, "count": len(times_b), "times": times_b, "trace": Trace(events_b),
            "device_trace": Trace(events_a), "device_seconds": window_a, "device_count": len(times_a),
            "untraced_item_s": untraced_s / n, "attempted": 2 * n + len(times_b)}


def run_frames(prog: Program, traffic: dict, sc: dict, conf: dict, limits: dict, seed: int, seconds: float,
               trace: bool, device, stages: Stages, t_start: float) -> dict:
    """Warm-up, then the window: back-to-back frames for `seconds` (trace
    off), or the traced windows (trace on).  Kept for the check: the chain
    of frames from the fresh start (warm-up frames first) and a frame of
    the window drawn from the seed (each rendered after the window,
    untimed, where the window closed before it).  A moving traffic's check
    adds tiles on the moving instances."""
    from benchmark.reference.frame import halo, tile_regions

    cfg = prog.cfg
    check = traffic["check"]
    rng = np.random.default_rng([seed, 1])
    svgf = {"svgf_atrous_passes": cfg.svgf_atrous_passes}
    tiles = tile_regions(rng, cfg.width, cfg.height, int(check["tile"]), halo(svgf))
    warmup = int(traffic["warmup_frames"])
    offset = int(rng.integers(0, int(check["window_frame_within"])))
    if trace:
        offset %= 2 * int(traffic["idle_frames"]) + int(traffic["trace_frames"])
    frames = Frames(prog, traffic, sc, seed, device)
    if frames.motion is not None:
        tiles += frames.motion.tiles(np.random.default_rng([seed, 4]), frames.path, cfg.width, cfg.height,
                                     int(check["tile"]), halo(svgf))
    keep = Keep(frames, tiles, int(check["chain_frames"]), warmup + offset)
    probes = Probes()
    if trace:
        probes.install()
    try:
        with stages.stage("warmup_s", device):
            warm = [keep.frame() for _ in range(warmup)]
        setup_s = time.perf_counter() - t_start
        run = measure(keep.frame, traffic, "frames", seconds, trace, probes)
    finally:
        probes.remove()
    while frames.count <= max(keep.drawn, keep.chain - 1):
        keep.frame()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    # The program's state is freed before the reference runs.
    for kf in keep.kept.values():
        kf["loss"] = float(kf["loss"])
    prog.renderer = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    run.update({"kind": "frames", "setup_s": setup_s, "width": cfg.width, "height": cfg.height,
                "n_tris": int(sc["tri_pos"].shape[0]), "trace_calls": probes.trace_calls,
                "atrous_calls": probes.atrous_calls, "warmup_times": warm})
    return {"run": run, "keep": keep, "memory_peak_bytes": int(peak)}


def make_target(spec: dict, seed: int, height: int, width: int, device):
    """The image a training job fits: a sum of `waves` plane waves a
    channel about a grey level, their frequencies and phases drawn from the
    seed, [H, W, 3] float32 on the device."""
    rng = np.random.default_rng([seed, 3])
    ys = torch.arange(height, device=device, dtype=torch.float32)[:, None] / height
    xs = torch.arange(width, device=device, dtype=torch.float32)[None, :] / width
    chans = []
    for _c in range(3):
        img = torch.full((height, width), float(spec["level"]), device=device)
        for _w in range(int(spec["waves"])):
            fx, fy = rng.uniform(0.5, float(spec["max_cycles"]), 2)
            ph = float(rng.uniform(0.0, 2.0 * np.pi))
            img = img + float(spec["amplitude"]) * torch.sin(2.0 * np.pi * (fx * xs + fy * ys) + ph)
        chans.append(img)
    return torch.clamp(torch.stack(chans, -1), 0.0, 1.0)


class Steps:
    """The `steps` traffic: the program's train step back to back, each
    one's loss read on the host before the next is issued; params and Adam's
    state updated every step, the frame state threaded."""

    def __init__(self, prog: Program, traffic: dict, sc: dict, seed: int, device):
        from nebulae_tpu_torch.core.camera import Camera
        from nebulae_tpu_torch.engine.renderer import init_frame_state
        from nebulae_tpu_torch.engine.train import Adam, make_train_step, split_scene_params
        from nebulae_tpu_torch.passes.gbuffer import make_camera_arrays

        cfg = prog.cfg
        r = prog.renderer
        self.path = CameraPath(traffic["camera"], sc["aabb_min"], sc["aabb_max"], seed)
        self.eye, self.target_pt = self.path.at(0)
        params, frozen = split_scene_params(r.scene)
        params["sun"] = r.sun
        self.step_fn, opt = make_train_step(cfg, frozen, r.tables, optimizer=Adam(float(traffic["learning_rate"])),
                                            device=device)
        self.params = params
        self.opt_state = opt.init(params)
        self.state = init_frame_state(cfg, device)
        self.cam = make_camera_arrays(Camera(eye=self.eye, target=self.target_pt, fov_y_deg=self.path.fov),
                                      cfg.width, cfg.height, device)
        self.target = make_target(traffic["target"], seed, cfg.height, cfg.width, device)
        self.count = 0

    def one(self) -> float:
        t0 = time.perf_counter()
        self.params, self.opt_state, self.state, loss, _img = self.step_fn(self.params, self.opt_state, self.cam,
                                                                           self.state, self.target)
        self.loss = float(loss)
        self.count += 1
        return time.perf_counter() - t0


def _leaves(params: dict) -> list:
    from nebulae_tpu_torch.engine.train import flatten_params

    return [t.detach().float().clone() for t in flatten_params(params)]


def run_steps(prog: Program, traffic: dict, sc: dict, conf: dict, limits: dict, seed: int, seconds: float,
              trace: bool, device, stages: Stages, t_start: float) -> dict:
    """Set-up drives the step through its first warmup_steps steps (the
    ones the reference follows), then the window: steps back to back for
    `seconds` (trace off), or the traced windows (trace on)."""
    if "motion" in traffic:
        raise ValueError("a steps traffic has no motion block: the train step runs on a still scene")
    steps = Steps(prog, traffic, sc, seed, device)
    probes = Probes()
    if trace:
        probes.install()
    kept = {"start": _leaves(steps.params), "losses": []}
    n_ref = int(traffic["reference_steps"])
    try:
        with stages.stage("warmup_s", device):
            warm = []
            for k in range(int(traffic["warmup_steps"])):
                warm.append(steps.one())
                kept["losses"].append(steps.loss)
                if k == 0:
                    kept["mu1"] = _leaves(steps.opt_state["mu"])
                if k + 1 == n_ref:
                    kept["after"] = _leaves(steps.params)
        setup_s = time.perf_counter() - t_start
        run = measure(steps.one, traffic, "steps", seconds, trace, probes)
    finally:
        probes.remove()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    cam_pts = (steps.eye, steps.target_pt, steps.path.fov)
    target = steps.target
    steps.params = steps.opt_state = steps.state = steps.step_fn = None
    prog.renderer = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cfg = prog.cfg
    run.update({"kind": "steps", "setup_s": setup_s, "width": cfg.width, "height": cfg.height,
                "n_tris": int(sc["tri_pos"].shape[0]), "trace_calls": probes.trace_calls,
                "atrous_calls": probes.atrous_calls, "warmup_times": warm})
    return {"run": run, "keep": {"kind": "steps", "kept": kept, "camera": cam_pts, "target": target,
                                 "steps": n_ref, "lr": float(traffic["learning_rate"])},
            "memory_peak_bytes": int(peak)}


def follow_steps(keep: dict, sc: dict, sun: dict, conf: dict, device, dtype=torch.float32, rows=None) -> dict:
    """The reference's first steps, in `dtype` (`rows`: train.follow's)."""
    from benchmark.reference import frame as ref
    from benchmark.reference import train

    cfg = conf["render"]
    S = ref.RefScene(sc, sun, device, dtype)
    eye, target_pt, fov = keep["camera"]
    cam = ref.camera_basis(eye, target_pt, fov, cfg["width"], cfg["height"])
    out = train.follow(S, cam, cfg, keep["target"], keep["steps"], keep["lr"], rows)
    out["pair_tests"] = S.tracer.pair_tests
    return out


def leaf_gap(prog: list, ref: list) -> tuple[float, list]:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's;
    leaves whose reference gradient is under a thousandth of the median
    leaf's are left out by the caller.  -> (worst, each leaf's)."""
    rn = [float(torch.linalg.vector_norm(r.float())) for r in ref]
    med = float(np.median(rn))
    gaps = [abs(float(torch.linalg.vector_norm(p.float())) - r) / max(r, med, 1e-30) for p, r in zip(prog, rn)]
    return max(gaps), gaps


def compare_steps(keep: dict, ref: dict, cand: dict | None = None) -> dict:
    """The numbers of a training cell: the worst step's loss gap, the
    first gradient's worst-leaf gap (the program's from Adam's first moment
    after one step: mu / (1 - beta1)), and the worst leaf's gap in the
    change of the parameters over the steps the reference follows.  Leaves
    whose reference gradient is under a thousandth of the median leaf's
    are left out of both (they move by round-off alone).  `cand` replaces
    the program's readings (the control's)."""
    k = keep["kept"]
    n = len(ref["losses"])
    if cand is None:
        losses = k["losses"][:n]
        g1 = [m / 0.1 for m in k["mu1"]]
        delta = [a - b for a, b in zip(k["after"], k["start"])]
    else:
        losses, g1, delta = cand["losses"], cand["grad1"], cand["delta"]
    gn = [float(torch.linalg.vector_norm(g)) for g in ref["grad1"]]
    med = float(np.median(gn))
    live = [i for i, x in enumerate(gn) if x >= 1e-3 * med]
    loss_err = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses, ref["losses"]))
    g_err, g_each = leaf_gap([g1[i] for i in live], [ref["grad1"][i] for i in live])
    d_err, d_each = leaf_gap([delta[i] for i in live], [ref["delta"][i] for i in live])
    return {"loss_err": loss_err, "grad1_err": g_err, "delta_err": d_err, "leaves_left_out": len(gn) - len(live),
            "grad1_each": g_each, "delta_each": d_each}


def check_steps(keep: dict, sc: dict, sun: dict, conf: dict, limits: dict, device) -> dict:
    t0 = time.perf_counter()
    ref = follow_steps(keep, sc, sun, conf, device)
    c = compare_steps(keep, ref)
    readings = {k: c[k] for k in ("loss_err", "grad1_err", "delta_err")}
    diag = {"grad1_each": c["grad1_each"], "delta_each": c["delta_each"], "leaves_left_out": c["leaves_left_out"],
            "losses": keep["kept"]["losses"], "reference_losses": ref["losses"],
            "reference_s": time.perf_counter() - t0, "pair_tests": ref["pair_tests"]}
    failed = sum(1 for a, b in zip(keep["kept"]["losses"], ref["losses"])
                 if abs(a - b) / max(abs(b), 1e-30) > limits.get("loss_err", float("inf")))
    return {"readings": readings, "diagnostics": diag, "failed_frames": failed}


DRIVERS = {"frames": run_frames, "steps": run_steps}
CHECKS = {"frames": lambda out, sc, sun, conf, limits, device: check_frames(out["keep"], sc, sun, conf, limits, device),
          "steps": lambda out, sc, sun, conf, limits, device: check_steps(out["keep"], sc, sun, conf, limits, device)}



def nvidia_smi(fields: str) -> str | None:
    """The card's `fields` as nvidia-smi reads them."""
    import shutil
    import subprocess

    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30, check=False)
    return out.stdout.strip() or None


def prepare(bench: dict, workload: str, seed: int, device, overrides: dict | None = None) -> dict:
    """A cell's files, its scene made from the seed, and the program built
    on it, with the set-up's stages timed."""
    cell = find_cell(bench, workload)
    conf, traffic, limits = cell_files(bench, cell)
    for group, values in (overrides or {}).items():
        if group == "traffic":
            traffic = {**traffic, **values}
        else:
            conf[group] = {**conf[group], **values}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stages = Stages()
    with stages.stage("cuda_init_s", device):
        torch.zeros(1, device=device)
    with stages.stage("scene_s"):
        sc = scenes.build_scene(conf["scene"], seed)
    sun = sun_of(conf["sun"])
    prog = Program(sc, conf["render"], sun, device, stages)
    return {"conf": conf, "traffic": traffic, "limits": limits, "sc": sc, "sun": sun, "prog": prog,
            "stages": stages}


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, overrides: dict | None = None, log=print) -> dict:
    """One run of `workload`: the result line's fields, and the check's
    readings.  `overrides` replaces groups of the configuration, or keys
    of the traffic under "traffic" (a test's small scene on the CPU); the
    benchmark's own runs pass none."""
    device = torch.device(device)
    p = prepare(bench, workload, seed, device, overrides)
    conf, traffic, limits, sc, sun, stages = (p[k] for k in ("conf", "traffic", "limits", "sc", "sun", "stages"))
    out = DRIVERS[traffic["kind"]](p["prog"], traffic, sc, conf, limits, seed, seconds, trace, device, stages,
                                   t_start)
    run = out["run"]
    t = sorted(run["times"])
    window = {"seconds": run["seconds"], "count": run["count"],
              "item_ms": [t[0] * 1e3, t[len(t) // 2] * 1e3, t[-1] * 1e3] if t else None}
    if trace:
        window["device_trace"] = {"seconds": run["device_seconds"], "count": run["device_count"],
                                  "untraced_item_ms": run["untraced_item_s"] * 1e3}
    log(json.dumps({"setup": {"setup_s": run["setup_s"], **stages.seconds, "warmup_items_s": run["warmup_times"]},
                    "card": nvidia_smi("name,power.limit"),
                    "after_window": {"card": nvidia_smi("clocks.sm,clocks.max.sm,temperature.gpu,power.draw"),
                                     "host_load_1min": run.get("host_load")}, "window": window}))
    metrics = {}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    for name in cell_metrics(bench, workload, trace):
        value = metric_reader(name)(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    missing = sorted(set(cell_metrics(bench, workload, trace)) - set(metrics))
    if trace and missing:
        # Every per-layer metric listed for the cell reads something here:
        # a probe that counted nothing or a range that never ran is an error.
        raise RuntimeError(f"{workload}: nothing to read for {', '.join(missing)}")
    traced = {}
    if trace:
        traced = {"busy_s": run["device_trace"].busy_s(), "window_s": run["device_seconds"],
                  "breakdown": {"device_ops": run["device_trace"].top_device_ops(10),
                                "idle_gaps": run["trace"].idle_gaps(10)}}
    # The traces' events are many small objects: freed before the check.
    run["trace"] = run["device_trace"] = None
    gc.collect()
    checked = CHECKS[traffic["kind"]](out, sc, sun, conf, limits, device)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in checked["readings"].items() if k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and len(checks) == len(limits)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": bool(correct), "attempted": run.get("attempted", run["count"]),
              "failed": checked["failed_frames"], "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"], dev["window_s"] = traced["busy_s"], traced["window_s"]
        result["breakdown"] = traced["breakdown"]
    result["checks"] = checks
    return {"result": result, "checks": checks, "diagnostics": checked["diagnostics"],
            "readings": checked["readings"]}
