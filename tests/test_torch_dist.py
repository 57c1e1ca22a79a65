"""The port's distribution (nebulae_tpu_torch.dist) on the CPU, over gloo.

Each multi-rank case runs `python -m nebulae_tpu_torch.dist.dryrun` as 2
or 4 processes (one thread each) meeting at a file:// store, each under a
120 s timeout; rank 0 writes the gathered frames, the summed loss and
gradients and the collective log.  The module fixture starts every case
at once and builds the references while they run.  Tolerances:
  * sharded frames (hdr, denoised, ldr, hit) against the port's
    single-process frames: max error 0, at 32x32 and 48x48 on 2 and 4
    ranks, still, orbiting (the history reprojected) and with the radiance
    cache: every pixel keeps its RNG stream, the stencils read their halo
    from the ranks that own it, and on the CPU the cache MLP's products are
    exact float64 sums (nrc/mlp.py), so the row split changes no pixel;
  * the 2-rank train step (SVGF on) against the port's single step: loss
    within a relative 1e-5, each gradient with a cosine >= 0.9999 and a
    relative L2 <= 1e-3 (the sums over ranks and over the halo's owners
    add in another order); the stepped params equal on every rank (the
    worker holds them by digest) and within 1e-6 plus one ulp of the
    single step's wherever the two gradients share a sign (Adam's first
    step moves by lr * sign(g));
  * the radiance cache bit-equal on every rank after each of 3 frames
    (DistRenderer.render raises otherwise) and bit-equal to the single
    process's cache;
  * collectives: the 32x32 step without SVGF moves <= 128 B a pixel
    (tests/test_dist.py's bound) and sums its gradients with an
    all-reduce; the halo bytes of a still frame do not grow with the
    height; shards are balanced.
The same frames and gradients against JAX's DistRenderer and sharded
render_loss: tests/test_torch_dist_jax.py.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

TIMEOUT = 120
KEYS = ("hdr", "denoised", "ldr", "hit")
# name: (ranks, width, height, worker flags)
CASES = {
    "2r32": (2, 32, 32, ["--frames", "2", "--orbit", "4", "--step"]),
    "4r32": (4, 32, 32, ["--frames", "2", "--orbit", "4"]),
    "2r48nrc": (2, 48, 48, ["--frames", "3", "--orbit", "3", "--nrc"]),
    "4r48": (4, 48, 48, ["--frames", "2", "--orbit", "4"]),
    "2r32flat": (2, 32, 32, ["--frames", "1", "--no-svgf", "--step"]),
    "2r64": (2, 32, 64, ["--frames", "1"]),
    "2r128": (2, 32, 128, ["--frames", "1"]),
}


def start(tmp: Path, n: int, args: list) -> list:
    """n ranks of the dry-run worker on the CPU, one thread each, meeting
    at a file store in `tmp`."""
    from nebulae_tpu_torch.dist.dryrun import spawn

    tmp.mkdir(parents=True)
    return spawn(n, ["--timeout", "60", *args], (tmp / "store").as_uri(), device="cpu",
                 env={**os.environ, "OMP_NUM_THREADS": "1"})


def finish(procs) -> str:
    from nebulae_tpu_torch.dist.dryrun import join

    return "\n".join(join(procs, TIMEOUT))


def recorded(tmp: Path, n: int, w: int, h: int, flags: list) -> list:
    """start() of a recording run: rank 0 writes tmp/out."""
    return start(tmp, n, ["--out", str(tmp / "out"), "--width", str(w), "--height", str(h), *flags])


def results(tmp: Path, procs) -> tuple:
    finish(procs)
    return dict(np.load(tmp / "out" / "result.npz")), json.loads((tmp / "out" / "stats.json").read_text())


def grad_close(a, b, what):
    a, b = np.asarray(a, np.float64).reshape(-1), np.asarray(b, np.float64).reshape(-1)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0.0 or nb == 0.0:
        assert na == nb == 0.0, what
        return
    assert a @ b / (na * nb) >= 0.9999, what
    assert np.linalg.norm(a - b) / nb <= 1e-3, what


def _single(fs, cfg, frames, orbit):
    from nebulae_tpu_torch.dist.dryrun import cameras
    from nebulae_tpu_torch.engine.renderer import Renderer

    r = Renderer(fs, cfg, device="cpu")
    out = []
    for cam in cameras(fs, frames, orbit):
        o = r.render(cam)
        o = {k: (o[k].to(torch.uint8) if k == "hit" else o[k]).numpy() for k in KEYS + ("nrc_query_frac",)}
        if cfg.enable_nrc:
            o["nrc"] = np.concatenate([t.float().numpy().reshape(-1) for layer in r.state["nrc"]["params"]
                                       for t in layer.values()])
        out.append(o)
    return out


def _cfg(w, h, flags):
    from nebulae_tpu_torch.config import RenderConfig

    return RenderConfig(width=w, height=h, max_bounces=4, enable_nrc="--nrc" in flags,
                        enable_svgf="--no-svgf" not in flags)


def _flag(flags, name, default):
    return type(default)(flags[flags.index(name) + 1]) if name in flags else default


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from nebulae_tpu_torch.utils.testscenes import textured_scene

    tmp = tmp_path_factory.mktemp("dist")
    procs = {name: recorded(tmp / name, n, w, h, flags) for name, (n, w, h, flags) in CASES.items()}
    procs["dryrun"] = start(tmp / "dryrun", 2, ["--dryrun"])
    fs = textured_scene(0)
    single = {}
    for n, w, h, flags in CASES.values():
        key = (w, h, tuple(flags))
        if key not in single:
            single[key] = _single(fs, _cfg(w, h, flags), _flag(flags, "--frames", 1), _flag(flags, "--orbit", 0.0))
    res = {"fs": fs, "single": single, "dryrun": finish(procs.pop("dryrun"))}
    for name, ps in procs.items():
        res[name] = results(tmp / name, ps)
    return res


# ---------------------------------------------------------------------------
# The rank's place in the image, without a process group
# ---------------------------------------------------------------------------


def _world(rank, size):
    from nebulae_tpu_torch.dist.mesh import World

    return World(rank, size, torch.device("cpu"), "gloo")


def test_rows_shard_and_backend_rule(monkeypatch):
    from nebulae_tpu_torch.dist import mesh

    assert [_world(r, 4).rows(32) for r in range(4)] == [(0, 8), (8, 16), (16, 24), (24, 32)]
    with pytest.raises(ValueError, match="must divide"):
        _world(0, 3).rows(32)
    assert mesh.pick_backend(torch.device("cpu"), 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.pick_backend(torch.device("cuda", 0), 2) == "nccl"
    assert mesh.pick_backend(torch.device("cuda", 0), 4) == "gloo"
    assert _world(0, 2).comm_device.type == "cpu"
    with pytest.raises(ValueError, match="coordinator"):
        mesh.init_distributed(None, 2, 0, device="cpu")
    with pytest.raises(ValueError, match="not a rank"):
        mesh.init_distributed("localhost:1", 2, 2, device="cpu")


@pytest.mark.parametrize("n", [2, 4])
def test_shard_frame_state_cuts_only_image_leaves(n):
    """The history's image leaves are cut to the rank's rows; the 4x4
    view-projection (whose 4 rows divide 2 and 4 ranks), the eye, counters
    and the cache replicate."""
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.dist.mesh import IMAGE_KEYS, shard_frame_state
    from nebulae_tpu_torch.engine.renderer import init_frame_state

    cfg = RenderConfig(width=8, height=16, enable_nrc=True)
    state = init_frame_state(cfg, "cpu")
    state["svgf"]["radiance"] = torch.arange(16 * 8 * 3, dtype=torch.float32).reshape(16, 8, 3)
    for r in range(n):
        s = shard_frame_state(_world(r, n), state)
        rows = slice(r * 16 // n, (r + 1) * 16 // n)
        for k in IMAGE_KEYS:
            assert torch.equal(s["svgf"][k], state["svgf"][k][rows]), k
        assert s["svgf"]["prev_viewproj"].shape == (4, 4) and s["nrc"] is state["nrc"]
        assert s["frame"] == 0 and s["reset_history"] is True


@pytest.mark.parametrize("n,h,band", [(2, 16, 1), (2, 16, 3), (2, 16, 30), (4, 8, 30), (4, 12, 30),
                                      (3, 5, 7), (4, 270, 30)])
def test_halo_rows_come_from_their_owners(n, h, band):
    """exchange_rows' index over the all-gathered edge pieces picks, on
    every rank, exactly the image's rows within `band` of its own, none
    past the image's top and bottom, even where the band reaches past the
    next rank."""
    from nebulae_tpu_torch.dist.comm import _halo_index

    image = torch.arange(n * h)
    for r in range(n):
        k, above, below = _halo_index(_world(r, n), h, band, "cpu")
        pieces = torch.cat([torch.cat([image[q * h:q * h + k], image[(q + 1) * h - k:(q + 1) * h]])
                            for q in range(n)])
        lo, hi = max(r * h - band, 0), min((r + 1) * h + band, n * h)
        assert torch.equal(torch.cat([pieces[above], image[r * h:(r + 1) * h], pieces[below]]), image[lo:hi])


def test_dist_renderer_refuses_rows_that_do_not_divide():
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.dist.runner import DistRenderer
    from nebulae_tpu_torch.utils.testscenes import box_scene

    with pytest.raises(ValueError, match="must divide"):
        DistRenderer(box_scene(), RenderConfig(width=8, height=10), _world(0, 4))


def test_world_of_one_renders_the_single_frame():
    """init_distributed with one process (a HashStore, no address) and a
    DistRenderer over it: the frame of the plain Renderer, every
    collective issued and logged."""
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.dist.dryrun import cameras
    from nebulae_tpu_torch.dist.mesh import init_distributed
    from nebulae_tpu_torch.dist.runner import DistRenderer, gather_state, present_gather
    from nebulae_tpu_torch.dist.stats import collective_stats, shard_balance
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.utils.testscenes import textured_scene

    fs = textured_scene(0)
    cfg = RenderConfig(width=16, height=16, max_bounces=2)
    cam = cameras(fs, 1)[0]
    world = init_distributed(device="cpu")
    try:
        assert (world.rank, world.size, world.backend) == (0, 1, "gloo")
        dr = DistRenderer(fs, cfg, world)
        got = present_gather(world, dr.render(cam)["ldr"])
        full = gather_state(world, dr.state)
        bal = shard_balance(world, got)
    finally:
        world.close()
    ref = Renderer(fs, cfg, device="cpu")
    assert torch.equal(got, ref.render(cam)["ldr"])
    for k, v in ref.state["svgf"].items():
        assert torch.equal(full["svgf"][k], v), k
    stats = collective_stats(world.log)
    assert stats["all_gather"]["tags"]["band"] > 0 and stats["all_reduce"]["count"] >= 1
    assert bal == {"shards": 1, "rows": [16], "balanced": True}


# ---------------------------------------------------------------------------
# 2 and 4 ranks against one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["2r32", "4r32", "2r48nrc", "4r48", "2r32flat"])
def test_sharded_frames_equal_single_process(runs, name):
    _, w, h, flags = CASES[name]
    got, _ = runs[name]
    ref = runs["single"][(w, h, tuple(flags))]
    for i, frame in enumerate(ref):
        for k in KEYS:
            np.testing.assert_array_equal(got[f"frame{i}_{k}"], frame[k], err_msg=f"frame {i} {k}")
        assert got[f"frame{i}_nrc_query_frac"] == frame["nrc_query_frac"]


def test_nrc_cache_equal_on_every_rank_and_to_one_process(runs):
    """Every rank trains the cache on the same inputs: the worker's frames
    pass DistRenderer's digest check, and the cache after each frame is
    the single process's, bit for bit."""
    got, _ = runs["2r48nrc"]
    ref = runs["single"][(48, 48, tuple(CASES["2r48nrc"][3]))]
    for i, frame in enumerate(ref):
        np.testing.assert_array_equal(got[f"frame{i}_nrc"], frame["nrc"], err_msg=f"frame {i}")
        assert 0.0 < got[f"frame{i}_nrc_query_frac"] < 1.0


def test_sharded_train_step_matches_single_step(runs):
    """The 2-rank step with SVGF: loss, gradients and stepped params
    against the port's single step."""
    from nebulae_tpu_torch.dist.dryrun import cameras, step_inputs
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.engine.train import flatten_params, loss_and_grads, make_train_step

    fs = runs["fs"]
    got, _ = runs["2r32"]
    cfg = _cfg(32, 32, CASES["2r32"][3])
    r = Renderer(fs, cfg, device="cpu")
    params, frozen, cam, state, target = step_inputs(r, cfg, cameras(fs, 1)[0], None)
    loss, grads, _, _ = loss_and_grads(params, frozen, r.tables, cam, state, target, cfg, device="cpu")
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    for i, g in enumerate(grads):
        grad_close(got[f"grad{i}"], g.numpy(), f"grad {i}")
    step, opt = make_train_step(cfg, frozen, r.tables, device="cpu")
    stepped = flatten_params(step(params, opt.init(params), cam, state, target)[0])
    for i, (p, g) in enumerate(zip(stepped, grads)):
        same = np.sign(got[f"grad{i}"]) == np.sign(g.numpy())
        tol = 1e-6 + np.abs(np.spacing(p.numpy()))
        assert (np.abs(got[f"param{i}"] - p.numpy()) <= tol)[same].all(), f"param {i}"


def test_collectives_bounded_halo_and_balance(runs):
    """The 32x32 step without SVGF sums its gradients with an all-reduce
    and moves <= 128 B a pixel (result bytes, JAX's measure); a rank sends
    half of an all-gather's result on 2 ranks; the still frames at 32x64 and 32x128 move
    the same halo bytes (W x rows of halo, not H x W); shards balance."""
    _, stats = runs["2r32flat"]
    grads = stats["grads"]
    assert grads["all_reduce"]["count"] > 0 and grads["all_reduce"]["tags"]["grads"] > 0
    assert stats["frame0"]["total_bytes"] + grads["total_bytes"] <= 128 * 32 * 32, (stats, grads)
    b64 = runs["2r64"][1]["frame0"]["all_gather"]["tags"]["band"]
    b128 = runs["2r128"][1]["frame0"]["all_gather"]["tags"]["band"]
    assert b64 == b128 > 0
    # Per rank: 2 ranks x (first and last 30 rows) x 32 px x 5 guide and 3
    # radiance floats for the a-trous band, 3 rows for the bootstrap's 5
    # floats, 1 row for the mip's 3 words.
    assert b64 == 2 * 32 * 4 * (2 * 30 * (5 + 3) + 2 * 3 * 5 + 2 * 1 * 3)
    # "bytes" are the results on a rank; a rank sends its own part of an
    # all-gather, and all of an all-reduce.
    frame = runs["2r64"][1]["frame0"]
    assert frame["all_gather"]["sent"] * 2 == frame["all_gather"]["bytes"]
    assert grads["all_reduce"]["sent"] == grads["all_reduce"]["bytes"]
    assert frame["total_sent"] == sum(v["sent"] for k, v in frame.items() if not k.startswith("total"))
    for name in CASES:
        assert runs[name][0]["balance"].tolist() == [CASES[name][2] // CASES[name][0]] * CASES[name][0], name


def test_dryrun_runs_on_two_ranks(runs):
    """The twin of __graft_entry__.py's dryrun_multichip: an NRC-on
    DistRenderer frame and present_gather, an NRC-off frame equal to one
    process's, one full train step."""
    assert runs["dryrun"].count("dryrun(2): loss=") == 2, runs["dryrun"]
