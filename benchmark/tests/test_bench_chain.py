"""The reference's own SVGF history along the chain: rendered only on each
tile's region (grown at earlier orbit frames to what the reprojection
reads), the tiles come out as they do when every frame is rendered whole."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness, scenes
from benchmark.reference.frame import halo, tile_regions
from benchmark.tests.conftest import ROOT, SMALL


@pytest.mark.parametrize("traffic,moving", [("orbit", False), ("still", False), ("orbit", True)])
def test_chain_on_regions_equals_whole_frames(traffic, moving):
    conf = json.loads((ROOT / "benchmark" / "configs" / "sponza247k-pt4.json").read_text())
    conf["scene"] = SMALL["nrc8-orbit" if traffic == "orbit" else "pt4-still"]["scene"]
    # Large enough that a tile's region (the stencils' 34 pixels about it)
    # leaves most of the image out.
    conf["render"] = {**conf["render"], "width": 192, "height": 144}
    cfg = conf["render"]
    spec = json.loads((ROOT / "benchmark" / "traffic" / f"{traffic}.json").read_text())["camera"]
    # At this size the cell's 0.02 rad a frame moves the image by about two
    # pixels; a larger step moves it by about the stencils' reach, as the
    # cell's step does at 1080p.
    spec["azimuth_step_rad"] *= 12
    seed = 2**31 + 41
    sc = scenes.build_scene(conf["scene"], seed)
    path = harness.CameraPath(spec, sc["aabb_min"], sc["aabb_max"], seed)
    # Moving, each frame reprojects against the instances where that frame
    # put them: every torus turns and slides.
    motion = None
    if moving:
        spec_m = json.loads((ROOT / "benchmark" / "traffic" / "still-dynamic.json").read_text())["motion"]
        motion = harness.Motion({**spec_m, "every": 1, "still_last": 5}, sc)
    # The lower quadrants' and the central tile: the upper ones see sky.
    tiles = tile_regions(np.random.default_rng(seed), cfg["width"], cfg["height"], 8, halo(cfg))[2:]
    whole = [(t, (0, cfg["height"], 0, cfg["width"])) for t, _r in tiles]

    def run(tl):
        keep = SimpleNamespace(frames=SimpleNamespace(path=path, motion=motion), tiles=tl, chain=3, drawn=2,
                               kept={k: {} for k in range(3)})
        return harness.reference_tiles(keep, sc, harness.sun_of(conf["sun"]), conf, "cpu")["tiles"]

    got, want = run(tiles), run(whole)
    assert got.keys() == want.keys()
    for key in want:
        for part in ("ldr", "radiance"):
            torch.testing.assert_close(got[key][part], want[key][part], rtol=1e-5, atol=1e-6)
