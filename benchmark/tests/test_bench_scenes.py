"""The frozen scene copy: each configuration's triangle count and texture
bytes, and the seed's hold on the scene."""

import json

import numpy as np
import pytest

from benchmark import scenes
from benchmark.tests.conftest import ROOT


def config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name,tris", [("sponza247k-pt4", 246_528), ("sponza247k-nrc8", 246_536)])
def test_config_scene_sizes(name, tris):
    path = ROOT / "benchmark" / "configs" / f"{name}.json"
    if not path.exists():
        pytest.skip(f"{name} is not a configuration of the benchmark")
    conf = config(name)
    sc = scenes.build_scene(conf["scene"], 2**31 + 7)
    b = scenes.scene_bytes(sc)
    assert b["triangles"] == tris == conf["triangles"]
    m, s = conf["materials"], conf["map_size"]
    # One 12-channel slot a material at the map size, and the ground's
    # (and walls') neutral slots padded to it; three RGBA maps a material.
    extra = 1 if conf["scene"]["kind"] == "torus_field" else 5
    assert b["atlas_bytes"] == (m + extra) * s * s * 12
    assert b["map_bytes"] == 3 * m * s * s * 4
    assert sc["mat_base_color"].shape[0] == m + extra


def test_same_seed_same_scene_other_seed_other_scene():
    spec = {"kind": "torus_field", "nx": 2, "nz": 1, "nu": 12, "nv": 8, "n_materials": 2, "map_size": 16}
    a, b, c = (scenes.build_scene(spec, s) for s in (3, 3, 4))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["tri_pos"], c["tri_pos"])
