"""Tests of the benchmark itself.  Run from the repository's root:

    python -m pytest benchmark/tests -q

Tests marked `card` need CUDA and skip without it; they decide inside a
fixture, at run time."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# A small scene and image for runs of each cell's harness on the CPU: the
# configuration's scene kind at 2 tori of 2,400 triangles and 64x64 maps;
# the still cell's compared window frame drawn from its first 12 frames.
SMALL = {
    "pt4-still": {"scene": {"kind": "torus_field", "nx": 2, "nz": 1, "nu": 40, "nv": 30, "n_materials": 2,
                            "map_size": 64}, "render": {"width": 64, "height": 48},
                  "traffic": {"check": {"tile": 32, "chain_frames": 8, "window_frame_within": 12}}},
    "nrc8-orbit": {"scene": {"kind": "torus_atrium", "nx": 2, "nz": 1, "nu": 40, "nv": 30, "n_materials": 2,
                             "map_size": 64}, "render": {"width": 64, "height": 48}},
    "pt4-train": {"scene": {"kind": "torus_field", "nx": 2, "nz": 1, "nu": 40, "nv": 30, "n_materials": 2,
                            "map_size": 64}, "render": {"width": 64, "height": 48}},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
