"""The port's BVH builder against nebulae_tpu's native builder, on the CPU.

The port compiles its copy of the C++ SAH builder (csrc/bvh_builder.cpp)
with the host compiler and the JAX package's flags (native/Makefile), so
that the CPU and the GPU path build the tree JAX's native library builds on
the same host:

  (a) build_bvh_for("cpu", ...) equals nebulae_tpu.bvh.cbuilder.build_bvh_fast
      in all seven FlatBVH arrays, bit for bit, with JAX's native library
      loaded (never its numpy fallback);
  (b) a CPU Renderer's tables equal JAX's Renderer tables through
      interop.tables_from_arrays, for bvh_wide 4 and 2;
  (c) no fallback: a failed compiler run raises, and an unknown device is
      refused; the empty scene takes the numpy builder's one-leaf tree.
"""

import time

import numpy as np
import pytest

FIELDS = ("node_lo", "node_hi", "node_first", "node_count", "node_skip", "node_right", "tri_index")
KW = dict(width=32, height=32, max_bounces=2, enable_svgf=False, enable_tonemap=False,
          tracer="pallas", bruteforce_max_tris=0)


def _jax_native():
    """JAX's cbuilder with its native library loaded, never its numpy
    fallback.  In a fresh checkout every test process runs `make -C native`
    at first use; a process that loads the library while another one links
    it gets None, so the load is retried before the assertion."""
    from nebulae_tpu.bvh import cbuilder as jc

    for _ in range(40):
        if jc._load_lib() is not None:
            return jc
        jc._lib_tried = False
        time.sleep(0.5)
    raise AssertionError("JAX's native builder did not load (make -C native)")


def _assert_same_tree(a, b):
    for k in FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.shape == y.shape, k
        np.testing.assert_array_equal(x.view(np.int32), y.view(np.int32), err_msg=k)


@pytest.fixture(scope="module", params=["textured_scene", "bench_scene"])
def scene(request):
    from nebulae_tpu_torch.utils import testscenes

    return getattr(testscenes, request.param)(seed=0)


@pytest.mark.parametrize("max_leaf", [15, 4])
def test_cpu_tree_is_jax_native_tree(scene, max_leaf):
    from nebulae_tpu_torch.bvh.cbuilder import build_bvh_for

    jc = _jax_native()
    _assert_same_tree(build_bvh_for("cpu", scene.tri_pos, max_leaf), jc.build_bvh_fast(scene.tri_pos, max_leaf))


def test_cuda_device_takes_the_same_builder(scene):
    """The GPU path's tree is the CPU path's: one host library for both."""
    import torch

    from nebulae_tpu_torch.bvh.cbuilder import build_bvh_for

    _assert_same_tree(build_bvh_for(torch.device("cuda"), scene.tri_pos, 15),
                      build_bvh_for(torch.device("cpu"), scene.tri_pos, 15))


@pytest.mark.parametrize("wide", [4, 2])
def test_renderer_tables_equal_jax(wide):
    from nebulae_tpu.config import RenderConfig as JCfg
    from nebulae_tpu.core.scene import FlatScene as JFlatScene
    from nebulae_tpu.engine.renderer import Renderer as JRenderer

    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.interop import tables_from_arrays
    from nebulae_tpu_torch.utils.testscenes import textured_scene

    _jax_native()
    fs = textured_scene(seed=0)
    kw = dict(KW, bvh_wide=wide)
    jr = JRenderer(JFlatScene(**fs.field_arrays()), JCfg(**kw))
    r = Renderer(fs, RenderConfig(**kw), device="cpu")
    want = tables_from_arrays({k: np.asarray(v) for k, v in jr.bvh.items()})
    nodes = "fatnodes" if wide == 2 else "fat4nodes"
    assert nodes in r.tables and nodes in want
    for k in (nodes, "tris"):
        np.testing.assert_array_equal(r.tables[k].numpy().view(np.int32), want[k].view(np.int32), err_msg=k)
    for k in {"fat4_slots", "inner_idx"} & set(r.tables):
        np.testing.assert_array_equal(r.tables[k], want[k], err_msg=k)
    assert r.tables["stack_depth"] == want["stack_depth"]


def test_failed_compiler_raises(tmp_path, monkeypatch):
    """A compiler that fails raises; nothing falls back to the numpy builder."""
    from nebulae_tpu_torch.bvh.cbuilder import build_bvh_for
    from nebulae_tpu_torch.kernels import build
    from nebulae_tpu_torch.utils.testscenes import box_scene

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_host", None)
    monkeypatch.setattr(build, "HOST_FLAGS", [*build.HOST_FLAGS, "-include", "nebulae_no_such_header.h"])
    with pytest.raises(RuntimeError, match="failed for bvh_builder.cpp"):
        build_bvh_for("cpu", box_scene().tri_pos)
    monkeypatch.setattr(build, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        build.host_native()


def test_unknown_device_refused():
    from nebulae_tpu_torch.bvh.cbuilder import build_bvh_for
    from nebulae_tpu_torch.utils.testscenes import box_scene

    with pytest.raises(ValueError, match="unsupported device"):
        build_bvh_for("meta", box_scene().tri_pos)


def test_empty_scene_tree_equals_jax():
    from nebulae_tpu_torch.bvh.cbuilder import build_bvh_for

    jc = _jax_native()
    empty = np.zeros((0, 3, 3), np.float32)
    _assert_same_tree(build_bvh_for("cpu", empty, 15), jc.build_bvh_fast(empty, 15))
