"""Parity of the port's core modules with nebulae_tpu on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  RNG
streams must be bit-equal; shading math uses the same float32 formulas and
is held to rtol 1e-5 / atol 1e-6 (the two frameworks round transcendental
functions and fused multiply-adds differently in the last bits).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

RTOL, ATOL = 1e-5, 1e-6
REPO = Path(__file__).resolve().parent.parent


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol, atol=atol)


def test_render_config_fields_and_defaults_match():
    from nebulae_tpu.config import RenderConfig as JCfg

    from nebulae_tpu_torch.config import RenderConfig

    jf = {f.name: f.default for f in dataclasses.fields(JCfg)}
    pf = {f.name: f.default for f in dataclasses.fields(RenderConfig)}
    assert list(jf) == list(pf)
    assert jf == pf


def test_sun_default_matches():
    from nebulae_tpu.config import SunLight as JSun

    from nebulae_tpu_torch.config import SunLight

    js = JSun.default(np)
    ps = SunLight.default("cpu")
    for k in ("direction", "radiance", "tan_half_angle", "sky_color"):
        np.testing.assert_array_equal(getattr(ps, k).numpy(), np.asarray(getattr(js, k), np.float32))


def test_rng_streams_bit_equal_1080p_three_frames():
    from nebulae_tpu.core import rng as jrng

    from nebulae_tpu_torch.core import rng as prng

    w, h = 1920, 1080
    ys, xs = np.meshgrid(np.arange(h, dtype=np.uint32), np.arange(w, dtype=np.uint32), indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    for frame in range(3):
        js = jrng.init_rng(jnp.asarray(xs), jnp.asarray(ys), w, jnp.uint32(frame))
        ps = prng.init_rng(torch.from_numpy(xs.astype(np.int64)), torch.from_numpy(ys.astype(np.int64)), w, frame)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js).astype(np.int64))
        for _ in range(5):
            js, ju = jrng.next_float(js)
            ps, pu = prng.next_float(ps)
            np.testing.assert_array_equal(ps.numpy(), np.asarray(js).astype(np.int64))
            np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))


@pytest.fixture(scope="module")
def shading_inputs():
    rng = np.random.default_rng(7)
    n = 4096
    return {
        "n": _unit(rng, n), "v": _unit(rng, n), "l": _unit(rng, n),
        "albedo": rng.uniform(0, 1, (n, 3)).astype(np.float32),
        "rough": rng.uniform(0.02, 1, n).astype(np.float32),
        "metal": rng.uniform(0, 1, n).astype(np.float32),
        "u1": rng.uniform(0, 1, n).astype(np.float32),
        "u2": rng.uniform(0, 1, n).astype(np.float32),
        "env": rng.uniform(0, 2, (16, 32, 3)).astype(np.float32),
    }


def _brdf_pair(name, x):
    from nebulae_tpu.core import brdf as jb

    from nebulae_tpu_torch.core import brdf as pb

    J = {k: jnp.asarray(v) for k, v in x.items()}
    P = {k: torch.from_numpy(v) for k, v in x.items()}
    sun = np.asarray([0.35, 0.8, 0.45], np.float32)
    sun /= np.linalg.norm(sun)
    ndv = np.clip((x["n"] * x["v"]).sum(-1), 0, 1).astype(np.float32)
    cases = {
        "eval_brdf": (
            lambda: jb.eval_brdf(J["n"], J["v"], J["l"], J["albedo"], J["rough"], J["metal"], jnp),
            lambda: pb.eval_brdf(P["n"], P["v"], P["l"], P["albedo"], P["rough"], P["metal"]),
        ),
        "diffuse_probability": (
            lambda: jb.diffuse_probability(J["albedo"], J["metal"], jnp.asarray(ndv), jnp),
            lambda: pb.diffuse_probability(P["albedo"], P["metal"], torch.from_numpy(ndv)),
        ),
        "diffuse_reflectance": (
            lambda: jb.diffuse_reflectance(J["albedo"], J["metal"], jnp),
            lambda: pb.diffuse_reflectance(P["albedo"], P["metal"]),
        ),
        "cosine_hemisphere_sample": (
            lambda: jb.cosine_hemisphere_sample(J["u1"], J["u2"], J["n"], jnp),
            lambda: pb.cosine_hemisphere_sample(P["u1"], P["u2"], P["n"]),
        ),
        "sun_disk_sample": (
            lambda: jb.sun_disk_sample(J["u1"], J["u2"], jnp.asarray(sun)[None], jnp.float32(0.00465), jnp),
            lambda: pb.sun_disk_sample(P["u1"], P["u2"], torch.from_numpy(sun)[None],
                                       torch.tensor(0.00465)),
        ),
        "sample_vndf_ggx": (
            lambda: jb.sample_vndf_ggx(J["u1"], J["u2"], J["n"], J["v"], J["rough"], jnp),
            lambda: pb.sample_vndf_ggx(P["u1"], P["u2"], P["n"], P["v"], P["rough"]),
        ),
        "vndf_pdf": (
            lambda: jb.vndf_pdf(J["n"], J["v"], J["l"], J["rough"], jnp),
            lambda: pb.vndf_pdf(P["n"], P["v"], P["l"], P["rough"]),
        ),
        "offset_ray_origin": (
            lambda: jb.offset_ray_origin(J["v"], J["n"]),
            lambda: pb.offset_ray_origin(P["v"], P["n"]),
        ),
        "sky_envmap": (
            lambda: jb.sky_envmap(J["l"], J["env"], jnp),
            lambda: pb.sky_envmap(P["l"], P["env"]),
        ),
    }
    return cases[name]


@pytest.mark.parametrize("name", [
    "eval_brdf", "diffuse_probability", "diffuse_reflectance", "cosine_hemisphere_sample",
    "sun_disk_sample", "sample_vndf_ggx", "vndf_pdf", "offset_ray_origin", "sky_envmap",
])
def test_brdf_matches(shading_inputs, name):
    jf, pf = _brdf_pair(name, shading_inputs)
    _close(pf().numpy(), jf())


def test_srgb_conversions_match(shading_inputs):
    from nebulae_tpu.core import texture as jt

    from nebulae_tpu_torch.core import texture as pt

    c = shading_inputs["albedo"]
    _close(pt.srgb_to_linear(torch.from_numpy(c)).numpy(), jt.srgb_to_linear(jnp.asarray(c)))
    _close(pt.linear_to_srgb(torch.from_numpy(c)).numpy(), jt.linear_to_srgb(jnp.asarray(c)))


@pytest.fixture(scope="module")
def scene_pair():
    from nebulae_tpu.core.scene import FlatScene as JFlatScene

    from nebulae_tpu_torch.utils.testscenes import textured_scene

    fs = textured_scene(seed=0)
    ja = JFlatScene(**fs.field_arrays()).device_arrays()
    pa = fs.device_arrays()
    return fs, ja, pa


def test_device_arrays_bit_equal(scene_pair):
    _, ja, pa = scene_pair
    assert list(ja) == list(pa)
    for k in ja:
        assert np.asarray(ja[k]).dtype == pa[k].dtype, k
        np.testing.assert_array_equal(pa[k], np.asarray(ja[k]), err_msg=k)


def test_bench_scene_size_and_mips_match():
    """The bench scene has ~139k triangles and its 512x512 atlas mips match
    the JAX package's (cv2-based) extend_atlas_mips bit for bit."""
    from nebulae_tpu.core.scene import extend_atlas_mips as jmips

    from nebulae_tpu_torch.core.scene import extend_atlas_mips as pmips
    from nebulae_tpu_torch.utils.testscenes import bench_scene

    fs = bench_scene(seed=0)
    assert 135_000 <= fs.num_triangles <= 142_000
    assert fs.textures.shape[0] > 0 and fs.mat_tex.shape[-1] == 12
    for a, b in zip(pmips(fs.mat_tex, fs.mat_tex_hw), jmips(fs.mat_tex, fs.mat_tex_hw)):
        np.testing.assert_array_equal(a, b)


def _scene_dicts(ja, pa):
    return ({k: jnp.asarray(v) for k, v in ja.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in pa.items()})


def test_sample_bilinear_quad_matches(scene_pair):
    from nebulae_tpu.core.texture import sample_bilinear_quad as jq

    from nebulae_tpu_torch.core.texture import sample_bilinear_quad as pq

    _, ja, pa = scene_pair
    js, ps = _scene_dicts(ja, pa)
    rng = np.random.default_rng(3)
    n = 5000
    uv = rng.uniform(-2, 3, (n, 2)).astype(np.float32)
    tid = rng.integers(0, pa["mat_tex_row_off"].shape[0], n).astype(np.int32)
    ref = jq(js["mat_tex_quad"], js["mat_tex_mip_hw"], jnp.asarray(tid), jnp.asarray(uv), jnp,
             row_off=js["mat_tex_row_off"])
    out = pq(ps["mat_tex_quad"], ps["mat_tex_mip_hw"], torch.from_numpy(tid), torch.from_numpy(uv),
             ps["mat_tex_row_off"])
    _close(out.numpy(), ref)


def test_reconstruct_surface_matches(scene_pair):
    from nebulae_tpu.core.surface import reconstruct_surface as jr

    from nebulae_tpu_torch.core.surface import reconstruct_surface as pr

    fs, ja, pa = scene_pair
    js, ps = _scene_dicts(ja, pa)
    rng = np.random.default_rng(4)
    n = 5000
    tri = rng.integers(0, fs.num_triangles, n).astype(np.int32)
    u = rng.uniform(0, 1, n).astype(np.float32)
    v = (rng.uniform(0, 1, n) * (1 - u)).astype(np.float32)
    view = _unit(rng, n)
    mip = rng.integers(0, 4, n).astype(np.int32)
    ref = jr(js, jnp.asarray(tri), jnp.asarray(u), jnp.asarray(v), view_dir=jnp.asarray(view),
             xp=jnp, mip_level=jnp.asarray(mip))
    out = pr(ps, torch.from_numpy(tri), torch.from_numpy(u), torch.from_numpy(v),
             view_dir=torch.from_numpy(view), mip_level=torch.from_numpy(mip.astype(np.int64)))
    assert set(ref) == set(out)
    for k in ref:
        _close(out[k].numpy(), ref[k], rtol=1e-5, atol=1e-5)


def test_mip_level_from_uv_matches(scene_pair):
    from nebulae_tpu.core.surface import mip_level_from_uv as jm

    from nebulae_tpu_torch.core.surface import mip_level_from_uv as pm

    fs, ja, pa = scene_pair
    js, ps = _scene_dicts(ja, pa)
    h, w = 24, 32
    rng = np.random.default_rng(5)
    # Patches of one triangle each (so same-triangle taps exist), some misses.
    tri = np.repeat(np.repeat(rng.integers(-1, fs.num_triangles, (6, 8)), 4, 0), 4, 1)
    tri = tri.reshape(-1).astype(np.int32)
    u = rng.uniform(0, 0.5, h * w).astype(np.float32)
    v = rng.uniform(0, 0.5, h * w).astype(np.float32)
    ref = jm(js, jnp.asarray(tri), jnp.asarray(u), jnp.asarray(v), h, w, xp=jnp)
    out = pm(ps, torch.from_numpy(tri), torch.from_numpy(u), torch.from_numpy(v), h, w)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_port_imports_neither_jax_nor_the_jax_package():
    """Importing every module of the port (in a fresh interpreter) leaves
    jax, nebulae_tpu, cv2 and PIL out of sys.modules, the radiance cache's,
    the glTF loader's, the app shell's, the distribution's and the
    reference tracer's modules included; chip_smoke.py imports none of
    them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import nebulae_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'nebulae_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import runpy; runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "bad = [m for m in sys.modules if m in ('jax', 'cv2', 'PIL') or m.startswith(('jax.', 'jaxlib', 'flax', "
        "'nebulae_tpu.', 'cv2.', 'PIL.')) or m == 'nebulae_tpu']\n"
        "print(len([m for m in sys.modules if m.startswith('nebulae_tpu_torch')]))\n"
        "assert not bad, bad\n"
        "nrc = ['nebulae_tpu_torch.nrc.' + m for m in ('encoding', 'mlp', 'cache')]\n"
        "nrc += ['nebulae_tpu_torch.passes.nrc_pathtrace', 'nebulae_tpu_torch.utils.nrc_quality']\n"
        "nrc += ['nebulae_tpu_torch.' + m for m in ('app', 'core.gltf', 'utils.png', 'utils.checkpoint', "
        "'utils.crashdump', 'utils.display', 'utils.golden', 'utils.logging', 'utils.metrics', 'utils.profiling')]\n"
        "nrc += ['nebulae_tpu_torch.dist.' + m for m in ('mesh', 'comm', 'stats', 'runner', 'dryrun')]\n"
        "nrc += ['nebulae_tpu_torch.ref', 'nebulae_tpu_torch.ref.tracer']\n"
        "assert all(m in sys.modules for m in nrc), nrc\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 20
