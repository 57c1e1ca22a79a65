"""Parity of the port's BVH builder, fat4 tables and plain K1-K3 traversals.

Oracles: nebulae_tpu's numpy builder and pack_bvh_fat4, its Pallas fat4
kernels run in interpret mode, and the numpy brute-force tracer
(ref/tracer.py).  Hit masks and occlusion must be equal; t/u/v agree within
rtol 1e-5 / atol 1e-6; triangle ids must be equal wherever the t values
differ (an exact t tie may pick another triangle, since the port orders
children by each ray's own direction signs, the TPU by the packet's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

RTOL, ATOL = 1e-5, 1e-6


def _soup(n_tris=1500, seed=11):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.0, 1.0, size=(n_tris, 1, 3))
    off = rng.normal(scale=0.05, size=(n_tris, 2, 3))
    return np.concatenate([base, base + off], axis=1).astype(np.float32)


def _rays(n, seed=5):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.2, 1.2, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def soup():
    from nebulae_tpu.bvh.builder import build_bvh as jbuild
    from nebulae_tpu.kernels.pallas_trace import pack_bvh_fat4 as jpack

    from nebulae_tpu_torch.bvh.builder import build_bvh
    from nebulae_tpu_torch.kernels.trace import pack_bvh_fat4, tables_to

    tri = _soup()
    jbvh = jbuild(tri, max_leaf=15)
    jp = jpack(jbvh, tri, tri_group=8)
    packed = pack_bvh_fat4(build_bvh(tri, max_leaf=15), tri, tri_group=8)
    return {
        "tri": tri,
        "jax": {k: jnp.asarray(jp[k]) for k in ("fat4nodes", "tris")},
        "jax_np": jp,
        "packed": packed,
        "tables": tables_to(packed, "cpu"),
    }


def _assert_hits(out, ref, where=None):
    out = {k: np.asarray(v) for k, v in out.items()}
    ref = {k: np.asarray(v) for k, v in ref.items()}
    sel = np.ones(out["tri"].shape, bool) if where is None else where
    hit = ref["tri"] >= 0
    np.testing.assert_array_equal(out["tri"][sel] >= 0, hit[sel])
    m = sel & hit
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(out[k][m], ref[k][m], rtol=RTOL, atol=ATOL, err_msg=k)
    differ_t = m & (out["t"] != ref["t"])
    np.testing.assert_array_equal(out["tri"][differ_t], ref["tri"][differ_t])
    assert np.isinf(out["t"][sel & ~hit]).all()


@pytest.mark.parametrize("max_leaf", [4, 15])
@pytest.mark.parametrize("scene", ["soup", "textured"])
def test_numpy_builder_bit_equal(scene, max_leaf):
    from nebulae_tpu.bvh.builder import build_bvh as jbuild

    from nebulae_tpu_torch.bvh.builder import build_bvh
    from nebulae_tpu_torch.utils.testscenes import textured_scene

    tri = _soup() if scene == "soup" else textured_scene(seed=0).tri_pos
    a, b = build_bvh(tri, max_leaf), jbuild(tri, max_leaf)
    for k in ("node_lo", "node_hi", "node_first", "node_count", "node_skip", "node_right", "tri_index"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
        assert getattr(a, k).dtype == getattr(b, k).dtype


@pytest.mark.parametrize("tri_group", [1, 8])
def test_packed_tables_equal_jax_fat4(tri_group):
    """Every position of the port's row-major tables, transposed back to
    the TPU's [blocks, rows, 128 lanes] layout, equals pack_bvh_fat4."""
    from nebulae_tpu.bvh.builder import build_bvh as jbuild
    from nebulae_tpu.kernels.pallas_trace import pack_bvh_fat4 as jpack

    from nebulae_tpu_torch.kernels.trace import pack_bvh_fat4

    tri = _soup()
    bvh = jbuild(tri, max_leaf=15)
    jp = jpack(bvh, tri, tri_group=tri_group)
    pp = pack_bvh_fat4(bvh, tri, tri_group=tri_group)

    jn = jp["fat4nodes"].transpose(0, 2, 1).reshape(-1, 32)
    pn = pp["fat4nodes"]
    ni = pn.shape[0]
    np.testing.assert_array_equal(pn[:, :24], jn[:ni, :24])
    np.testing.assert_array_equal(pn[:, 24:29].view(np.int32).astype(np.float32), jn[:ni, 24:29])
    assert not pn[:, 29:].any() and not jn[ni:].any()

    jt = jp["tris"].transpose(0, 2, 1).reshape(-1, tri_group, 10)
    pt = pp["tris"]
    ns = pt.shape[0]
    np.testing.assert_array_equal(pt[..., :9], jt[:ns, :, :9])
    np.testing.assert_array_equal(pt[..., 9].view(np.int32).astype(np.float32), jt[:ns, :, 9])
    assert not jt[ns:].any()
    assert pp["stack_depth"] <= 128


def test_plain_closest_matches_pallas_and_oracle(soup):
    from nebulae_tpu.kernels.pallas_trace import pallas_closest_hit_fat4
    from nebulae_tpu.ref.tracer import intersect_closest_np

    from nebulae_tpu_torch.kernels.trace import closest_hit_fat4

    o, d = _rays(1024)
    out = closest_hit_fat4(_t(o), _t(d), soup["tables"])
    ref = pallas_closest_hit_fat4(jnp.asarray(o), jnp.asarray(d), soup["jax"], interpret=True)
    _assert_hits(out, ref)
    _assert_hits(out, intersect_closest_np(o, d, soup["tri"]))
    assert (np.asarray(ref["tri"]) >= 0).mean() > 0.2


def test_plain_combo_matches_pallas_and_oracle(soup):
    from nebulae_tpu.kernels.pallas_trace import pallas_shadow_closest_fat4
    from nebulae_tpu.ref.tracer import intersect_any_np, intersect_closest_np

    from nebulae_tpu_torch.kernels.trace import shadow_closest_fat4

    o, b = _rays(1024)
    _, l = _rays(1024, seed=9)
    rng = np.random.default_rng(2)
    t_b = np.where(rng.uniform(size=1024) < 0.8, np.inf, 0.0).astype(np.float32)
    t_l = np.where(rng.uniform(size=1024) < 0.8, np.inf, 0.0).astype(np.float32)
    hit, occ = shadow_closest_fat4(_t(o), _t(b), _t(l), soup["tables"], _t(t_b), _t(t_l))
    jhit, jocc = pallas_shadow_closest_fat4(
        jnp.asarray(o), jnp.asarray(b), jnp.asarray(l), soup["jax"],
        t_max_b=jnp.asarray(t_b), t_max_l=jnp.asarray(t_l), interpret=True,
    )
    _assert_hits(hit, jhit)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    ref = intersect_closest_np(o, b, soup["tri"], t_max=t_b[:, None])
    _assert_hits(hit, ref)
    np.testing.assert_array_equal(occ.numpy(), intersect_any_np(o, l, soup["tri"], t_max=t_l))
    assert 0.05 < occ.numpy().mean() < 0.95


def test_plain_any_matches_pallas_and_oracle(soup):
    from nebulae_tpu.kernels.pallas_trace import pallas_any_hit_fat4
    from nebulae_tpu.ref.tracer import intersect_any_np

    from nebulae_tpu_torch.kernels.trace import any_hit_fat4

    o, d = _rays(1024, seed=6)
    t_max = np.random.default_rng(3).uniform(0.0, 0.6, 1024).astype(np.float32)
    occ = any_hit_fat4(_t(o), _t(d), soup["tables"], _t(t_max)).numpy()
    ref = np.asarray(pallas_any_hit_fat4(jnp.asarray(o), jnp.asarray(d), soup["jax"],
                                         t_max=jnp.asarray(t_max), interpret=True))
    np.testing.assert_array_equal(occ, ref)
    np.testing.assert_array_equal(occ, intersect_any_np(o, d, soup["tri"], t_max=t_max))
    assert 0.05 < occ.mean() < 0.95


@pytest.mark.parametrize("t_max", [0.05, 0.2, 1.0, np.inf])
def test_any_hit_t_max_clamps(soup, t_max):
    from nebulae_tpu.ref.tracer import intersect_any_np

    from nebulae_tpu_torch.kernels.trace import any_hit_fat4

    o, d = _rays(2000, seed=8)
    occ = any_hit_fat4(_t(o), _t(d), soup["tables"], t_max).numpy()
    np.testing.assert_array_equal(occ, intersect_any_np(o, d, soup["tri"], t_max=t_max))


def test_axis_aligned_rays(soup):
    """Zero direction components (and -0.0) hit the 1e12 slab path."""
    from nebulae_tpu.ref.tracer import intersect_any_np, intersect_closest_np

    from nebulae_tpu_torch.kernels.trace import any_hit_fat4, closest_hit_fat4

    rng = np.random.default_rng(12)
    n = 600
    o = rng.uniform(-0.2, 1.2, (n, 3)).astype(np.float32)
    d = np.zeros((n, 3), np.float32)
    axis = rng.integers(0, 3, n)
    d[np.arange(n), axis] = rng.choice([-1.0, 1.0], n)
    d[::7] = np.where(d[::7] == 0, np.float32(-0.0), d[::7])
    _assert_hits(closest_hit_fat4(_t(o), _t(d), soup["tables"]), intersect_closest_np(o, d, soup["tri"]))
    np.testing.assert_array_equal(
        any_hit_fat4(_t(o), _t(d), soup["tables"]).numpy(), intersect_any_np(o, d, soup["tri"])
    )


def test_zero_area_triangle_is_never_hit():
    from nebulae_tpu.ref.tracer import intersect_closest_np

    from nebulae_tpu_torch.bvh.builder import build_bvh
    from nebulae_tpu_torch.kernels.trace import closest_hit_fat4, pack_bvh_fat4, tables_to

    tri = _soup(200)
    tri[17] = [[0.5, 0.5, 0.5], [0.6, 0.6, 0.6], [0.7, 0.7, 0.7]]  # collinear
    tri[18] = [[0.3, 0.3, 0.3]] * 3  # a point
    tables = tables_to(pack_bvh_fat4(build_bvh(tri, 15), tri, 8), "cpu")
    o = np.tile(np.float32([[0.55, 0.55, -1.0]]), (64, 1))
    d = np.tile(np.float32([[0.0, 0.0, 1.0]]), (64, 1))
    o[:, 0] += np.linspace(-0.01, 0.01, 64, dtype=np.float32)
    out = closest_hit_fat4(_t(o), _t(d), tables)
    assert not np.isin(out["tri"].numpy(), [17, 18]).any()
    _assert_hits(out, intersect_closest_np(o, d, tri))


def test_empty_scene_and_empty_batches_miss():
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.kernels.trace import (
        any_hit_fat4, closest_hit_fat4, empty_tables, shadow_closest_fat4, tables_to,
    )
    from nebulae_tpu_torch.tracer.trace import make_tracer

    o, d = (_t(x) for x in _rays(100))
    tables = tables_to(empty_tables(), "cpu")
    hit = closest_hit_fat4(o, d, tables)
    assert (hit["tri"] == -1).all() and torch.isinf(hit["t"]).all()
    assert not any_hit_fat4(o, d, tables).any()
    assert not shadow_closest_fat4(o, d, d, tables)[1].any()
    scene = {"tri_pos": torch.zeros((0, 3, 3))}
    for tracer in ("auto", "pallas"):
        closest, any_hit = make_tracer(scene, tables, RenderConfig(tracer=tracer), device="cpu")
        assert (closest(o, d)["tri"] == -1).all() and not any_hit(o, d).any()
    soup_tables = tables_to(empty_tables(), "cpu")
    out = closest_hit_fat4(o[:0], d[:0], soup_tables)
    assert out["t"].shape == (0,)


def test_dead_lanes_return_miss_records(soup):
    from nebulae_tpu_torch.kernels.trace import any_hit_fat4, closest_hit_fat4, shadow_closest_fat4
    from nebulae_tpu_torch.tracer.sorting import DEAD_ORIGIN

    o, d = _rays(300)
    o[::2] = DEAD_ORIGIN
    d[1::4] = 0.0
    d[3::8] = 1e-8
    dead = np.zeros(300, bool)
    dead[::2] = True
    dead[1::4] = True
    dead[3::8] = True
    hit = closest_hit_fat4(_t(o), _t(d), soup["tables"])
    assert (hit["tri"].numpy()[dead] == -1).all() and np.isinf(hit["t"].numpy()[dead]).all()
    assert not any_hit_fat4(_t(o), _t(d), soup["tables"]).numpy()[dead].any()
    h2, occ = shadow_closest_fat4(_t(o), _t(d), _t(d), soup["tables"])
    assert (h2["tri"].numpy()[dead] == -1).all() and not occ.numpy()[dead].any()
    assert (hit["tri"].numpy()[~dead] >= 0).any()


def test_sorted_shadow_closest_order_does_not_change_results(soup):
    """Compaction and key order only move work: results land back in pixel
    order, with miss records on lanes that take no part."""
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.tracer.sorting import ray_sort_key, sorted_any, sorted_shadow_closest
    from nebulae_tpu_torch.tracer.trace import make_tracer

    scene = {"tri_pos": _t(soup["tri"])}
    closest, any_hit = make_tracer(scene, soup["tables"], RenderConfig(tracer="pallas"), device="cpu")
    o, b = (_t(x) for x in _rays(1024))
    l = _t(_rays(1024, seed=9)[1])
    rng = np.random.default_rng(4)
    shoot = _t(rng.uniform(size=1024) < 0.6)
    alive = _t(rng.uniform(size=1024) < 0.6)
    key = ray_sort_key(o, b, torch.zeros(3), torch.ones(3))
    occ_k, hit_k, walked_k = sorted_shadow_closest(closest.combo, o, l, b, shoot, alive, key=key)
    occ_n, hit_n, walked_n = sorted_shadow_closest(closest.combo, o, l, b, shoot, alive)
    ref_hit = closest(o, b)
    ref_occ = any_hit(o, l)
    for occ, hit in ((occ_k, hit_k), (occ_n, hit_n)):
        np.testing.assert_array_equal(occ.numpy(), (ref_occ & shoot).numpy())
        for k in ("t", "tri", "u", "v"):
            np.testing.assert_array_equal(hit[k][alive].numpy(), ref_hit[k][alive].numpy())
        assert (hit["tri"][~alive] == -1).all() and torch.isinf(hit["t"][~alive]).all()
    # Both walks trace every lane that shoots or bounces, the keyed one in key order.
    np.testing.assert_array_equal(walked_n.numpy(), torch.nonzero(shoot | alive)[:, 0].numpy())
    np.testing.assert_array_equal(torch.sort(walked_k).values.numpy(), walked_n.numpy())
    np.testing.assert_array_equal(sorted_any(any_hit, o, l, shoot, key).numpy(), (ref_occ & shoot).numpy())


def test_make_tracer_dispatch_and_device_rules(soup):
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.tracer.trace import bruteforce_any_hit, bruteforce_closest_hit, make_tracer

    scene = {"tri_pos": _t(soup["tri"])}
    o, d = (_t(x) for x in _rays(256))
    brute = bruteforce_closest_hit(o, d, scene["tri_pos"])
    # "bvh" walks the tables as "pallas" does, even below bruteforce_max_tris.
    for cfg in (RenderConfig(), RenderConfig(bruteforce_max_tris=100), RenderConfig(tracer="bruteforce"),
                RenderConfig(tracer="bvh")):
        closest, any_hit = make_tracer(scene, soup["tables"], cfg, device="cpu")
        _assert_hits(closest(o, d), brute)
        hit, occ = closest.combo(o, d, d, torch.full((256,), float("inf")), 0.5)
        _assert_hits(hit, brute)
        np.testing.assert_array_equal(occ.numpy(), bruteforce_any_hit(o, d, scene["tri_pos"], 0.5).numpy())
    with pytest.raises(ValueError, match="bvh"):
        make_tracer(scene, None, RenderConfig(tracer="bvh"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_tracer(scene, soup["tables"], RenderConfig())
