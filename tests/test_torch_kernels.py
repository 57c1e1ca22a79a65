"""The checks in front of the redesigned kernels, and K5's plain version at
ragged edges, on the CPU.

  * The fused walk (K2, its paged build K6a and its slot-gated build K6b)
    reads a fat4 row as 16-byte loads and a triangle as 8-byte loads.  Its
    wrappers refuse, before they dispatch, a stack depth outside the
    kernels' 1..STACK_MAX, a table that is not contiguous and a table whose
    start is not so aligned.  A triangle chunk, the view tris[lo:hi], is
    always 8-byte aligned and is taken for every tri_group: the chained
    slot-gated walks over such views equal JAX's interpreted kernel.
  * The closest-hit walk (K1, K6a, K6b) and the any-hit walk (K3, K6a,
    K6b) read rows and triangles as K2 does, and their wrappers refuse the
    same tables before they dispatch; so do the three fat2 walks (K7a, K7b
    and K7c), with the node faults on their fatnodes table, and the two
    one-node walks (K8 closest and any hit), on their nodes table.
  * K4 and K5 refuse a step below 1.
  * K5's plain version on a ragged 13x11 image, where the taps of steps 4
    and 8 reach past every edge, against jax.vjp of the interpreted Pallas
    step and of the XLA step: rtol 1e-5 / atol 1e-6 for a positive
    cotangent, the tolerance tests/test_torch_train.py states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

FUSED = ("shadow_closest_fat4", "shadow_closest_fat4_paged", "shadow_closest_fat4_slots")
CLOSEST = ("closest_hit_fat4", "closest_hit_fat4_paged", "closest_hit_fat4_slots")
ANY = ("any_hit_fat4", "any_hit_fat4_paged", "any_hit_fat4_slots")
FAT2_FUSED = "shadow_closest_fat"
FAT2 = ("closest_hit_fat", FAT2_FUSED, "any_hit_fat")
NODE = ("closest_hit_node", "any_hit_node")


def _soup(n_tris=400, seed=3):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.0, 1.0, size=(n_tris, 1, 3))
    off = rng.normal(scale=0.05, size=(n_tris, 2, 3))
    return np.concatenate([base, base + off], axis=1).astype(np.float32)


def _rays(n, seed=7):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.2, 1.2, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 2, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = d.astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d[:, 0].copy()), torch.from_numpy(d[:, 1].copy())


def _tables(tri_group=8, wide=4):
    """fat4 (wide 4), fat2 (wide 2) or one-node (wide 1) tables of _soup()."""
    from nebulae_tpu_torch.bvh.builder import build_bvh
    from nebulae_tpu_torch.kernels.trace import pack_bvh_fat, pack_bvh_fat4, pack_bvh_nodes, tables_to

    tri = _soup()
    pack = {4: pack_bvh_fat4, 2: pack_bvh_fat, 1: pack_bvh_nodes}[wide]
    return tables_to(pack(build_bvh(tri, max_leaf=15), tri, tri_group), "cpu")


def _call(name, o, b, l, tables):
    """A fused wrapper on (o, b, l), or a closest- or any-hit one on (o, b)."""
    from nebulae_tpu_torch.kernels import trace as kt

    if name.endswith("_slots"):
        n = tables["tris"].shape[0]
        tables = {**tables, "slot_lo": 0, "slot_hi": n}
    if name in FUSED or name == FAT2_FUSED:
        return getattr(kt, name)(o, b, l, tables)
    return getattr(kt, name)(o, b, tables)


def _misaligned(t):
    """A contiguous copy of t that starts 4 bytes past an aligned address."""
    buf = torch.zeros(t.numel() + 4, dtype=t.dtype)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def _strided(t):
    """A copy of t as a view that is not contiguous (every other column)."""
    wide = torch.zeros(t.shape[:-1] + (2 * t.shape[-1],), dtype=t.dtype)
    wide[..., ::2] = t
    return wide[..., ::2]


# Each fault on tables t whose node table is t[nodes].
BAD_TABLES = {
    "stack_too_deep": lambda t, nodes: {**t, "stack_depth": 129},
    "stack_empty": lambda t, nodes: {**t, "stack_depth": 0},
    "nodes_not_contiguous": lambda t, nodes: {**t, nodes: _strided(t[nodes])},
    "tris_not_contiguous": lambda t, nodes: {**t, "tris": _strided(t["tris"])},
    "nodes_misaligned": lambda t, nodes: {**t, nodes: _misaligned(t[nodes])},
    "tris_misaligned": lambda t, nodes: {**t, "tris": _misaligned(t["tris"])},
}


def _refuses_bad_tables_before_dispatch(name, fault):
    from nebulae_tpu_torch.kernels import trace as kt

    nodes = "fatnodes" if name in FAT2 else "nodes" if name in NODE else "fat4nodes"
    tables = _tables(wide=2 if name in FAT2 else 1 if name in NODE else 4)
    o, b, l = _rays(64)
    _call(name, o, b, l, tables)  # the tables as packed are taken
    bad = BAD_TABLES[fault](tables, nodes)
    if fault.endswith("misaligned"):
        key = nodes if fault.startswith("nodes") else "tris"
        assert bad[key].is_contiguous() and torch.equal(bad[key], tables[key])
    before = getattr(kt, name).launches
    with pytest.raises(ValueError):
        _call(name, o, b, l, bad)
    assert getattr(kt, name).launches == before


@pytest.mark.parametrize("fault", list(BAD_TABLES))
@pytest.mark.parametrize("name", FUSED)
def test_fused_walk_refuses_bad_tables_before_dispatch(name, fault):
    _refuses_bad_tables_before_dispatch(name, fault)


@pytest.mark.parametrize("fault", list(BAD_TABLES))
@pytest.mark.parametrize("name", CLOSEST)
def test_closest_walk_refuses_bad_tables_before_dispatch(name, fault):
    _refuses_bad_tables_before_dispatch(name, fault)


@pytest.mark.parametrize("fault", list(BAD_TABLES))
@pytest.mark.parametrize("name", ANY)
def test_any_walk_refuses_bad_tables_before_dispatch(name, fault):
    _refuses_bad_tables_before_dispatch(name, fault)


@pytest.mark.parametrize("name, fault", [
    # The fused walk's cases keep the ids they had before K7a and K7c joined.
    pytest.param(name, fault, id=fault if name == FAT2_FUSED else f"{name}-{fault}")
    for name in FAT2 for fault in BAD_TABLES])
def test_fat2_fused_walk_refuses_bad_tables_before_dispatch(name, fault):
    """The fat2 walks: closest (K7a), fused (K7b) and any hit (K7c)."""
    _refuses_bad_tables_before_dispatch(name, fault)


@pytest.mark.parametrize("fault", list(BAD_TABLES))
@pytest.mark.parametrize("name", NODE)
def test_node_walk_refuses_bad_tables_before_dispatch(name, fault):
    """The one-node walks (K8 closest and any hit) read a row as two
    16-byte loads and a triangle as 8-byte loads."""
    _refuses_bad_tables_before_dispatch(name, fault)


@pytest.mark.parametrize("tri_group, n_tris", [(1, 800), (3, 1500), (8, 1500)])
def test_fused_walk_takes_every_tri_chunk_view(tri_group, n_tris):
    """pack_bvh_tri_chunks cuts the triangle table into views tris[lo:hi]
    that start lo * G * 40 bytes in: 8-byte aligned for every G, 16-byte
    only for even G.  The fused walk's wrapper takes every view, and the
    chained slot-gated walks equal JAX's pallas_shadow_closest_tri_chunks
    in interpret mode: hits and occ equal, t within rtol 1e-5 (JAX's
    interpreted kernel contracts into FMAs), tri equal wherever t differs."""
    from nebulae_tpu.bvh.builder import build_bvh as jbuild
    from nebulae_tpu.kernels import pallas_trace as pt

    from nebulae_tpu_torch.bvh.builder import build_bvh
    from nebulae_tpu_torch.kernels import chunks as kc
    from nebulae_tpu_torch.kernels.trace import tables_to

    tri = _soup(n_tris)
    jbvh, pbvh = jbuild(tri, max_leaf=8), build_bvh(tri, max_leaf=8)
    # The nodes and the least chunk the packers cut (128 slots).
    budget = pt.pack_bvh_fat4(jbvh, tri, tri_group=tri_group)["fat4nodes"].nbytes + 128 * 40 * tri_group
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pt, "TRI_CHUNK_TABLE_BUDGET", budget)
        mp.setattr(kc, "TRI_CHUNK_TABLE_BUDGET", budget)
        jp = pt.pack_bvh_tri_chunks(jbvh, tri, tri_group=tri_group)
        pp = kc.pack_bvh_tri_chunks(pbvh, tri, tri_group=tri_group)
    tables = tables_to(pp, "cpu")
    chunks = tables["tri_chunks"]
    assert len(chunks) >= 2
    assert all(c["tris"].data_ptr() % 8 == 0 for c in chunks)
    if tri_group % 2:  # some view that is not 16-byte aligned
        assert any(c["tris"].data_ptr() % 16 for c in chunks)

    o, b, l = _rays(256)
    hit, occ = kc.shadow_closest_tri_chunks(o, b, l, tables, t_max_l=0.6)
    jtab = {"fat4nodes": jnp.asarray(jp["fat4nodes"]),
            "tri_chunks": [jax.tree.map(jnp.asarray, c) for c in jp["tri_chunks"]]}
    jhit, jocc = pt.pallas_shadow_closest_tri_chunks(
        *(jnp.asarray(x.numpy()) for x in (o, b, l)), jtab, t_max_l=0.6, interpret=True)
    out = {k: v.numpy() for k, v in hit.items()}
    ref = {k: np.asarray(v) for k, v in jhit.items()}
    hits = ref["tri"] >= 0
    np.testing.assert_array_equal(out["tri"] >= 0, hits)
    np.testing.assert_allclose(out["t"][hits], ref["t"][hits], rtol=1e-5, atol=0.0)
    differ = hits & (out["t"] != ref["t"])
    np.testing.assert_array_equal(out["tri"][differ], ref["tri"][differ])
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    assert hits.any() and occ.any() and not occ.all()


@pytest.mark.parametrize("step", [0, -1])
def test_atrous_bwd_refuses_step_below_one(step):
    from nebulae_tpu_torch.kernels.svgf import atrous_step_bwd

    h, w = 5, 6
    img, one = torch.zeros((h, w, 3)), torch.ones((h, w))
    with pytest.raises(ValueError):
        atrous_step_bwd(img, one, img, one, one, img, step, (4.0, 128, 0.002))


@pytest.mark.parametrize("step", [0, -1])
def test_atrous_fwd_refuses_step_below_one(step):
    from nebulae_tpu_torch.kernels.svgf import atrous_step, atrous_step_fwd

    h, w = 5, 6
    img, one = torch.zeros((h, w, 3)), torch.ones((h, w))
    for fn in (atrous_step_fwd, atrous_step):
        with pytest.raises(ValueError):
            fn(img, one, one, img, step, (4.0, 128, 0.002))


def _ragged_inputs(h=11, w=13, seed=2):
    rng = np.random.default_rng(seed)
    rad = rng.uniform(0, 2, (h, w, 3)).astype(np.float32)
    var = (rng.uniform(0, 1, (h, w)) * 0.05).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dep = (3.0 + 0.001 * xx + 0.0005 * yy + rng.uniform(0, 2e-3, (h, w))).astype(np.float32)
    n = rng.normal(size=(h, w, 3)) * 0.05 + [0, 0, 1]
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    gbar = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    return rad, var, dep, n, gbar


@pytest.mark.parametrize("step", [1, 2, 4, 8])
def test_plain_atrous_bwd_on_ragged_image_matches_pallas_vjp(step):
    from nebulae_tpu.config import RenderConfig as JCfg
    from nebulae_tpu.kernels.pallas_svgf import atrous_step_pallas
    from nebulae_tpu.passes.svgf import svgf_atrous_step

    from nebulae_tpu_torch.kernels.svgf import atrous_step_bwd_plain, atrous_step_plain

    cfg = JCfg()
    phi = (cfg.svgf_phi_color, cfg.svgf_phi_normal, cfg.svgf_phi_depth)
    rad, var, dep, n, gbar = _ragged_inputs()
    j = [jnp.asarray(x) for x in (rad, var, dep, n)]
    _, vjp = jax.vjp(lambda r: atrous_step_pallas(r, *j[1:], step, cfg, interpret=True), j[0])
    pallas = np.asarray(vjp(jnp.asarray(gbar))[0])
    _, vjp_x = jax.vjp(lambda r: svgf_atrous_step(r, *j[1:], step, cfg), j[0])
    xla = np.asarray(vjp_x(jnp.asarray(gbar))[0])

    t = [torch.from_numpy(x) for x in (rad, var, dep, n)]
    _, sum_w = atrous_step_plain(*t, step, phi)
    grad = atrous_step_bwd_plain(torch.from_numpy(gbar), sum_w, *t, step, phi).numpy()
    np.testing.assert_allclose(grad, pallas, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(grad, xla, rtol=1e-5, atol=1e-6)
