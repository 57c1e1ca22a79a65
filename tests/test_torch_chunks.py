"""Parity of the port's large-scene tables and walks with nebulae_tpu.

The subtree and triangle-chunk packers against pack_bvh_chunks and
pack_bvh_tri_chunks, and the plain versions of the chained walks (K6b over
triangle chunks, K1-K3 / K8 over subtree chunks) and of the paged route
(K6a) against the Pallas kernels in interpret mode.  The chunk limits are
shrunk on both packages with monkeypatch.  Tolerances: hit masks and occ
equal; t within rtol 1e-5 on hits (XLA contracts the interpreted
kernels' Moller-Trumbore products into FMAs, which moves t by up to
~1.2e-6 relative; ROADMAP Queue 3); triangle ids equal wherever t differs
(an exact t tie may pick another triangle: the port orders children by
each ray's own direction signs, the TPU by the packet's majority).  The
chained walks also equal the port's single-table walk exactly in t.
"""

RTOL = 1e-5

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


def _soup(n_tris, seed, center=0.0, scale=1.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.0, 1.0, size=(n_tris, 1, 3)) * scale + center
    off = rng.normal(scale=0.05, size=(n_tris, 2, 3))
    return np.concatenate([base, base + off], axis=1).astype(np.float32)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.2, 1.2, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_hits(out, ref, rtol):
    out = {k: np.asarray(v) for k, v in out.items()}
    ref = {k: np.asarray(v) for k, v in ref.items()}
    hit = ref["tri"] >= 0
    np.testing.assert_array_equal(out["tri"] >= 0, hit)
    np.testing.assert_allclose(out["t"][hit], ref["t"][hit], rtol=rtol, atol=0.0)
    differ_t = hit & (out["t"] != ref["t"])
    np.testing.assert_array_equal(out["tri"][differ_t], ref["tri"][differ_t])
    assert np.isinf(out["t"][~hit]).all()
    assert 0.1 < hit.mean() < 0.95


def _bvhs(tri, max_leaf=8):
    from nebulae_tpu.bvh.builder import build_bvh as jbuild

    from nebulae_tpu_torch.bvh.builder import build_bvh

    return jbuild(tri, max_leaf=max_leaf), build_bvh(tri, max_leaf=max_leaf)


def _jax_rows(table, width):
    """A JAX [blocks, width, 128] table as [rows, width] (lane-major rows)."""
    return table.transpose(0, 2, 1).reshape(-1, width)


def _assert_tris_equal(port_tris, jax_tris):
    g = port_tris.shape[1]
    jt = _jax_rows(jax_tris, 10 * g).reshape(-1, g, 10)
    ns = port_tris.shape[0]
    np.testing.assert_array_equal(port_tris[..., :9], jt[:ns, :, :9])
    np.testing.assert_array_equal(port_tris[..., 9].view(np.int32).astype(np.float32), jt[:ns, :, 9])
    assert not jt[ns:].any()


def _assert_nodes_equal(port_nodes, jax_nodes, width):
    """Boxes equal, enc (int32 bits in the port, exact f32 in JAX) equal;
    fat4 rows hold 4 boxes and 5 enc words, one-node rows 1 box and 1."""
    jn = _jax_rows(jax_nodes, width)
    ni = port_nodes.shape[0]
    box, n_enc = (24, 5) if width == 32 else (6, 1)
    np.testing.assert_array_equal(port_nodes[:, :box], jn[:ni, :box])
    enc = port_nodes[:, box:box + n_enc].view(np.int32).astype(np.float32)
    np.testing.assert_array_equal(enc, jn[:ni, box:box + n_enc])
    assert not port_nodes[:, box + n_enc:].any() and not jn[ni:].any()


def _assert_chunk_equal(pc, jc):
    """Decoded boxes, enc and triangle ids of one chunk equal JAX's."""
    if "fat4nodes" in jc:
        _assert_nodes_equal(pc["fat4nodes"], jc["fat4nodes"], 32)
    else:
        _assert_nodes_equal(pc["nodes"], jc["nodes"], 8)
    _assert_tris_equal(pc["tris"], jc["tris"])


@pytest.fixture(scope="module")
def subtree():
    """A 2000-triangle cluster and a 6-triangle one far away: cut at 1500
    triangles, two fat4 chunks and one single-leaf (one-node) chunk."""
    from nebulae_tpu.kernels.pallas_trace import pack_bvh_chunks as jchunks

    from nebulae_tpu_torch.kernels.chunks import pack_bvh_chunks
    from nebulae_tpu_torch.kernels.trace import tables_to

    tri = np.concatenate([_soup(2000, 23), _soup(6, 5, center=3.0, scale=0.3)])
    jbvh, pbvh = _bvhs(tri)
    jc = jchunks(jbvh, tri, max_tris=1500, wide=4, tri_group=4)
    pc = pack_bvh_chunks(pbvh, tri, max_tris=1500, tri_group=4)
    return {"tri": tri, "jax": jc, "port": pc, "jbvh": jbvh, "pbvh": pbvh,
            "tables": [tables_to(c, "cpu") for c in pc]}


@pytest.mark.parametrize("max_tris", [256, 1500])
def test_subtree_chunks_equal_jax(subtree, max_tris):
    from nebulae_tpu.kernels.pallas_trace import pack_bvh_chunks as jchunks

    from nebulae_tpu_torch.kernels.chunks import pack_bvh_chunks

    tri = subtree["tri"]
    jc = jchunks(subtree["jbvh"], tri, max_tris=max_tris, wide=4, tri_group=4)
    pc = pack_bvh_chunks(subtree["pbvh"], tri, max_tris=max_tris, tri_group=4)
    assert len(pc) == len(jc) >= 3
    assert sum("nodes" in c for c in pc) >= 1 and sum("fat4nodes" in c for c in pc) >= 2
    for p, j in zip(pc, jc):
        assert ("nodes" in p) == ("nodes" in j)
        _assert_chunk_equal(p, j)
        assert p["stack_depth"] <= 128


@pytest.fixture(scope="module")
def tri_chunked():
    """pack_bvh_tri_chunks of a 2000-triangle soup with the budget shrunk
    to the nodes plus 64 KB of triangles (both packages), and the single
    table it chunks."""
    from nebulae_tpu.kernels import pallas_trace as pt

    from nebulae_tpu_torch.kernels import chunks as kc
    from nebulae_tpu_torch.kernels.trace import pack_bvh_fat4, tables_to

    tri = _soup(2000, 23)
    jbvh, pbvh = _bvhs(tri)
    single = pt.pack_bvh_fat4(jbvh, tri, tri_group=4)
    budget = single["fat4nodes"].nbytes + 64 * 1024
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pt, "TRI_CHUNK_TABLE_BUDGET", budget)
        mp.setattr(kc, "TRI_CHUNK_TABLE_BUDGET", budget)
        jp = pt.pack_bvh_tri_chunks(jbvh, tri, tri_group=4)
        pp = kc.pack_bvh_tri_chunks(pbvh, tri, tri_group=4)
    return {
        "jax_np": jp, "port_np": pp,
        "jax": {"fat4nodes": jnp.asarray(jp["fat4nodes"]),
                "tri_chunks": [jax.tree.map(jnp.asarray, c) for c in jp["tri_chunks"]]},
        "tables": tables_to(pp, "cpu"),
        "single": tables_to(pack_bvh_fat4(pbvh, tri, 4), "cpu"),
    }


def test_tri_chunk_ranges_and_tables_equal_jax(tri_chunked):
    """The same slot ranges as JAX; each chunk is the view tris[lo:hi] of
    the one triangle table and holds JAX's chunk table; the whole-tree
    nodes equal JAX's."""
    jp, pp = tri_chunked["jax_np"], tri_chunked["port_np"]
    assert pp is not None and len(pp["tri_chunks"]) >= 2
    assert pp["tri_chunks"] == [(c.slot_lo, c.slot_hi) for c in jp["tri_chunks"]]
    storage = pp["tris"].shape
    chunks = tri_chunked["tables"]["tri_chunks"]
    for c, jc, (lo, hi) in zip(chunks, jp["tri_chunks"], pp["tri_chunks"]):
        assert (c["slot_lo"], c["slot_hi"]) == (lo, hi)
        assert c["tris"].untyped_storage().data_ptr() == chunks[0]["tris"].untyped_storage().data_ptr()
        assert c["tris"].storage_offset() == lo * storage[1] * storage[2]
        _assert_tris_equal(c["tris"].numpy(), jc.tris)
    _assert_nodes_equal(pp["fat4nodes"], jp["fat4nodes"], 32)


def test_none_cases_match_jax():
    """pack_bvh_tri_chunks returns None when the whole table fits the
    budget and when the root is a leaf, as JAX does."""
    from nebulae_tpu.kernels import pallas_trace as pt

    from nebulae_tpu_torch.kernels import chunks as kc

    for tri in (_soup(2000, 23), _soup(6, 1)):
        jbvh, pbvh = _bvhs(tri)
        assert pt.pack_bvh_tri_chunks(jbvh, tri, tri_group=4) is None
        assert kc.pack_bvh_tri_chunks(pbvh, tri, tri_group=4) is None


def test_tri_chunk_walks_match_jax(tri_chunked):
    from nebulae_tpu.kernels import pallas_trace as pt

    from nebulae_tpu_torch.kernels import chunks as kc
    from nebulae_tpu_torch.kernels.trace import any_hit_fat4, closest_hit_fat4, shadow_closest_fat4

    tables, jtab, single = tri_chunked["tables"], tri_chunked["jax"], tri_chunked["single"]
    o, d = _rays(1024, 31)
    _, l = _rays(1024, 32)
    oj, dj, lj = jnp.asarray(o), jnp.asarray(d), jnp.asarray(l)

    hit = kc.closest_tri_chunks(_t(o), _t(d), tables)
    _assert_hits(hit, pt.pallas_closest_tri_chunks(oj, dj, jtab, interpret=True), RTOL)
    _assert_hits(hit, closest_hit_fat4(_t(o), _t(d), single), 0.0)

    occ = kc.any_tri_chunks(_t(o), _t(d), tables, 0.6).numpy()
    np.testing.assert_array_equal(occ, np.asarray(pt.pallas_any_tri_chunks(oj, dj, jtab, 0.6, interpret=True)))
    np.testing.assert_array_equal(occ, any_hit_fat4(_t(o), _t(d), single, 0.6).numpy())
    assert 0.05 < occ.mean() < 0.95

    h, s = kc.shadow_closest_tri_chunks(_t(o), _t(d), _t(l), tables, t_max_l=0.6)
    jh, js = pt.pallas_shadow_closest_tri_chunks(oj, dj, lj, jtab, t_max_l=0.6, interpret=True)
    _assert_hits(h, jh, RTOL)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    sh, ss = shadow_closest_fat4(_t(o), _t(d), _t(l), single, t_max_l=0.6)
    _assert_hits(h, sh, 0.0)
    np.testing.assert_array_equal(s.numpy(), ss.numpy())


def test_paged_route_matches_jax_paged_kernels():
    """The paged route (K1-K3 over the one table) against the Pallas
    paged=True builds over the padded table, as test_pallas_kernel's
    paged parity test runs them."""
    from nebulae_tpu.kernels import pallas_trace as pt

    from nebulae_tpu_torch.kernels.trace import (
        any_hit_fat4_paged, closest_hit_fat4_paged, pack_bvh_fat4, shadow_closest_fat4_paged, tables_to,
    )

    tri = _soup(2400, 29)
    jbvh, pbvh = _bvhs(tri)
    packed = pt.pack_bvh_fat4(jbvh, tri, tri_group=1)
    paged = {"fat4nodes": jnp.asarray(packed["fat4nodes"]),
             "tris": jnp.asarray(pt.pad_tris_for_paging(packed["tris"]))}
    assert paged["tris"].shape[0] >= 3 * pt.PAGE_TILES
    tables = tables_to(pack_bvh_fat4(pbvh, tri, 1), "cpu")
    o, d = _rays(512, 41)
    _, l = _rays(512, 42)
    oj, dj, lj = jnp.asarray(o), jnp.asarray(d), jnp.asarray(l)

    _assert_hits(closest_hit_fat4_paged(_t(o), _t(d), tables),
                 pt.pallas_closest_hit_fat4(oj, dj, paged, interpret=True, paged=True), RTOL)
    np.testing.assert_array_equal(
        any_hit_fat4_paged(_t(o), _t(d), tables, 0.6).numpy(),
        np.asarray(pt.pallas_any_hit_fat4(oj, dj, paged, t_max=0.6, interpret=True, paged=True)))
    h, s = shadow_closest_fat4_paged(_t(o), _t(d), _t(l), tables, t_max_l=0.6)
    jh, js = pt.pallas_shadow_closest_fat4(oj, dj, lj, paged, t_max_l=0.6, interpret=True, paged=True)
    _assert_hits(h, jh, RTOL)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_subtree_chains_match_jax(subtree):
    """Closest, any and fused walks over two fat4 chunks and a
    single-leaf chunk, against pallas_*_chunks; per-ray caps included."""
    from nebulae_tpu.kernels import pallas_trace as pt

    from nebulae_tpu_torch.kernels import chunks as kc

    jc = [jax.tree.map(jnp.asarray, {k: v for k, v in c.items() if k != "fat4_slots"})
          for c in subtree["jax"]]
    pc = subtree["tables"]
    o, d = _rays(1024, 51)
    # A few rays aimed at the far single-leaf cluster's triangles.
    o[:64] = np.float32([1.5, 1.5, 1.5])
    tgt = subtree["tri"][2000 + np.arange(64) % 6].mean(axis=1)
    d[:64] = (tgt - o[:64]) / np.linalg.norm(tgt - o[:64], axis=-1, keepdims=True)
    _, l = _rays(1024, 52)
    t_b = np.where(np.random.default_rng(4).uniform(size=1024) < 0.8, np.inf, 0.0).astype(np.float32)
    oj, dj, lj = jnp.asarray(o), jnp.asarray(d), jnp.asarray(l)

    hit = kc.closest_chunks(_t(o), _t(d), pc)
    jhit = pt.pallas_closest_chunks(oj, dj, jc, interpret=True)
    _assert_hits(hit, jhit, RTOL)
    far = np.asarray(jhit["tri"])[:64]
    assert (far >= 2000).sum() >= 8, "rays must reach the single-leaf chunk"

    occ = kc.any_chunks(_t(o), _t(d), pc, 0.6).numpy()
    np.testing.assert_array_equal(occ, np.asarray(pt.pallas_any_chunks(oj, dj, jc, 0.6, interpret=True)))
    assert 0.05 < occ.mean() < 0.95

    h, s = kc.shadow_closest_chunks(_t(o), _t(d), _t(l), pc, _t(t_b), 0.6)
    jh, js = pt.pallas_shadow_closest_chunks(oj, dj, lj, jc, t_max_b=jnp.asarray(t_b), t_max_l=0.6,
                                             interpret=True)
    _assert_hits(h, jh, RTOL)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
