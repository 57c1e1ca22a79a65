"""Path tracing with the neural radiance cache in the loop.

Counterpart of `nebulae_tpu/passes/nrc_pathtrace.py`: a full-resolution
query pass whose paths hand off to the cache once their cumulative spread
passes a threshold, and a reduced-resolution training pass whose longer
paths record every vertex, accumulate targets backward (the tail queries
the cache itself) and take nrc_train_iterations optimizer steps on
contiguous batches of nrc_records_per_iteration records.  Both reuse the
plain path tracer's vertex (bounce_vertex, nee_bounce_step, _nee_direct:
kernels K9, K2 and K3) but not its loop: the query body adds no emission
at a new vertex and applies no throughput threshold, as in JAX.

With nrc_inline_resolve the query pass asks the cache only on the lanes
each vertex's walk kept (`_resolve_walked`): a lane hands off only where
its bounce found a surface, so every other lane's term is 0 and is never
computed.  The counters "nrc.query_rows" and "nrc.query_full" (utils/
metrics.py) take the rows so evaluated and the lanes a full-width resolve
would have evaluated.  The training pass's queries stay at full width.

RNG: the query pass draws as the path tracer does (5 a bounce vertex, 2 at
the last); the training pass seeds with frame ^ 0x9E3779B9, then draws 2
for its jitter, 1 for the unbiased-path lottery, 5 a bounce vertex and 2 at
the last.
"""

from __future__ import annotations

import torch

from nebulae_tpu_torch.core import brdf
from nebulae_tpu_torch.core import rng as nrng
from nebulae_tpu_torch.core.math import clip, dot
from nebulae_tpu_torch.kernels.vertex import bounce_vertex
from nebulae_tpu_torch.nrc.cache import primary_spread, query_cache, spread_term, train_cache_step
from nebulae_tpu_torch.passes.gbuffer import camera_rays, render_gbuffer
from nebulae_tpu_torch.passes.pathtrace import SURF_KEYS, _nee_direct, nee_bounce_step, sort_box
from nebulae_tpu_torch.utils.metrics import count

PI = 3.14159265358979
QREC_KEYS = ("position", "normal_s", "albedo", "roughness", "metalness")


def _primary_spread0(surf0, gbuf):
    """Each path's primary spread; 0 where it is not finite (misses)."""
    cos0 = clip(dot(surf0["normal_s"], gbuf["view"], False), 1e-3, 1.0)
    spread0 = primary_spread(gbuf["depth"], cos0)
    return torch.where(torch.isfinite(spread0), spread0, 0.0)


def _resolve_walked(acc, cache_params, surf, view, throughput, terminate, walked, aabb, cfg):
    """acc plus throughput times the cache's radiance on the lanes that
    hand off at this vertex (`terminate`), evaluated on the `walked` lanes
    alone (the vertex walk's indices, a superset of them) and added back
    at their pixels.  No walked lane: no query."""
    count("nrc.query_full", terminate.shape[0])
    count("nrc.query_rows", walked.numel())
    if walked.numel() == 0:
        return acc
    pred = query_cache(cache_params, {k: surf[k][walked] for k in QREC_KEYS}, view[walked], *aabb,
                       learn_irradiance=cfg.nrc_learn_irradiance)
    return acc.index_add(0, walked, torch.where(terminate[walked][..., None], throughput[walked] * pred, 0.0))


def path_trace_nrc_query(scene, gbuf, sun, closest_fn, any_fn, rng_state, cfg, cache_params):
    """The query pass from the G-buffer: paths end in the cache by the
    spread heuristic.  With cfg.nrc_inline_resolve the cache is queried at
    the handoff vertex inside the loop; without, the handoff records are
    latched and one query after the loop resolves them.  Returns (radiance
    [N, 3], rng_state, aux): query and alive fractions, and per pixel the
    vertex count n_vert, the handoff bounce term_bounce (-1: none) and
    query_set."""
    n_pix = gbuf["ray_d"].shape[0]
    dev = gbuf["ray_d"].device
    surf = {k: gbuf[k] for k in SURF_KEYS}
    acc = torch.where(gbuf["hit"][..., None], surf["emissive"], 0.0)
    spread0 = _primary_spread0(surf, gbuf)
    throughput = torch.ones((n_pix, 3), dtype=torch.float32, device=dev)
    alive = gbuf["hit"]
    view = gbuf["view"]
    spread = torch.zeros(n_pix, dtype=torch.float32, device=dev)
    q_set = torch.zeros(n_pix, dtype=torch.bool, device=dev)
    n_vert = gbuf["hit"].float()
    term_bounce = torch.full((n_pix,), -1.0, dtype=torch.float32, device=dev)
    qrec = None
    if not cfg.nrc_inline_resolve:
        qrec = {k: torch.zeros_like(surf[k]) for k in QREC_KEYS}
        qrec["view"] = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
        qrec["throughput"] = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    aabb = (scene["aabb_min"], scene["aabb_max"])
    for bounce in range(cfg.max_bounces - 1):
        rng_state, pre = bounce_vertex(surf, view, sun, alive, rng_state, sort_box(scene, cfg))
        alive_b = alive & pre["rr_continue"]
        vis, found, hit_t, new_surf, walked = nee_bounce_step(scene, pre, alive_b, closest_fn, cfg)
        direct = pre["f"] * (pre["n_dot_l"] * vis)[..., None] * sun.radiance[None, :]
        acc = acc + torch.where(alive[..., None], throughput * direct, 0.0)
        alive = alive_b
        new_d = pre["new_d"]
        cos_new = clip(dot(new_surf["normal_s"], -new_d, False), 1e-3, 1.0)
        throughput = throughput * pre["weight"]
        sky = brdf.sky_eval(new_d, sun, scene, cfg)
        acc = acc + torch.where((alive & ~found)[..., None], throughput * sky, 0.0)
        alive = alive & found
        surf, view = new_surf, -new_d
        # The spread at the new vertex; pdf is the cosine lobe's times the
        # Russian roulette's diffuse probability.
        pdf = cos_new / PI * pre["p_d"]
        spread = spread + spread_term(hit_t, cos_new, pdf)
        terminate = alive & (spread > cfg.nrc_terminate_threshold * spread0) & ~q_set
        if cfg.nrc_inline_resolve:
            acc = _resolve_walked(acc, cache_params, surf, view, throughput, terminate, walked, aabb, cfg)
        else:
            t_ = terminate[..., None]
            qrec = {
                **{k: torch.where(t_ if surf[k].dim() == 2 else terminate, surf[k], qrec[k]) for k in QREC_KEYS},
                "view": torch.where(t_, view, qrec["view"]),
                "throughput": torch.where(t_, throughput, qrec["throughput"]),
            }
        q_set = q_set | terminate
        n_vert = n_vert + alive.float()
        term_bounce = torch.where(terminate & (term_bounce < 0), 1.0 + float(bounce), term_bounce)
        alive = alive & ~terminate
    if qrec is not None and cfg.max_bounces > 1:
        pred = query_cache(cache_params, {k: qrec[k] for k in QREC_KEYS}, qrec["view"], *aabb,
                           learn_irradiance=cfg.nrc_learn_irradiance)
        acc = acc + torch.where(q_set[..., None], qrec["throughput"] * pred, 0.0)
    direct, rng_state, _shoot = _nee_direct(scene, surf, view, sun, alive, any_fn, rng_state, cfg)
    acc = acc + torch.where(alive[..., None], throughput * direct, 0.0)
    aux = {
        "query_frac": q_set.float().mean(),
        "alive_frac": alive.float().mean(),
        "n_vert": n_vert,
        "term_bounce": term_bounce,
        "query_set": q_set,
    }
    return acc, rng_state, aux


def compute_ideal_training_dims(width: int, height: int, cfg) -> tuple[int, int]:
    """The training pass's size: about nrc_train_iterations x
    nrc_records_per_iteration records at half nrc_max_path_vertices a
    path, in the frame's aspect, multiples of 4 and at least 8."""
    avg_verts = max(cfg.nrc_max_path_vertices * 0.5, 1.0)
    target_paths = cfg.nrc_train_iterations * cfg.nrc_records_per_iteration / avg_verts
    scale = min((target_paths / float(width * height)) ** 0.5, 1.0)
    tw = max(int(round(width * scale / 4.0)) * 4, 8)
    th = max(int(round(height * scale / 4.0)) * 4, 8)
    return tw, th


def _vertex_record(surf, view, local, alive):
    return {
        "position": surf["position"],
        "normal": surf["normal_s"],
        "view": view,
        "roughness": surf["roughness"],
        "albedo": surf["albedo"],
        "metalness": surf["metalness"],
        "local": local,
        "alive": alive.float(),
    }


@torch.no_grad()
def path_trace_nrc_train(scene, sun, closest_fn, any_fn, cfg, cache_state, optimizer, cam, frame: int):
    """The training pass: jittered paths of up to nrc_max_path_vertices
    vertices at compute_ideal_training_dims, one record a vertex, targets
    L_k = local_k + w_after_k * L_(k+1) with the EMA cache's own query as
    the tail, then optimizer steps on contiguous batches of the records
    in pixel-major order.  No gradient reaches the scene: the frame's
    outer gradient flows through the query pass only.  Returns (new cache
    state, mean loss over the batches)."""
    tw, th = compute_ideal_training_dims(cfg.width, cfg.height, cfg)
    n_pix = tw * th
    dev = cam["eye"].device
    aabb = (scene["aabb_min"], scene["aabb_max"])
    ema = cache_state["ema_params"]

    ys, xs = torch.meshgrid(torch.arange(th, device=dev), torch.arange(tw, device=dev), indexing="ij")
    rng_state = nrng.init_rng(xs.reshape(-1), ys.reshape(-1), tw, (int(frame) ^ 0x9E3779B9) & 0xFFFFFFFF)
    rng_state, jx = nrng.next_float(rng_state)
    rng_state, jy = nrng.next_float(rng_state)
    o, d = camera_rays(cam, tw, th, jitter=torch.stack([jx, jy], -1))
    gbuf = render_gbuffer(scene, closest_fn, o, d, image_hw=(th, tw) if cfg.texture_mips else None)
    surf = {k: gbuf[k] for k in SURF_KEYS}

    # A 1/16 lottery of paths that the spread heuristic never ends.
    rng_state, u_lot = nrng.next_float(rng_state)
    unbiased = u_lot < cfg.nrc_unbiased_fraction
    spread0 = _primary_spread0(surf, gbuf)
    alive = gbuf["hit"]
    view = gbuf["view"]
    spread = torch.zeros(n_pix, dtype=torch.float32, device=dev)
    recs = []
    for _ in range(cfg.nrc_max_path_vertices - 1):
        rng_state, pre = bounce_vertex(surf, view, sun, alive, rng_state, sort_box(scene, cfg))
        alive_b = alive & pre["rr_continue"]
        vis, found, hit_t, new_surf, _walked = nee_bounce_step(scene, pre, alive_b, closest_fn, cfg)
        direct = pre["f"] * (pre["n_dot_l"] * vis)[..., None] * sun.radiance[None, :]
        local = torch.where(alive[..., None], direct + surf["emissive"], 0.0)
        rec = _vertex_record(surf, view, local, alive)
        alive = alive_b
        new_d = pre["new_d"]
        weight = pre["weight"]
        # The sky closes the path: it folds into this vertex's target.
        sky = brdf.sky_eval(new_d, sun, scene, cfg)
        local = local + torch.where((alive & ~found)[..., None], weight * sky, 0.0)
        cos_new = clip(dot(new_surf["normal_s"], -new_d, False), 1e-3, 1.0)
        pdf = cos_new / PI * pre["p_d"]
        spread = spread + spread_term(hit_t, cos_new, pdf)
        term = alive & found & ~unbiased & (spread > cfg.nrc_train_terminate_threshold * spread0)
        if cfg.nrc_self_training:
            # A path ended by the heuristic takes the cache's own query at
            # the new vertex as its suffix, folded in like the sky.
            pred = query_cache(ema, new_surf, -new_d, *aabb, learn_irradiance=cfg.nrc_learn_irradiance)
            local = local + torch.where(term[..., None], weight * pred, 0.0)
        alive = alive & found & ~term
        rec["local"] = local
        rec["w_after"] = torch.where(alive[..., None], weight, 0.0)
        recs.append(rec)
        surf, view = new_surf, -new_d

    # The last vertex: NEE, and the cache's query as the tail.
    direct, rng_state, _shoot = _nee_direct(scene, surf, view, sun, alive, any_fn, rng_state, cfg)
    local_last = torch.where(alive[..., None], direct + surf["emissive"], 0.0)
    target = local_last
    if cfg.nrc_self_training:
        tail = query_cache(ema, surf, view, *aabb, learn_irradiance=cfg.nrc_learn_irradiance)
        target = local_last + torch.where(alive[..., None], tail, 0.0)
    last = _vertex_record(surf, view, local_last, alive)
    targets = [target]
    for rec in reversed(recs):
        target = rec["local"] + rec["w_after"] * target
        targets.append(target)
    targets.reverse()

    # Pixel-major records ([n_pix, k] flattened): each contiguous batch
    # holds every depth of a block of pixels.
    def interleave(key):
        full = torch.stack([r[key] for r in recs] + [last[key]], dim=1)
        return full.reshape((full.shape[0] * full.shape[1],) + full.shape[2:])

    records = {k: interleave(k) for k in ("position", "normal", "view", "roughness", "albedo", "metalness")}
    full = torch.stack(targets, dim=1)
    records["target"] = full.reshape((-1,) + full.shape[2:])
    records["weight"] = interleave("alive")

    total = records["weight"].shape[0]
    bsz = min(cfg.nrc_records_per_iteration, total)
    n_batches = max(min(cfg.nrc_train_iterations, total // bsz), 1)
    losses = []
    for i in range(n_batches):
        batch = {k: v[i * bsz:(i + 1) * bsz] for k, v in records.items()}
        cache_state, loss = train_cache_step(cache_state, optimizer, batch, *aabb,
                                             learn_irradiance=cfg.nrc_learn_irradiance)
        losses.append(loss)
    return cache_state, torch.stack(losses).mean()
