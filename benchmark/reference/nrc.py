"""The plain reference of the neural radiance cache's frame.

What a frame with the cache does, written out in plain PyTorch beside
reference.frame: the training pass (jittered paths at the reduced size the
configuration implies, one record a vertex, targets summed backward with
the cache's own prediction as the tail of a path the spread heuristic
ends), the cache's optimizer steps (relative L2 loss, global-norm clipping
at 1, Adam, an EMA of the weights at 0.99), and the query pass (paths that
hand off to the cache once their spread passes the threshold).  The cache
is an MLP 59 -> 64 x5 -> 3 whose products take bfloat16 operands and sum
in float32, ReLU between, softplus at the head; its input is a
triangle-wave encoding of the position, one-blob encodings of the normal
and view in octahedral coordinates, 1 - exp(-roughness), albedo and
specular F0.  With learn_irradiance it learns radiance over F0 plus the
diffuse reflectance.

The cache state is {"params", "ema_params": lists of {"w", "b"}, "count",
"mu", "nu"}; a fresh one is `init_cache()`: He-normal weights from a CPU
torch.Generator seeded with 0, zero biases.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import frame as rf

N_FREQ = 12
N_BLOB = 4
HIDDEN, DEPTH = 64, 5
IN_DIM = 3 * N_FREQ + 2 * 2 * N_BLOB + 1 + 3 + 3
BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8


def init_cache(device) -> dict:
    g = torch.Generator().manual_seed(0)
    params = []
    dims = [IN_DIM] + [HIDDEN] * DEPTH + [3]
    for a, b in zip(dims[:-1], dims[1:]):
        w = torch.randn((a, b), generator=g, dtype=torch.float32) * math.sqrt(2.0 / a)
        params.append({"w": w.to(device), "b": torch.zeros(b, dtype=torch.float32, device=device)})
    zeros = [{k: torch.zeros_like(t) for k, t in layer.items()} for layer in params]
    return {"params": params, "ema_params": [{k: t.clone() for k, t in layer.items()} for layer in params],
            "count": 0, "mu": zeros, "nu": [{k: t.clone() for k, t in layer.items()} for layer in zeros]}


def oct01(n):
    denom = n[..., 0].abs() + n[..., 1].abs() + n[..., 2].abs()
    p = n[..., :2] / torch.clamp(denom[..., None], min=1e-12)
    px, py = p[..., 0], p[..., 1]
    wx = (1.0 - py.abs()) * torch.where(px >= 0.0, 1.0, -1.0).to(n.dtype)
    wy = (1.0 - px.abs()) * torch.where(py >= 0.0, 1.0, -1.0).to(n.dtype)
    down = n[..., 2] < 0.0
    return torch.stack([torch.where(down, wx, px), torch.where(down, wy, py)], -1) * 0.5 + 0.5


def oneblob(x):
    centers = torch.from_numpy((np.arange(N_BLOB, dtype=np.float32) + 0.5) / N_BLOB).to(x.device, x.dtype)
    d = (x[..., :, None] - centers) / (1.0 / N_BLOB)
    return torch.exp(-0.5 * d * d).reshape(*x.shape[:-1], x.shape[-1] * N_BLOB)


def encode(pos, normal, view, rough, albedo, specular, aabb_min, aabb_max):
    ext = torch.clamp(aabb_max - aabb_min, min=1e-6)
    x = torch.clamp((pos - aabb_min) / ext, 0.0, 1.0)
    waves = []
    for k in range(N_FREQ):
        v = x * (2.0 ** k)
        waves.append((2.0 * (v - torch.floor(v + 0.5))).abs())
    return torch.cat(waves + [oneblob(oct01(normal)), oneblob(oct01(view)), 1.0 - torch.exp(-rough[..., None]),
                      albedo, specular], -1)


def mlp(params, x):
    """Products of bfloat16 operands summed in float32 (TF32 off), the
    bias in float32, ReLU, rounded to bfloat16 again; softplus head.
    Differentiable: the casts round the backward's products too."""
    h = x.float().to(torch.bfloat16)
    z = None
    for i, layer in enumerate(params):
        z = h.float() @ layer["w"].float().to(torch.bfloat16).float() + layer["b"].float()
        if i < len(params) - 1:
            h = torch.clamp(z, min=0.0).to(torch.bfloat16)
    return torch.logaddexp(z, torch.zeros((), dtype=z.dtype, device=z.device))


def modulation(albedo, metal):
    return torch.clamp(rf.base_f0(albedo, metal) + albedo * (1.0 - metal[..., None]), min=1e-2)


def query(params, surf, view, aabb, learn_irradiance=True):
    spec = rf.base_f0(surf["albedo"], surf["metalness"])
    x = encode(surf["position"], surf["normal_s"], view, surf["roughness"], surf["albedo"], spec, *aabb)
    pred = mlp(params, x).to(surf["albedo"].dtype)
    if learn_irradiance:
        pred = pred * modulation(surf["albedo"], surf["metalness"])
    return pred


def train_step(cache: dict, rec: dict, aabb, lr: float, learn_irradiance=True):
    """One optimizer step on a batch of records -> (new cache, loss)."""
    with torch.no_grad():
        spec = rf.base_f0(rec["albedo"], rec["metalness"])
        x = encode(rec["position"], rec["normal"], rec["view"], rec["roughness"], rec["albedo"], spec, *aabb).float()
        target = rec["target"]
        if learn_irradiance:
            target = target / modulation(rec["albedo"], rec["metalness"])
        target = target.float()
        w = rec["weight"].float()
    leaves = [t.detach().float().requires_grad_(True) for layer in cache["params"] for t in (layer["w"], layer["b"])]
    with torch.enable_grad():
        params = [{"w": leaves[i], "b": leaves[i + 1]} for i in range(0, len(leaves), 2)]
        pred = mlp(params, x)
        err = ((pred - target) ** 2 / (pred.detach() ** 2 + 1e-2)).mean(-1) * w
        loss = err.sum() / torch.clamp(w.sum(), min=1.0)
        grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        grads = [torch.where(norm < 1.0, g, g / norm) for g in grads]
        t = cache["count"] + 1
        flat = lambda ps: [x for layer in ps for x in (layer["w"], layer["b"])]  # noqa: E731
        new_p, new_m, new_v = [], [], []
        for p, g, m, v in zip(flat(cache["params"]), grads, flat(cache["mu"]), flat(cache["nu"])):
            m = BETA1 * m + (1.0 - BETA1) * g
            v = BETA2 * v + (1.0 - BETA2) * g * g
            denom = torch.sqrt(v) / math.sqrt(1.0 - BETA2 ** t) + ADAM_EPS
            new_p.append(p - (lr / (1.0 - BETA1 ** t)) * m / denom)
            new_m.append(m)
            new_v.append(v)

        def layers(xs):
            return [{"w": xs[i], "b": xs[i + 1]} for i in range(0, len(xs), 2)]

        params = layers(new_p)
        ema = [{k: e[k] * 0.99 + p[k] * 0.01 for k in ("w", "b")} for e, p in zip(cache["ema_params"], params)]
    return {"params": params, "ema_params": ema, "count": t, "mu": layers(new_m), "nu": layers(new_v)}, loss.detach()


def train_dims(width: int, height: int, cfg: dict):
    avg = max(cfg["nrc_max_path_vertices"] * 0.5, 1.0)
    target = cfg["nrc_train_iterations"] * cfg["nrc_records_per_iteration"] / avg
    scale = min((target / float(width * height)) ** 0.5, 1.0)
    return max(int(round(width * scale / 4.0)) * 4, 8), max(int(round(height * scale / 4.0)) * 4, 8)


def train_pass(S: rf.RefScene, cam: dict, cfg: dict, frame: int, cache: dict):
    """The frame's training pass and optimizer steps from `cache` ->
    (new cache, mean loss).  Only the pixels whose records the steps read
    are traced (the records are pixel-major, in contiguous batches)."""
    width, height = int(cfg["width"]), int(cfg["height"])
    tw, th = train_dims(width, height, cfg)
    verts = int(cfg["nrc_max_path_vertices"])
    bsz_full = int(cfg["nrc_records_per_iteration"])
    total = tw * th * verts
    bsz = min(bsz_full, total)
    n_batches = max(min(int(cfg["nrc_train_iterations"]), total // bsz), 1)
    need_px = -(-(n_batches * bsz) // verts)
    rows = min(th, -(-need_px // tw) + 1)  # one more row: the uv derivatives read it
    region = (0, rows, 0, tw)
    dt = S.dtype
    ys, xs = rf.region_pixels(region, S.device)
    rng = rf.init_rng(xs, ys, tw, (int(frame) ^ 0x9E3779B9) & 0xFFFFFFFF)
    rng, jx = rf.next_float(rng, torch.float32)
    rng, jy = rf.next_float(rng, torch.float32)
    gb = rf.gbuffer(S, cam, tw, th, region, mips=bool(cfg.get("texture_mips", True)), jitter=(jx, jy))
    aabb = (S.aabb_min, S.aabb_max)
    ema = cache["ema_params"]
    li = bool(cfg["nrc_learn_irradiance"])
    surf = {k: gb[k] for k in rf.SURF_KEYS}
    rng, u_lot = rf.next_float(rng, dt)
    unbiased = u_lot < cfg["nrc_unbiased_fraction"]
    cos0 = torch.clamp(rf.dot(surf["normal_s"], gb["view"]), 1e-3, 1.0)
    spread0 = primary_spread(gb["depth"].to(dt), cos0)
    spread0 = torch.where(torch.isfinite(spread0), spread0, 0.0)
    alive = gb["hit"]
    view = gb["view"]
    spread = torch.zeros_like(spread0)
    recs = []
    for _ in range(verts - 1):
        rng, pre = rf.vertex_draws(S, surf, view, alive, rng)
        alive_b = alive & pre["rr"]
        vis, found, hit_t, new_surf = rf.trace_vertex(S, pre, alive_b)
        direct = pre["f"] * (pre["n_l"] * vis)[:, None] * S.sun_rad[None]
        local = torch.where(alive[:, None], direct + surf["emissive"], 0.0)
        rec = {"position": surf["position"], "normal": surf["normal_s"], "view": view,
               "roughness": surf["roughness"], "albedo": surf["albedo"], "metalness": surf["metalness"],
               "alive": alive.to(dt)}
        alive = alive_b
        new_d, weight = pre["new_d"], pre["weight"]
        local = local + torch.where((alive & ~found)[:, None], weight * S.sky[None], 0.0)
        cos_new = torch.clamp(rf.dot(new_surf["normal_s"], -new_d), 1e-3, 1.0)
        spread = spread + spread_term(hit_t.to(dt), cos_new, cos_new / rf.PI * pre["p_d"])
        term = alive & found & ~unbiased & (spread > cfg["nrc_train_terminate_threshold"] * spread0)
        if cfg["nrc_self_training"]:
            pred = query(ema, new_surf, -new_d, aabb, li)
            local = local + torch.where(term[:, None], weight * pred, 0.0)
        alive = alive & found & ~term
        rec["local"] = local
        rec["w_after"] = torch.where(alive[:, None], weight, 0.0)
        recs.append(rec)
        surf, view = new_surf, -new_d
    direct, rng = rf.nee_last(S, surf, view, alive, rng)
    local_last = torch.where(alive[:, None], direct + surf["emissive"], 0.0)
    target = local_last
    if cfg["nrc_self_training"]:
        target = local_last + torch.where(alive[:, None], query(ema, surf, view, aabb, li), 0.0)
    last = {"position": surf["position"], "normal": surf["normal_s"], "view": view, "roughness": surf["roughness"],
            "albedo": surf["albedo"], "metalness": surf["metalness"], "alive": alive.to(dt)}
    targets = [target]
    for rec in reversed(recs):
        target = rec["local"] + rec["w_after"] * target
        targets.append(target)
    targets.reverse()
    n = need_px

    def interleave(key):
        full = torch.stack([r[key][:n] for r in recs] + [last[key][:n]], dim=1)
        return full.reshape((full.shape[0] * full.shape[1],) + full.shape[2:])

    records = {k: interleave(k) for k in ("position", "normal", "view", "roughness", "albedo", "metalness")}
    records["target"] = torch.stack([t[:n] for t in targets], dim=1).reshape(-1, 3)
    records["weight"] = interleave("alive")
    losses = []
    for i in range(n_batches):
        batch = {k: v[i * bsz:(i + 1) * bsz] for k, v in records.items()}
        cache, loss = train_step(cache, batch, aabb, float(cfg["nrc_learning_rate"]), li)
        losses.append(loss)
    return cache, torch.stack(losses).mean()


def spread_term(hit_dist, cos_gamma, pdf):
    return hit_dist / torch.sqrt(torch.clamp(cos_gamma * pdf, min=1e-6))


def primary_spread(hit_dist, cos_gamma):
    return hit_dist / torch.sqrt(torch.clamp(cos_gamma / (4.0 * math.pi), min=1e-6))


def query_pass(S: rf.RefScene, gb: dict, cfg: dict, rng, params):
    """Radiance of the G-buffer's pixels with the cache in the loop:
    paths hand off to the cache at the vertex where their spread passes
    the threshold; primary misses show the sky."""
    dt = S.dtype
    aabb = (S.aabb_min, S.aabb_max)
    li = bool(cfg["nrc_learn_irradiance"])
    surf = {k: gb[k] for k in rf.SURF_KEYS}
    n = gb["hit"].shape[0]
    acc = torch.where(gb["hit"][:, None], surf["emissive"], 0.0)
    cos0 = torch.clamp(rf.dot(surf["normal_s"], gb["view"]), 1e-3, 1.0)
    spread0 = primary_spread(gb["depth"].to(dt), cos0)
    spread0 = torch.where(torch.isfinite(spread0), spread0, 0.0)
    throughput = torch.ones((n, 3), dtype=dt, device=S.device)
    alive = gb["hit"]
    view = gb["view"]
    spread = torch.zeros_like(spread0)
    q_set = torch.zeros_like(alive)
    for _ in range(int(cfg["max_bounces"]) - 1):
        rng, pre = rf.vertex_draws(S, surf, view, alive, rng)
        alive_b = alive & pre["rr"]
        vis, found, hit_t, new_surf = rf.trace_vertex(S, pre, alive_b)
        direct = pre["f"] * (pre["n_l"] * vis)[:, None] * S.sun_rad[None]
        acc = acc + torch.where(alive[:, None], throughput * direct, 0.0)
        alive = alive_b
        new_d = pre["new_d"]
        cos_new = torch.clamp(rf.dot(new_surf["normal_s"], -new_d), 1e-3, 1.0)
        throughput = throughput * pre["weight"]
        acc = acc + torch.where((alive & ~found)[:, None], throughput * S.sky[None], 0.0)
        alive = alive & found
        surf, view = new_surf, -new_d
        spread = spread + spread_term(hit_t.to(dt), cos_new, cos_new / rf.PI * pre["p_d"])
        terminate = alive & (spread > cfg["nrc_terminate_threshold"] * spread0) & ~q_set
        pred = query(params, surf, view, aabb, li)
        acc = acc + torch.where(terminate[:, None], throughput * pred, 0.0)
        q_set = q_set | terminate
        alive = alive & ~terminate
    direct, rng = rf.nee_last(S, surf, view, alive, rng)
    acc = acc + torch.where(alive[:, None], throughput * direct, 0.0)
    return torch.where(gb["hit"][:, None], acc, S.sky[None])
