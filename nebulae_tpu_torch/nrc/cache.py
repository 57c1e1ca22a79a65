"""The neural radiance cache: an MLP trained online inside the frame.

Counterpart of `nebulae_tpu/nrc/cache.py`.  The cache state is a dict
{"params", "ema_params", "opt_state"}: two MLP parameter lists (the trained
parameters and their exponential moving average, which renders) and the
optimizer's state {"count", "mu", "nu"} (optax's ScaleByAdamState; the
clipping stage keeps no state).  The optimizer is optax's
chain(clip_by_global_norm(1.0), adam(lr)): the port's engine.train.Adam
behind the global-norm clip.

With learn_irradiance the MLP learns radiance divided by the vertex's
specular F0 plus diffuse reflectance (`modulation_factor`), and a query
multiplies it back.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from nebulae_tpu_torch.core import brdf
from nebulae_tpu_torch.core.math import maximum
from nebulae_tpu_torch.nrc.encoding import encode_query, encoded_dim
from nebulae_tpu_torch.nrc.mlp import apply_mlp, init_mlp, mlp_from_leaves, mlp_leaves


@dataclass(frozen=True)
class NRCConfig:
    hidden: int = 64
    depth: int = 5
    learning_rate: float = 2e-3
    ema: float = 0.99


def clip_by_global_norm(grads: list, max_norm: float) -> list:
    """optax.clip_by_global_norm on an MLP parameter list: unchanged below
    `max_norm`, else each leaf / norm * max_norm.  The norm sums the leaves
    in JAX's tree order (b before w in each layer)."""
    norm = torch.sqrt(sum((layer[k] * layer[k]).sum() for layer in grads for k in ("b", "w")))
    keep = norm < max_norm
    return [{k: torch.where(keep, t, t / norm * max_norm) for k, t in layer.items()} for layer in grads]


class ClippedAdam:
    """optax.chain(clip_by_global_norm(max_norm), adam(learning_rate)) on an
    MLP parameter list."""

    def __init__(self, learning_rate: float, max_norm: float = 1.0):
        from nebulae_tpu_torch.engine.train import Adam

        self.adam = Adam(learning_rate)
        self.max_norm = max_norm

    def init(self, params: list) -> dict:
        def zeros():
            return mlp_from_leaves([torch.zeros_like(t) for t in mlp_leaves(params)])

        return {"count": 0, "mu": zeros(), "nu": zeros()}

    def update(self, grads: list, opt_state: dict, params: list):
        """(new params, new opt_state), as new tensors."""
        clipped = clip_by_global_norm(grads, self.max_norm)
        new, mu, nu = self.adam.update_leaves(
            mlp_leaves(params), mlp_leaves(clipped), int(opt_state["count"]),
            mlp_leaves(opt_state["mu"]), mlp_leaves(opt_state["nu"]))
        return mlp_from_leaves(new), {"count": int(opt_state["count"]) + 1,
                                      "mu": mlp_from_leaves(mu), "nu": mlp_from_leaves(nu)}


def make_optimizer(learning_rate: float) -> ClippedAdam:
    """The cache's optimizer: Adam behind global-norm clipping at 1.0."""
    return ClippedAdam(learning_rate)


def init_cache(seed: int, nrc_cfg: NRCConfig = NRCConfig(), device="cpu") -> dict:
    """{params, ema_params, opt_state}: He-normal weights drawn on the CPU
    from torch.Generator(seed), so every device starts from the same cache."""
    params = init_mlp(torch.Generator().manual_seed(seed), encoded_dim(), nrc_cfg.hidden, nrc_cfg.depth)
    params = [{k: t.to(device) for k, t in layer.items()} for layer in params]
    return {
        "params": params,
        "ema_params": [{k: t.clone() for k, t in layer.items()} for layer in params],
        "opt_state": make_optimizer(nrc_cfg.learning_rate).init(params),
    }


def modulation_factor(albedo, metalness):
    """Specular F0 plus diffuse reflectance at a vertex, floored at 1e-2."""
    return maximum(brdf.base_f0(albedo, metalness) + brdf.diffuse_reflectance(albedo, metalness), 1e-2)


def query_cache(params: list, surf: dict, view, aabb_min, aabb_max, learn_irradiance: bool = True):
    """Radiance leaving each surface point toward `view` [..., 3]."""
    specular = brdf.base_f0(surf["albedo"], surf["metalness"])
    x = encode_query(surf["position"], surf["normal_s"], view, surf["roughness"], surf["albedo"], specular,
                     aabb_min, aabb_max)
    pred = apply_mlp(params, x)
    if learn_irradiance:
        pred = pred * modulation_factor(surf["albedo"], surf["metalness"])
    return pred


def train_cache_step(cache_state: dict, optimizer: ClippedAdam, records: dict, aabb_min, aabb_max,
                     learn_irradiance: bool = True):
    """One optimizer step of the cache MLP on a batch of training records
    (position, normal, view, roughness, albedo, metalness, target, weight;
    weight 0 masks a record) with the relative L2 loss.  Records carry no
    gradient.  Returns (new cache state, loss)."""
    with torch.no_grad():
        specular = brdf.base_f0(records["albedo"], records["metalness"])
        x = encode_query(records["position"], records["normal"], records["view"], records["roughness"],
                         records["albedo"], specular, aabb_min, aabb_max)
        target = records["target"]
        if learn_irradiance:
            target = target / modulation_factor(records["albedo"], records["metalness"])
        w = records["weight"]
    leaves = [t.detach().requires_grad_(True) for t in mlp_leaves(cache_state["params"])]
    with torch.enable_grad():
        pred = apply_mlp(mlp_from_leaves(leaves), x)
        denom = pred.detach() ** 2 + 1e-2
        err = ((pred - target) ** 2 / denom).mean(-1) * w
        loss = err.sum() / torch.clamp(w.sum(), min=1.0)
        grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        params, opt_state = optimizer.update(mlp_from_leaves(list(grads)), cache_state["opt_state"],
                                             cache_state["params"])
        # The rendering parameters' EMA decay is fixed at 0.99, as in JAX
        # (NRCConfig.ema is not read).
        ema = [{k: e[k] * 0.99 + p[k] * 0.01 for k in ("w", "b")}
               for e, p in zip(cache_state["ema_params"], params)]
    return {"params": params, "ema_params": ema, "opt_state": opt_state}, loss.detach()


def memory_footprint(cache_state: dict) -> dict:
    """Bytes of the cache: {params, ema_params, opt_state, total}, as JAX
    counts them (the step count is optax's int32 scalar: 4 bytes)."""
    def nbytes(params):
        return sum(t.numel() * t.element_size() for t in mlp_leaves(params))

    opt = cache_state["opt_state"]
    out = {
        "params": nbytes(cache_state["params"]),
        "ema_params": nbytes(cache_state["ema_params"]),
        "opt_state": 4 + nbytes(opt["mu"]) + nbytes(opt["nu"]),
    }
    out["total"] = sum(out.values())
    return out


def spread_term(hit_dist, cos_gamma, pdf):
    """A vertex's path-spread increment: hitDist / sqrt(cos * pdf)."""
    return hit_dist / torch.sqrt(maximum(cos_gamma * pdf, 1e-6))


def primary_spread(hit_dist, cos_gamma):
    """The primary vertex's spread: hitDist / sqrt(cos / 4 pi)."""
    return hit_dist / torch.sqrt(maximum(cos_gamma / (4.0 * torch.pi), 1e-6))
