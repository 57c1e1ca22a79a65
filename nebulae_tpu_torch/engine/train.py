"""Inverse-rendering train step: forward render, MSE loss, backward through
the whole pipeline, and an Adam update of the material tables and the sun.

Counterpart of `nebulae_tpu/engine/train.py`, with its contract

    step(params, opt_state, cam, state, target)
        -> (params, opt_state, state, loss, img)

where params holds the four material tables of TRAINABLE_SCENE_KEYS and
"sun" (a SunLight, whose four fields are leaves).  The step is functional:
it leaves its inputs as they are and returns new tensors, so a caller can
hold params fixed across steps.  The returned frame state and image are
detached, so the SVGF history does not keep a step's graph alive into the
next.  On the GPU the a-trous cascade runs kernel K4 forward and K5
backward.  Besides the frame's own `record_function` ranges, the step
opens "nebulae/backward" and "nebulae/optimizer".
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from nebulae_tpu_torch.config import SUN_LEAVES, RenderConfig, SunLight
from nebulae_tpu_torch.device import resolve_device
from nebulae_tpu_torch.dist.comm import all_reduce_sum
from nebulae_tpu_torch.engine.renderer import render_frame

# Scene tables that are trainable (the material factors).
TRAINABLE_SCENE_KEYS = ("mat_base_color", "mat_metallic", "mat_roughness", "mat_emissive")


def split_scene_params(scene: dict):
    """Split a scene dict into (trainable params, frozen tensors)."""
    params = {k: scene[k] for k in TRAINABLE_SCENE_KEYS}
    frozen = {k: v for k, v in scene.items() if k not in TRAINABLE_SCENE_KEYS}
    return params, frozen


def clamp_scene_params(params: dict) -> dict:
    """Project material parameters back to their physical ranges."""
    out = dict(params)
    if "mat_base_color" in out:
        out["mat_base_color"] = torch.clamp(out["mat_base_color"], 0.0, 1.0)
    if "mat_metallic" in out:
        out["mat_metallic"] = torch.clamp(out["mat_metallic"], 0.0, 1.0)
    if "mat_roughness" in out:
        out["mat_roughness"] = torch.clamp(out["mat_roughness"], 0.02, 1.0)
    if "mat_emissive" in out:
        out["mat_emissive"] = torch.clamp(out["mat_emissive"], min=0.0)
    return out


def flatten_params(params: dict) -> list:
    """The leaves of a params dict: its material tables in
    TRAINABLE_SCENE_KEYS order, then the sun's fields in SUN_LEAVES order."""
    return [params[k] for k in TRAINABLE_SCENE_KEYS if k in params] + list(params["sun"].leaves())


def unflatten_params(like: dict, leaves) -> dict:
    """Inverse of flatten_params, with the keys of `like`."""
    keys = [k for k in TRAINABLE_SCENE_KEYS if k in like]
    out = dict(zip(keys, leaves[:len(keys)]))
    out["sun"] = SunLight(*leaves[len(keys):len(keys) + len(SUN_LEAVES)])
    return out


def detach_state(state):
    """A frame state (nested dicts and lists of tensors and Python values)
    with every tensor detached."""
    if isinstance(state, dict):
        return {k: detach_state(v) for k, v in state.items()}
    if isinstance(state, list):
        return [detach_state(v) for v in state]
    return state.detach() if isinstance(state, torch.Tensor) else state


class Adam:
    """optax.adam through torch.optim.Adam: the same formula and defaults
    (betas 0.9 / 0.999, eps 1e-8).  Its state mirrors optax's
    ScaleByAdamState: {"count": steps taken, "mu": params-like first
    moments, "nu": params-like second moments}."""

    def __init__(self, lr: float = 1e-2, betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.betas, self.eps = lr, tuple(betas), eps

    def init(self, params: dict) -> dict:
        zeros = [torch.zeros_like(t) for t in flatten_params(params)]
        return {"count": 0, "mu": unflatten_params(params, zeros),
                "nu": unflatten_params(params, [z.clone() for z in zeros])}

    def update_leaves(self, leaves: list, grads: list, count: int, mu: list, nu: list):
        """One update of a list of leaves after `count` earlier steps, with
        their first and second moments.  Returns (leaves, mu, nu) as new
        tensors."""
        new = [t.detach().clone() for t in leaves]
        opt = torch.optim.Adam(new, lr=self.lr, betas=self.betas, eps=self.eps)
        for p, g, m, v in zip(new, grads, mu, nu):
            p.grad = g.detach()
            opt.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": m.detach().clone(),
                "exp_avg_sq": v.detach().clone(),
            }
        opt.step()
        out_mu = [opt.state[p]["exp_avg"] for p in new]
        out_nu = [opt.state[p]["exp_avg_sq"] for p in new]
        for p in new:
            p.grad = None
        return new, out_mu, out_nu

    def apply(self, params: dict, grads: list, opt_state: dict):
        """One update of every leaf (a zero gradient still moves a leaf whose
        first moment is not zero, as in optax).  Returns (params, opt_state)
        as new tensors."""
        new, mu, nu = self.update_leaves(flatten_params(params), grads, int(opt_state["count"]),
                                         flatten_params(opt_state["mu"]), flatten_params(opt_state["nu"]))
        state = {
            "count": int(opt_state["count"]) + 1,
            "mu": unflatten_params(params, mu),
            "nu": unflatten_params(params, nu),
        }
        return unflatten_params(params, new), state


def render_loss(params, frozen_scene, tables, cam, state, target, cfg: RenderConfig, device=None, world=None):
    """(loss, (new_state, img)): MSE of the denoised image (the hdr one when
    SVGF is off) against `target`.  `lean_outputs` is turned off, since the
    loss reads the linear image.  On a rank of `world` the state, `target`
    and `img` hold the rank's rows, and the loss is the rank's share: its
    squared error over the whole image's element count, so the ranks'
    losses and gradients sum to the image's."""
    scene = dict(frozen_scene)
    scene.update({k: v for k, v in params.items() if k != "sun"})
    cfg = dataclasses.replace(cfg, lean_outputs=False)
    out, new_state = render_frame(scene, tables, params["sun"], cam, state, cfg, device=device, world=world)
    img = out["denoised"] if cfg.enable_svgf else out["hdr"]
    if world is None:
        loss = torch.mean((img - target) ** 2)
    else:
        loss = torch.sum((img - target) ** 2) / (cfg.height * cfg.width * 3)
    return loss, (new_state, img)


def loss_and_grads(params, frozen_scene, tables, cam, state, target, cfg: RenderConfig, device=None, world=None):
    """render_loss and its gradients with respect to flatten_params(params)
    (zeros for a leaf the loss does not reach) -> (loss, grads, new_state,
    img).  On a rank of `world` the loss and the gradients are summed over
    ranks: every rank gets the whole image's."""
    leaves = [t.detach().requires_grad_(True) for t in flatten_params(params)]
    with torch.enable_grad():
        loss, (new_state, img) = render_loss(
            unflatten_params(params, leaves), frozen_scene, tables, cam, state, target,
            cfg, device=device, world=world,
        )
        with record_function("nebulae/backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]
    if world is not None:
        with record_function("nebulae/grad_sum"):
            loss = all_reduce_sum(world, loss, "loss")
            flat = all_reduce_sum(world, torch.cat([g.reshape(-1) for g in grads]), "grads")
            grads = [g.reshape(x.shape) for g, x in zip(flat.split([x.numel() for x in leaves]), leaves)]
    return loss.detach(), grads, new_state, img


def make_train_step(cfg: RenderConfig, frozen_scene: dict, tables: dict | None,
                    optimizer: Adam | None = None, train_sun: bool = True, device=None, world=None):
    """Build the train step (see the module docstring); returns
    (step, optimizer).  With train_sun=False the sun's gradients are zeros,
    so, as in optax, the sun still moves while its Adam moments decay.
    On a rank of `world` the step takes and returns the rank's rows of the
    state, target and image; the loss and every gradient are summed over
    ranks before Adam, so params and Adam's state stay equal on all."""
    dev = resolve_device(device)
    if optimizer is None:
        optimizer = Adam(1e-2)

    def step(params, opt_state, cam, state, target):
        loss, grads, new_state, img = loss_and_grads(params, frozen_scene, tables, cam, state, target, cfg,
                                                     device=dev, world=world)
        if not train_sun:
            n_sun = len(SUN_LEAVES)
            grads = grads[:-n_sun] + [torch.zeros_like(g) for g in grads[-n_sun:]]
        with record_function("nebulae/optimizer"), torch.no_grad():
            new_params, opt_state = optimizer.apply(params, grads, opt_state)
            mats = clamp_scene_params({k: v for k, v in new_params.items() if k != "sun"})
            new_params = {**mats, "sun": new_params["sun"]}
        return new_params, opt_state, detach_state(new_state), loss, img.detach()

    return step, optimizer
