"""The distributed frame loop: DistRenderer, the image gather and the global
state snapshot (as `nebulae_tpu/dist/runner.py`).

`DistRenderer` is the Renderer on one rank of a World: the scene, tables,
sun and camera replicate (every rank builds them from the same inputs),
the frame is the rank's rows and the SVGF history holds those rows.
`present_gather` joins the rows into the whole image on every rank, and
rank 0 writes it.  `gather_state` builds the whole frame state on every
rank, the snapshot a checkpoint stores, so a checkpoint does not depend on
the number of ranks.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from nebulae_tpu_torch.dist.comm import all_gather_rows
from nebulae_tpu_torch.dist.mesh import IMAGE_KEYS, World, check_rows
from nebulae_tpu_torch.engine.renderer import Renderer


class DistRenderer(Renderer):
    """Renderer of one rank's rows.  Built on every rank with the same
    scene, config and sun; `render` is collective (every rank calls it for
    the same camera); resize, update_config, update_instances and
    update_geometry act on the replicated data as the Renderer does."""

    def __init__(self, flat_scene, cfg, world: World, sun=None, bvh=None, env_map=None):
        check_rows(cfg.height, world.size)
        self.world = world
        super().__init__(flat_scene, cfg, sun=sun, bvh=bvh, device=world.device, env_map=env_map)

    def render(self, camera, sun=None) -> dict:
        """The rank's rows of the frame (collective).  With the radiance
        cache, every rank trained it on the same inputs; the ranks' caches
        are then compared by digest, and a difference raises."""
        out = super().render(camera, sun)
        if "nrc" in self.state and not replicas_equal(self.world, self.state["nrc"]):
            raise RuntimeError(f"rank {self.world.rank}: the radiance cache differs between ranks")
        return out

    def resize(self, width: int, height: int):
        check_rows(height, self.world.size)
        super().resize(width, height)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if dataclasses.is_dataclass(tree):
        return _leaves([getattr(tree, f.name) for f in dataclasses.fields(tree)])
    return [tree]


def _digest(tree) -> bytes:
    """sha256 of a tree's tensors (bytes, shapes, dtypes) and values."""
    h = hashlib.sha256()
    for x in _leaves(tree):
        if isinstance(x, torch.Tensor):
            h.update(f"{x.dtype}{tuple(x.shape)}".encode())
            h.update(x.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
        else:
            h.update(repr(x).encode())
    return h.digest()


def replicas_equal(world: World, tree) -> bool:
    """True when `tree` is the same on every rank (an all-gathered digest)."""
    mine = torch.from_numpy(np.frombuffer(_digest(tree), np.int64).copy()).to(world.device)
    return bool((all_gather_rows(world, mine[None], "digest") == mine).all())


def present_gather(world: World | None, image):
    """A rank's rows [h, W, C] -> the whole image [H, W, C] on every rank
    (the image itself without a world)."""
    if world is None:
        return image
    with torch.no_grad():
        return all_gather_rows(world, image, "present")


def gather_state(world: World, state: dict) -> dict:
    """The whole frame state on every rank (collective): the SVGF history's
    image-space leaves gathered from every rank's rows, the replicated
    entries as they are."""
    if "svgf" not in state:
        return dict(state)
    hist = dict(state["svgf"])
    for k in IMAGE_KEYS:
        hist[k] = present_gather(world, hist[k])
    return {**state, "svgf": hist}
