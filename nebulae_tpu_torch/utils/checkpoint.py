"""Checkpoint and resume of the frame state (as `nebulae_tpu/utils/checkpoint.py`).

The state is a nested dict of tensors, lists and Python values: the SVGF
history, the frame counter, the history-reset flag and, with the radiance
cache, its parameters, EMA parameters and Adam state {count, mu, nu}.
`save_checkpoint` writes it with torch.save into `<path>/step_%08d/`
(built in a temporary directory, then renamed into place, so a reader never
sees half a checkpoint); `load_checkpoint` reads it back with
torch.load(weights_only=True) onto the devices of a `like` state and
raises on any difference from it in structure, shape or dtype, as JAX's
restore against a target does.  With a `world` (dist.mesh.World) both are
collective: a checkpoint holds the whole image's state, whatever the
number of ranks; every rank gathers it, rank 0 writes it, and on resume
every rank reads it and keeps its rows (JAX's app.py:276-287, :398-408).
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path

import torch

STATE_FILE = "state.pt"


def _host_copy(tree):
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host_copy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def save_checkpoint(path: str | Path, state: dict, step: int | None = None, world=None) -> str:
    """Save `state`; returns the directory written (`<path>/step_%08d` with
    a step), replacing one that exists.  On a rank of `world`, `state` is
    the rank's and the call is collective; the ranks return once rank 0
    has written the whole state."""
    path = Path(path).absolute()
    if step is not None:
        path = path / f"step_{step:08d}"
    if world is not None:
        from nebulae_tpu_torch.dist.comm import barrier
        from nebulae_tpu_torch.dist.runner import gather_state

        state = gather_state(world, state)
        if world.rank == 0:
            save_checkpoint(path, state)
        barrier(world, "checkpoint")
        return str(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / f".{path.name}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    torch.save(_host_copy(state), tmp / STATE_FILE)
    if path.exists():
        shutil.rmtree(path)
    os.replace(tmp, path)
    return str(path)


def _restore(saved, like, where: str):
    """`saved` checked against `like` and moved onto its tensors' devices."""
    if isinstance(like, dict):
        if not isinstance(saved, dict) or set(saved) != set(like):
            got = sorted(saved) if isinstance(saved, dict) else type(saved).__name__
            raise ValueError(f"checkpoint {where or 'root'}: keys {got}, expected {sorted(like)}")
        return {k: _restore(saved[k], v, f"{where}/{k}") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(like):
            raise ValueError(f"checkpoint {where}: expected a sequence of {len(like)}, got {type(saved).__name__}")
        return type(like)(_restore(s, v, f"{where}/{i}") for i, (s, v) in enumerate(zip(saved, like)))
    if isinstance(like, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise ValueError(f"checkpoint {where}: expected a tensor, got {type(saved).__name__}")
        if saved.shape != like.shape or saved.dtype != like.dtype:
            raise ValueError(f"checkpoint {where}: {saved.dtype} {tuple(saved.shape)}, expected "
                             f"{like.dtype} {tuple(like.shape)}")
        return saved.to(like.device)
    if type(saved) is not type(like):
        raise ValueError(f"checkpoint {where}: {type(saved).__name__}, expected {type(like).__name__}")
    return saved


def load_checkpoint(path: str | Path, like: dict, world=None) -> dict:
    """Restore a checkpoint directory with `like` as the structure, shape,
    dtype and device spec.  On a rank of `world`, `like` is the rank's
    state, the checkpoint the whole image's, and the rank keeps its rows
    (collective)."""
    saved = torch.load(Path(path).absolute() / STATE_FILE, map_location="cpu", weights_only=True)
    if world is None:
        return _restore(saved, like, "")
    from nebulae_tpu_torch.dist.mesh import shard_frame_state
    from nebulae_tpu_torch.dist.runner import gather_state

    return shard_frame_state(world, _restore(saved, gather_state(world, like), ""))


def latest_step_dir(root: str | Path) -> str | None:
    root = Path(root)
    if not root.exists():
        return None
    steps = sorted(p for p in root.iterdir() if p.name.startswith("step_"))
    return str(steps[-1]) if steps else None
