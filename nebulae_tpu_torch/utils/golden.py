"""Golden-data dump and compare (as `nebulae_tpu/utils/golden.py`).

`dump_golden` writes a nested dict of arrays or tensors to an .npz, one key
per leaf ("a/b/c"); `compare_golden` reloads one and lists the leaves that
are missing, change shape or leave rtol / atol.  Tensors are copied to
numpy on the host first.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def to_numpy(x) -> np.ndarray:
    """A tensor (any device, detached) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten(tree: dict) -> dict:
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}/", v)
        else:
            flat[prefix.rstrip("/")] = to_numpy(node)

    walk("", tree)
    return flat


def dump_golden(path: str | Path, tree: dict) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **_flatten(tree))


def load_golden(path: str | Path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def compare_golden(path: str | Path, tree: dict, rtol=1e-5, atol=1e-6) -> list[str]:
    """Returns a list of mismatch descriptions (empty = all match)."""
    golden = load_golden(path)
    flat = _flatten(tree)
    problems = []
    for k, v in golden.items():
        if k not in flat:
            problems.append(f"missing key {k}")
        elif v.shape != flat[k].shape:
            problems.append(f"{k}: shape {flat[k].shape} != golden {v.shape}")
        elif not np.allclose(flat[k], v, rtol=rtol, atol=atol):
            err = np.abs(np.asarray(flat[k], np.float64) - v).max()
            problems.append(f"{k}: max abs err {err}")
    return problems
