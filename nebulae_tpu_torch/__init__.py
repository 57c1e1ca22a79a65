"""Nebulae on PyTorch and CUDA: the forward frame of `nebulae_tpu`, ported.

A second package beside the JAX one.  Module names mirror `nebulae_tpu`
(`core/rng.py` <-> `core/rng.py`, ...); the traversal and a-trous kernels are
hand-written CUDA C++ under `csrc/`, built with nvcc at first use.  Entry
points run on `cuda` unless the caller passes `device="cpu"`; on CPU tensors
every kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"
