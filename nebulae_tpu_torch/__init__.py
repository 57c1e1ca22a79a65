"""Nebulae on PyTorch and CUDA: `nebulae_tpu`'s forward frame, train step,
large-scene routes, fat2 tables, dynamic scenes (BVH refit), the neural
radiance cache, glTF scenes and the app shell (`python -m
nebulae_tpu_torch.app`), ported.

A second package beside the JAX one.  Module names mirror `nebulae_tpu`
(`core/rng.py` <-> `core/rng.py`, ...); the traversal and a-trous kernels are
hand-written CUDA C++ under `csrc/`, built with nvcc at first use; the BVH
builder beside them is host C++, built with g++ at first use on either
device.  Entry points run on `cuda` unless the caller passes
`device="cpu"` (the app: `--device cpu`); on CPU tensors every kernel
wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"
