"""The radiance-cache MLP: 59 -> 64 x5 -> 3, ReLU, softplus head.

Counterpart of `nebulae_tpu/nrc/mlp.py`.  Parameters are a list of
{"w": [in, out], "b": [out]} float32 layers.  Each product takes bfloat16
operands and keeps a float32 result; the bias is added in float32, then
ReLU, then the activation is rounded to bfloat16 again.  JAX's transpose
of that product rounds its results to the operands' type, so every weight
gradient and every input gradient is bfloat16-representable while bias
gradients stay float32: `_BF16MLP` is that forward with that backward.
The head is jax.nn.softplus, logaddexp(z, 0) (F.softplus turns linear past
20), with JAX's derivative exp(z - softplus(z)).

On the card a forward product is `aten::mm.dtype` (bf16 x bf16 on the
tensor cores, float32 out).  On the CPU, which does not run that overload,
every product is taken in float64 and rounded to float32 once: the
products of bf16 values are exact, so this is the exact sum, rounded.  A
float32 sum in another order than XLA's moves an activation across a bf16
rounding boundary now and then, and through the later layers an output by
up to ~1%; the exact sum stays within a few tenths of a percent of XLA's.

The backward takes the exact sums on both devices where a weight needs a
gradient (the cache's own step, on batches of 16,384 records), and sums
bias gradients in float64: Adam's first steps move each weight by about
lr * sign(g), so a near-zero gradient summed in another order would move
a weight by up to 2 lr on one device and not the other.  Where only the
input needs a gradient (the outer train step's query, at full width) the
card's products are float32.
"""

from __future__ import annotations

import math

import torch
from torch.profiler import record_function

HIDDEN = 64
DEPTH = 5

# aten::mm.dtype (bf16 operands, float32 result), where this build has it.
MM_OUT_DTYPE = "dtype" in torch.ops.aten.mm.overloads()


def init_mlp(generator: torch.Generator, in_dim: int, hidden: int = HIDDEN, depth: int = DEPTH,
             out_dim: int = 3) -> list:
    """He-normal weights and zero biases on the CPU, drawn from `generator`."""
    params = []
    dims = [in_dim] + [hidden] * depth + [out_dim]
    for a, b in zip(dims[:-1], dims[1:]):
        w = torch.randn((a, b), generator=generator, dtype=torch.float32) * math.sqrt(2.0 / a)
        params.append({"w": w, "b": torch.zeros(b, dtype=torch.float32)})
    return params


def mlp_leaves(params: list) -> list:
    """[w0, b0, w1, b1, ...]."""
    return [t for layer in params for t in (layer["w"], layer["b"])]


def mlp_from_leaves(leaves) -> list:
    return [{"w": leaves[i], "b": leaves[i + 1]} for i in range(0, len(leaves), 2)]


def exact_product(a, b):
    """a @ b as the float64 product rounded once to float32."""
    return (a.double() @ b.double()).float()


def f32_product(a, b):
    """a @ b with a float32 result: float32 on the card, exact_product on
    the CPU."""
    if a.is_cuda:
        return a.float() @ b.float()
    return exact_product(a, b)


def bf16_product(a, b, upcast: bool = False):
    """a @ b of two bfloat16 matrices with a float32 result and no rounding
    before it: `aten::mm.dtype` on the card unless `upcast` asks for the
    float32 product of the upcast operands (or this build lacks it)."""
    if a.is_cuda and MM_OUT_DTYPE and not upcast:
        return torch.mm(a, b, out_dtype=torch.float32)
    return f32_product(a, b)


def _round_bf16(x):
    return x.to(torch.bfloat16).float()


def _softplus(z):
    return torch.logaddexp(z, z.new_zeros(()))


def _no_inf(x):
    return torch.where(x == float("inf"), 0.0, x)


def forward_layers(x, leaves, keep: bool = False, upcast: bool = False):
    """The layers up to the head's pre-activation z, from x [N, in] and
    [w0, b0, ...]: (z, acts, ws, gates).  With `keep`, acts and gates hold
    the bf16 inputs of each product and each hidden layer's ReLU gate (1
    above 0, 1/2 at 0 as jnp.maximum splits a tie, else 0) for the
    backward.  `upcast` takes bf16_product's upcast form on the card."""
    n = len(leaves) // 2
    h = x.to(torch.bfloat16)
    ws = [leaves[2 * i].to(torch.bfloat16) for i in range(n)]
    acts, gates = [], []
    for i in range(n):
        if keep:
            acts.append(h)
        z = bf16_product(h, ws[i], upcast) + leaves[2 * i + 1]
        if i < n - 1:
            if keep:
                gates.append(((z > 0.0).to(torch.bfloat16) + (z == 0.0).to(torch.bfloat16) * 0.5))
            h = torch.clamp(z, min=0.0).to(torch.bfloat16)
    return z, acts, ws, gates


class _BF16MLP(torch.autograd.Function):
    """x [N, in], then w0, b0, w1, b1, ... -> radiance [N, out], with
    JAX's derivatives: softplus', and bf16 rounding of weight and input
    gradients."""

    @staticmethod
    def forward(ctx, x, *leaves):
        z, acts, ws, gates = forward_layers(x, leaves, keep=True)
        out = _softplus(z)
        ctx.n = len(ws)
        ctx.save_for_backward(z, out, *acts, *ws, *gates)
        return out

    @staticmethod
    def backward(ctx, g):
        n = ctx.n
        z, out, *saved = ctx.saved_tensors
        acts, ws, gates = saved[:n], saved[n:2 * n], saved[2 * n:]
        need = ctx.needs_input_grad
        grads = [None] * (2 * n)
        gx = None
        lowest = 0 if need[0] else min(i for i in range(n) if need[1 + 2 * i] or need[2 + 2 * i])
        product = exact_product if any(need[1:]) else f32_product
        g = g * torch.exp(_no_inf(z) - _no_inf(out))
        for i in reversed(range(lowest, n)):
            if need[1 + 2 * i]:
                grads[2 * i] = _round_bf16(product(acts[i].T, g))
            if need[2 + 2 * i]:
                grads[2 * i + 1] = g.double().sum(0).float()
            if i > lowest or (i == 0 and need[0]):
                gh = _round_bf16(product(g, ws[i].T))
                if i == 0:
                    gx = gh
                else:
                    g = gh * gates[i - 1].float()
        return (gx, *grads)


def apply_mlp(params: list, x):
    """x [..., in_dim] -> radiance [..., 3] (softplus, non-negative)."""
    with record_function("nebulae/nrc_mlp"):
        leaves = mlp_leaves(params)
        x2 = x.reshape(-1, x.shape[-1])
        if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in leaves)):
            out = _BF16MLP.apply(x2, *leaves)
        else:
            out = _softplus(forward_layers(x2, leaves)[0])
        return out.reshape(*x.shape[:-1], out.shape[-1])
