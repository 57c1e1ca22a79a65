"""XorShift32 RNG with Jenkins-hash seeding, bit-exact with `nebulae_tpu`.

PyTorch on the CPU has no right shift for uint32, and `>>` on int32 is
arithmetic, so the 32-bit state is carried in int64 tensors masked to
[0, 2^32): every shift is then a logical shift of the low 32 bits.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def jenkins_hash(x):
    """Jenkins one-at-a-time style avalanche hash on 32-bit values (int64)."""
    x = x & _U32
    x = (x + (x << 10)) & _U32
    x = x ^ (x >> 6)
    x = (x + (x << 3)) & _U32
    x = x ^ (x >> 11)
    x = (x + (x << 15)) & _U32
    return x


def init_rng(pixel_x, pixel_y, width: int, frame):
    """State from pixel coordinate and frame: H((x + y*w) ^ H(frame))."""
    px = pixel_x.to(torch.int64)
    py = pixel_y.to(torch.int64)
    f = torch.as_tensor(frame, dtype=torch.int64, device=px.device)
    seed = ((px + py * int(width)) & _U32) ^ jenkins_hash(f)
    state = jenkins_hash(seed)
    # Zero is a fixed point of xorshift; nudge it.
    return torch.where(state == 0, torch.full_like(state, 0x9E3779B9), state)


def xorshift32(state):
    state = state ^ ((state << 13) & _U32)
    state = state ^ (state >> 17)
    state = state ^ ((state << 5) & _U32)
    return state


def uint_to_unit_float(bits):
    """32-bit value -> float32 in [0, 1): asfloat(0x3f800000 | x >> 9) - 1."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def next_float(state):
    """Advance the state; return (new_state, uniform float32 in [0, 1))."""
    state = xorshift32(state)
    return state, uint_to_unit_float(state)
