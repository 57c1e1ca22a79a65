"""The least work of one a-trous pass over an h x w image: it reads each
pixel's radiance, variance, depth and normal once and writes its filtered
radiance and weight sum once; per pixel 25 taps of about 30 float32
operations each (edge stops, weight, sums) and 12 more."""

F32 = 4
IN_BYTES = (3 + 1 + 1 + 3) * F32
OUT_BYTES = (3 + 1) * F32
OPS_TAP, TAPS, OPS_PIXEL = 30, 25, 12


def pass_bytes(h: int, w: int) -> int:
    return h * w * (IN_BYTES + OUT_BYTES)


def pass_ops(h: int, w: int) -> int:
    return h * w * (OPS_TAP * TAPS + OPS_PIXEL)


def bwd_pass_bytes(h: int, w: int) -> int:
    """The backward of a pass (the transposed stencil): it reads the
    output's cotangent, the forward's weight sums and the pass's inputs once
    and writes the radiance's cotangent once."""
    return h * w * ((3 + 1) * F32 + IN_BYTES + 3 * F32)
