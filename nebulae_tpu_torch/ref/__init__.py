"""The reference path tracer (brute force), the oracle of the port's
frames and gradients."""

from nebulae_tpu_torch.ref.tracer import (  # noqa: F401
    intersect_any,
    intersect_closest,
    path_trace,
    render_direct,
    render_gbuffer,
    shade_direct,
)
