"""The least traffic of a ray cast, whatever the acceleration structure:
each ray reads its origin, direction and extent once and writes its result
once, and each call reads the scene's triangles (three float32 vertices)
once.  Counted at the tracer's entry, so neither the tables' layout, the
route nor the walk changes the count."""

F32 = 4
TRIANGLE_BYTES = 9 * F32
RAY_IN = 3 * F32 + 3 * F32 + F32  # origin, direction, extent
HIT_OUT = 4 * F32  # t, triangle, u, v
OCCLUDED_OUT = 1


def closest_bytes(n_rays: int, n_tris: int) -> int:
    return n_rays * (RAY_IN + HIT_OUT) + n_tris * TRIANGLE_BYTES


def any_bytes(n_rays: int, n_tris: int) -> int:
    return n_rays * (RAY_IN + OCCLUDED_OUT) + n_tris * TRIANGLE_BYTES


def combo_bytes(n_rays: int, n_tris: int) -> int:
    """A shadow ray and a bounce ray from one origin: the origin once, two
    directions and two extents, a hit record and an occlusion flag."""
    return n_rays * (3 * F32 + 2 * (3 * F32 + F32) + HIT_OUT + OCCLUDED_OUT) + n_tris * TRIANGLE_BYTES


BYTES = {"closest": closest_bytes, "any": any_bytes, "combo": combo_bytes}


def call_bytes(kind: str, n_rays: int, n_tris: int) -> int:
    return BYTES[kind](n_rays, n_tris)
