"""The reference's ray casting: every ray against the triangles of every
cluster whose box it enters, in plain PyTorch.

The acceleration structure is the reference's own and deliberately simple:
triangles in their scene order are cut into runs of `cluster` triangles,
each run gets its bounding box, a ray is tested against the boxes and
then, block by block, against every triangle of each box it enters.  The
closest hit over all tested triangles wins, the lowest triangle index on
an exact tie, as a brute-force loop over the triangles in order gives.
The intersection is two-sided Moller-Trumbore with EPS = 1e-7 on both the
determinant and the near distance, the program's stated convention.
"""

from __future__ import annotations

import torch

EPS = 1e-7
BLOCK = 1 << 22  # ray x triangle pairs per block
RAY_CHUNK = 1 << 18  # rays per box test


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def ray_triangle(o, d, v0, e1, e2, t_max):
    """[R, 1, 3] rays against [1, K, 3] triangles -> (t [R, K], inf on a
    miss; u, v)."""
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    ok = torch.abs(det) >= EPS
    inv = torch.where(ok, 1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    tvec = o - v0
    u = _dot(tvec, pvec) * inv
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv
    t = _dot(e2, qvec) * inv
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS) & (t < t_max)
    return torch.where(hit, t, float("inf")), u, v


class ClusterTracer:
    """Closest-hit and any-hit queries over float32 triangles [T, 3, 3]."""

    def __init__(self, tri_pos: torch.Tensor, cluster: int = 2048):
        self.block = BLOCK * (4 if tri_pos.is_cuda else 1)
        self.v0 = tri_pos[:, 0].float().contiguous()
        self.e1 = (tri_pos[:, 1] - tri_pos[:, 0]).float().contiguous()
        self.e2 = (tri_pos[:, 2] - tri_pos[:, 0]).float().contiguous()
        t = tri_pos.shape[0]
        self.starts = list(range(0, t, cluster))
        self.ends = [min(s + cluster, t) for s in self.starts]
        lo = [tri_pos[s:e].reshape(-1, 3).amin(0) for s, e in zip(self.starts, self.ends)]
        hi = [tri_pos[s:e].reshape(-1, 3).amax(0) for s, e in zip(self.starts, self.ends)]
        pad = 1e-4
        self.box_lo = (torch.stack(lo) - pad).float() if lo else tri_pos.new_zeros((0, 3))
        self.box_hi = (torch.stack(hi) + pad).float() if hi else tri_pos.new_zeros((0, 3))
        self.pair_tests = 0

    def _boxes(self, o, d, t_max):
        """[R, C] mask of the boxes each ray enters before t_max."""
        inv = 1.0 / torch.where(d == 0.0, torch.full_like(d, 1e-30), d)
        t0 = (self.box_lo[None] - o[:, None]) * inv[:, None]
        t1 = (self.box_hi[None] - o[:, None]) * inv[:, None]
        near = torch.minimum(t0, t1).amax(-1)
        far = torch.maximum(t0, t1).amin(-1)
        return (near <= far) & (far >= 0.0) & (near < t_max[:, None])

    def closest(self, o, d, t_max=None):
        """-> dict(t [R] (inf on a miss), tri [R] int64 (-1), u, v)."""
        n = o.shape[0]
        if n > RAY_CHUNK:
            parts = [self.closest(o[s:s + RAY_CHUNK], d[s:s + RAY_CHUNK],
                                  None if t_max is None else t_max[s:s + RAY_CHUNK]) for s in range(0, n, RAY_CHUNK)]
            return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        dev = o.device
        o = o.detach().float()
        d = d.detach().float()
        t_max = torch.full((n,), float("inf"), device=dev) if t_max is None else t_max.float()
        best_t = torch.full((n,), float("inf"), device=dev)
        best_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
        best_u = torch.zeros(n, device=dev)
        best_v = torch.zeros(n, device=dev)
        if n == 0 or not self.starts:
            return {"t": best_t, "tri": best_tri, "u": best_u, "v": best_v}
        enter = self._boxes(o, d, t_max)
        for c, (s, e) in enumerate(zip(self.starts, self.ends)):
            rays = torch.nonzero(enter[:, c])[:, 0]
            if rays.numel() == 0:
                continue
            k = e - s
            step = max(1, self.block // k)
            for r0 in range(0, rays.numel(), step):
                idx = rays[r0:r0 + step]
                t, u, v = ray_triangle(o[idx, None], d[idx, None], self.v0[None, s:e], self.e1[None, s:e],
                                       self.e2[None, s:e], t_max[idx, None])
                self.pair_tests += idx.numel() * k
                tmin, arg = torch.min(t, dim=1)
                better = tmin < best_t[idx]
                win = idx[better]
                a = arg[better]
                best_t[win] = tmin[better]
                best_tri[win] = s + a
                best_u[win] = torch.gather(u[better], 1, a[:, None])[:, 0]
                best_v[win] = torch.gather(v[better], 1, a[:, None])[:, 0]
        return {"t": best_t, "tri": best_tri, "u": best_u, "v": best_v}

    def occluded(self, o, d, t_max=None):
        """-> [R] bool: some triangle lies on the ray before t_max."""
        n = o.shape[0]
        if n > RAY_CHUNK:
            return torch.cat([self.occluded(o[s:s + RAY_CHUNK], d[s:s + RAY_CHUNK],
                                            None if t_max is None else t_max[s:s + RAY_CHUNK])
                              for s in range(0, n, RAY_CHUNK)])
        dev = o.device
        o = o.detach().float()
        d = d.detach().float()
        t_max = torch.full((n,), float("inf"), device=dev) if t_max is None else t_max.float()
        occ = torch.zeros(n, dtype=torch.bool, device=dev)
        if n == 0 or not self.starts:
            return occ
        enter = self._boxes(o, d, t_max)
        for c, (s, e) in enumerate(zip(self.starts, self.ends)):
            rays = torch.nonzero(enter[:, c] & ~occ)[:, 0]
            if rays.numel() == 0:
                continue
            k = e - s
            step = max(1, self.block // k)
            for r0 in range(0, rays.numel(), step):
                idx = rays[r0:r0 + step]
                t, _, _ = ray_triangle(o[idx, None], d[idx, None], self.v0[None, s:e], self.e1[None, s:e],
                                       self.e2[None, s:e], t_max[idx, None])
                self.pair_tests += idx.numel() * k
                occ[idx] = occ[idx] | torch.isfinite(t).any(dim=1)
        return occ
