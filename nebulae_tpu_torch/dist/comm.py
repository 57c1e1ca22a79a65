"""The collectives of a sharded frame and train step, written out by hand.

JAX declares shardings and XLA's partitioner inserts the gradient psums,
the halo exchanges of SVGF's stencils and the gathers behind reprojection.
Here every collective the port issues goes through this module, and each
call appends {"op", "tag", "dtype", "bytes", "sent", "ms"} to world.log:
the torch.distributed op, what it carried, the bytes of its result on
this rank (JAX's measure, an HLO collective's output shape), the bytes
this rank put in (an all-gather's result is world.size times that), and
the host milliseconds of the call, staging included.  Under gloo
a CUDA tensor goes through host memory (gloo takes only some collectives
on CUDA tensors, so all of them are staged alike).

  all_reduce_sum    sum over ranks (gradients, the loss, counters)
  all_gather_rows   the full image from every rank's rows (differentiable)
  broadcast         rank `src`'s tensor on every rank
  broadcast_json    rank 0's JSON value on every rank
  any_rank          a host decision taken the same on every rank
  exchange_rows     a rank's rows with `band` halo rows from the ranks that
                    own them (differentiable)
  barrier           every rank waits for the others
"""

from __future__ import annotations

import json
import time

import torch
import torch.distributed as dist

from nebulae_tpu_torch.dist.mesh import World


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _record(world: World, op: str, tag: str, out, sent: int, t0: float) -> None:
    world.log.append({"op": op, "tag": tag, "dtype": str(out.dtype).removeprefix("torch."),
                      "bytes": _nbytes(out), "sent": sent, "ms": (time.perf_counter() - t0) * 1e3})


def all_reduce_sum(world: World, t, tag: str = "sum"):
    """The sum of `t` over ranks, on every rank (a new tensor, no gradient)."""
    t0 = time.perf_counter()
    buf = t.detach().to(world.comm_device, copy=True).contiguous()
    dist.all_reduce(buf)
    out = buf.to(world.device)
    _record(world, "all_reduce", tag, out, _nbytes(buf), t0)
    return out


def _all_gather(world: World, t, tag: str):
    t0 = time.perf_counter()
    buf = t.detach().to(world.comm_device).contiguous()
    parts = [torch.empty_like(buf) for _ in range(world.size)]
    dist.all_gather(parts, buf)
    out = torch.cat(parts).to(world.device)
    _record(world, "all_gather", tag, out, _nbytes(buf), t0)
    return out


def broadcast(world: World, t, src: int = 0, tag: str = "broadcast"):
    """Rank `src`'s `t` on every rank (a new tensor)."""
    t0 = time.perf_counter()
    buf = t.detach().to(world.comm_device, copy=True).contiguous()
    dist.broadcast(buf, src)
    out = buf.to(world.device)
    _record(world, "broadcast", tag, out, _nbytes(buf) if world.rank == src else 0, t0)
    return out


def broadcast_json(world: World, obj, tag: str = "json"):
    """Rank 0's `obj` (a JSON value; the others' is ignored) on every rank."""
    data = json.dumps(obj).encode() if world.rank == 0 else b""
    n = int(broadcast(world, torch.tensor([len(data)], dtype=torch.int64), tag=tag)[0])
    buf = torch.frombuffer(bytearray(data), dtype=torch.uint8) if data else torch.zeros(n, dtype=torch.uint8)
    return json.loads(bytes(broadcast(world, buf, tag=tag).cpu().numpy()))


def barrier(world: World, tag: str = "barrier") -> None:
    t0 = time.perf_counter()
    dist.barrier()
    _record(world, "barrier", tag, torch.empty(0), 0, t0)


def any_rank(world: World, flag) -> bool:
    """True on every rank when `flag` (a bool tensor) is true on any: a host
    branch that runs collectives must be taken alike on all ranks."""
    return bool(all_reduce_sum(world, flag.reshape(1).to(torch.int32), "flag")[0] > 0)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world, tag):
        ctx.world = world
        ctx.rows = x.shape[0]
        return _all_gather(world, x, tag)

    @staticmethod
    def backward(ctx, grad):
        # Every rank's copy of the image fed its own loss: sum the copies'
        # cotangents, then keep this rank's rows.
        world, h = ctx.world, ctx.rows
        total = all_reduce_sum(world, grad, "rows_grad")
        return total[world.rank * h:(world.rank + 1) * h], None, None


def all_gather_rows(world: World, x, tag: str = "rows"):
    """Every rank's x [h, ...] joined in rank order: [n*h, ...] on every rank."""
    return _GatherRows.apply(x, world, tag)


def halo_rows(world: World, h: int, band: int) -> tuple[int, int]:
    """The halo rows (above, below) of a rank that owns h rows: `band`
    rows, fewer at the image's real top and bottom."""
    return min(band, world.rank * h), min(band, (world.size - 1 - world.rank) * h)


def _halo_index(world: World, h: int, band: int, device) -> tuple:
    """Where the halo rows sit in the all-gathered edge pieces: each rank
    sends its first and last k = min(band, h) rows, so piece q holds rank
    q's rows [0, k) at [2kq, 2kq + k) and [h - k, h) at [2kq + k, 2kq + 2k).
    A halo row more than h rows away lies on a rank that sends all of its
    rows (k == h), so every halo row is in some piece."""
    k = min(band, h)
    top, bot = halo_rows(world, h, band)
    r0 = world.rank * h

    def pos(g):
        q, i = divmod(g, h)
        return 2 * k * q + (i if i < k else k + i - (h - k))

    above = [pos(g) for g in range(r0 - top, r0)]
    below = [pos(g) for g in range(r0 + h, r0 + h + bot)]
    return (k, torch.tensor(above, dtype=torch.long, device=device),
            torch.tensor(below, dtype=torch.long, device=device))


class _Band(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world, band):
        h = x.shape[0]
        k, above, below = _halo_index(world, h, band, x.device)
        pieces = _all_gather(world, torch.cat([x[:k], x[h - k:]]), "band")
        ctx.world, ctx.k, ctx.h = world, k, h
        ctx.save_for_backward(above, below)
        return torch.cat([pieces[above], x, pieces[below]])

    @staticmethod
    def backward(ctx, grad):
        # Each halo row's cotangent goes back to the rank that owns the row,
        # which adds it to its own: one all-reduce of the edge pieces.
        world, k, h = ctx.world, ctx.k, ctx.h
        above, below = ctx.saved_tensors
        top = above.shape[0]
        sent = grad.new_zeros((world.size * 2 * k,) + tuple(grad.shape[1:]))
        sent[above] = grad[:top]
        sent[below] = grad[top + h:]
        mine = all_reduce_sum(world, sent, "band_grad")[2 * k * world.rank:2 * k * (world.rank + 1)]
        own = grad[top:top + h].clone()
        own[:k] += mine[:k]
        own[h - k:] += mine[k:]
        return own, None, None


def exchange_rows(world: World, x, band: int):
    """x [h, ...] (this rank's rows) -> (padded [top + h + bot, ...], top,
    bot): the `band` rows above and below from whichever ranks own them,
    none past the image's real top and bottom.  Differentiable in x."""
    top, bot = halo_rows(world, x.shape[0], band)
    return _Band.apply(x, world, band), top, bot
