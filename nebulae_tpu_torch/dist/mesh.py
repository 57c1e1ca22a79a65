"""Process-group bring-up, the rank's place in the image, and the frame
state's sharding (as `nebulae_tpu/dist/mesh.py`).

Image rows shard over ranks: rank r of n owns rows [r*H/n, (r+1)*H/n), and
H % n != 0 raises ValueError.  Of the frame state only the SVGF history's
image-space leaves shard; everything else replicates.  (JAX's rule shards
any leaf whose leading dimension divides the mesh, which is placement
there; here it would cut a 4x4 view-projection into rows.)

Backend rule, fixed before init_process_group and logged: NCCL when each
rank has a GPU of its own (torch.cuda.device_count() >= world size; rank
r on cuda:r % count), else gloo, whose collectives the port stages through
host memory (comm.py).  Nothing retries with another backend.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from datetime import timedelta

import torch
import torch.distributed as dist

from nebulae_tpu_torch.device import resolve_device
from nebulae_tpu_torch.utils.logging import log_info

# The SVGF history's leaves that hold one value per pixel: they shard with
# the rows; prev_viewproj and prev_eye replicate.
IMAGE_KEYS = ("radiance", "depth", "normal", "moments", "histlen")
# Entries kept in World.log (a bounded window over a long run).
LOG_ENTRIES = 1 << 16


def check_rows(height: int, size: int) -> None:
    if height % size:
        raise ValueError(f"height {height} must divide over the {size} ranks (row-sharded image)")


@dataclass
class World:
    """One rank's view of the process group: its rank, the world size, the
    device it computes on, the backend, and the log of its collectives
    (comm.py appends one dict per call)."""

    rank: int
    size: int
    device: torch.device
    backend: str
    log: deque = field(default_factory=lambda: deque(maxlen=LOG_ENTRIES))

    @property
    def comm_device(self) -> torch.device:
        """Where collectives run: the device under NCCL, the host under gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def rows(self, height: int) -> tuple[int, int]:
        """This rank's global rows [r0, r1) of an image `height` rows high."""
        check_rows(height, self.size)
        h = height // self.size
        return self.rank * h, (self.rank + 1) * h

    def close(self) -> None:
        dist.destroy_process_group()


def rank_device(device, rank: int) -> torch.device:
    """The rank's compute device: CUDA unless "cpu" is asked for; a CUDA
    request without an index takes cuda:rank % device_count."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def pick_backend(device: torch.device, world_size: int) -> str:
    """NCCL when every rank has a GPU of its own, else gloo."""
    if device.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def init_distributed(coordinator: str | None = None, num_processes: int = 1, process_id: int = 0,
                     device=None, init_method: str | None = None, timeout_s: float = 300.0) -> World:
    """Join the process group and return this rank's World.  The group
    meets at `coordinator` ("host:port", a TCP store on rank 0, as
    jax.distributed's coordinator) or at `init_method` (any URL
    init_process_group takes, such as file:///path); a world of one needs
    neither.  Every collective fails after `timeout_s`, so a rank that
    raises does not leave its peers waiting for ever."""
    if coordinator is not None:
        init_method = f"tcp://{coordinator}"
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not a rank of a {num_processes}-process world")
    if init_method is None and num_processes > 1:
        raise ValueError("a multi-process world needs a coordinator address or an init method")
    dev = rank_device(device, process_id)
    backend = pick_backend(dev, num_processes)
    log_info(f"dist: rank {process_id} of {num_processes} on {dev}, backend {backend} "
             f"({torch.cuda.device_count() if dev.type == 'cuda' else 0} GPUs visible)")
    if backend == "nccl":
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, world_size=num_processes, rank=process_id, timeout=timedelta(seconds=timeout_s))
    if init_method is None:
        dist.init_process_group(store=dist.HashStore(), **kw)
    else:
        dist.init_process_group(init_method=init_method, **kw)
    return World(process_id, num_processes, dev, backend)


def shard_frame_state(world: World, state: dict) -> dict:
    """The rank's rows of a full-height frame state: the SVGF history's
    image-space leaves are cut to the rank's rows, every other entry (the
    view-projection, the eye, counters, the radiance cache) is kept."""
    out = dict(state)
    if "svgf" in state:
        hist = dict(state["svgf"])
        r0, r1 = world.rows(hist["radiance"].shape[0])
        for k in IMAGE_KEYS:
            hist[k] = hist[k][r0:r1].contiguous()
        out["svgf"] = hist
    return out
