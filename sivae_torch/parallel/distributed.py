"""Processes joined for data parallelism: one process per card.

Port of `sivae_tpu/parallel/distributed.py:20-54`. The JAX package joins
hosts with `jax.distributed.initialize` (JAX_COORDINATOR_ADDRESS /
JAX_NUM_PROCESSES / JAX_PROCESS_ID) and runs one GSPMD program over every
device. Here each card has its own process, joined by `torch.distributed`
from the launcher's environment (torchrun's `RANK`, `WORLD_SIZE`,
`LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`; the train CLI sets the same
variables for the processes it spawns itself). Each process feeds its own
rows of the global batch (`local_batch_slice`) and the collectives of
`parallel/mesh.py` make the step compute what one process would compute on
the whole global batch.

Without a launcher's environment nothing is initialised and every helper
here answers as one process does: rank 0 of 1, no collective.

Depth sharding (`sivae_tpu/parallel/mesh.py:46-81`, `volume_sharding`) lays
the processes out as a grid of `data x spatial` ranks (`set_grid`, called by
`parallel.mesh.make_mesh`): rank `d * spatial + s` feeds the rows of data
index `d` and the depth slab of spatial index `s`. Without a grid every
process is a data rank (`data = world`, `spatial = 1`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.distributed as dist


def launched() -> bool:
    """True when a launcher (torchrun, or the train CLI's own spawn) set the
    environment of a process group."""
    return "WORLD_SIZE" in os.environ


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


@dataclass(frozen=True)
class Grid:
    """This process's place in a `data x spatial` grid of ranks.

    `spatial_group` holds the ranks that feed this rank's rows (one per depth
    slab): the per-sample voxel sums are reduced over it. `data_group` holds
    the ranks that feed this rank's depth slab (one per row shard): the
    dp_semantics batch means are reduced over it. A group is None where it
    has one rank (nothing to reduce); it is `dist.group.WORLD` where it holds
    every rank. Depth neighbours are the global ranks `rank() - 1` and
    `rank() + 1`."""

    data: int
    spatial: int
    data_index: int
    spatial_index: int
    spatial_group: Optional[object] = None
    data_group: Optional[object] = None


_GRID: Optional[Grid] = None


def grid() -> Grid:
    """The grid `set_grid` made, else every process a data rank."""
    if _GRID is not None:
        return _GRID
    world = world_size()
    return Grid(world, 1, rank(), 0, None, dist.group.WORLD if world > 1 else None)


def set_grid(data: int, spatial: int) -> Grid:
    """Lay the process group out as `data x spatial` ranks and make it this
    process's grid. Every rank must call it with the same shape (it creates
    one group per data index and one per spatial index, each on every rank
    and in the same order, as `dist.new_group` requires)."""
    global _GRID
    world = world_size()
    if data < 1 or spatial < 1 or data * spatial != world:
        raise ValueError(f"a {data} x {spatial} grid needs {data * spatial} processes, "
                         f"there are {world}")
    rk = rank()

    def groups(members):
        """One group per member list (each rank creates all of them); this
        rank's own, None for a group of one, WORLD for all ranks."""
        mine = None
        for ranks in members:
            if len(ranks) == 1:
                g = None
            elif len(ranks) == world:
                g = dist.group.WORLD
            else:
                g = dist.new_group(ranks)
            if rk in ranks:
                mine = g
        return mine

    spatial_group = groups([[d * spatial + s for s in range(spatial)] for d in range(data)])
    data_group = groups([[d * spatial + s for d in range(data)] for s in range(spatial)])
    _GRID = Grid(data, spatial, rk // spatial, rk % spatial, spatial_group, data_group)
    return _GRID


def spatial_ranks() -> int:
    """The number of depth slabs a volume is cut into (1 without a grid)."""
    return grid().spatial


def is_main_process() -> bool:
    """Rank 0 (or the only process): the one that writes the run's files."""
    return rank() == 0


def init_distributed(backend: Optional[str] = None,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Optional[torch.device]:
    """Join the launcher's process group; a no-op (None) without a launcher,
    as the JAX function is in one process.

    Returns this rank's device: `cuda:LOCAL_RANK`, made the current device,
    or the CPU when `device` is "cpu" or there is no CUDA. The backend is
    NCCL on CUDA and gloo on the CPU; `backend` overrides it, for callers
    that put two ranks on one card (NCCL refuses that). A failure to join
    raises: nothing falls back to one process.
    """
    if not launched():
        return None
    world = int(os.environ["WORLD_SIZE"])
    rk = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", str(rk)))
    cpu = (device is not None and torch.device(device).type == "cpu") or \
        not torch.cuda.is_available()
    dev = torch.device("cpu") if cpu else torch.device("cuda", local)
    if not cpu:
        torch.cuda.set_device(dev)
    backend = backend or ("gloo" if cpu else "nccl")
    # NCCL binds its communicator to the rank's card at once
    bind = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method="env://", rank=rk, world_size=world, **bind)
    return dev


def shutdown() -> None:
    """Leave the process group, if this process joined one, and its grid."""
    global _GRID
    _GRID = None
    if initialized():
        dist.destroy_process_group()


def local_batch_slice(global_batch: int) -> slice:
    """The rows of a global batch that this process feeds
    (`sivae_tpu/parallel/distributed.py:48-54`): its data index's share. The
    global batch must divide by the number of data ranks: every rank's
    BatchNorm and loss means count equal shards."""
    g = grid()
    if global_batch % g.data:
        raise ValueError(f"global batch {global_batch} does not divide by {g.data} data ranks")
    per = global_batch // g.data
    return slice(g.data_index * per, (g.data_index + 1) * per)


def _device_of_group() -> torch.device:
    """Where a small tensor made for a collective lives: the current card
    under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    if initialized():
        dist.barrier()


def main_decides(flag: bool) -> bool:
    """Rank 0's `flag`, on every rank (a broadcast), so that all ranks take
    the branch rank 0 took; `flag` itself in one process."""
    if not initialized():
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=_device_of_group())
    dist.broadcast(t, 0)
    return bool(t.item())
