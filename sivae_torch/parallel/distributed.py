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
"""

from __future__ import annotations

import os
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
    """Leave the process group, if this process joined one."""
    if initialized():
        dist.destroy_process_group()


def local_batch_slice(global_batch: int) -> slice:
    """The rows of a global batch that this process feeds
    (`sivae_tpu/parallel/distributed.py:48-54`). The global batch must
    divide by the number of processes: every rank's BatchNorm and loss
    means count equal shards."""
    world, rk = world_size(), rank()
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} does not divide by {world} processes")
    per = global_batch // world
    return slice(rk * per, (rk + 1) * per)


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
