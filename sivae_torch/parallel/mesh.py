"""The collectives of data parallelism, and the checks around them.

Port of `sivae_tpu/parallel/mesh.py:1-110`. The JAX package shards each
global batch over a device mesh and lets GSPMD partition the jitted step: it
inserts the cross-replica sums of the BatchNorm statistics (so BN normalises
by the GLOBAL batch, `mesh.py:4-10`) and of the gradients (so each replica
takes the gradient of the global-batch loss). Here each card runs its own
eager step on its rows of the global batch, and the same sums are explicit:

- `all_reduce_` (BatchNorm's statistics and their cotangents,
  `models/blocks.py`), `average_gradients` (one bucketed mean of the
  `.grad`s after each backward, `train/step.py`), `global_mean` (a
  differentiable mean, where a batch mean enters a non-linear term) and
  `mean_across` (the epoch means, `train/loop.py`);
- `normal_rows` / `rand_rows`: draws with a batch axis are taken for the
  global batch and this rank's rows kept, so every rank's generator moves
  alike and the ranks' rows together are one process's draw;
- `replicate_state` checks that every rank holds the same train state.

Every function is the one-process identity (no collective) when no process
group is initialised or it has one process. `collectives` counts the
all-reduces and their bytes by kind, for the smoke run to print.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from sivae_torch.parallel.distributed import (_device_of_group, initialized, local_batch_slice,
                                              rank, world_size)

# all-reduces since the last `reset_collectives()`, by kind: "bn" (forward
# statistics), "bn_grad" (their cotangents), "grad" (gradient buckets),
# "loss" (differentiable means), "metrics" (epoch means); each [calls, bytes]
collectives: Dict[str, List[int]] = {}

# largest gradient bucket, in bytes
BUCKET_BYTES = 32 << 20


def reset_collectives() -> None:
    collectives.clear()


def all_reduce_(t: torch.Tensor, kind: str) -> torch.Tensor:
    """Sum `t` over the ranks, in place (counted under `kind`)."""
    calls = collectives.setdefault(kind, [0, 0])
    calls[0] += 1
    calls[1] += t.numel() * t.element_size()
    dist.all_reduce(t)
    return t


def mean_across(t: torch.Tensor, kind: str = "metrics") -> torch.Tensor:
    """The mean of `t` over the ranks (a new tensor); `t` in one process."""
    w = world_size()
    if w == 1:
        return t
    return all_reduce_(t.clone(), kind).div_(w)


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks of each rank's batch mean `t`, which is the
    global batch mean (the shards are equal), and differentiable: the
    backward sums each rank's cotangent over the ranks, as the global loss's
    gradient takes it. `t` in one process."""
    w = world_size()
    if w == 1:
        return t
    from torch.distributed.nn.functional import all_reduce

    calls = collectives.setdefault("loss", [0, 0])
    calls[0] += 1
    calls[1] += t.numel() * t.element_size()
    return all_reduce(t) / w


def average_gradients(params: Iterable[torch.Tensor]) -> None:
    """Replace each `.grad` of `params` that exists by its mean over the
    ranks, in buckets of one dtype of at most `BUCKET_BYTES`: the gradient
    of the global-batch loss, since each rank's loss is its shard's mean.
    Every rank holds gradients for the same parameters (the same graph)."""
    w = world_size()
    if w == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    buckets: List[List[torch.Tensor]] = []
    size = 0
    for g in grads:
        nbytes = g.numel() * g.element_size()
        if not buckets or buckets[-1][0].dtype != g.dtype or size + nbytes > BUCKET_BYTES:
            buckets.append([])
            size = 0
        buckets[-1].append(g)
        size += nbytes
    for bucket in buckets:
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in bucket]), "grad").div_(w)
        off = 0
        for g in bucket:
            g.copy_(flat[off:off + g.numel()].view(g.shape))
            off += g.numel()


def _rows(draw, shape: Sequence[int]) -> torch.Tensor:
    w = world_size()
    shape = tuple(shape)
    if w == 1:
        return draw(shape)
    return draw((shape[0] * w,) + shape[1:])[local_batch_slice(shape[0] * w)]


def normal_rows(shape: Sequence[int], generator: Optional[torch.Generator],
                device) -> torch.Tensor:
    """N(0, 1) fp32 of `shape`, whose first axis is this rank's rows of the
    global batch: `torch.randn` at the global batch, this rank's rows kept."""
    return _rows(lambda s: torch.randn(s, generator=generator, device=device,
                                       dtype=torch.float32), shape)


def rand_rows(shape: Sequence[int], generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """U[0, 1) fp32 of `shape`, drawn as `normal_rows` is."""
    return _rows(lambda s: torch.rand(s, generator=generator, device=device,
                                      dtype=torch.float32), shape)


def rank_generator(generator: torch.Generator, step: int) -> torch.Generator:
    """A generator of `generator`'s device for the activation-sized draws of
    one step (dropout masks), seeded from `generator`'s seed, the step and
    this rank: each rank draws other masks for its other volumes, and the
    state's own generator is left alone, so it stays the same on every rank."""
    seed = (generator.initial_seed() * 1_000_003 + step) * 65_537 + rank()
    return torch.Generator(device=generator.device).manual_seed(seed % (1 << 63))


def _bytes_of(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes()


def state_digest(state) -> bytes:
    """SHA-256 (16 bytes) over every parameter and buffer, both Adams'
    tensors and step counts, the generator's state and the step count."""
    h = hashlib.sha256()
    for name, t in state.model.state_dict().items():
        h.update(name.encode())
        h.update(_bytes_of(t))
    for opt in (state.opt_e, state.opt_d):
        if opt is None:
            continue
        for i, st in sorted(opt.state_dict()["state"].items()):
            for k in sorted(st):
                h.update(f"{i}/{k}".encode())
                h.update(_bytes_of(torch.as_tensor(st[k])))
    h.update(_bytes_of(state.generator.get_state()))
    h.update(str(int(state.step)).encode())
    return h.digest()[:16]


def replicate_state(state):
    """Check that every rank holds the same train state: each rank's
    `state_digest`, all-gathered, must be equal, else ValueError naming every
    rank's digest (`_assert_identical_across_processes`, `mesh.py:84-110`).
    It verifies and does not broadcast: a checkpoint restored on one rank
    only, or a construction that differs, fails here rather than train
    replicas that drift apart. Returns `state`; no collective without a
    process group."""
    if not initialized():
        return state
    mine = torch.from_numpy(np.frombuffer(state_digest(state), dtype=np.int64).copy())
    mine = mine.to(_device_of_group())
    gathered = [torch.empty_like(mine) for _ in range(world_size())]
    dist.all_gather(gathered, mine)
    digests = [g.cpu().numpy().tobytes().hex() for g in gathered]
    if len(set(digests)) != 1:
        raise ValueError(f"replicate_state: the train state differs across ranks (rank: "
                         f"digest {dict(enumerate(digests))}); every rank must construct or "
                         f"restore the same state")
    return state
