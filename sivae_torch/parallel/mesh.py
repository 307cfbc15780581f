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

Depth sharding (`volume_sharding`, `mesh.py:46-81`): `make_mesh((d, s),
("data", "spatial"))` lays the processes out as a grid (`distributed.set_grid`)
and `shard_batch` gives each rank its rows and its depth slab
(`volume_slab`: split at the latent's depth, so every pool stays local).
GSPMD partitions the JAX step with no change to it; here the model and the
step see the grid:
- the 3x3x3 convs exchange halo planes with their depth neighbours
  (`parallel/halo.py`, `models/blocks.py`);
- BatchNorm's statistics are the whole grid's (`all_reduce_`);
- the per-sample voxel and latent sums are partial on a slab: `spatial_sum`
  adds them over the ranks of the same rows. Every rank of those rows then
  holds the same loss, so the backward of that sum is the identity: each
  partial sum takes the loss's cotangent once (a differentiable all-reduce
  would hand it the sum of the P equal cotangents, P times the gradient).
  The other way round, a whole value that enters a computation on the
  slab (dp_semantics' batch-mean reconstruction term beside a per-position
  KL) takes only its slab's part of the cotangent on each rank:
  `spatial_broadcast` adds those parts up in the backward;
- the gradients are each rank's partial gradient of its rows' loss: their
  sum over the spatial ranks is the gradient of that loss, the mean over
  the data ranks the global batch's (`average_gradients`: the sum over every
  rank over the number of data ranks);
- the latent draws keep this rank's depth slab (`normal_rows`), and
  `gather_depth` puts whole latents back together;
- a Linear between a slab and a whole value (the FC family's heads, the
  lucky AE's, the classifier's over its pool) is split by the slab
  (`linear_from_slab`, `linear_to_slab`, `linear_of_partial_sums`): each
  rank computes its slab's part with its slab's columns or rows of the
  whole weight, so its gradient is that part's alone, as every other
  parameter's is. A Linear run whole on every spatial rank would take the
  whole gradient on each of them, P times the right one after the sum over
  the grid. A flat latent is whole on every spatial rank of its rows: its
  draws are the same there and its losses are not summed over the slabs.

Every function is the one-process identity (no collective) when no process
group is initialised or it has one process. `collectives` counts the
all-reduces, the halo exchanges and their bytes by kind, for the smoke run
to print.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils._pytree import tree_map

from sivae_torch.models.remat import active_tape
from sivae_torch.parallel.distributed import (Grid, _device_of_group, grid, initialized,
                                              local_batch_slice, rank, set_grid, world_size)
from sivae_torch.utils.dtypes import widen

# collectives since the last `reset_collectives()`, by kind: "bn" (forward
# statistics), "bn_grad" (their cotangents), "grad" (gradient buckets),
# "loss" (differentiable means), "metrics" (epoch means), "spatial" (the
# per-sample sums over a volume's slabs), "gather" (`gather_depth`), "halo"
# (halo exchanges, forward and backward: bytes sent) and "halo_host" (the
# bytes a halo exchange copied through the host); each [calls, bytes]
collectives: Dict[str, List[int]] = {}

# largest gradient bucket, in bytes
BUCKET_BYTES = 32 << 20


def reset_collectives() -> None:
    collectives.clear()


def count(kind: str, nbytes: int) -> None:
    calls = collectives.setdefault(kind, [0, 0])
    calls[0] += 1
    calls[1] += nbytes


def all_reduce_(t: torch.Tensor, kind: str, group=None) -> torch.Tensor:
    """Sum `t` over the ranks of `group` (every rank: None), in place
    (counted under `kind`)."""
    count(kind, t.numel() * t.element_size())
    dist.all_reduce(t, group=group)
    return t


def mean_across(t: torch.Tensor, kind: str = "metrics") -> torch.Tensor:
    """The mean of `t` over the ranks (a new tensor); `t` in one process."""
    w = world_size()
    if w == 1:
        return t
    return all_reduce_(t.clone(), kind).div_(w)


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean over the data ranks of each one's batch mean `t`, which is
    the global batch mean (the shards are equal), and differentiable: the
    backward sums each rank's cotangent over the data ranks, as the global
    loss's gradient takes it. Under depth sharding `t` must be whole (its
    per-sample sums taken over the slabs first, `spatial_sum`): it is reduced
    over the ranks of this rank's slab. `t` in one process."""
    g = grid()
    if g.data == 1:
        return t
    from torch.distributed.nn.functional import all_reduce

    count("loss", t.numel() * t.element_size())
    return all_reduce(t, group=g.data_group) / g.data


class _SpatialSum(torch.autograd.Function):
    """The sum of `t` over the spatial ranks of this rank's rows; the
    backward hands the cotangent on unchanged (module docstring: every one of
    those ranks holds the same cotangent of the whole sum). Inside a
    rematerialised region the first forward's sum is taped and the rerun
    takes it (`models/remat.py`): a rerun issues no collective."""

    @staticmethod
    def forward(ctx, t):
        def reduce():
            return (all_reduce_(t.clone(), "spatial", grid().spatial_group),)

        tape = active_tape()
        return reduce()[0] if tape is None else tape.received(reduce)[0].clone()

    @staticmethod
    def backward(ctx, g):
        return g


class _SpatialBroadcast(torch.autograd.Function):
    """The identity on `t`, a value that every spatial rank of these rows
    holds whole, where it meets this rank's slab; the backward sums the
    slabs' parts of its cotangent over those ranks."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), "spatial", grid().spatial_group)


def spatial_broadcast(t: torch.Tensor) -> torch.Tensor:
    """`t`, whole on every rank of these rows, for a computation over this
    rank's depth slab (module docstring); `t` without depth sharding."""
    return t if grid().spatial == 1 else _SpatialBroadcast.apply(t)


def spatial_sum(t: torch.Tensor) -> torch.Tensor:
    """`t`, a sum over this rank's depth slab, summed over the whole volume
    (the ranks of this rank's rows); `t` without depth sharding."""
    return t if grid().spatial == 1 else _SpatialSum.apply(t)


def spatial_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of every element of `t`, a tensor over this rank's depth
    slab, over the whole volume: the slabs' sums and element counts in one
    `spatial_sum`. `t.mean()` without depth sharding."""
    if grid().spatial == 1:
        return t.mean()
    # float64: an element count past 2**24 is exact
    n = torch.tensor(float(t.numel()), dtype=torch.float64, device=t.device)
    total, n = spatial_sum(torch.stack([t.sum().double(), n]))
    return (total / n).to(t.dtype)


def average_gradients(params: Iterable[torch.Tensor]) -> None:
    """Replace each `.grad` of `params` that exists by its sum over the
    ranks over the number of data ranks, in buckets of one dtype of at most
    `BUCKET_BYTES`: the gradient of the global-batch loss, since each rank's
    gradient is its slab's part of its rows' loss and that loss is its
    shard's mean (without depth sharding: the mean over the ranks). Every
    rank holds gradients for the same parameters (the same graph)."""
    w = world_size()
    if w == 1:
        return
    data = grid().data
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
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in bucket]), "grad").div_(data)
        off = 0
        for g in bucket:
            g.copy_(flat[off:off + g.numel()].view(g.shape))
            off += g.numel()


def _rows(draw, shape: Sequence[int], depth_axis: Optional[int]) -> torch.Tensor:
    g = grid()
    shape = tuple(shape)
    out = draw((shape[0] * g.data,) + shape[1:])
    if g.data > 1:
        out = out[local_batch_slice(shape[0] * g.data)]
    if depth_axis is not None and g.spatial > 1:
        out = out.narrow(depth_axis, *_start_len(volume_slab(shape[depth_axis])))
    return out


def _start_len(sl: slice) -> Tuple[int, int]:
    return sl.start, sl.stop - sl.start


def normal_rows(shape: Sequence[int], generator: Optional[torch.Generator],
                device, depth_axis: Optional[int] = None) -> torch.Tensor:
    """N(0, 1) fp32 whose first axis is this rank's rows of the global batch:
    `torch.randn` at the global batch, this rank's rows kept. `shape` is
    (rows,) + the whole volume's axes; with `depth_axis` under depth sharding
    this rank's depth slab of that axis is kept too (`volume_slab` at level
    0: a latent-shaped draw), so the ranks' pieces are one process's draw."""
    return _rows(lambda s: torch.randn(s, generator=generator, device=device,
                                       dtype=torch.float32), shape, depth_axis)


def rand_rows(shape: Sequence[int], generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """U[0, 1) fp32 of `shape`, drawn as `normal_rows` is."""
    return _rows(lambda s: torch.rand(s, generator=generator, device=device,
                                      dtype=torch.float32), shape, None)


# ---------------------------------------------------------------------------
# depth sharding: the mesh, the slabs, the whole latents
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Mesh:
    """The process grid of `make_mesh`: axis names and sizes, and this
    process's `Grid`."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    grid: Grid


def make_mesh(shape: Tuple[int, ...] = (-1,),
              axis_names: Tuple[str, ...] = ("data",)) -> Mesh:
    """The processes as a mesh of `shape` over `axis_names` ("data" and
    optionally "spatial"; one -1 takes the rest of the world), made this
    process's grid (`distributed.set_grid`). Port of `make_mesh`
    (`sivae_tpu/parallel/mesh.py:24-38`), over processes: the mesh holds
    every process (JAX may take a subset of its devices). Every rank calls
    it alike."""
    shape, axis_names = tuple(shape), tuple(axis_names)
    if len(shape) != len(axis_names) or set(axis_names) - {"data", "spatial"} or \
            len(set(axis_names)) != len(axis_names):
        raise ValueError(f"make_mesh takes the axes 'data' and 'spatial', got {axis_names} "
                         f"for shape {shape}")
    if shape.count(-1) > 1:
        raise ValueError(f"at most one -1 in a mesh shape, got {shape}")
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape = tuple(world_size() // known if s == -1 else s for s in shape)
    sizes = dict(zip(axis_names, shape))
    g = set_grid(sizes.get("data", 1), sizes.get("spatial", 1))
    return Mesh(shape, axis_names, g)


def slab_bounds(depth: int, parts: int, levels: int = 0) -> List[Tuple[int, int]]:
    """[start, stop) of each of `parts` depth slabs of `depth` planes: split
    as evenly as possible (the larger parts first, each at least one plane)
    at the coarsest resolution, `depth / 2**levels` planes, and scaled by
    `2**levels`, so each of `levels` stride-2 stages keeps every slab on a
    voxel boundary and every AvgPool(2) local to its rank."""
    unit = 1 << levels
    if depth % unit:
        raise ValueError(f"depth {depth} does not divide by 2**{levels}")
    coarse = depth // unit
    if coarse < parts:
        raise ValueError(f"{coarse} planes at the coarsest resolution cannot feed {parts} "
                         f"spatial ranks: each needs one")
    q, r = divmod(coarse, parts)
    bounds, start = [], 0
    for i in range(parts):
        stop = start + q + (i < r)
        bounds.append((start * unit, stop * unit))
        start = stop
    return bounds


def volume_slab(depth: int, mesh: Optional[Mesh] = None, levels: int = 0) -> slice:
    """This rank's slab of `depth` planes (`slab_bounds`) in `mesh`'s grid
    (the process's grid without one). spatial_1200's latent (depth 10) over
    4 ranks is 3/3/2/2, 24/24/16/16 at 80 planes (`levels` 3)."""
    g = grid() if mesh is None else mesh.grid
    return slice(*slab_bounds(depth, g.spatial, levels)[g.spatial_index])


def depth_scale(latent_depth: int) -> Fraction:
    """The whole volume's depth over this rank's slab's, at every resolution
    of a model whose latent has `latent_depth` planes (1 without depth
    sharding)."""
    sl = volume_slab(latent_depth)
    return Fraction(latent_depth, sl.stop - sl.start)


def slab_shape(shape: Sequence[int]) -> Tuple[int, ...]:
    """A latent's (C, D, H, W) `shape` with this rank's slab of D."""
    sl = volume_slab(shape[1])
    return (shape[0], sl.stop - sl.start) + tuple(shape[2:])


def shard_batch(batch, mesh: Mesh, spatial_axis: Optional[str] = None, levels: int = 0):
    """This rank's part of a global host batch (a tensor or array, or a
    tuple / list / dict of them): its rows of the "data" shard and, with
    `spatial_axis` "spatial" for 5-D NCDHW volumes, its depth slab
    (`volume_slab` at `levels`, the model's number of stride-2 stages). Port
    of `shard_batch` (`sivae_tpu/parallel/mesh.py:62-81`); where JAX
    assembles one global array, each process keeps its own part."""
    if spatial_axis not in (None, "spatial"):
        raise ValueError(f"shard_batch shards depth over 'spatial', got {spatial_axis!r}")

    def part(x):
        x = x[local_batch_slice(x.shape[0])]
        if spatial_axis is not None and x.ndim == 5:
            x = x[:, :, volume_slab(x.shape[2], mesh, levels)]
        return x

    return tree_map(part, batch)


class _GatherDepth(torch.autograd.Function):
    """The depth slabs of the spatial ranks, `sizes` planes each, joined
    along `axis` on every one of them. Backward: this rank's slab of the
    cotangent (each rank holds the same cotangent of the whole)."""

    @staticmethod
    def forward(ctx, t, sizes, axis):
        g = grid()
        ctx.axis, ctx.start = axis, sum(sizes[:g.spatial_index])
        ctx.size = sizes[g.spatial_index]
        top = max(sizes)
        pad = list(t.shape)
        pad[axis] = top - t.shape[axis]
        buf = torch.cat([t, t.new_zeros(pad)], dim=axis).contiguous() if pad[axis] else \
            t.contiguous()
        parts = [torch.empty_like(buf) for _ in sizes]
        count("gather", buf.numel() * buf.element_size())
        dist.all_gather(parts, buf, group=g.spatial_group)
        return torch.cat([p.narrow(axis, 0, n) for p, n in zip(parts, sizes)], dim=axis)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.axis, ctx.start, ctx.size), None, None


def gather_depth(t: torch.Tensor, depth: int, axis: int = 2) -> torch.Tensor:
    """This rank's depth slab `t` (of a volume of `depth` planes along
    `axis`, `volume_slab` at level 0: a latent) joined with the other spatial
    ranks' into the whole, on every one of them; `t` without depth
    sharding."""
    g = grid()
    if g.spatial == 1:
        return t
    sizes = [b - a for a, b in slab_bounds(depth, g.spatial)]
    return _GatherDepth.apply(t, sizes, axis)


# ---------------------------------------------------------------------------
# Linears that meet a depth slab
# ---------------------------------------------------------------------------


def _bottom_slab(whole: Sequence[int]) -> slice:
    """This rank's depth slab of a (C, D, H, W) `whole` volume at its own
    resolution (`volume_slab` at level 0)."""
    return volume_slab(whole[1])


def _partial_linear(linear, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """`x @ weight.T` plus `linear`'s bias on spatial index 0 only (times 0
    elsewhere, so every rank's bias has a gradient and the gradient buckets
    pair up), in `linear.dtype`, summed over the spatial ranks of these rows
    in at least fp32: the whole product, on each of them. The sum's
    backward hands each rank the whole cotangent, so `weight`'s gradient is
    this rank's part alone and the gradient sum over the grid is right."""
    dt = linear.dtype
    first = float(grid().spatial_index == 0)
    y = F.linear(x.to(dt), weight.to(dt), (linear.bias * first).to(dt))
    return spatial_sum(widen(y)).to(y.dtype)


def linear_from_slab(linear, x: torch.Tensor, whole: Sequence[int]) -> torch.Tensor:
    """`linear` (torch's (out, in) weight and bias, compute `dtype`) of the
    (C, D, H, W) volume `whole` flattened in that order, of which `x` (B, C,
    d, H, W) is this rank's depth slab: (B, out), whole on every spatial rank
    of these rows. Each rank multiplies its slab's columns of the weight (a
    (out, C, D, H, W) view: one strided block per channel) by its slab's
    features and the partial products are summed (`_partial_linear`). The
    parameters stay whole; each rank's gradient is zero outside its
    columns. `linear(x.reshape(B, -1))` without depth sharding."""
    b = x.shape[0]
    if grid().spatial == 1:
        return linear(x.reshape(b, -1))
    out = linear.weight.shape[0]
    w = linear.weight.view((out,) + tuple(whole))[:, :, _bottom_slab(whole)]
    return _partial_linear(linear, x.reshape(b, -1), w.reshape(out, -1))


def linear_to_slab(linear, z: torch.Tensor, whole: Sequence[int]) -> torch.Tensor:
    """This rank's depth slab (B, C, d, H, W) of `linear(z)`, whose output
    features are the (C, D, H, W) volume `whole` flattened in that order;
    `z` (B, in) is whole on every spatial rank of these rows. Each rank
    computes its slab's rows of the weight and the bias (strided once per
    channel); `z` goes through `spatial_broadcast`, so its cotangent is the
    sum of the slabs' parts. `linear(z)` reshaped without depth sharding."""
    b = z.shape[0]
    if grid().spatial == 1:
        return linear(z).reshape((b,) + tuple(whole))
    sl, n_in = _bottom_slab(whole), linear.weight.shape[1]
    w = linear.weight.view(tuple(whole) + (n_in,))[:, sl].reshape(-1, n_in)
    bias = linear.bias.view(tuple(whole))[:, sl].reshape(-1)
    dt = linear.dtype
    y = F.linear(spatial_broadcast(z).to(dt), w.to(dt), bias.to(dt))
    return y.reshape((b, whole[0], sl.stop - sl.start) + tuple(whole[2:]))


def linear_of_partial_sums(linear, x: torch.Tensor) -> torch.Tensor:
    """`linear` of the sum over the spatial ranks of `x` (B, in), this rank's
    partial sum (a pool's sum over its slab): the Linear of each partial,
    the bias once, summed (`_partial_linear`), so the weight takes its
    gradient once. `linear(x)` without depth sharding."""
    if grid().spatial == 1:
        return linear(x)
    return _partial_linear(linear, x, linear.weight)


def slab_features(t: torch.Tensor, whole: Sequence[int]) -> torch.Tensor:
    """This rank's slab of a per-feature tensor `t` (F,) over the (C, D, H,
    W) volume `whole` flattened in that order (a BatchNorm's parameters over
    `linear_to_slab`'s features); `t` without depth sharding."""
    if grid().spatial == 1:
        return t
    return t.view(tuple(whole))[:, _bottom_slab(whole)].reshape(-1)


def whole_features(t: torch.Tensor, whole: Sequence[int]) -> torch.Tensor:
    """The per-feature rows (K, F_slab) of every spatial rank's slab joined
    into (K, F) over the (C, D, H, W) volume `whole` flattened in that order,
    on every one of them (one `gather_depth`); `t` without depth sharding."""
    if grid().spatial == 1:
        return t
    k, (c, d, h, w) = t.shape[0], whole
    slab = _bottom_slab(whole)
    joined = gather_depth(t.reshape(k, c, slab.stop - slab.start, h, w), d)
    return joined.reshape(k, -1)


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
