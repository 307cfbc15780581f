"""Halo exchanges between depth neighbours, for the depth-sharded convs.

Under depth sharding (`parallel/mesh.py`) each spatial rank holds a slab of
the volume's depth. A 3x3x3 SAME conv at a slab's first and last planes
reads one plane of each neighbouring slab; GSPMD inserts that exchange in
the JAX package (`sivae_tpu/parallel/mesh.py:46-55`). Here the conv
(`models/blocks.py`) pads its NDHWC slab with the neighbours' planes
(`exchange_planes`, then `pad_depth`), runs its kernel and crops the two
planes its SAME padding touched.

- Forward: each rank sends its first and last planes to its lower and
  upper neighbour (global ranks `rank() - 1` and `rank() + 1`) and receives
  theirs. A slab at the grid's edge gets zeros there: SAME padding.
- Backward (`pad_depth`'s autograd Function): the cotangents of the halo
  planes go back to their owners, who add them to their own edge planes.

Transport: `dist.batch_isend_irecv` of the planes in place, on the card under
NCCL and on the CPU under gloo. gloo sends and receives host memory only, so
ranks that share one card through gloo (NCCL refuses two ranks on a device)
copy each message through the host; that copy is counted apart, as
`collectives["halo_host"]` (its bytes both ways), beside `collectives["halo"]`
(one call per exchange, forward or backward, and the bytes this rank sends).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from sivae_torch.parallel.distributed import grid, rank
from sivae_torch.parallel.mesh import count

Planes = Tuple[torch.Tensor, torch.Tensor]


def _swap(to_lower: torch.Tensor, to_upper: torch.Tensor) -> Planes:
    """Send `to_lower` to the lower depth neighbour and `to_upper` to the
    upper one; return (from the lower, from the upper), zeros where this
    rank has no such neighbour. Every message has one shape."""
    g = grid()
    peers = (rank() - 1 if g.spatial_index > 0 else None,
             rank() + 1 if g.spatial_index < g.spatial - 1 else None)
    send = [t.contiguous() for t in (to_lower, to_upper)]
    recv = [torch.zeros_like(t) for t in send]
    nbytes = send[0].numel() * send[0].element_size()
    links = sum(p is not None for p in peers)
    count("halo", links * nbytes)
    staged = send[0].is_cuda and dist.get_backend() != "nccl"
    wire_send, wire_recv = send, recv
    if staged:
        count("halo_host", 2 * links * nbytes)
        wire_send = [t.cpu() if p is not None else t for t, p in zip(send, peers)]
        wire_recv = [torch.zeros(t.shape, dtype=t.dtype) for t in recv]
    ops = []
    for peer, out, inp in zip(peers, wire_send, wire_recv):
        if peer is not None:
            ops += [dist.P2POp(dist.isend, out, peer), dist.P2POp(dist.irecv, inp, peer)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        recv = [w.to(r.device) if p is not None else r
                for w, r, p in zip(wire_recv, recv, peers)]
    return recv[0], recv[1]


def exchange_planes(x: torch.Tensor) -> Planes:
    """The plane below this rank's NDHWC slab `x` (the lower neighbour's
    last) and the one above it (the upper neighbour's first), zeros at the
    grid's edges. Not differentiable: `pad_depth` takes them."""
    x = x.detach()
    return _swap(x[:, :1], x[:, -1:])


class _HaloPad(torch.autograd.Function):
    """[below, x, above] along depth; the backward sends the halo planes'
    cotangents to their owners and adds the ones it receives to x's edge
    planes."""

    @staticmethod
    def forward(ctx, x, below, above):
        ctx.h = below.shape[1]
        return torch.cat([below, x, above], dim=1)

    @staticmethod
    def backward(ctx, g):
        h = ctx.h
        from_lower, from_upper = _swap(g[:, :h], g[:, -h:])
        dx = g[:, h:-h].clone(memory_format=torch.contiguous_format)
        dx[:, :h] += from_lower
        dx[:, -h:] += from_upper
        return dx, None, None


def pad_depth(x: torch.Tensor, received: Planes) -> torch.Tensor:
    """NDHWC `x` (B, d, H, W, C) with the planes `exchange_planes` received
    on either side: (B, d + 2, H, W, C), differentiable in `x`."""
    return _HaloPad.apply(x, *received)
