"""Activation rematerialisation: the JAX package's `remat` / `remat_policy`
(`sivae_tpu/models/blocks.py:29-93`, `:472-505`) and the two-phase step's
`remat_calls` (`sivae_tpu/train/step.py:57-91`).

A rematerialised region (a block, one of the FC family's conv-BN-act units,
or with `remat_calls` a whole encode or decode call) runs under
`torch.utils.checkpoint.checkpoint(use_reentrant=False)`: autograd keeps
none of the tensors the region's nodes save for the backward, and when the
backward first needs one of them the region's forward runs again and
regenerates them all. Non-reentrant checkpointing differentiates the first
forward's nodes and takes only their saved tensors from the rerun, which
must save the same tensors in the same order (it checks their shapes,
dtypes and devices).

The rerun must not redo what the first forward did once, so the first
forward writes a tape that the rerun reads:
- the output of every conv whose tag (`site_tag`) the policy saves. The
  rerun does not run that conv again; it builds the conv's node on the kept
  output: `_Kept` saves what the kernels' own autograd Functions save
  (`kernels/conv3d.py` `_Conv3dSame`, `kernels/conv3d_small.py`
  `_Conv3dTo1`, `_Conv3dFrom1`: x where the weight needs a gradient, w
  where x does), and the library's fused upsample + conv runs its
  `aten.convolution` node under `_ReturnKept`, which hands back the kept
  output. torch's selective checkpointing cannot do this for the kernels:
  it decides per dispatcher op, and each kernel is a ctypes call inside an
  autograd Function that no policy sees. A conv the policy does not keep
  runs again through the same dispatch as in the first forward: the kernel
  for a CUDA tensor, the plain version for a CPU tensor;
- each BatchNorm's batch statistics, under every policy (JAX's `bn_stat`,
  which its `conv_outs*` policies save and `None` does not). The rerun
  normalises with them: it moves no running statistic, reduces nothing and,
  under data parallelism, issues no collective;
- the state of the generator each Dropout drew its mask from. The rerun
  draws the same mask from a copy of that state, whatever generator the
  module holds by then (phase D's replayed decodes swap it, and data
  parallelism's masks come from a rank generator);
- under depth sharding, the halo planes each conv received from its depth
  neighbours (`parallel/halo.py`), and each sum over the spatial ranks (an
  FC head's partial products, `parallel.mesh.spatial_sum`): the rerun pads
  with the kept planes and takes the kept sums, and exchanges nothing. With
  the statistics above, a rerun issues no collective. The halo's backward
  (its cotangents to their owners) belongs to the first forward's node and
  runs once.
1x1 convs (the spatial decoder's head and the encoder's heads, at the
latent's resolution in every registry model) are recomputed under every
policy, where the JAX policies would keep them.

Regions are entered only in training with gradients on; in eval mode or
under `torch.no_grad()` a region is a plain call, as JAX's
`_CheckpointedCalls` passes `train=False` straight through. The wrap is in
the forward code, not in the module tree, so `state_dict` keys stay the
reference's (flax's `nn.remat` prefixes `Checkpoint` to module names).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from fractions import Fraction
from typing import Callable, Dict, FrozenSet, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

# tags of conv outputs (`sivae_tpu/models/blocks.py:39-41`) and of the BN
# batch statistics (`:47`); a conv output of at least HI_RES_VOXELS spatial
# voxels is "hi", the encoder's or the decoder's
CONV_OUT = "conv_out"
CONV_OUT_HI_ENC = "conv_out_hi_enc"
CONV_OUT_HI_DEC = "conv_out_hi_dec"
BN_STAT = "bn_stat"
HI_RES_VOXELS = 200_000

POLICIES = (None, "conv_outs", "conv_outs_lo", "conv_outs_no_dec_hi", "conv_outs_no_enc_hi")
_SAVES = {
    None: frozenset(),
    "conv_outs": frozenset({CONV_OUT, CONV_OUT_HI_ENC, CONV_OUT_HI_DEC}),
    "conv_outs_lo": frozenset({CONV_OUT}),
    "conv_outs_no_dec_hi": frozenset({CONV_OUT, CONV_OUT_HI_ENC}),
    "conv_outs_no_enc_hi": frozenset({CONV_OUT, CONV_OUT_HI_DEC}),
}
KERNELS = ("conv3d_same", "conv3d_to1", "conv3d_from1")


def remat_policy_by_name(name: Optional[str]) -> FrozenSet[str]:
    """The tags a policy keeps (`sivae_tpu/models/blocks.py:472-490`), with
    `BN_STAT` for every policy, None included."""
    try:
        return _SAVES[name] | {BN_STAT}
    except KeyError:
        raise ValueError(f"unknown remat_policy {name!r}") from None


def site_tag(voxels: int, scope: str) -> str:
    """The tag of a conv output of `voxels` spatial voxels in the encoder
    ("enc") or decoder ("dec"), by `sivae_tpu/models/blocks.py:80-93`."""
    if voxels < HI_RES_VOXELS:
        return CONV_OUT
    return CONV_OUT_HI_DEC if scope == "dec" else CONV_OUT_HI_ENC


# ---------------------------------------------------------------------------
# the tape of one region
# ---------------------------------------------------------------------------

_ACTIVE: List["_Tape"] = []


def active_tape() -> Optional["_Tape"]:
    """The tape of the region whose forward (first or rerun) is running."""
    return _ACTIVE[-1] if _ACTIVE else None


class _Tape:
    """What one call of a region keeps for its rerun, in the order its
    forward met the sites (the rerun meets them in the same order)."""

    def __init__(self, saves: FrozenSet[str], scope: str, depth_scale: Fraction = Fraction(1)):
        self.saves, self.scope = saves, scope
        # the whole volume's depth over this rank's slab's, under depth
        # sharding: a site's tag follows the whole volume's voxels
        self.depth_scale = depth_scale
        self.convs: List[Optional[torch.Tensor]] = []
        self.stats: List[list] = []
        self.gens: list = []
        self.halos: list = []
        self.replaying = False
        self.at = {"conv": 0, "stats": 0, "gen": 0, "halo": 0}

    def contexts(self):
        """checkpoint's `context_fn`: (first forward, rerun)."""
        return _Mode(self, False), _Mode(self, True)

    def _next(self, what: str, items: list):
        i = self.at[what]
        self.at[what] = i + 1
        return items[i]

    def conv(self, voxels: int, compute: Callable[[], torch.Tensor],
             replay: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        """compute() in the first forward, its output kept if the policy
        saves its tag; in the rerun replay(kept) for a kept one, else
        compute() again."""
        if not self.replaying:
            y = compute()
            keep = site_tag(int(voxels * self.depth_scale), self.scope) in self.saves
            self.convs.append(y.detach() if keep else None)
            return y
        kept = self._next("conv", self.convs)
        return compute() if kept is None else replay(kept)

    def bn_stats(self) -> list:
        """The list a BatchNorm's `_BatchNormTrain` fills with its batch
        statistics in the first forward, and takes them from in the rerun."""
        if not self.replaying:
            self.stats.append([])
            return self.stats[-1]
        return self._next("stats", self.stats)

    def received(self, exchange: Callable[[], tuple]) -> tuple:
        """exchange() (a collective: a halo exchange, a sum over the spatial
        ranks) in the first forward, its tensors kept; in the rerun the kept
        tensors, and no collective."""
        if not self.replaying:
            self.halos.append(exchange())
            return self.halos[-1]
        return self._next("halo", self.halos)

    def generator(self, gen: Optional[torch.Generator]) -> Optional[torch.Generator]:
        """The generator a Dropout draws its mask from: its own in the first
        forward, whose state is kept; in the rerun a copy of that state."""
        if not self.replaying:
            self.gens.append(None if gen is None else (gen.device, gen.get_state()))
            return gen
        kept = self._next("gen", self.gens)
        return None if kept is None else torch.Generator(device=kept[0]).set_state(kept[1])


class _Mode:
    """Enters a tape for the first forward or for a rerun."""

    def __init__(self, tape: _Tape, replaying: bool):
        self.tape, self.replaying = tape, replaying

    def __enter__(self):
        self.tape.replaying = self.replaying
        self.tape.at = dict.fromkeys(self.tape.at, 0)
        _ACTIVE.append(self.tape)
        return self.tape

    def __exit__(self, *exc):
        _ACTIVE.remove(self.tape)
        return False


class _Kept(torch.autograd.Function):
    """A kernel conv's node in a rerun, on the output the first forward
    kept: it saves what the kernels' autograd Functions save and launches
    nothing. Non-reentrant checkpointing never differentiates a rerun's
    nodes, so its backward does not run."""

    @staticmethod
    def forward(ctx, x, w, kept):
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None,
                              w if ctx.needs_input_grad[0] else None)
        return kept

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("a rematerialised region's rerun is not differentiated")


class _ReturnKept(TorchDispatchMode):
    """While active, `aten.convolution` returns the kept output instead of
    computing it; autograd still builds its node above the dispatch and
    saves what the first forward's node saved."""

    def __init__(self, kept: torch.Tensor):
        super().__init__()
        self.kept, self.calls = kept, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.calls += 1
            return self.kept.detach()
        return func(*args, **(kwargs or {}))


def kernel_conv(fn: Callable, x: torch.Tensor, w: torch.Tensor,
                voxels: Optional[int] = None) -> torch.Tensor:
    """fn(x, w) for one of the kernels' differentiable wrappers
    (`conv3d_same`, `conv3d_to1`, `conv3d_from1`; NDHWC x), taped inside a
    region. `voxels`: the output's spatial voxels on this rank (x's, unless
    x carries halo planes)."""
    tape = active_tape()
    if tape is None:
        return fn(x, w)
    if voxels is None:
        voxels = x.shape[1] * x.shape[2] * x.shape[3]
    return tape.conv(voxels, lambda: fn(x, w), lambda kept: _Kept.apply(x, w, kept))


def library_conv(compute: Callable[[], torch.Tensor], voxels: int) -> torch.Tensor:
    """compute(), a library call whose output is that of its one
    `aten.convolution` (the fused upsample + conv), taped inside a region."""
    tape = active_tape()
    if tape is None:
        return compute()
    return tape.conv(voxels, compute, functools.partial(_replay_convolution, compute))


def _replay_convolution(compute, kept: torch.Tensor) -> torch.Tensor:
    with _ReturnKept(kept) as mode:
        y = compute()
    if mode.calls != 1:
        raise RuntimeError(f"expected one aten.convolution in a kept conv, met {mode.calls}")
    return y


# ---------------------------------------------------------------------------
# regions
# ---------------------------------------------------------------------------


def region(fn: Callable, saves: FrozenSet[str], scope: str, *args,
           depth_scale: Fraction = Fraction(1)):
    """fn(*args) as one rematerialised region that keeps `saves` (a
    `remat_policy_by_name` set) in the encoder or decoder `scope`
    (`depth_scale`: the volume's depth over this rank's slab's, under depth
    sharding). preserve_rng_state=False: nothing in a region draws from
    torch's global generators (dropout masks come from explicit generators,
    whose states the tape keeps), so there is no global state to stash and
    restore."""
    tape = _Tape(saves, scope, depth_scale)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=tape.contexts)


class Remat:
    """The rematerialisation of one model half: `on` (the config's `remat`),
    the policy's saved tags and the half's scope. `wraps(training)` says
    whether a call rematerialises now: remat on, training mode, gradients
    on."""

    def __init__(self, on: bool, policy: Optional[str], scope: str):
        self.saves = remat_policy_by_name(policy) if on else None
        self.scope = scope

    def wraps(self, training: bool) -> bool:
        return self.saves is not None and training and torch.is_grad_enabled()

    def __call__(self, training: bool, fn: Callable, *args,
                 depth_scale: Fraction = Fraction(1)):
        """fn(*args), as a region when `wraps(training)`."""
        if not self.wraps(training):
            return fn(*args)
        return region(fn, self.saves, self.scope, *args, depth_scale=depth_scale)


def chain(modules: Sequence[torch.nn.Module], h: torch.Tensor) -> torch.Tensor:
    for m in modules:
        h = m(h)
    return h


def run_units(seq: torch.nn.Sequential, units: Sequence[tuple], h: torch.Tensor,
              remat: Remat, training: bool, depth_scale: Fraction = Fraction(1)) -> torch.Tensor:
    """seq's modules in order, each index range [a, b) of `units` as one
    region: the FC family's conv-BN-act units, JAX's `cba` calls
    (`depth_scale` as in `region`)."""
    if not remat.wraps(training):
        return seq(h)
    mods, ends, i = list(seq), dict(units), 0
    while i < len(mods):
        if i in ends:
            h = remat(training, functools.partial(chain, mods[i:ends[i]]), h,
                      depth_scale=depth_scale)
            i = ends[i]
        else:
            h = mods[i](h)
            i += 1
    return h


# ---------------------------------------------------------------------------
# conv sites, for the launch counts a policy derives
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ConvSite:
    """One conv of a model half's forward: `kind` is a kernel
    (`conv3d_same`, `conv3d_to1`, `conv3d_from1`), "upconv" (the library's
    fused upsample + conv) or "1x1"; `voxels` its output's spatial voxels;
    `region` the block-remat region it runs in (a module path), or None."""

    kind: str
    scope: str
    voxels: int
    region: Optional[str]

    @property
    def tag(self) -> str:
        return site_tag(self.voxels, self.scope)


def recomputed_launches(sites: Sequence[ConvSite], policy: Optional[str],
                        whole_call: bool = False) -> Dict[str, int]:
    """Kernel launches the reruns of one differentiated forward over `sites`
    add: every kernel conv in a region (with `whole_call`, the call is the
    region) whose tag the policy does not keep."""
    saves = remat_policy_by_name(policy)
    n = dict.fromkeys(KERNELS, 0)
    for s in sites:
        if s.kind in n and (whole_call or s.region is not None) and s.tag not in saves:
            n[s.kind] += 1
    return n


# a two-phase Soft-IntroVAE step differentiates 5 encodes and 7 decodes
# (phase E's decode of the noise has no graph: `train/step.py`)
STEP_ENCODES, STEP_DECODES = 5, 7


def soft_intro_step_recomputes(enc: Sequence[ConvSite], dec: Sequence[ConvSite],
                               policy: Optional[str], whole_call: bool = False) -> Dict[str, int]:
    """Kernel launches rematerialisation adds to one two-phase step."""
    e = recomputed_launches(enc, policy, whole_call)
    d = recomputed_launches(dec, policy, whole_call)
    return {k: STEP_ENCODES * e[k] + STEP_DECODES * d[k] for k in KERNELS}
