"""Plain reference of the Soft-IntroVAE two-phase train step (reference
utils/my_trainer.py:241-324) with Adam, written from its definition.

Phase E updates the encoder by the encoder loss: the decoder's parameters
take no gradient, the targets of the expELBO terms are `rec` (attached)
and `fake`, and the re-encoded `rec` / `fake` are detached. Phase D, after
the encoder's update, updates the decoder: `z`, `z_rec`, `z_fake` and the
reconstruction targets detached. Thirteen forwards in train mode, each
moving BatchNorm's running statistics. Losses are reduced in float32.

The random draws follow the step's own order from one generator seeded
with the run's seed: the noise batch, then per forward the dropout masks
(drawn in channels-last memory order, one float32 uniform per element) and
each reparameterisation's normal eps. Phase D's two replayed decodes take
the masks that phase E's `decode(noise)` and `decode(z)` drew. Under data
parallelism every draw with a batch axis is taken for the global batch and
this rank's rows kept, the dropout masks come from a generator of this
rank and step, BatchNorm's statistics are summed over the ranks, and each
gradient is the mean over the ranks.

With `meta=True` nothing is drawn or computed: the step runs on the meta
device so that `FlopCounterMode` can count its multiplications.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from port_bench.reference.model import Precision, Run


@dataclass(frozen=True)
class StepHyper:
    """The loss and optimizer settings of a train cell (its traffic file)."""

    beta_rec: float
    beta_neg: float
    beta_kl: float
    gamma_r: float = 1e-8
    exp_elbo_weight: float = 0.5
    loss_multiplier: float = 10.0
    lr: float = 2e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    milestones: tuple = (350,)
    gamma: float = 0.1


class Draws:
    """The step's random numbers, from a CUDA or CPU generator (or none on
    the meta device). `rows` is this rank's slice of the global batch."""

    def __init__(self, gen: Optional[torch.Generator], device, world: int = 1,
                 rows: slice = slice(None)):
        self.gen, self.device, self.world, self.rows = gen, device, world, rows

    def normal_rows(self, shape) -> torch.Tensor:
        full = (shape[0] * self.world,) + tuple(shape[1:])
        out = torch.randn(full, generator=self.gen, device=self.device, dtype=torch.float32)
        return out[self.rows] if self.world > 1 else out

    def uniform_masks(self, gen: Optional[torch.Generator]):
        """A `Run.drop` drawing from `gen`: the uniforms of an NCDHW shape in
        channels-last (N, D, H, W, C) memory order."""
        def draw(shape):
            n, c = shape[0], shape[1]
            u = torch.empty((n,) + tuple(shape[2:]) + (c,), dtype=torch.float32,
                            device=self.device)
            u.uniform_(generator=gen)
            return u.permute(0, 4, 1, 2, 3)
        return draw


def rank_seed(seed: int, step: int, rank: int) -> int:
    """The seed of rank `rank`'s dropout generator at step `step`."""
    return ((seed * 1_000_003 + step) * 65_537 + rank) % (1 << 63)


def recon(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-sample sum of squared errors."""
    return ((x.float() - y.float()) ** 2).reshape(x.shape[0], -1).sum(dim=1)


def kl(logvar: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Per-sample KL(N(mu, e^logvar) || N(0, I))."""
    mu, logvar = mu.float().reshape(mu.shape[0], -1), logvar.float().reshape(mu.shape[0], -1)
    return -0.5 * (1.0 + logvar - mu * mu - torch.exp(logvar)).sum(dim=1)


@dataclass
class RefTrainer:
    """The reference model with two Adams, driven one step at a time."""

    model: torch.nn.Module
    hp: StepHyper
    seed: int
    steps_per_epoch: int
    scale: float
    prec: Precision = field(default_factory=Precision)
    world: int = 1
    rank: int = 0
    meta: bool = False
    exchange: bool = True     # False: a fault, the ranks reduce nothing
    step_count: int = 0
    grads: List[Dict[str, torch.Tensor]] = field(default_factory=list)  # the first step's

    def __post_init__(self):
        dev = next(self.model.parameters()).device
        self.device = dev
        self.gen = None if self.meta else torch.Generator(device=dev).manual_seed(self.seed)
        self.adam: Dict[str, list] = {}
        self.enc = dict(self.model.encoder.named_parameters(prefix="encoder"))
        self.dec = dict(self.model.decoder.named_parameters(prefix="decoder"))

    def _reduce(self):
        if self.world == 1 or not self.exchange:
            return None
        from torch.distributed.nn.functional import all_reduce

        return lambda t: all_reduce(t)

    def _lr(self) -> float:
        lr = self.hp.lr
        for m in self.hp.milestones:
            if self.step_count >= int(m) * self.steps_per_epoch:
                lr *= self.hp.gamma
        return lr

    def _adam(self, params: Dict[str, torch.nn.Parameter], loss: torch.Tensor) -> Dict:
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        grads = [g.detach() for g in grads]
        if self.world > 1 and self.exchange:
            import torch.distributed as dist

            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat)
            flat /= self.world
            grads, off = [], 0
            for k in names:
                n = params[k].numel()
                grads.append(flat[off:off + n].view_as(params[k]))
                off += n
        hp, lr, t = self.hp, self._lr(), self.step_count + 1
        with torch.no_grad():
            for k, g in zip(names, grads):
                m, v = self.adam.setdefault(k, [torch.zeros_like(g), torch.zeros_like(g)])
                m.mul_(hp.b1).add_(g, alpha=1 - hp.b1)
                v.mul_(hp.b2).addcmul_(g, g, value=1 - hp.b2)
                mhat = m / (1 - hp.b1 ** t)
                vhat = v / (1 - hp.b2 ** t)
                params[k].sub_(lr * mhat / (vhat.sqrt() + hp.eps))
        return dict(zip(names, grads))

    def step(self, real: torch.Tensor) -> Dict[str, float]:
        """One two-phase step on this rank's rows `real` (B, 1, D, H, W);
        returns the two losses (as tensors on the meta device)."""
        model, hp, s = self.model, self.hp, self.scale
        b = real.shape[0]
        rows = slice(self.rank * b, (self.rank + 1) * b)
        draws = Draws(self.gen, self.device, self.world, rows)
        if self.meta:
            drop_gen = None
        elif self.world == 1:
            drop_gen = self.gen
        else:
            drop_gen = torch.Generator(device=self.device).manual_seed(
                rank_seed(self.seed, self.step_count, self.rank))
        reduce = self._reduce()

        def run(gen=drop_gen):
            return Run(train=True, prec=self.prec, drop=draws.uniform_masks(gen),
                       reduce=reduce, ranks=self.world if reduce is not None else 1)

        def replay(state):
            if state is None:
                return None
            return torch.Generator(device=self.device).set_state(state)

        def reparam(mu, logvar):
            eps = draws.normal_rows(tuple(mu.shape))
            return mu.float() + eps * torch.exp(0.5 * logvar.float())

        def snapshot():
            return None if drop_gen is None else drop_gen.get_state()

        latent = tuple(model.latent_shape)
        noise = draws.normal_rows((b,) + latent)
        enc_p, dec_p = self.enc, self.dec

        # phase E: the encoder's update
        for p in dec_p.values():
            p.requires_grad_(False)
        s_fake = snapshot()
        fake = model.decode(noise, run())
        mu, logvar = model.encode(real, run())
        z = reparam(mu, logvar)
        s_rec = snapshot()
        rec = model.decode(z, run())
        loss_rec = recon(real, rec).mean()
        kl_real = kl(logvar, mu).mean()
        rmu, rlv = model.encode(rec.detach(), run())
        rec_rec = model.decode(reparam(rmu, rlv), run())
        fmu, flv = model.encode(fake.detach(), run())
        rec_fake = model.decode(reparam(fmu, flv), run())

        def exp_elbo(rec_ps, kl_ps):
            return torch.exp(-2.0 * s * (hp.beta_rec * rec_ps + hp.beta_neg * kl_ps)).mean()

        e_fake = exp_elbo(recon(fake, rec_fake), kl(flv, fmu))
        e_rec = exp_elbo(recon(rec, rec_rec), kl(rlv, rmu))
        loss_e = (s * (hp.beta_rec * loss_rec + hp.beta_kl * kl_real)
                  + hp.exp_elbo_weight * (e_fake + e_rec)) * hp.loss_multiplier
        g_e = self._adam(enc_p, loss_e)
        for p in dec_p.values():
            p.requires_grad_(True)
        z = z.detach()

        # phase D: the decoder's update, with the updated encoder
        for p in enc_p.values():
            p.requires_grad_(False)
        fake = model.decode(noise, run(replay(s_fake)) if s_fake is not None else run())
        rec = model.decode(z, run(replay(s_rec)) if s_rec is not None else run())
        loss_rec_d = recon(real, rec).mean()
        rmu, rlv = model.encode(rec, run())
        z_rec = reparam(rmu, rlv)
        fmu, flv = model.encode(fake, run())
        z_fake = reparam(fmu, flv)
        rec_rec = model.decode(z_rec.detach(), run())
        rec_fake = model.decode(z_fake.detach(), run())
        rec_kl, fake_kl = kl(rlv, rmu).mean(), kl(flv, fmu).mean()
        loss_d = s * (hp.beta_rec * loss_rec_d + 0.5 * hp.beta_kl * (rec_kl + fake_kl)
                      + hp.gamma_r * 0.5 * hp.beta_rec
                      * (recon(rec.detach(), rec_rec).mean() + recon(fake.detach(), rec_fake).mean()))
        loss_d = loss_d * hp.loss_multiplier
        g_d = self._adam(dec_p, loss_d)
        for p in enc_p.values():
            p.requires_grad_(True)
        self.step_count += 1
        if not self.grads and not self.meta:
            self.grads.append({**g_e, **g_d})
        return {"lossE": loss_e.detach(), "lossD": loss_d.detach()}
