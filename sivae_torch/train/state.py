"""Training state: everything a Soft-IntroVAE run needs to take its next step.

Port of `sivae_tpu/train/state.py:21-79`. The JAX state is one immutable
pytree; here it is a small mutable object around the model (parameters and
BatchNorm running statistics), one Adam for each half, the step counter and
one `torch.Generator` on the model's device, from which the step draws its
noise and every dropout mask. The step functions update it in place.
"""

from __future__ import annotations

import dataclasses

import torch

from sivae_torch.config import OptimConfig
from sivae_torch.models.resnet_vae import SoftIntroVAE


def learning_rate(cfg: OptimConfig, steps_per_epoch: int, count: int) -> float:
    """Adam's rate for the update with `count` updates already done: MultiStep
    decay (reference my_trainer.py:183-186) as
    `optax.piecewise_constant_schedule` with boundaries at
    `milestone * steps_per_epoch`: the rate is multiplied by `gamma` from the
    update whose count equals a boundary onwards."""
    lr = cfg.lr
    for m in cfg.milestones:
        if count >= int(m) * steps_per_epoch:
            lr *= cfg.gamma
    return lr


def make_optimizer(params, cfg: OptimConfig) -> torch.optim.Adam:
    """`torch.optim.Adam` with the config's b1 / b2 / eps computes what
    `optax.adam` does (eps outside the root, both moments bias-corrected).
    Its rate is set before every update from `learning_rate`."""
    return torch.optim.Adam(list(params), lr=cfg.lr, betas=(cfg.b1, cfg.b2), eps=cfg.eps)


@dataclasses.dataclass
class SIVAETrainState:
    model: SoftIntroVAE
    opt_e: torch.optim.Adam         # over model.encoder's parameters
    opt_d: torch.optim.Adam         # over model.decoder's parameters
    generator: torch.Generator      # on the model's device
    step: int = 0                   # steps taken = updates done by each Adam


def create_train_state(model: SoftIntroVAE, seed: int = 0,
                       optim_cfg: OptimConfig = OptimConfig()) -> SIVAETrainState:
    """State around `model` (already on its device, see `make_model`), with
    fresh Adams and a generator seeded with `seed`. The LR schedule belongs
    to the step function, which sets each update's rate from the state's
    step count (the JAX state holds no schedule either). The
    single-optimizer form of the plain VAE / CAE trainers comes with those
    steps."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    return SIVAETrainState(model=model,
                           opt_e=make_optimizer(model.encoder.parameters(), optim_cfg),
                           opt_d=make_optimizer(model.decoder.parameters(), optim_cfg),
                           generator=gen)


def param_count(state: SIVAETrainState) -> int:
    return sum(p.numel() for p in state.model.parameters())

