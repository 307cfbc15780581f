"""The Soft-IntroVAE two-phase train step and its validation step, and the
plain VAE, CAE and classifier steps.

Port of `make_soft_intro_train_step` and `make_soft_intro_eval_step`
(`sivae_tpu/train/step.py:94-402`) and of the plain steps (`:410-536`). The JAX step is one jitted function over
an immutable state; this one runs eagerly and updates the state in place:

- phase E differentiates the encoder loss w.r.t. the encoder's parameters
  only: the decoder's are frozen (`requires_grad_(False)`) for the phase, so
  no weight gradient is spent on them and phase E leaves no `.grad` there;
- phase D does the same for the decoder, with the encoder already updated
  (the reference steps optimizer_e before it builds the decoder graph);
- every `stop_gradient` of the JAX step is a `.detach()` at the same place;
- BatchNorm running statistics move in every one of the 13 forwards, in the
  JAX step's order. Phase D runs `decode(noise)` and `decode(z)` again
  (XLA merges them with phase E's when the dropout masks are shared;
  eager PyTorch recomputes them, which moves the decoder's statistics
  a second time exactly as the JAX step does);
- all losses are reduced in fp32 even when activations are bf16.

Gradient-flow topology (the correctness-critical bits, as in the JAX step):
phase E's `loss_rec_rec` takes the NON-detached `rec` as its target, and
re-encodes detached `rec` / `fake` while the resampled `z_rec` / `z_fake`
stay attached for the inner decode; phase D detaches `z`, `z_rec`, `z_fake`
and the recon targets, but its KL terms flow decoder -> decode -> encode.

Noise and dropout masks come from the state's generator, one draw per
forward that has dropout; they cannot equal JAX's bits, so the tests
compare the two steps with `zero_noise` / `fixed_noise` and no dropout.
The metrics are 0-d tensors left on the device: the step itself never
waits for the card.

Data parallelism (one process per card, `sivae_torch/parallel/`): each rank
runs this step on its rows of the global batch, and the step computes the
global-batch step of the JAX package's mesh:
- BatchNorm takes the global batch's statistics (`models/blocks.py`);
- after each backward, one bucketed mean all-reduce of the `.grad`s that
  exist (`parallel.mesh.average_gradients`): phase E's encoder half, phase
  D's decoder half, or the plain steps' whole model. Each rank's loss is
  its shard's mean, so the mean of the ranks' gradients is the gradient of
  the global-batch loss;
- a batch mean that enters a non-linear term is made global before it does:
  the dp_semantics expELBO's reconstruction means go inside `exp`, so they
  pass through a differentiable all-reduce (`global_mean`). Every other
  loss term is a mean over samples (or over samples and positions) of
  per-sample values, linear in the shards;
- the noise batch and the reparameterisation eps are drawn for the global
  batch and each rank keeps its rows (`normal_rows`), so with dropout off
  the ranks together draw one process's noise; dropout masks, the size of
  the activations, come from a generator that folds in the rank
  (`rank_generator`). The state's generator moves alike on every rank.
Depth sharding (a `data x spatial` grid, `parallel.mesh.make_mesh`): each
rank runs this step on its rows and its depth slab (`shard_batch`), and the
step computes the global-batch step of the JAX package's 2-D mesh
(`tests/test_spatial_sharding.py`):
- the convs exchange halo planes and BatchNorm takes the grid's statistics
  (`models/blocks.py`);
- the per-sample voxel and latent sums are added over the spatial ranks
  before the losses use them (`ops/losses.py`): every rank of the same rows
  then holds the same loss, its rows', and backpropagates it once;
- a rank's gradient is its slab's part of that loss's gradient: the sum of
  the spatial ranks' is the whole, and the gradient all-reduce sums over
  every rank and divides by the number of data ranks (`average_gradients`).
  The spatial sum's backward is the identity, so no rank's partial sum
  takes the cotangent more than once: a differentiable all-reduce there
  (whose backward all-reduces the P equal cotangents) would make every
  gradient P times too large;
- the noise batch and the reparameterisation eps are drawn for the global
  batch and the whole latent; each rank keeps its rows and its depth slab
  (`normal_rows(..., depth_axis=2)`), so the ranks together draw one
  process's noise. A flat latent (the FC family) is whole on every spatial
  rank: each keeps its rows of the same draw, and its KL is not summed over
  the slabs (`flat` in `ops/losses.py`);
- the plain VAE, CAE and classifier steps and the validation step run on
  the grid the same way (the classifier's pool and head: `models/classifier.py`).
`torch.nn.parallel.DistributedDataParallel` is not used: its reducer
assumes one forward and one backward over a fixed set of parameters, where
this step runs 13 forwards and two backwards over halves switched by
`requires_grad_`. In one process none of this runs any collective, and the
step is the one described above.

Rematerialisation: with the model's `cfg.remat` its blocks rematerialise
inside every train-mode forward (`models/remat.py`); with `remat_calls`
the step does it to whole encode and decode calls instead, as the JAX
step's `_CheckpointedCalls` (`sivae_tpu/train/step.py:57-91`). Neither
changes the math: the reruns replay the forwards' dropout masks and batch
statistics, move no running statistic and issue no collective.

Spans (`utils/trace.py`, recorded only under a torch profiler): `step`
around the whole two-phase step, and in it each phase's `forward` (its
forwards and losses), `backward` and `update` (the gradient average and the
Adam step), as `phase_e.*` and `phase_d.*`; the plain steps' update as
`plain.backward` and `plain.update`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import functools

import numpy as np
import torch
import torch.nn.functional as F

from sivae_torch.config import OptimConfig, SoftIntroLossConfig
from sivae_torch.models.blocks import Dropout
from sivae_torch.models.remat import region, remat_policy_by_name
from sivae_torch.models.resnet_vae import SoftIntroVAE, bottom_depth, reparameterize
from sivae_torch.ops.losses import (calc_kl, calc_kl_per_position, calc_reconstruction_loss,
                                    normal_loss, soft_intro_decoder_loss,
                                    soft_intro_encoder_loss, voxel_mse)
from sivae_torch.parallel.distributed import grid, local_batch_slice, world_size
from sivae_torch.parallel.mesh import (average_gradients, depth_scale, global_mean, normal_rows,
                                       rank_generator, slab_shape, volume_slab)
from sivae_torch.train.state import SIVAETrainState, learning_rate
from sivae_torch.utils.dtypes import widen
from sivae_torch.utils.trace import span

Metrics = Dict[str, torch.Tensor]


def _dropouts(module: torch.nn.Module) -> List[Dropout]:
    return [m for m in module.modules() if isinstance(m, Dropout) and m.rate > 0.0]


def _set_generator(drops: Sequence[Dropout], gen: Optional[torch.Generator]) -> None:
    for m in drops:
        m.generator = gen


def _depth_axis(latent_shape) -> Optional[int]:
    """The depth axis of a (B,) + `latent_shape` latent: 2 for a spatial
    latent (1, d, h, w), None for a flat one."""
    return 2 if len(latent_shape) == 4 else None


def _flat_latent(model: torch.nn.Module) -> bool:
    """A flat latent (the FC family's (B, z)), whole on every spatial rank."""
    return _depth_axis(model.cfg.latent_shape) is None


def _kl(model: torch.nn.Module, dp: bool):
    """The step's KL, per position under dp_semantics, told whether the
    model's latent is flat."""
    return functools.partial(calc_kl_per_position if dp else calc_kl, flat=_flat_latent(model))


def _noise_batch(b: int, latent_shape, dev, zero_noise: bool, fixed_noise,
                 gen: Optional[torch.Generator]) -> torch.Tensor:
    """This rank's `b` rows (and, under depth sharding, depth slab) of the
    global batch's noise; `fixed_noise` holds the global batch's values."""
    shape = (b,) + tuple(latent_shape)
    axis = _depth_axis(latent_shape)
    if fixed_noise is not None:
        rows = b * grid().data
        full = torch.as_tensor(fixed_noise, dtype=torch.float32).to(dev)
        full = full.reshape((rows,) + tuple(latent_shape))[local_batch_slice(rows)]
        return full if axis is None else full[:, :, volume_slab(latent_shape[1])]
    if zero_noise:
        local = shape if axis is None else (b,) + slab_shape(latent_shape)
        return torch.zeros(local, dtype=torch.float32, device=dev)
    return normal_rows(shape, gen, dev, depth_axis=axis)


def _reparam(mu: torch.Tensor, logvar: torch.Tensor, val_eps: Optional[float],
             gen: Optional[torch.Generator], latent_shape: tuple) -> torch.Tensor:
    """`reparameterize`, whose random eps is drawn for the global batch and
    this rank's rows kept under data parallelism; under depth sharding for
    the whole `latent_shape` and this rank's depth slab kept."""
    if val_eps is not None or world_size() == 1:
        return reparameterize(mu, logvar, val_eps=val_eps, generator=gen)
    std = torch.exp(0.5 * widen(logvar))
    eps = normal_rows((std.shape[0],) + tuple(latent_shape), gen, std.device,
                      depth_axis=_depth_axis(latent_shape))
    return widen(mu) + eps * std


# the spans of an update's backward and of its averaging and Adam step
PHASE_E_SPANS = ("phase_e.backward", "phase_e.update")
PHASE_D_SPANS = ("phase_d.backward", "phase_d.update")
PLAIN_SPANS = ("plain.backward", "plain.update")


def _update(opt: torch.optim.Adam, loss: torch.Tensor, lr: float,
            spans: Tuple[str, str]) -> None:
    """One Adam update from `loss` at rate `lr`; under data parallelism the
    gradients are averaged over the ranks between the backward and the step.
    The backward and the rest are the two spans `spans` names."""
    with span(spans[0]):
        opt.zero_grad(set_to_none=True)
        loss.backward()
    with span(spans[1]):
        average_gradients(p for group in opt.param_groups for p in group["params"])
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()


def _elbo_recon(dp: bool):
    """The expELBO's reconstruction terms: per sample, or under dp_semantics
    the global batch's mean, which goes inside `exp` (`global_mean`; the
    per-sample sums are whole first, `calc_reconstruction_loss` takes them
    over the depth slabs)."""
    if dp:
        return lambda x, y: global_mean(calc_reconstruction_loss(x, y, reduction="mean"))
    return calc_reconstruction_loss


def make_soft_intro_train_step(
    model: SoftIntroVAE,
    loss_cfg: SoftIntroLossConfig,
    optim_cfg: OptimConfig,
    steps_per_epoch: int,
    input_shape: Tuple[int, int, int],
    remat_calls: bool = False,
    remat_calls_policy: Optional[str] = None,
    zero_noise: bool = False,
    fixed_noise=None,
    share_phase_d_dropout_keys: bool = True,
) -> Callable[[SIVAETrainState, torch.Tensor], Tuple[SIVAETrainState, Metrics]]:
    """Build the two-phase step: `state, metrics = step(state, real)` with
    `real` (B, 1, D, H, W) on the model's device. The state is updated in
    place and returned; the model is left in eval mode.

    remat_calls=True rematerialises each encode and decode call whole
    (`models/remat.py`): only its inputs, outputs and BN statistics stay
    between the forwards and the backward, plus the conv outputs that
    `remat_calls_policy` (a `remat_policy` name) keeps; None keeps none.
    It stands instead of the model's block remat, so a model built with
    `cfg.remat` raises here: its blocks would be recomputed twice.

    zero_noise=True makes the step deterministic (noise batch 0, every
    reparameterize returns mu): test support, never for real training.
    fixed_noise (an array of B * latent_dim values, B the global batch)
    replaces the noise batch and leaves zero_noise's eps behaviour as it is:
    a ZERO noise batch makes the fake path constant per channel, so every BN
    on it sees batch variance 0 and the gradients through it are rounding
    noise; a fixed non-zero batch keeps the comparison with the JAX step
    sharp.

    share_phase_d_dropout_keys=True (the JAX package's default) gives phase
    D's `decode(noise)` and `decode(z)` the masks phase E drew for them, so
    the two phases see the same `fake` and `rec`; False draws fresh masks, as
    the reference does.
    """
    scale = loss_cfg.resolved_scale(input_shape)
    eps0 = 0.0 if zero_noise else None
    dp = loss_cfg.dp_semantics
    kl = _kl(model, dp)
    recon = calc_reconstruction_loss
    elbo_recon = _elbo_recon(dp)
    enc_drops, dec_drops = _dropouts(model.encoder), _dropouts(model.decoder)
    share = share_phase_d_dropout_keys and bool(dec_drops)
    encode, decode = model.encode, model.decode
    if remat_calls:
        if getattr(model.cfg, "remat", False):
            raise ValueError("remat_calls rematerialises whole encode / decode calls: build "
                             "the model with remat=False, or its blocks are recomputed twice")
        saves = remat_policy_by_name(remat_calls_policy)
        # the whole depth over this rank's slab's at the coarsest resolution
        # (an FC model's bottleneck), as the model halves' own remat tags it
        bottom = bottom_depth(model.cfg)

        def encode(x):
            return region(model.encode, saves, "enc", x, depth_scale=depth_scale(bottom))

        def decode(z):
            return region(model.decode, saves, "dec", z, depth_scale=depth_scale(bottom))

    def train_step(state: SIVAETrainState, real: torch.Tensor):
        if state.model is not model:
            raise ValueError("the step was built for another model than the state holds")
        gen, dev, b = state.generator, real.device, real.shape[0]
        lr = learning_rate(optim_cfg, steps_per_epoch, state.step)
        # the dropout masks' generator: the state's own in one process
        drop_gen = gen if world_size() == 1 else rank_generator(gen, state.step)

        def reparam(mu, logvar):
            return _reparam(mu, logvar, eps0, gen, model.cfg.latent_shape)

        def replayed_decode(z, gen_state):
            """decode with the masks drawn at `gen_state` (phase E's)."""
            if gen_state is None:
                return decode(z)
            _set_generator(dec_drops, torch.Generator(device=dev).set_state(gen_state))
            try:
                return decode(z)
            finally:
                _set_generator(dec_drops, drop_gen)

        # ============ Phase E: update encoder ============ (my_trainer.py:241-288)
        def phase_e():
            with span("phase_e.forward"):
                model.decoder.requires_grad_(False)
                s_fake = drop_gen.get_state() if share else None
                fake = decode(noise)
                real_mu, real_logvar = encode(real)
                z = reparam(real_mu, real_logvar)
                s_rec = drop_gen.get_state() if share else None
                rec = decode(z)

                loss_rec = recon(real, rec, reduction="mean")
                kl_real = kl(real_logvar, real_mu, "mean")

                # model.forward(rec.detach()) / model.forward(fake.detach())
                rec_mu, rec_logvar = encode(rec.detach())
                rec_rec = decode(reparam(rec_mu, rec_logvar))
                fake_mu, fake_logvar = encode(fake.detach())
                rec_fake = decode(reparam(fake_mu, fake_logvar))

                # dp_semantics: the DP reconstruction loss ignores `reduction`, so
                # the expELBO recon terms are batch-mean scalars there, of the
                # global batch: they go inside exp
                loss_fake_rec = elbo_recon(fake, rec_fake)
                # the target `rec` is NOT detached here (my_trainer.py:275)
                loss_rec_rec = elbo_recon(rec, rec_rec)
                loss_e, e_fake, e_rec = soft_intro_encoder_loss(
                    loss_rec=loss_rec, kl_real=kl_real, loss_fake_rec=loss_fake_rec,
                    loss_rec_rec=loss_rec_rec, fake_kl=kl(fake_logvar, fake_mu, "none"),
                    rec_kl=kl(rec_logvar, rec_mu, "none"), scale=scale, beta_rec=loss_cfg.beta_rec,
                    beta_neg=loss_cfg.beta_neg, beta_kl=loss_cfg.beta_kl,
                    exp_elbo_weight=loss_cfg.exp_elbo_weight,
                    loss_multiplier=loss_cfg.loss_multiplier)
            _update(state.opt_e, loss_e, lr, PHASE_E_SPANS)
            model.decoder.requires_grad_(True)
            aux = {"lossE": loss_e, "kl_real": kl_real, "exp_elbo_fake": e_fake,
                   "exp_elbo_rec": e_rec}
            return {k: v.detach() for k, v in aux.items()}, z.detach(), s_fake, s_rec

        # ============ Phase D: update decoder ============ (my_trainer.py:290-324)
        # with the freshly updated encoder, as optimizer_e.step() precedes the
        # decoder graph in the reference
        def phase_d(z, s_fake, s_rec):
            with span("phase_d.forward"):
                model.encoder.requires_grad_(False)
                fake = replayed_decode(noise, s_fake)
                rec = replayed_decode(z, s_rec)
                # dp_semantics: the DP trainer detaches rec here, so its decoder
                # gets no reconstruction gradient from this term
                loss_rec = recon(real, rec.detach() if dp else rec, reduction="mean")

                rec_mu, rec_logvar = encode(rec)
                z_rec = reparam(rec_mu, rec_logvar)
                fake_mu, fake_logvar = encode(fake)
                z_fake = reparam(fake_mu, fake_logvar)
                # dp_semantics: the DP trainer does not detach z_rec / z_fake
                # before the re-decode, unlike my_trainer.py:310-311
                rec_rec = decode(z_rec if dp else z_rec.detach())
                rec_fake = decode(z_fake if dp else z_fake.detach())

                rec_kl = kl(rec_logvar, rec_mu, "mean")
                fake_kl = kl(fake_logvar, fake_mu, "mean")
                loss_d = soft_intro_decoder_loss(
                    loss_rec=loss_rec, rec_kl=rec_kl, fake_kl=fake_kl,
                    loss_rec_rec=recon(rec.detach(), rec_rec, reduction="mean"),
                    loss_fake_rec=recon(fake.detach(), rec_fake, reduction="mean"),
                    scale=scale, beta_rec=loss_cfg.beta_rec, beta_kl=loss_cfg.beta_kl,
                    gamma_r=loss_cfg.gamma_r, loss_multiplier=loss_cfg.loss_multiplier)
            _update(state.opt_d, loss_d, lr, PHASE_D_SPANS)
            model.encoder.requires_grad_(True)
            aux = {"lossD": loss_d, "loss_rec": loss_rec, "rec_kl": rec_kl, "fake_kl": fake_kl}
            return {k: v.detach() for k, v in aux.items()}

        with span("step"):
            model.train()
            _set_generator(enc_drops + dec_drops, drop_gen)
            try:
                noise = _noise_batch(b, model.cfg.latent_shape, dev, zero_noise, fixed_noise,
                                     gen)
                aux_e, z, s_fake, s_rec = phase_e()
                aux_d = phase_d(z, s_fake, s_rec)
            finally:
                _set_generator(enc_drops + dec_drops, None)
                model.requires_grad_(True)
                model.eval()
            state.step += 1
            metrics = {
                "lossE": aux_e["lossE"], "lossD": aux_d["lossD"], "loss_rec": aux_d["loss_rec"],
                "kl_real": aux_e["kl_real"], "rec_kl": aux_d["rec_kl"], "fake_kl": aux_d["fake_kl"],
                "exp_elbo_fake": aux_e["exp_elbo_fake"], "exp_elbo_rec": aux_e["exp_elbo_rec"],
                "diff_kl": aux_d["fake_kl"] - aux_e["kl_real"],
                # the reference's NaN guard (my_trainer.py:327-328), for the host
                # to read when it chooses to
                "nan": torch.isnan(aux_e["lossE"]) | torch.isnan(aux_d["lossD"]),
            }
        return state, metrics

    return train_step


def make_soft_intro_eval_step(
    model: SoftIntroVAE,
    loss_cfg: SoftIntroLossConfig,
    input_shape: Tuple[int, int, int],
    val_eps: float = 0.1,
    zero_noise: bool = False,
    fixed_noise=None,
    val_loss_multiplier: float = 1.0,
) -> Callable[[SIVAETrainState, torch.Tensor, Optional[torch.Generator]], Metrics]:
    """Validation pass (reference my_trainer.py:385-439): eval mode (running
    BN statistics, no dropout), the fixed eps = `val_eps` for the outer real /
    recon reparams, random eps inside the `model.forward` calls on rec / fake,
    the reference's own mix.

    val_loss_multiplier: the spatial trainer's validation loop reports the
    raw losses (no x10, unlike its train loop), the FC trainer's keeps the
    x10; pass `loss_cfg.loss_multiplier` for the latter.

    zero_noise=True zeroes the noise batch and the two random-eps reparams
    (the fixed-eps ones are untouched); fixed_noise replaces the noise batch
    and leaves that eps behaviour as it is. `generator` (on the data's device) feeds the
    random draws and may be None when there are none.
    """
    scale = loss_cfg.resolved_scale(input_shape)
    eps0 = 0.0 if zero_noise else None
    dp = loss_cfg.dp_semantics
    kl = _kl(model, dp)
    recon = calc_reconstruction_loss
    elbo_recon = _elbo_recon(dp)

    @torch.no_grad()
    def eval_step(state: SIVAETrainState, real: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> Metrics:
        if state.model is not model:
            raise ValueError("the step was built for another model than the state holds")
        model.eval()
        noise = _noise_batch(real.shape[0], model.cfg.latent_shape, real.device, zero_noise,
                             fixed_noise, generator)

        # --- encoder-side metrics ---
        fake = model.decode(noise)
        real_mu, real_logvar = model.encode(real)
        rec = model.decode(reparameterize(real_mu, real_logvar, val_eps=val_eps))
        loss_rec = recon(real, rec, reduction="mean")
        kl_real = kl(real_logvar, real_mu, "mean")

        rec_mu, rec_logvar = model.encode(rec)
        rec_rec = model.decode(_reparam(rec_mu, rec_logvar, eps0, generator,
                                        model.cfg.latent_shape))
        fake_mu, fake_logvar = model.encode(fake)
        rec_fake = model.decode(_reparam(fake_mu, fake_logvar, eps0, generator,
                                         model.cfg.latent_shape))
        loss_e, e_fake, e_rec = soft_intro_encoder_loss(
            loss_rec=loss_rec, kl_real=kl_real,
            loss_fake_rec=elbo_recon(fake, rec_fake),
            loss_rec_rec=elbo_recon(rec, rec_rec),
            fake_kl=kl(fake_logvar, fake_mu, "none"), rec_kl=kl(rec_logvar, rec_mu, "none"),
            scale=scale, beta_rec=loss_cfg.beta_rec, beta_neg=loss_cfg.beta_neg,
            beta_kl=loss_cfg.beta_kl, exp_elbo_weight=loss_cfg.exp_elbo_weight,
            loss_multiplier=val_loss_multiplier)

        # --- decoder-side metrics (eps = val_eps reparams, my_trainer.py:419-423) ---
        # the eval-mode encoder is deterministic: its outputs on rec / fake
        # are the ones above
        rec_rec2 = model.decode(reparameterize(rec_mu, rec_logvar, val_eps=val_eps))
        rec_fake2 = model.decode(reparameterize(fake_mu, fake_logvar, val_eps=val_eps))
        rec_kl = kl(rec_logvar, rec_mu, "mean")
        fake_kl = kl(fake_logvar, fake_mu, "mean")
        loss_d = soft_intro_decoder_loss(
            loss_rec=loss_rec, rec_kl=rec_kl, fake_kl=fake_kl,
            loss_rec_rec=recon(rec, rec_rec2, reduction="mean"),
            loss_fake_rec=recon(fake, rec_fake2, reduction="mean"),
            scale=scale, beta_rec=loss_cfg.beta_rec, beta_kl=loss_cfg.beta_kl,
            gamma_r=loss_cfg.gamma_r, loss_multiplier=val_loss_multiplier)
        return {"lossE": loss_e, "lossD": loss_d, "loss_rec": loss_rec, "kl_real": kl_real,
                "rec_kl": rec_kl, "fake_kl": fake_kl, "exp_elbo_fake": e_fake,
                "exp_elbo_rec": e_rec}

    return eval_step


# --------------------------------------------------------------------------
# Plain VAE / CAE / classifier steps (reference my_trainer.py:557-652,
# 763-910). One joint Adam (`create_train_state(joint_optimizer=True)`),
# one forward and one backward; the state is updated in place.
# --------------------------------------------------------------------------


def _plain_update(state: SIVAETrainState, model: torch.nn.Module, optim_cfg: OptimConfig,
                  steps_per_epoch: int, loss_fn: Callable[[], Tuple[torch.Tensor, Metrics]]):
    """Train mode with the state's generator on every dropout, `loss_fn()`,
    one update of the joint Adam at the scheduled rate; the model is left
    in eval mode. Returns the metrics, detached, with the `nan` flag."""
    if state.model is not model:
        raise ValueError("the step was built for another model than the state holds")
    if state.opt_d is not None:
        raise ValueError("the plain steps update one joint Adam: "
                         "create_train_state(..., joint_optimizer=True)")
    drops = _dropouts(model)
    model.train()
    gen = state.generator
    _set_generator(drops, gen if world_size() == 1 else rank_generator(gen, state.step))
    try:
        loss, aux = loss_fn()
        _update(state.opt_e, loss, learning_rate(optim_cfg, steps_per_epoch, state.step),
                PLAIN_SPANS)
    finally:
        _set_generator(drops, None)
        model.eval()
    state.step += 1
    return {**{k: v.detach() for k, v in aux.items()}, "nan": torch.isnan(loss.detach())}


def make_vae_train_step(model: SoftIntroVAE, optim_cfg: OptimConfig, steps_per_epoch: int,
                        mse_w: float = 1.0, kl_w: float = 1.0):
    """ELBO step over all parameters (train_ResNetVAE, my_trainer.py:557-652;
    loss = lossf.normal_loss with the CLI's mse / kl weights,
    vae_main.py:205): `state, metrics = step(state, real)`, metrics
    {"loss", "mse", "kl", "nan"}. The reparameterisation noise comes from
    the state's generator."""
    flat = _flat_latent(model)

    def train_step(state: SIVAETrainState, real: torch.Tensor):
        def loss_fn():
            mu, logvar = model.encode(real)
            x_re = model.decode(_reparam(mu, logvar, None, state.generator,
                                         model.cfg.latent_shape))
            loss, mse, kld = normal_loss(x_re, mu, logvar, real, msew=mse_w, kldw=kl_w,
                                         flat=flat)
            return loss, {"loss": loss, "mse": mse, "kl": kld}

        return state, _plain_update(state, model, optim_cfg, steps_per_epoch, loss_fn)

    return train_step


def make_vae_eval_step(model: SoftIntroVAE):
    """Eval mode, `metrics = step(state, real, generator)`. Quirk kept from
    the reference: its validation calls normal_loss with the defaults
    (my_trainer.py:616), so the weights are mse 1 and KL 10 whatever the
    training weights are (`sivae_tpu/train/step.py:451`)."""
    flat = _flat_latent(model)

    @torch.no_grad()
    def eval_step(state: SIVAETrainState, real: torch.Tensor,
                  generator: torch.Generator) -> Metrics:
        if state.model is not model:
            raise ValueError("the step was built for another model than the state holds")
        model.eval()
        mu, logvar = model.encode(real)
        x_re = model.decode(_reparam(mu, logvar, None, generator, model.cfg.latent_shape))
        loss, mse, kld = normal_loss(x_re, mu, logvar, real, msew=1.0, kldw=10.0, flat=flat)
        return {"loss": loss, "mse": mse, "kl": kld}

    return eval_step


def _labels(labels, dev) -> torch.Tensor:
    """Class indices on `dev`: from a host array, or from a tensor on any
    device (numpy cannot read a CUDA tensor)."""
    if isinstance(labels, torch.Tensor):
        return labels.to(dev).long()
    return torch.as_tensor(np.asarray(labels), device=dev).long()


def make_classifier_train_step(model: torch.nn.Module, optim_cfg: OptimConfig,
                               steps_per_epoch: int):
    """CrossEntropy step (reference `train`, my_trainer.py:829-910):
    `state, metrics = step(state, x, labels)`, metrics {"loss", "acc",
    "nan"}; `labels` a host array or a tensor of class indices."""

    def train_step(state: SIVAETrainState, x: torch.Tensor, labels):
        lab = _labels(labels, x.device)

        def loss_fn():
            logits = model(x)
            loss = F.cross_entropy(logits, lab)
            acc = (logits.argmax(-1) == lab).float().mean()
            return loss, {"loss": loss, "acc": acc}

        return state, _plain_update(state, model, optim_cfg, steps_per_epoch, loss_fn)

    return train_step


def make_classifier_eval_step(model: torch.nn.Module):
    """`metrics, predictions = step(state, x, labels)` in eval mode."""

    @torch.no_grad()
    def eval_step(state: SIVAETrainState, x: torch.Tensor, labels):
        if state.model is not model:
            raise ValueError("the step was built for another model than the state holds")
        model.eval()
        lab = _labels(labels, x.device)
        logits = model(x)
        pred = logits.argmax(-1)
        return {"loss": F.cross_entropy(logits, lab), "acc": (pred == lab).float().mean()}, pred

    return eval_step


def make_cae_train_step(model: SoftIntroVAE, optim_cfg: OptimConfig, steps_per_epoch: int):
    """CAE step: the encoder's latent straight into the decoder, the
    elementwise-mean MSE (torch nn.MSELoss default, my_trainer.py:777):
    `state, metrics = step(state, real)`, metrics {"loss", "nan"}."""

    def train_step(state: SIVAETrainState, real: torch.Tensor):
        def loss_fn():
            out = model.decode(model.encode(real))
            loss = voxel_mse(out, real)
            return loss, {"loss": loss}

        return state, _plain_update(state, model, optim_cfg, steps_per_epoch, loss_fn)

    return train_step
