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
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sivae_torch.config import OptimConfig, SoftIntroLossConfig
from sivae_torch.models.blocks import Dropout
from sivae_torch.models.resnet_vae import SoftIntroVAE, reparameterize
from sivae_torch.ops.losses import (calc_kl, calc_kl_per_position, calc_reconstruction_loss,
                                    normal_loss, soft_intro_decoder_loss,
                                    soft_intro_encoder_loss)
from sivae_torch.train.state import SIVAETrainState, learning_rate

Metrics = Dict[str, torch.Tensor]


def _dropouts(module: torch.nn.Module) -> List[Dropout]:
    return [m for m in module.modules() if isinstance(m, Dropout) and m.rate > 0.0]


def _set_generator(drops: Sequence[Dropout], gen: Optional[torch.Generator]) -> None:
    for m in drops:
        m.generator = gen


def _noise_batch(b: int, latent_shape, dev, zero_noise: bool, fixed_noise,
                 gen: Optional[torch.Generator]) -> torch.Tensor:
    shape = (b,) + tuple(latent_shape)
    if fixed_noise is not None:
        return torch.as_tensor(fixed_noise, dtype=torch.float32).to(dev).reshape(shape)
    if zero_noise:
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)


def make_soft_intro_train_step(
    model: SoftIntroVAE,
    loss_cfg: SoftIntroLossConfig,
    optim_cfg: OptimConfig,
    steps_per_epoch: int,
    input_shape: Tuple[int, int, int],
    zero_noise: bool = False,
    fixed_noise=None,
    share_phase_d_dropout_keys: bool = True,
) -> Callable[[SIVAETrainState, torch.Tensor], Tuple[SIVAETrainState, Metrics]]:
    """Build the two-phase step: `state, metrics = step(state, real)` with
    `real` (B, 1, D, H, W) on the model's device. The state is updated in
    place and returned; the model is left in eval mode.

    zero_noise=True makes the step deterministic (noise batch 0, every
    reparameterize returns mu): test support, never for real training.
    fixed_noise (an array of B * latent_dim values) replaces the noise batch
    and leaves zero_noise's eps behaviour as it is: a ZERO noise batch makes the
    fake path constant per channel, so every BN on it sees batch variance 0
    and the gradients through it are rounding noise; a fixed non-zero batch
    keeps the comparison with the JAX step sharp.

    share_phase_d_dropout_keys=True (the JAX package's default) gives phase
    D's `decode(noise)` and `decode(z)` the masks phase E drew for them, so
    the two phases see the same `fake` and `rec`; False draws fresh masks, as
    the reference does.
    """
    scale = loss_cfg.resolved_scale(input_shape)
    eps0 = 0.0 if zero_noise else None
    dp = loss_cfg.dp_semantics
    kl = calc_kl_per_position if dp else calc_kl
    recon = calc_reconstruction_loss
    enc_drops, dec_drops = _dropouts(model.encoder), _dropouts(model.decoder)
    share = share_phase_d_dropout_keys and bool(dec_drops)

    def train_step(state: SIVAETrainState, real: torch.Tensor):
        if state.model is not model:
            raise ValueError("the step was built for another model than the state holds")
        gen, dev, b = state.generator, real.device, real.shape[0]
        lr = learning_rate(optim_cfg, steps_per_epoch, state.step)

        def reparam(mu, logvar):
            return reparameterize(mu, logvar, val_eps=eps0, generator=gen)

        def replayed_decode(z, gen_state):
            """decode with the masks drawn at `gen_state` (phase E's)."""
            if gen_state is None:
                return model.decode(z)
            _set_generator(dec_drops, torch.Generator(device=dev).set_state(gen_state))
            try:
                return model.decode(z)
            finally:
                _set_generator(dec_drops, gen)

        def update(opt, loss):
            opt.zero_grad(set_to_none=True)
            loss.backward()
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()

        # ============ Phase E: update encoder ============ (my_trainer.py:241-288)
        def phase_e():
            model.decoder.requires_grad_(False)
            s_fake = gen.get_state() if share else None
            fake = model.decode(noise)
            real_mu, real_logvar = model.encode(real)
            z = reparam(real_mu, real_logvar)
            s_rec = gen.get_state() if share else None
            rec = model.decode(z)

            loss_rec = recon(real, rec, reduction="mean")
            kl_real = kl(real_logvar, real_mu, "mean")

            # model.forward(rec.detach()) / model.forward(fake.detach())
            rec_mu, rec_logvar = model.encode(rec.detach())
            rec_rec = model.decode(reparam(rec_mu, rec_logvar))
            fake_mu, fake_logvar = model.encode(fake.detach())
            rec_fake = model.decode(reparam(fake_mu, fake_logvar))

            # dp_semantics: the DP reconstruction loss ignores `reduction`, so
            # the expELBO recon terms are batch-mean scalars there
            elbo_red = "mean" if dp else "none"
            loss_fake_rec = recon(fake, rec_fake, reduction=elbo_red)
            # the target `rec` is NOT detached here (my_trainer.py:275)
            loss_rec_rec = recon(rec, rec_rec, reduction=elbo_red)
            loss_e, e_fake, e_rec = soft_intro_encoder_loss(
                loss_rec=loss_rec, kl_real=kl_real, loss_fake_rec=loss_fake_rec,
                loss_rec_rec=loss_rec_rec, fake_kl=kl(fake_logvar, fake_mu, "none"),
                rec_kl=kl(rec_logvar, rec_mu, "none"), scale=scale, beta_rec=loss_cfg.beta_rec,
                beta_neg=loss_cfg.beta_neg, beta_kl=loss_cfg.beta_kl,
                exp_elbo_weight=loss_cfg.exp_elbo_weight,
                loss_multiplier=loss_cfg.loss_multiplier)
            update(state.opt_e, loss_e)
            model.decoder.requires_grad_(True)
            aux = {"lossE": loss_e, "kl_real": kl_real, "exp_elbo_fake": e_fake,
                   "exp_elbo_rec": e_rec}
            return {k: v.detach() for k, v in aux.items()}, z.detach(), s_fake, s_rec

        # ============ Phase D: update decoder ============ (my_trainer.py:290-324)
        # with the freshly updated encoder, as optimizer_e.step() precedes the
        # decoder graph in the reference
        def phase_d(z, s_fake, s_rec):
            model.encoder.requires_grad_(False)
            fake = replayed_decode(noise, s_fake)
            rec = replayed_decode(z, s_rec)
            # dp_semantics: the DP trainer detaches rec here, so its decoder
            # gets no reconstruction gradient from this term
            loss_rec = recon(real, rec.detach() if dp else rec, reduction="mean")

            rec_mu, rec_logvar = model.encode(rec)
            z_rec = reparam(rec_mu, rec_logvar)
            fake_mu, fake_logvar = model.encode(fake)
            z_fake = reparam(fake_mu, fake_logvar)
            # dp_semantics: the DP trainer does not detach z_rec / z_fake
            # before the re-decode, unlike my_trainer.py:310-311
            rec_rec = model.decode(z_rec if dp else z_rec.detach())
            rec_fake = model.decode(z_fake if dp else z_fake.detach())

            rec_kl = kl(rec_logvar, rec_mu, "mean")
            fake_kl = kl(fake_logvar, fake_mu, "mean")
            loss_d = soft_intro_decoder_loss(
                loss_rec=loss_rec, rec_kl=rec_kl, fake_kl=fake_kl,
                loss_rec_rec=recon(rec.detach(), rec_rec, reduction="mean"),
                loss_fake_rec=recon(fake.detach(), rec_fake, reduction="mean"),
                scale=scale, beta_rec=loss_cfg.beta_rec, beta_kl=loss_cfg.beta_kl,
                gamma_r=loss_cfg.gamma_r, loss_multiplier=loss_cfg.loss_multiplier)
            update(state.opt_d, loss_d)
            model.encoder.requires_grad_(True)
            aux = {"lossD": loss_d, "loss_rec": loss_rec, "rec_kl": rec_kl, "fake_kl": fake_kl}
            return {k: v.detach() for k, v in aux.items()}

        model.train()
        _set_generator(enc_drops + dec_drops, gen)
        try:
            noise = _noise_batch(b, model.cfg.latent_shape, dev, zero_noise, fixed_noise, gen)
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
    kl = calc_kl_per_position if dp else calc_kl
    recon = calc_reconstruction_loss

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
        rec_rec = model.decode(reparameterize(rec_mu, rec_logvar, val_eps=eps0,
                                              generator=generator))
        fake_mu, fake_logvar = model.encode(fake)
        rec_fake = model.decode(reparameterize(fake_mu, fake_logvar, val_eps=eps0,
                                               generator=generator))
        elbo_red = "mean" if dp else "none"
        loss_e, e_fake, e_rec = soft_intro_encoder_loss(
            loss_rec=loss_rec, kl_real=kl_real,
            loss_fake_rec=recon(fake, rec_fake, reduction=elbo_red),
            loss_rec_rec=recon(rec, rec_rec, reduction=elbo_red),
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
    _set_generator(drops, state.generator)
    try:
        loss, aux = loss_fn()
        state.opt_e.zero_grad(set_to_none=True)
        loss.backward()
        for group in state.opt_e.param_groups:
            group["lr"] = learning_rate(optim_cfg, steps_per_epoch, state.step)
        state.opt_e.step()
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

    def train_step(state: SIVAETrainState, real: torch.Tensor):
        def loss_fn():
            mu, logvar = model.encode(real)
            x_re = model.decode(reparameterize(mu, logvar, generator=state.generator))
            loss, mse, kld = normal_loss(x_re, mu, logvar, real, msew=mse_w, kldw=kl_w)
            return loss, {"loss": loss, "mse": mse, "kl": kld}

        return state, _plain_update(state, model, optim_cfg, steps_per_epoch, loss_fn)

    return train_step


def make_vae_eval_step(model: SoftIntroVAE):
    """Eval mode, `metrics = step(state, real, generator)`. Quirk kept from
    the reference: its validation calls normal_loss with the defaults
    (my_trainer.py:616), so the weights are mse 1 and KL 10 whatever the
    training weights are (`sivae_tpu/train/step.py:451`)."""

    @torch.no_grad()
    def eval_step(state: SIVAETrainState, real: torch.Tensor,
                  generator: torch.Generator) -> Metrics:
        if state.model is not model:
            raise ValueError("the step was built for another model than the state holds")
        model.eval()
        mu, logvar = model.encode(real)
        x_re = model.decode(reparameterize(mu, logvar, generator=generator))
        loss, mse, kld = normal_loss(x_re, mu, logvar, real, msew=1.0, kldw=10.0)
        return {"loss": loss, "mse": mse, "kl": kld}

    return eval_step


def _labels(labels, dev) -> torch.Tensor:
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
            loss = torch.mean((out.float() - real.float()) ** 2)
            return loss, {"loss": loss}

        return state, _plain_update(state, model, optim_cfg, steps_per_epoch, loss_fn)

    return train_step
