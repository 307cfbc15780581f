"""Functional losses for VAE / Soft-IntroVAE training.

Port of `sivae_tpu/ops/losses.py:28-198`, function for function:

- reconstruction: squared error summed over voxels per sample, then
  optionally the mean over the batch (reference utils/my_trainer.py:62-78);
- KL: analytic KL(N(mu, sigma) || N(0, I)) summed over latent dims per
  sample, then optionally reduced over the batch (my_trainer.py:38-48);
- the Soft-IntroVAE encoder / decoder objectives with their expELBO terms
  (my_trainer.py:260-321).

Every reduction is taken in float32 whatever the activation type: the
expELBO term exponentiates `-2 s (beta_rec rec + 1024 kl)`, which underflows
quickly, and conv outputs may be bfloat16.

Under depth sharding (`parallel/mesh.py`) the volumes and latents here are
this rank's depth slabs: every sum over voxels or latent positions is a
partial sum, added over the ranks of the same rows (`spatial_sum`, or
`spatial_mean` for a mean over positions) before any non-linear term (the
expELBO's `exp`) or batch reduction sees it; a whole value that meets a
per-position term goes through `spatial_broadcast`. A flat latent (the FC
family's (B, z)) is whole on every spatial rank, so its KL is not summed
over the ranks (P times the KL): the caller says which latent it passes
(`flat`), from the model's config.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from sivae_torch.parallel.mesh import spatial_broadcast, spatial_mean, spatial_sum
from sivae_torch.utils.dtypes import widen

Tensor = torch.Tensor


def _flatten_per_sample(x: Tensor) -> Tensor:
    return widen(x.reshape(x.shape[0], -1))


def _reduce(per_item: Tensor, reduce: str) -> Tensor:
    if reduce == "mean":
        return per_item.mean()
    if reduce == "sum":
        return per_item.sum()
    return per_item


def _reduce_positions(per_position: Tensor, reduce: str) -> Tensor:
    """`_reduce` of a (B, d, h, w) tensor over a depth-sharded latent: the
    mean and the sum over the whole latent."""
    if reduce == "mean":
        return spatial_mean(per_position)
    if reduce == "sum":
        return spatial_sum(per_position.sum())
    return per_position


def calc_reconstruction_loss(x: Tensor, recon_x: Tensor, reduction: str = "none") -> Tensor:
    """Sum of squares over voxels per sample; batch mean iff reduction='mean'."""
    per_sample = ((_flatten_per_sample(x) - _flatten_per_sample(recon_x)) ** 2).sum(dim=1)
    per_sample = spatial_sum(per_sample)
    return per_sample.mean() if reduction == "mean" else per_sample


def _latent_sum(per_sample: Tensor, flat: bool) -> Tensor:
    """A per-sample sum over this rank's latent: over the slabs for a
    spatial latent, as it is for a flat one (whole on every rank)."""
    return per_sample if flat else spatial_sum(per_sample)


def calc_kl(logvar: Tensor, mu: Tensor, reduce: str = "none", flat: bool = False) -> Tensor:
    """Analytic KL to N(0, I): per-sample sum over latent dims. Argument
    order (logvar, mu) as in the reference; `flat` for a flat latent (module
    docstring)."""
    mu, logvar = _flatten_per_sample(mu), _flatten_per_sample(logvar)
    kl = -0.5 * _latent_sum((1.0 + logvar - mu ** 2 - torch.exp(logvar)).sum(dim=1), flat)
    return _reduce(kl, reduce)


def _as_prior(v: Union[Tensor, float], like: Tensor) -> Tensor:
    v = torch.as_tensor(v, dtype=torch.float32, device=like.device)
    return v.reshape(v.shape[0], -1) if v.dim() > 1 else v


def calc_kl_general(logvar: Tensor, mu: Tensor, mu_o: Union[Tensor, float] = 0.0,
                    logvar_o: Union[Tensor, float] = 0.0, reduce: str = "none",
                    flat: bool = False) -> Tensor:
    """KL(N(mu, e^logvar) || N(mu_o, e^logvar_o)), the generalized form of
    the DataParallel trainer (reference main_DataParallel.py:87-98)."""
    mu, logvar = _flatten_per_sample(mu), _flatten_per_sample(logvar)
    mu_o, logvar_o = _as_prior(mu_o, mu), _as_prior(logvar_o, mu)
    kl = -0.5 * _latent_sum((1.0 + logvar - logvar_o - (mu - mu_o) ** 2 * torch.exp(-logvar_o)
                             - torch.exp(logvar - logvar_o)).sum(dim=1), flat)
    return _reduce(kl, reduce)


def calc_kl_per_position(logvar: Tensor, mu: Tensor, reduce: str = "none",
                         flat: bool = False) -> Tensor:
    """KL summed over the CHANNEL axis only: the DataParallel trainer's
    calc_kl never flattens, so its `.sum(1)` hits the singleton channel of
    the conv latent (B, 1, d, h, w) and the result is a per-position KL of
    shape (B, d, h, w); 'mean' then divides by B*d*h*w, not B. The port's
    tensors are NCDHW, so the channel axis is 1 (axis -1 in the JAX package).
    A flat latent (B, z) has no positions: its KL is `calc_kl`'s.
    """
    mu, logvar = mu.float(), logvar.float()
    kl = -0.5 * (1.0 + logvar - mu ** 2 - torch.exp(logvar)).sum(dim=1)
    return _reduce(kl, reduce) if flat else _reduce_positions(kl, reduce)


# --- plain-VAE losses (reference models/lossf.py) --------------------------


def voxel_mse(out: Tensor, x: Tensor) -> Tensor:
    """The mean squared error over every voxel of the batch (torch
    `nn.MSELoss`'s default), in fp32."""
    return spatial_mean((out.float() - x.float()) ** 2)


def mse_loss(out: Tensor, x: Tensor) -> Tensor:
    """Sum over voxels, mean over the batch (models/lossf.py:5-12)."""
    return calc_reconstruction_loss(x, out, reduction="mean")


def kld_loss(mu: Tensor, logvar: Tensor, flat: bool = False) -> Tensor:
    """models/lossf.py:14-18."""
    return calc_kl(logvar, mu, reduce="mean", flat=flat)


def normal_loss(x_hat: Tensor, mu: Tensor, logvar: Tensor, x: Tensor, msew: float = 1.0,
                kldw: float = 10.0, flat: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    """Weighted ELBO of the plain ResNetVAE path (models/lossf.py:20-24)."""
    mse = mse_loss(x_hat, x) * msew
    kld = kld_loss(mu, logvar, flat) * kldw
    return mse + kld, mse, kld


def localized_loss(x_hat: Tensor, mu: Tensor, logvar: Tensor, localize_loss: Tensor, x: Tensor,
                   msew: float = 1.0, kldw: float = 1.0,
                   localizew: float = 1.0, flat: bool = False
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """ELBO plus an externally supplied per-sample localization term (sum
    over dim 1, mean over the batch; models/lossf.py:26-31)."""
    mse = mse_loss(x_hat, x) * msew
    kld = kld_loss(mu, logvar, flat) * kldw
    loc = localize_loss.float().sum(dim=1).mean() * localizew
    return mse + kld + loc, mse, kld, loc


# --- Soft-IntroVAE objectives ----------------------------------------------


def exp_elbo(rec_per_sample: Tensor, kl_per_sample: Tensor, *, scale: float, beta_rec: float,
             beta_neg: float) -> Tensor:
    """mean_b exp(-2 s (beta_rec rec_b + beta_neg kl_b)), in fp32
    (my_trainer.py:278-279). The argument is large and negative for confident
    fakes, so this underflows to 0. A per-position KL (dp_semantics: (B, d,
    h, w)) makes it a mean over the whole latent's positions too."""
    if kl_per_sample.dim() > 1:   # on this rank's slab of the latent
        rec_per_sample = spatial_broadcast(rec_per_sample)
    arg = -2.0 * scale * (beta_rec * rec_per_sample + beta_neg * kl_per_sample)
    e = torch.exp(widen(arg))
    return spatial_mean(e) if e.dim() > 1 else e.mean()


def soft_intro_encoder_loss(*, loss_rec: Tensor, kl_real: Tensor, loss_fake_rec: Tensor,
                            loss_rec_rec: Tensor, fake_kl: Tensor, rec_kl: Tensor, scale: float,
                            beta_rec: float, beta_neg: float, beta_kl: float,
                            exp_elbo_weight: float = 0.5,
                            loss_multiplier: float = 10.0) -> Tuple[Tensor, Tensor, Tensor]:
    """Encoder (discriminator-side) loss (my_trainer.py:278-284): scalar
    `loss_rec` and `kl_real`, per-sample fake / rec terms.
    Returns (lossE, exp_elbo_fake, exp_elbo_rec)."""
    e_fake = exp_elbo(loss_fake_rec, fake_kl, scale=scale, beta_rec=beta_rec, beta_neg=beta_neg)
    e_rec = exp_elbo(loss_rec_rec, rec_kl, scale=scale, beta_rec=beta_rec, beta_neg=beta_neg)
    loss_e = scale * (beta_rec * loss_rec + beta_kl * kl_real) + exp_elbo_weight * (e_fake + e_rec)
    return loss_e * loss_multiplier, e_fake, e_rec


def soft_intro_decoder_loss(*, loss_rec: Tensor, rec_kl: Tensor, fake_kl: Tensor,
                            loss_rec_rec: Tensor, loss_fake_rec: Tensor, scale: float,
                            beta_rec: float, beta_kl: float, gamma_r: float,
                            loss_multiplier: float = 10.0) -> Tensor:
    """Decoder (generator-side) loss over scalar terms (my_trainer.py:319-321)."""
    loss_d = scale * (beta_rec * loss_rec + 0.5 * beta_kl * (rec_kl + fake_kl)
                      + gamma_r * 0.5 * beta_rec * (loss_rec_rec + loss_fake_rec))
    return loss_d * loss_multiplier
