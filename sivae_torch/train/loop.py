"""The epoch loops: `SoftIntroTrainer`, and the plain `VAETrainer`,
`CAETrainer` and `ClassifierTrainer`.

Port of `sivae_tpu/train/loop.py:55-452` (reference utils/my_trainer.py:
147-508, :557-652, :763-910). As in the JAX package, and unlike the
reference:
- the step's metrics are 0-d device tensors, summed on the device; the host
  reads the sums once an epoch (the reference's `.item()` per batch makes
  the host wait on the card every step);
- the NaN guard is read from the epoch's sums and raises FloatingPointError
  at the end of the epoch (the reference raises SystemError per batch,
  my_trainer.py:327-328);
- checkpoints carry the full train state (optimizers and generator too).

Resuming keeps the JAX package's behaviour: `try_resume` restores the state,
and `fit` still counts epochs from 0, so a resumed run logs epochs 0, 1, ...
again (with a new CSV header), draws epoch 0's order again, and its
checkpoint manager skips the steps that the directory already holds.

The plain trainers keep the JAX package's cadences: a checkpoint every 10
epochs (the reference's, my_trainer.py:628) for the VAE and CAE, none for
the classifier, and no resume from the CLI.

Under data parallelism (`sivae_torch/parallel/`) every rank builds the same
trainer, and `replicate_state` checks that the ranks hold the same state
after construction and after a resume. Each rank's pipelines feed its rows
of every global batch (validation included); the epoch means are averaged
over the ranks, the `nan` flag with them, so every rank raises together.
The logs, checkpoints, plots and panels are written by rank 0 only; each
save ends at a barrier (`CheckpointManager.save`).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from sivae_torch.config import OptimConfig, SoftIntroLossConfig, TrainConfig
from sivae_torch.eval.recon_quality import eval_mode, reconstruct
from sivae_torch.models.resnet_vae import SoftIntroVAE, SpatialDecoder, SpatialEncoder
from sivae_torch.parallel.distributed import is_main_process
from sivae_torch.parallel.mesh import mean_across, replicate_state
from sivae_torch.train.state import create_train_state
from sivae_torch.train.step import (make_cae_train_step, make_classifier_eval_step,
                                    make_classifier_train_step, make_soft_intro_eval_step,
                                    make_soft_intro_train_step, make_vae_eval_step,
                                    make_vae_train_step)
from sivae_torch.utils.checkpoint import CheckpointManager
from sivae_torch.utils.device import resolve_device
from sivae_torch.utils.logging import MetricsLogger
from sivae_torch.utils.plots import (matplotlib_missing, plot_ae_losses, plot_kl_stats,
                                     plot_soft_intro_losses, save_recon_panel)


def _add(sums: Optional[Dict[str, torch.Tensor]], metrics: Dict[str, torch.Tensor]):
    """Running sums on the metrics' device (the `nan` flag counts)."""
    metrics = {k: v.float() for k, v in metrics.items()}
    return metrics if sums is None else {k: sums[k] + metrics[k] for k in sums}


def _to_host(sums: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """One device-to-host copy for the whole dict, of the means over the
    ranks under data parallelism (every rank runs as many batches)."""
    values = mean_across(torch.stack(list(sums.values()))).cpu().tolist()
    return dict(zip(sums, values))


def _means(batches, fn) -> Dict[str, float]:
    """Means over `batches` ((voxels, labels) pairs) of the metrics that
    `fn(voxels, labels)` returns, summed on the device and read once; {}
    when there is no batch."""
    sums, n = None, 0
    for vox, lab in batches:
        sums, n = _add(sums, fn(vox, lab)), n + 1
    return {k: v / n for k, v in _to_host(sums).items()} if n else {}


def _train_means(batches, step, epoch: int) -> Dict[str, float]:
    """One train epoch: the means of the metrics that `step(voxels, labels)`
    returns (the steps update the state in place); raises at the end of the
    epoch when any step's loss was NaN."""
    means = _means(batches, step)
    if not means:
        raise ValueError(f"epoch {epoch}: the pipeline gave no batch")
    if means.pop("nan") > 0:
        raise FloatingPointError(f"NaN in the loss during epoch {epoch} "
                                 "(reference raises SystemError, my_trainer.py:327-328)")
    return means


def _plot_ae(history, run_dir: str) -> None:
    if is_main_process() and matplotlib_missing() is None:
        plot_ae_losses(history, run_dir)


class SoftIntroTrainer:
    """Owns the train state, the two steps, the logs and the checkpoints."""

    def __init__(
        self,
        model,
        loss_cfg: SoftIntroLossConfig = SoftIntroLossConfig(),
        optim_cfg: OptimConfig = OptimConfig(),
        train_cfg: TrainConfig = TrainConfig(),
        run_dir: str = "./runs/soft_intro",
        steps_per_epoch: int = 1,
        keep_checkpoints: int = 3,
    ):
        """`model` is already on its device (`models.registry.make_model`);
        its configuration is `model.cfg`. `steps_per_epoch` places the LR
        milestones (the pipeline's)."""
        self.model = model
        self.model_cfg = model.cfg
        self.loss_cfg = loss_cfg
        self.train_cfg = train_cfg
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.logger = MetricsLogger(run_dir)
        self.ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"),
                                      max_to_keep=keep_checkpoints)
        self.device = next(model.parameters()).device
        self.state = replicate_state(create_train_state(model, seed=train_cfg.seed,
                                                        optim_cfg=optim_cfg))
        shape = model.cfg.input_shape
        self._step = make_soft_intro_train_step(model, loss_cfg, optim_cfg, steps_per_epoch, shape)
        self._eval = make_soft_intro_eval_step(model, loss_cfg, shape, val_eps=train_cfg.val_eps)
        self.n_voxels = int(np.prod(shape))

    # -- warm start (reference pretrained_path, my_trainer.py:179-180) ------
    def try_resume(self) -> Optional[int]:
        latest = self.ckpt.latest_step()
        if latest is not None:
            replicate_state(self.ckpt.restore(self.state, latest))
        return latest

    def train_epoch(self, pipeline, epoch: int) -> Dict[str, float]:
        avg = _train_means(pipeline.epoch(epoch), lambda vox, _: self._step(self.state, vox)[1],
                           epoch)
        # RMSE per reference my_trainer.py:353-354
        avg["rmse"] = float(np.sqrt(avg["loss_rec"] / self.n_voxels))
        return avg

    def eval_epoch(self, pipeline, epoch: int) -> Dict[str, float]:
        gen = torch.Generator(device=self.device).manual_seed(self.train_cfg.seed * 1000 + epoch)
        # val order fixed (no shuffle anyway)
        avg = _means(pipeline.epoch(0), lambda vox, _: self._eval(self.state, vox, gen))
        if avg:
            avg["rmse"] = float(np.sqrt(avg["loss_rec"] / self.n_voxels))
        return avg

    def save_panels(self, pipeline, epoch: int, val_pipeline=None) -> None:
        """Recon / fake panels from the first train batch and, as the
        reference's in-training val panels (my_trainer.py:455-463), a val
        original / recon panel when a val pipeline is given. Eval mode; the
        model's mode is put back afterwards."""
        with eval_mode(self.model):
            vox, _ = pipeline.first_batch()
            val_eps = self.train_cfg.val_eps
            img_dir = os.path.join(self.run_dir, "imgs")
            save_recon_panel(vox, reconstruct(self.model, vox, val_eps),
                             os.path.join(img_dir, f"rec_epoch{epoch}.jpg"))
            gen = torch.Generator(device=self.device).manual_seed(epoch + 1)
            fake = self.model.sample_with_noise(min(8, vox.shape[0]), gen)
            save_recon_panel(vox, fake, os.path.join(img_dir, f"fake_epoch{epoch}.jpg"))
            if val_pipeline is not None:
                vvox, _ = val_pipeline.first_batch()
                save_recon_panel(
                    vvox, reconstruct(self.model, vvox, val_eps),
                    os.path.join(self.run_dir, "val_imgs", f"val_rec_epoch{epoch}.jpg"))

    def fit(self, train_pipeline, val_pipeline=None, epochs: Optional[int] = None,
            verbose: bool = True) -> Dict[str, List[float]]:
        epochs = epochs if epochs is not None else self.train_cfg.epochs
        tc = self.train_cfg
        main = is_main_process()
        no_plots = matplotlib_missing() if main else "not rank 0"
        if main and no_plots is not None:
            print(f"[plots] loss plots and image panels skipped: matplotlib does not import "
                  f"({no_plots}); the CSV / JSONL / txt logs are written", flush=True)
        for epoch in range(epochs):
            t0 = time.time()
            train_m = self.train_epoch(train_pipeline, epoch)
            val_m = {}
            if val_pipeline is not None and (epoch % tc.eval_every_epochs == 0):
                val_m = self.eval_epoch(val_pipeline, epoch)
            self.logger.append(
                train_lossE=train_m["lossE"], train_lossD=train_m["lossD"],
                val_lossE=val_m.get("lossE", float("nan")),
                val_lossD=val_m.get("lossD", float("nan")),
                kls_real=train_m["kl_real"], kls_fake=train_m["fake_kl"],
                kls_rec=train_m["rec_kl"], rec_errs=train_m["loss_rec"],
                train_rmse=train_m["rmse"], val_rmse=val_m.get("rmse", float("nan")),
            )
            self.logger.write_epoch(epoch, {
                "train_lossE": train_m["lossE"], "train_lossD": train_m["lossD"],
                "val_lossE": val_m.get("lossE", float("nan")),
                "val_lossD": val_m.get("lossD", float("nan")),
                "train_rmse": train_m["rmse"], "val_rmse": val_m.get("rmse", float("nan")),
                "kls_real": train_m["kl_real"], "kls_fake": train_m["fake_kl"],
                "kls_rec": train_m["rec_kl"],
            })
            self.logger.write_loss_txt()
            self.logger.write_kl_txt()
            if epoch % tc.checkpoint_every_epochs == 0:
                self.ckpt.save(epoch, self.state)
            if (no_plots is None and tc.log_images_every_epochs
                    and epoch % tc.log_images_every_epochs == 0):
                self.save_panels(train_pipeline, epoch, val_pipeline=val_pipeline)
            if verbose and main:
                print(self.logger.epoch_line(epoch, epochs, train_m, val_m,
                                             time.time() - t0), flush=True)
        if no_plots is None:
            plot_soft_intro_losses(self.logger.history, self.run_dir)
            plot_kl_stats(self.logger.history, self.run_dir)
        self.ckpt.close()
        return self.logger.history


class VAETrainer:
    """Plain ELBO trainer (reference train_ResNetVAE, my_trainer.py:557-652):
    one joint Adam, a checkpoint every `checkpoint_every` epochs."""

    def __init__(
        self,
        model: SoftIntroVAE,
        optim_cfg: OptimConfig = OptimConfig(),
        train_cfg: TrainConfig = TrainConfig(),
        mse_w: float = 1.0,
        kl_w: float = 1.0,  # vae_main.py:54 default (kldw=10 is val-side only)
        run_dir: str = "./runs/vae",
        steps_per_epoch: int = 1,
        keep_checkpoints: int = 3,
        checkpoint_every: int = 10,  # reference cadence, my_trainer.py:628
    ):
        self.model = model
        self.train_cfg = train_cfg
        self.run_dir = run_dir
        self.checkpoint_every = checkpoint_every
        os.makedirs(run_dir, exist_ok=True)
        self.logger = MetricsLogger(run_dir, csv_columns=["epoch", "train_loss", "val_loss"])
        self.ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"),
                                      max_to_keep=keep_checkpoints)
        self.device = next(model.parameters()).device
        self.state = replicate_state(create_train_state(
            model, seed=train_cfg.seed, optim_cfg=optim_cfg, joint_optimizer=True))
        self._step = make_vae_train_step(model, optim_cfg, steps_per_epoch, mse_w, kl_w)
        self._eval = make_vae_eval_step(model)

    def fit(self, train_pipeline, val_pipeline=None, epochs: int = 1,
            verbose: bool = True) -> Dict[str, List[float]]:
        for epoch in range(epochs):
            t0 = time.time()
            train_m = _train_means(train_pipeline.epoch(epoch),
                                   lambda vox, _: self._step(self.state, vox)[1], epoch)
            val_m = {}
            if val_pipeline is not None:
                gen = torch.Generator(device=self.device).manual_seed(epoch)
                val_m = _means(val_pipeline.epoch(0),
                               lambda vox, _: self._eval(self.state, vox, gen))
            self.logger.append(train_loss=train_m["loss"],
                               val_loss=val_m.get("loss", float("nan")),
                               train_mse=train_m["mse"], train_kl=train_m["kl"])
            self.logger.write_epoch(epoch, {
                "train_loss": train_m["loss"], "val_loss": val_m.get("loss", float("nan"))})
            self.logger.write_mse_kl_txt("train_losses.txt", "train_mse", "train_kl")
            if epoch % self.checkpoint_every == 0:
                self.ckpt.save(epoch, self.state)
            if verbose and is_main_process():
                print(f"Epoch[{epoch + 1}/{epochs}] "
                      f"train[loss:{train_m['loss']:.1f} mse:{train_m['mse']:.1f} "
                      f"kl:{train_m['kl']:.1f}] val[loss:{val_m.get('loss', float('nan')):.1f}] "
                      f"epoch:{time.time() - t0:.1f}s", flush=True)
        _plot_ae(self.logger.history, self.run_dir)
        self.ckpt.close()
        return self.logger.history


class CAETrainer:
    """Convolutional autoencoder trainer (reference train_ResNetCAE,
    my_trainer.py:763-823: joint Adam, elementwise-mean MSE). It builds its
    model from `model_cfg` with `variational=False` (a 1x1 latent head) on
    `device` (CUDA unless "cpu" is asked for)."""

    def __init__(self, model_cfg, optim_cfg: OptimConfig = OptimConfig(),
                 train_cfg: TrainConfig = TrainConfig(), run_dir: str = "./runs/cae",
                 steps_per_epoch: int = 1, keep_checkpoints: int = 3,
                 checkpoint_every: int = 10, device=None):
        model_cfg = dataclasses.replace(model_cfg, variational=False)
        # Quirk kept from the JAX CAE trainer (sivae_tpu/train/loop.py:224-246):
        # the encoder and the decoder are drawn from two different seeds
        enc_gen = torch.Generator().manual_seed(train_cfg.seed)
        dec_gen = torch.Generator().manual_seed(train_cfg.seed + 1)
        self.model = SoftIntroVAE(model_cfg, SpatialEncoder(model_cfg, enc_gen),
                                  SpatialDecoder(model_cfg, dec_gen)).to(resolve_device(device))
        self.model.eval()
        self.train_cfg = train_cfg
        self.run_dir = run_dir
        self.checkpoint_every = checkpoint_every
        os.makedirs(run_dir, exist_ok=True)
        self.logger = MetricsLogger(run_dir, csv_columns=["epoch", "train_loss", "val_loss"])
        self.ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"),
                                      max_to_keep=keep_checkpoints)
        self.state = replicate_state(create_train_state(
            self.model, seed=train_cfg.seed + 2, optim_cfg=optim_cfg, joint_optimizer=True))
        self._step = make_cae_train_step(self.model, optim_cfg, steps_per_epoch)

    @torch.no_grad()
    def _eval_loss(self, vox: torch.Tensor) -> torch.Tensor:
        self.model.eval()
        out = self.model.decode(self.model.encode(vox))
        return torch.mean((out.float() - vox.float()) ** 2)

    def fit(self, train_pipeline, val_pipeline=None, epochs: int = 1,
            verbose: bool = True) -> Dict[str, List[float]]:
        for epoch in range(epochs):
            t0 = time.time()
            train_m = _train_means(train_pipeline.epoch(epoch),
                                   lambda vox, _: self._step(self.state, vox)[1], epoch)
            val_loss = float("nan")
            if val_pipeline is not None:
                val_loss = _means(val_pipeline.epoch(0),
                                  lambda vox, _: {"loss": self._eval_loss(vox)}).get("loss",
                                                                                     val_loss)
            self.logger.append(train_loss=train_m["loss"], val_loss=val_loss)
            self.logger.write_epoch(epoch, {"train_loss": train_m["loss"], "val_loss": val_loss})
            if epoch % self.checkpoint_every == 0:
                self.ckpt.save(epoch, self.state)
            if verbose and is_main_process():
                print(f"Epoch[{epoch + 1}/{epochs}] train_loss:{train_m['loss']:.5f} "
                      f"val_loss:{val_loss:.5f} epoch:{time.time() - t0:.1f}s", flush=True)
        _plot_ae(self.logger.history, self.run_dir)
        self.ckpt.close()
        return self.logger.history


class ClassifierTrainer:
    """CNN classifier trainer (reference `train`, my_trainer.py:829-910):
    Adam + CrossEntropy, per-epoch accuracy, confusion-matrix evaluation.
    Writes train_result.csv and metrics.jsonl, no checkpoints (as the JAX
    trainer)."""

    def __init__(self, model, optim_cfg: OptimConfig = OptimConfig(),
                 train_cfg: TrainConfig = TrainConfig(), run_dir: str = "./runs/clf",
                 steps_per_epoch: int = 1):
        self.model = model
        self.train_cfg = train_cfg
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.logger = MetricsLogger(
            run_dir, csv_columns=["epoch", "train_loss", "train_acc", "val_loss", "val_acc"])
        self.state = replicate_state(create_train_state(
            model, seed=train_cfg.seed, optim_cfg=optim_cfg, joint_optimizer=True))
        self._step = make_classifier_train_step(model, optim_cfg, steps_per_epoch)
        self._eval = make_classifier_eval_step(model)

    def fit(self, train_pipeline, val_pipeline=None, epochs: int = 1,
            verbose: bool = True) -> Dict[str, List[float]]:
        for epoch in range(epochs):
            t0 = time.time()
            tm = _train_means(train_pipeline.epoch(epoch),
                              lambda vox, lab: self._step(self.state, vox, lab)[1], epoch)
            vm = {}
            if val_pipeline is not None:
                vm = _means(val_pipeline.epoch(0),
                            lambda vox, lab: self._eval(self.state, vox, lab)[0])
            self.logger.append(train_loss=tm["loss"], train_acc=tm["acc"],
                               val_loss=vm.get("loss", float("nan")),
                               val_acc=vm.get("acc", float("nan")))
            self.logger.write_epoch(epoch, {
                "train_loss": tm["loss"], "train_acc": tm["acc"],
                "val_loss": vm.get("loss", float("nan")),
                "val_acc": vm.get("acc", float("nan"))})
            if verbose and is_main_process():
                print(f"Epoch[{epoch + 1}/{epochs}] loss:{tm['loss']:.3f} "
                      f"acc:{tm['acc'] * 100:.1f}% val_acc:"
                      f"{vm.get('acc', float('nan')) * 100:.1f}% "
                      f"epoch:{time.time() - t0:.1f}s", flush=True)
        return self.logger.history

    def confusion_matrix(self, pipeline, class_map, path: str):
        """(confusion matrix, accuracy) over one pass of `pipeline` (this
        rank's rows under data parallelism); the heatmap goes to `path`
        where matplotlib imports."""
        from sivae_torch.eval.confusion import make_confusion_matrix, predict_all

        preds, labels, acc = predict_all(self._eval, self.state, pipeline)
        return make_confusion_matrix(preds, labels, class_map, path), acc
