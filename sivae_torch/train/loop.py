"""The epoch loop of Soft-IntroVAE training: `SoftIntroTrainer`.

Port of `sivae_tpu/train/loop.py:55-213` (reference utils/my_trainer.py:
147-508). As in the JAX package, and unlike the reference:
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

The VAE / CAE / classifier trainers come with their steps.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from sivae_torch.config import OptimConfig, SoftIntroLossConfig, TrainConfig
from sivae_torch.eval.recon_quality import reconstruct
from sivae_torch.train.state import create_train_state
from sivae_torch.train.step import make_soft_intro_eval_step, make_soft_intro_train_step
from sivae_torch.utils.checkpoint import CheckpointManager
from sivae_torch.utils.logging import MetricsLogger
from sivae_torch.utils.plots import (matplotlib_missing, plot_kl_stats, plot_soft_intro_losses,
                                     save_recon_panel)


def _add(sums: Optional[Dict[str, torch.Tensor]], metrics: Dict[str, torch.Tensor]):
    """Running sums on the metrics' device (the `nan` flag counts)."""
    metrics = {k: v.float() for k, v in metrics.items()}
    return metrics if sums is None else {k: sums[k] + metrics[k] for k in sums}


def _to_host(sums: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """One device-to-host copy for the whole dict."""
    values = torch.stack(list(sums.values())).cpu().tolist()
    return dict(zip(sums, values))


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
        self.state = create_train_state(model, seed=train_cfg.seed, optim_cfg=optim_cfg)
        shape = model.cfg.input_shape
        self._step = make_soft_intro_train_step(model, loss_cfg, optim_cfg, steps_per_epoch, shape)
        self._eval = make_soft_intro_eval_step(model, loss_cfg, shape, val_eps=train_cfg.val_eps)
        self.n_voxels = int(np.prod(shape))

    # -- warm start (reference pretrained_path, my_trainer.py:179-180) ------
    def try_resume(self) -> Optional[int]:
        latest = self.ckpt.latest_step()
        if latest is not None:
            self.ckpt.restore(self.state, latest)
        return latest

    def train_epoch(self, pipeline, epoch: int) -> Dict[str, float]:
        sums = None
        steps = 0
        for vox, _ in pipeline.epoch(epoch):
            self.state, metrics = self._step(self.state, vox)
            sums = _add(sums, metrics)
            steps += 1
        host = _to_host(sums)
        if host.pop("nan", 0.0) > 0:
            raise FloatingPointError(
                f"NaN in lossE/lossD during epoch {epoch} "
                "(reference raises SystemError, my_trainer.py:327-328)")
        avg = {k: v / steps for k, v in host.items()}
        # RMSE per reference my_trainer.py:353-354
        avg["rmse"] = float(np.sqrt(avg["loss_rec"] / self.n_voxels))
        return avg

    def eval_epoch(self, pipeline, epoch: int) -> Dict[str, float]:
        sums = None
        steps = 0
        gen = torch.Generator(device=self.device).manual_seed(self.train_cfg.seed * 1000 + epoch)
        for vox, _ in pipeline.epoch(0):  # val order fixed (no shuffle anyway)
            sums = _add(sums, self._eval(self.state, vox, gen))
            steps += 1
        if steps == 0:
            return {}
        avg = {k: v / steps for k, v in _to_host(sums).items()}
        avg["rmse"] = float(np.sqrt(avg["loss_rec"] / self.n_voxels))
        return avg

    def save_panels(self, pipeline, epoch: int, val_pipeline=None) -> None:
        """Recon / fake panels from the first train batch and, as the
        reference's in-training val panels (my_trainer.py:455-463), a val
        original / recon panel when a val pipeline is given. Eval mode; the
        model's mode is put back afterwards."""
        was_training = self.model.training
        self.model.eval()
        try:
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
        finally:
            self.model.train(was_training)

    def fit(self, train_pipeline, val_pipeline=None, epochs: Optional[int] = None,
            verbose: bool = True) -> Dict[str, List[float]]:
        epochs = epochs if epochs is not None else self.train_cfg.epochs
        tc = self.train_cfg
        no_plots = matplotlib_missing()
        if no_plots is not None:
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
            if verbose:
                print(self.logger.epoch_line(epoch, epochs, train_m, val_m,
                                             time.time() - t0), flush=True)
        if no_plots is None:
            plot_soft_intro_losses(self.logger.history, self.run_dir)
            plot_kl_stats(self.logger.history, self.run_dir)
        self.ckpt.close()
        return self.logger.history
