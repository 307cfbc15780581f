"""Training CLI of the port: every preset of `cli/train.py`.

Experiment presets, each one exact reference invocation (the table is the
JAX CLI's, copied):
  z1200      <- z-1200main.py:158,202: models.SoftIntroVAE(64,[[64,1,2],
               [128,1,2],[256,2,2]]), beta_kl=.75, beta_neg=1024, no aug
  aug-z1200  <- aug-z-1200main.py:167: same model + RandomAffine(10deg) p=.35
  z600       <- 600z_main.py:176 AS RUN: mymodel.SoftIntroVAE(12,24,32,48,150)
               (z=150 despite the script name; the 600-d ctor is only a
               comment, :54), beta_kl=.7, RandomAffine(15deg) p=.6
  z600-wide  <- 600z_main.py:54's documented variant (16,32,64,128,600):
               the 600-d FC model, same betas / aug
  z150       <- main.py:139: models.SoftIntroVAE(12,[[12,1,2],[24,1,2],
               [32,2,2],[48,2,2]]), no aug
  vae        <- vae_main.py:180,205: vaemodel.ResNetVAE + RandomNoise p=.5,
               mse_w / kl_w from the CLI
  cae        <- main.py:131 --model ResNetCAE
  vae2soft   <- main.py:185-192 VAEtoSoftVAE (VAE pretrain -> warm start)
  dp-variant <- main_DataParallel.py:470,617: the DataParallel trainer's
               loss variant (0.25*expELBO, no x10, scale 1/614400,
               beta_neg=256, beta_kl=1) on the spatial-150 model

beta_* defaults come from the preset; --beta-rec/--beta-neg/--beta-kl/
--gamma-r override them (z-1200main.py:46-48).

Usage:
  python -m sivae_torch.cli.train --preset z1200 --epochs 500 --data-root /data/radiology_datas
  python -m sivae_torch.cli.train --preset z600 --synthetic 64 --epochs 2
  python -m sivae_torch.cli.train --preset z1200 --model tiny_spatial --synthetic 40 \\
      --epochs 2 --batch 4 --device cpu --run-dir /tmp/r
  python -m sivae_torch.cli.train --preset z600 --model tiny_fc --synthetic 40 \\
      --epochs 2 --batch 4 --device cpu --run-dir /tmp/fc

Runs on CUDA unless `--device cpu` is given, and fails without CUDA
otherwise. Writes into the run directory what the JAX CLI writes: args.json,
train_result.csv, metrics.jsonl and ckpt/<epoch>.pth (the port's checkpoint
files); loss.txt and kl_losses.txt for the Soft-IntroVAE trainer,
train_losses.txt for the VAE's; vae2soft runs its VAE stage in
`<run-dir>/vae_stage`; and, where matplotlib imports, the loss plots and
image panels. `main` loads the records and splits them;
`train_on_split(args, train_src, val_src)` does everything after the split.

Data parallelism (`--data-parallel`, on by default, as in the JAX CLI):
with more than one visible card and no launcher, `main` starts one process
per card (127.0.0.1, a free port, NCCL) and each runs the whole CLI on its
card; under torchrun (or any launcher that sets `RANK`, `WORLD_SIZE`,
`LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`, on one host or several) each
process joins the launcher's group. `--batch` is the global batch and must
divide by the number of processes. Every rank loads the same records and
split; rank 0 writes args.json, the logs, checkpoints and figures and runs
the health gate. A rank that fails fails the run: nothing falls back to one
process. With one card, `--no-data-parallel` or `--device cpu`, one
process runs as it always did, with no collective.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import sys
from typing import List, Optional

PRESETS = {
    "z1200": dict(model="spatial_1200", beta_rec=1.0, beta_neg=1024.0, beta_kl=0.75,
                  augment=None, trainer="soft_intro"),
    "aug-z1200": dict(model="spatial_1200", beta_rec=1.0, beta_neg=1024.0, beta_kl=0.75,
                      augment=("affine", 10.0, 0.35), trainer="soft_intro"),
    # 600z_main.py:176 constructs mymodel.SoftIntroVAE(12,24,32,48,150) —
    # z=150 with the small channel walk; the "600" in the filename refers to
    # the commented-out ctor at :54. z600 reproduces the run; z600-wide is
    # the documented 600-d variant.
    "z600": dict(model="fc_150", beta_rec=1.0, beta_neg=1024.0, beta_kl=0.7,
                 augment=("affine", 15.0, 0.6), trainer="soft_intro"),
    "z600-wide": dict(model="fc_600", beta_rec=1.0, beta_neg=1024.0, beta_kl=0.7,
                      augment=("affine", 15.0, 0.6), trainer="soft_intro"),
    "z150": dict(model="spatial_150", beta_rec=1.0, beta_neg=1024.0, beta_kl=0.75,
                 augment=None, trainer="soft_intro"),
    # vae_main.py:53-54 defaults mse_weight=1, kl_weight=1 (NOT the
    # normal_loss kldw=10 default, which only applies to the val-side call)
    "vae": dict(model="vae_150", augment=("noise", 0.03, 0.5), trainer="vae",
                mse_w=1.0, kl_w=1.0),
    "cae": dict(model="cae_150", augment=None, trainer="cae"),
    "vae2soft": dict(model="spatial_150", beta_rec=1.0, beta_neg=1024.0, beta_kl=0.75,
                     augment=None, trainer="vae2soft", mse_w=1.0, kl_w=20.0),
    # main_DataParallel.py:470,617: the DataParallel trainer's loss variant —
    # expELBO weight 0.25, no x10 multiplier, scale 1/(80*96*80) (:411),
    # beta_neg=256, beta_kl=1.0, spatial-150 model (:605), batch 16 (:46)
    "dp-variant": dict(model="spatial_150", beta_rec=1.0, beta_neg=256.0,
                       beta_kl=1.0, augment=None, trainer="soft_intro",
                       exp_elbo_weight=0.25, loss_multiplier=1.0,
                       scale=1.0 / (80 * 96 * 80), dp_semantics=True),
}


def make_augment_fn(spec):
    """('affine', degrees, p) or ('noise', std, p) -> (generator, vox) -> vox,
    on the device."""
    if spec is None:
        return None
    kind, value, p = spec
    if kind == "affine":
        from sivae_torch.data.augment import random_affine_batch

        return lambda gen, vox: random_affine_batch(gen, vox, degrees=value, p=p)
    if kind == "noise":
        from sivae_torch.data.augment import random_noise_batch

        return lambda gen, vox: random_noise_batch(gen, vox, mean=value, std=value, p=p)
    raise ValueError(f"unknown augment kind {kind!r}")


def load_records(args, input_shape):
    """The run's records: N synthetic volumes of seed 82, or the catalog."""
    if args.synthetic:
        from sivae_torch.data.synthetic import SyntheticBrainSource

        return list(SyntheticBrainSource(args.synthetic, input_shape, seed=82))
    from sivae_torch.data.catalog import load_data

    return load_data(kinds=["ADNI2", "ADNI2-2"],
                     classes=["CN", "AD", "EMCI", "LMCI", "SMC", "MCI"],
                     blacklist=True, root=args.data_root)


def build_pipelines(args, train_src, val_src, augment_spec=None):
    """Augmentation applies to the train split only (the reference passes
    transform=None for val, 600z_main.py:138)."""
    from sivae_torch.data.pipeline import DataPipeline

    train = DataPipeline(train_src, args.batch, device=args.device, seed=args.seed_split,
                         augment=make_augment_fn(augment_spec))
    val = DataPipeline(val_src, args.batch, device=args.device, shuffle=False)
    return train, val


def apply_health_gate(cfg, val_source, run_dir, batch, device):
    """Post-training health gate (VERDICT r4 next-#5): sweep the run's
    checkpoints over the val split and apply the frozen r4 criterion
    (`eval.run_dir.health_gate`, which writes sweep.json and health.json).
    Exits 1 if unhealthy, so a training job's exit code certifies the run."""
    from sivae_torch.eval.run_dir import health_gate

    _, health = health_gate(cfg, val_source, run_dir, batch, device)
    if not health["healthy"]:
        sys.exit(1)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """Parse, and refuse what the port cannot run yet before any work."""
    ap = argparse.ArgumentParser(description="sivae_torch training")
    ap.add_argument("--preset", choices=sorted(PRESETS), default="z1200")
    ap.add_argument("--model", default=None,
                    help="override the preset's model config (registry name)")
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--milestones", type=int, nargs="*", default=None,
                    help="LR x0.1 epoch milestones (reference MultiStepLR "
                         "milestone 350, my_trainer.py:185-186)")
    ap.add_argument("--beta-rec", type=float, default=None,
                    help="override the preset's beta_rec")
    ap.add_argument("--beta-neg", type=float, default=None)
    ap.add_argument("--beta-kl", type=float, default=None)
    ap.add_argument("--gamma-r", type=float, default=None)
    ap.add_argument("--mse-w", type=float, default=None,
                    help="VAE trainer mse weight (vae_main.py:53, default 1)")
    ap.add_argument("--kl-w", type=float, default=None,
                    help="VAE trainer kl weight (vae_main.py:54, default 1)")
    ap.add_argument("--data-root", default="/data/radiology_datas")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="use N synthetic volumes instead of the dataset")
    ap.add_argument("--run-dir", default=None)
    ap.add_argument("--seed", type=int, default=77)
    ap.add_argument("--seed-split", type=int, default=103)
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--no-bf16", dest="bf16", action="store_false")
    ap.add_argument("--data-parallel", action="store_true", default=True,
                    help="one process per visible card (or per launcher rank), --batch "
                         "split among them, BatchNorm over the global batch; on one card "
                         "a no-op")
    ap.add_argument("--no-data-parallel", dest="data_parallel", action="store_false")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--keep-checkpoints", type=int, default=3,
                    help="checkpoints kept (raise for checkpoint sweeps)")

    def positive_int(s):
        v = int(s)
        if v <= 0:
            raise argparse.ArgumentTypeError(f"must be a positive int, got {v}")
        return v

    ap.add_argument("--checkpoint-every", type=positive_int, default=None,
                    help="checkpoint cadence in epochs (default: each trainer's reference "
                         "cadence: every epoch for soft-intro, my_trainer.py:476-480; every "
                         "10 for vae / cae, my_trainer.py:628)")
    ap.add_argument("--pretrained", default=None,
                    help="warm start from a reference .pth, a port checkpoint file or a port "
                         "checkpoint directory (its latest step)")
    ap.add_argument("--health-gate", action="store_true",
                    help="after training, sweep the run's checkpoints on the val split "
                         "and apply the FROZEN r4 long-run health criterion "
                         "(eval/sweep.py run_health: drift_frac=0.3, min_ssim3d=0.2); "
                         "writes sweep.json + health.json into the run dir and exits 1 "
                         "if unhealthy")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.health_gate and PRESETS[args.preset]["trainer"] in ("vae", "cae"):
        ap.error("--health-gate applies to the soft-intro trainers only "
                 "(the criterion is calibrated on adversarial drift)")
    if args.pretrained:
        from sivae_torch.utils.checkpoint import checkpoint_file

        try:
            args.pretrained = checkpoint_file(args.pretrained)
        except ValueError as e:
            ap.exit(2, f"--pretrained {e}\n")
    from sivae_torch.parallel.distributed import launched
    from sivae_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if launched():
        args.world_size = int(os.environ["WORLD_SIZE"])
        if not args.data_parallel and args.world_size > 1:
            ap.exit(2, f"--no-data-parallel under a launcher of {args.world_size} processes\n")
    elif args.data_parallel and dev.type == "cuda" and args.device in (None, "cuda"):
        import torch

        args.world_size = torch.cuda.device_count()
    else:
        args.world_size = 1
    if args.batch % args.world_size:
        ap.exit(2, f"--batch {args.batch} is the global batch: it must divide by the "
                   f"{args.world_size} data-parallel processes\n")
    args.device = str(dev)
    return args


def train_on_split(args: argparse.Namespace, train_src, val_src):
    """Everything after the split: pipelines, model, the preset's trainer,
    warm start or resume, fit, health gate (the dispatch of
    `cli/train.py:237-300`). Returns the trainer (for vae2soft the
    Soft-IntroVAE stage's)."""
    import torch

    from sivae_torch.config import OptimConfig, SoftIntroLossConfig, TrainConfig, to_json
    from sivae_torch.models.registry import get_model_config, make_model
    from sivae_torch.parallel import is_main_process, replicate_state
    from sivae_torch.train.loop import CAETrainer, SoftIntroTrainer, VAETrainer

    preset = PRESETS[args.preset]
    cfg = get_model_config(args.model or preset["model"])
    if args.bf16:
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    run_dir = args.run_dir or f"./runs/{args.preset}"
    os.makedirs(run_dir, exist_ok=True)

    train, val = build_pipelines(args, train_src, val_src, augment_spec=preset.get("augment"))
    optim_cfg = OptimConfig(lr=args.lr)
    if args.milestones is not None:
        optim_cfg = dataclasses.replace(optim_cfg, milestones=tuple(args.milestones))
    train_cfg = TrainConfig(epochs=args.epochs, batch_size=args.batch, seed=args.seed,
                            checkpoint_every_epochs=(args.checkpoint_every
                                                     if args.checkpoint_every is not None else 1))

    # args snapshot (reference my_args.txt, main.py:152-153)
    if is_main_process():
        with open(os.path.join(run_dir, "args.json"), "w") as f:
            json.dump({**vars(args), "model_config": to_json(cfg)}, f, indent=2, default=str)

    plain_every = args.checkpoint_every if args.checkpoint_every is not None else 10
    if preset["trainer"] == "cae":
        trainer = CAETrainer(cfg, optim_cfg, train_cfg, run_dir=run_dir,
                             steps_per_epoch=train.steps_per_epoch,
                             keep_checkpoints=args.keep_checkpoints,
                             checkpoint_every=plain_every, device=args.device)
        trainer.fit(train, val, epochs=args.epochs)
        return trainer

    model = make_model(cfg, device=args.device)
    if preset["trainer"] == "vae":
        trainer = VAETrainer(model, optim_cfg, train_cfg,
                             mse_w=args.mse_w if args.mse_w is not None else preset["mse_w"],
                             kl_w=args.kl_w if args.kl_w is not None else preset["kl_w"],
                             run_dir=run_dir, steps_per_epoch=train.steps_per_epoch,
                             keep_checkpoints=args.keep_checkpoints,
                             checkpoint_every=plain_every)
        trainer.fit(train, val, epochs=args.epochs)
        return trainer

    loss_cfg = SoftIntroLossConfig(
        beta_rec=(args.beta_rec if args.beta_rec is not None else preset.get("beta_rec", 1.0)),
        beta_neg=(args.beta_neg if args.beta_neg is not None
                  else preset.get("beta_neg", 1024.0)),
        beta_kl=(args.beta_kl if args.beta_kl is not None else preset.get("beta_kl", 0.75)),
        exp_elbo_weight=preset.get("exp_elbo_weight", 0.5),
        loss_multiplier=preset.get("loss_multiplier", 10.0),
        scale=preset.get("scale"),
        dp_semantics=preset.get("dp_semantics", False))
    if args.gamma_r is not None:
        loss_cfg = dataclasses.replace(loss_cfg, gamma_r=args.gamma_r)

    if preset["trainer"] == "vae2soft":
        # two-stage pipeline (main.py:185-192): a VAE stage on the model, then
        # a Soft-IntroVAE from its parameters and BN statistics (the same
        # model object) with fresh Adams
        stage = VAETrainer(model, optim_cfg, train_cfg, mse_w=preset["mse_w"],
                           kl_w=preset["kl_w"], run_dir=os.path.join(run_dir, "vae_stage"),
                           steps_per_epoch=train.steps_per_epoch,
                           keep_checkpoints=args.keep_checkpoints, checkpoint_every=plain_every)
        stage.fit(train, val, epochs=max(1, args.epochs // 5))
        trainer = SoftIntroTrainer(model, loss_cfg, optim_cfg, train_cfg, run_dir=run_dir,
                                   steps_per_epoch=train.steps_per_epoch)
        trainer.fit(train, val, epochs=args.epochs)
        if args.health_gate and is_main_process():
            apply_health_gate(cfg, val.source, run_dir, args.batch, args.device)
        return trainer

    trainer = SoftIntroTrainer(model, loss_cfg, optim_cfg, train_cfg, run_dir=run_dir,
                               steps_per_epoch=train.steps_per_epoch,
                               keep_checkpoints=args.keep_checkpoints)
    if args.resume:
        resumed = trainer.try_resume()
        if resumed is not None and is_main_process():
            print(f"resumed from epoch {resumed}")
    elif args.pretrained:
        from sivae_torch.utils.jax_import import load_reference_pth

        load_reference_pth(model, args.pretrained)
        replicate_state(trainer.state)
        if is_main_process():
            print(f"warm-started from {args.pretrained}")
    trainer.fit(train, val, epochs=args.epochs)
    if args.health_gate and is_main_process():
        apply_health_gate(cfg, val.source, run_dir, args.batch, args.device)
    return trainer


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(local_rank: int, argv: List[str], world: int, port: int) -> None:
    """One spawned process: the launcher's environment for this rank, then
    the CLI."""
    os.environ.update(RANK=str(local_rank), LOCAL_RANK=str(local_rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    import torch

    # the host's cores shared among the processes, as torchrun's default does
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    main(argv)


def main(argv: Optional[List[str]] = None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    from sivae_torch.parallel.distributed import init_distributed, launched, shutdown

    if args.world_size > 1 and not launched():
        # one process per visible card; a rank that fails raises here, after
        # the others are stopped
        import torch.multiprocessing as mp

        from sivae_torch.cli import train as this

        mp.spawn(this._rank_main, args=(argv, args.world_size, _free_port()),
                 nprocs=args.world_size, join=True)
        return None
    dev = init_distributed(device=args.device)
    if dev is not None:
        args.device = str(dev)
    try:
        from sivae_torch.data.pipeline import BrainDataSource, grouped_split
        from sivae_torch.models.registry import get_model_config

        input_shape = get_model_config(args.model or PRESETS[args.preset]["model"]).input_shape
        src = BrainDataSource(load_records(args, input_shape))
        tid, vid = grouped_split(src.labels, src.pids, n_splits=5, split_index=4,
                                 seed=args.seed_split)
        return train_on_split(args, src.subset(tid), src.subset(vid))
    finally:
        shutdown()


if __name__ == "__main__":
    main()
