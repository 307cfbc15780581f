"""Time the eval CLI's default path (fp32) and the FC models' train steps of
one checkout of the port, so that two versions can be compared on one card.

    python tools/torch_path_compare.py [--root DIR] [--windows 5]

Imports `sivae_torch` from DIR (default: this checkout), builds its kernels
there and prints, beside the card's name and power limit:
- fp32 encode and reconstruct throughput (vol/s) of spatial_1200 and of
  fc_150 (the z600 preset's model) at 80x96x80, seeded random weights (seed
  0), batch 8, over 32 synthetic volumes (seed 7) as in `chip_smoke.py`
  phase 5; `encode_dataset` and `reconstruction_report`, median / min / max
  of the windows after a warm-up of each;
- the z600 and z600-wide presets' train steps (fc_150 and fc_600, bf16,
  batch 8, the first 8 of those volumes, the preset's loss weights): median
  / min / max s/step of as many steps after a warm-up step (fc_600's 32->64
  at 20x24x20 runs the wgmma body in 32-channel chunks).
Needs a CUDA card and `nvcc`. To compare a parent commit with a change,
unpack the parent with `git archive` into a directory that `.gitignore`
lists and run parent, change, change, parent in one call.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2], xs[0], xs[-1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--windows", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    from sivae_torch.cli import train as cli_train
    from sivae_torch.config import OptimConfig, SoftIntroLossConfig
    from sivae_torch.data.pipeline import BrainDataSource
    from sivae_torch.data.preprocess import preprocess_batch
    from sivae_torch.data.synthetic import SyntheticBrainSource
    from sivae_torch.eval.latent_probe import encode_dataset
    from sivae_torch.eval.recon_quality import reconstruction_report
    from sivae_torch.kernels import build
    from sivae_torch.models.registry import get_model_config, make_model
    from sivae_torch.train.state import create_train_state
    from sivae_torch.train.step import make_soft_intro_train_step
    from sivae_torch.utils.device import resolve_device

    if not torch.cuda.is_available():
        raise SystemExit("torch_path_compare: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    dev = resolve_device("cuda")  # TF32 off
    build.library()
    tag = os.path.relpath(root)
    print(f"[compare] {tag}: {card}; sivae_torch from {build.PKG_DIR}", flush=True)

    cfg = get_model_config("spatial_1200")
    src = BrainDataSource(list(SyntheticBrainSource(32, cfg.input_shape, seed=7)))
    vox = preprocess_batch(torch.from_numpy(src.voxels).to(dev))
    n_vol, batch = vox.shape[0], 8

    for name in ("spatial_1200", "fc_150"):
        model = make_model(get_model_config(name), device=dev, seed=0)
        for what, fn in (("encode", lambda: encode_dataset(model, vox, batch_size=batch)),
                         ("reconstruct", lambda: reconstruction_report(model, vox,
                                                                       batch_size=batch))):
            fn()
            rates = []
            for _ in range(args.windows):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                rates.append(n_vol / (time.perf_counter() - t0))
            med, lo, hi = _median(rates)
            print(f"[compare] {tag}: {name} fp32 {what} {n_vol} vols x {args.windows} windows: "
                  f"median {med:.2f} vol/s, min {lo:.2f}, max {hi:.2f}", flush=True)
        del model
        torch.cuda.empty_cache()

    real = vox[:batch].clone()
    for preset in ("z600", "z600-wide"):
        spec = cli_train.PRESETS[preset]
        fcfg = dataclasses.replace(get_model_config(spec["model"]), dtype=torch.bfloat16)
        model = make_model(fcfg, device=dev, seed=0)
        state = create_train_state(model, seed=0)
        loss_cfg = SoftIntroLossConfig(beta_rec=spec["beta_rec"], beta_neg=spec["beta_neg"],
                                       beta_kl=spec["beta_kl"])
        step = make_soft_intro_train_step(model, loss_cfg, OptimConfig(), 1, fcfg.input_shape)
        step(state, real)
        times = []
        for _ in range(args.windows):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, real)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med, lo, hi = _median(times)
        print(f"[compare] {tag}: {spec['model']} bf16 step batch {batch}: median {med:.4f} "
              f"s/step, min {lo:.4f}, max {hi:.4f}", flush=True)
        del model, state, step
        torch.cuda.empty_cache()

if __name__ == "__main__":
    main()
