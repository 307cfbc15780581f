"""Why an fp32 train step on the card and the same step on the CPU disagree:
hold every `conv3d_same` call of the card's step against float64, and list
the ReLU / LeakyReLU inputs whose sign differs between the two steps.

    python tools/torch_step_ties.py [--model tiny_fc]

The step is `chip_smoke.py`'s card-vs-CPU step: one fp32 Soft-IntroVAE
step of the model (dropout off, zero_noise, a fixed numpy noise batch, batch
4, weights of seed 3), once on the card through the kernels and once on the
CPU through the plain versions. Printed: the card's largest `conv3d_same`
error against float64 (relative to the call's largest output) with its body,
and for each activation call where the two steps took different branches,
its shape, the elements and their inputs on the card and on the CPU beside
the tensor's largest. Needs a CUDA card and `nvcc`.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="tiny_fc")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import numpy as np
    import torch
    import torch.nn.functional as F

    from sivae_torch.config import OptimConfig, SoftIntroLossConfig
    from sivae_torch.kernels import conv3d as kc
    from sivae_torch.models.registry import get_model_config, make_model
    from sivae_torch.train.state import create_train_state
    from sivae_torch.train.step import make_soft_intro_train_step
    from sivae_torch.utils.device import resolve_device

    dev = resolve_device("cuda")  # TF32 off
    conv_errs, acts = [], []
    forward = kc.conv3d_same_forward

    def checked(x, w):  # the card's calls against float64 on the same values
        y = forward(x, w)
        if x.is_cuda:
            ref = kc.conv3d_same_plain(x.double(), w.double())
            err = (y.double() - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
            conv_errs.append((err, tuple(x.shape), w.shape[-1], kc.conv3d_same_body(x, w, y)))
        return y

    relu, leaky = F.relu, F.leaky_relu
    kc.conv3d_same_forward = checked
    F.relu = lambda x, inplace=False: (acts.append(x.detach().double().cpu()), relu(x, inplace))[1]
    F.leaky_relu = lambda x, negative_slope=0.01, inplace=False: (
        acts.append(x.detach().double().cpu()), leaky(x, negative_slope, inplace))[1]

    cfg = get_model_config(args.model)
    if hasattr(cfg.act, "with_no_dropout"):
        cfg = dataclasses.replace(cfg, act=cfg.act.with_no_dropout())
    rng = np.random.RandomState(11)
    real = torch.from_numpy(rng.rand(4, 1, *cfg.input_shape).astype(np.float32))
    fixed = rng.randn(4, cfg.latent_dim).astype(np.float32)
    runs = {}
    for where in (dev, torch.device("cpu")):
        acts.clear()
        model = make_model(cfg, device=where, seed=3)
        state = create_train_state(model, seed=0)
        step = make_soft_intro_train_step(model, SoftIntroLossConfig(), OptimConfig(), 1,
                                          cfg.input_shape, zero_noise=True, fixed_noise=fixed)
        step(state, real.to(where))
        runs[where.type] = list(acts)
    kc.conv3d_same_forward, F.relu, F.leaky_relu = forward, relu, leaky

    worst = max(conv_errs)
    print(f"[ties] {args.model}: {len(conv_errs)} conv3d_same calls on the card, worst "
          f"{worst[0]:.3e} of the largest output against float64 ({worst[1]} -> {worst[2]}, "
          f"{worst[3]}); bodies {sorted({e[3] for e in conv_errs})}")
    card, cpu = runs["cuda"], runs["cpu"]
    print(f"[ties] activation calls: card {len(card)}, CPU {len(cpu)}")
    for i, (a, b) in enumerate(zip(card, cpu)):
        flip = (a > 0) != (b > 0)
        if flip.any():
            print(f"[ties] call {i} {tuple(a.shape)}: {int(flip.sum())} elements take the other "
                  f"branch; card {a[flip][:4].tolist()} CPU {b[flip][:4].tolist()}, largest "
                  f"{b.abs().max().item():.3e}")


if __name__ == "__main__":
    main()
