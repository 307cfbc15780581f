"""Golden replay of the reference trainer through the port (slow tier).

tests/golden/reference_oracle.npz holds 5 single-batch epochs of the
reference `utils/my_trainer.py:train_soft_intro_vae` (torch on the CPU,
zero stochasticity) on a 2-channel flagship-topology model at 80x96x80,
batch 8: its initial and final state_dicts, both Adams' moments and the
per-epoch train and val losses (tools/gen_reference_golden.py). This file
replays those 5 steps through the port's two-phase step and validation
step from the golden's `init/` state dict, loaded with `load_state_dict`,
and holds the port to the reference at the tolerances of
tests/test_reference_oracle.py, which does the same for the JAX package:

  1. per-step train lossE / lossD, rtol 5e-3;
  2. val lossE / lossD after the first and the last step, rtol 2.5e-2;
  3. final parameters and BN running statistics, per tensor within 5% of
     its own movement over the 5 steps, plus floors for exactly-zero
     gradients (Adam's random-sign first steps) and 3x the reference's own
     divergence under a 1e-6 init perturbation (`_perturbed` goldens);
  4. both Adams' first and second moments, within 15% of their magnitude
     plus the same kinds of floor.

One difference stays: the JAX replay materialises the decoder's
upsample before its conv (`fuse_upconv=False`, test_reference_oracle.py:
80-88), because the fused form made one BN statistic an outlier over the 5
steps; the port always fuses the upsample into its conv.

It runs on the card when there is one (every conv through the kernels, in
fp32 with TF32 off), else on the CPU (the plain versions; minutes).
It imports nothing of JAX, so on the card's machine it runs as

    python -m pytest --noconftest -m slow tests/test_torch_oracle.py -q
"""

import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from sivae_torch.config import OptimConfig, SoftIntroLossConfig, SpatialVAEConfig
from sivae_torch.models.registry import make_model
from sivae_torch.train.state import create_train_state
from sivae_torch.train.step import make_soft_intro_eval_step, make_soft_intro_train_step
from sivae_torch.utils.jax_import import load_reference_pth

pytestmark = [pytest.mark.slow, pytest.mark.oracle]

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
NPZ = os.path.join(GOLDEN_DIR, "reference_oracle.npz")
META = os.path.join(GOLDEN_DIR, "reference_oracle.json")
PERTURBED = [os.path.join(GOLDEN_DIR, n) for n in
             ("reference_oracle_perturbed_1e-6.npz", "reference_oracle_perturbed.npz")]
LR = 2e-4


def _sub(data, prefix):
    return {k[len(prefix):]: np.asarray(data[k]) for k in data.files if k.startswith(prefix)}


@pytest.fixture(scope="module")
def replay():
    data = np.load(NPZ)
    with open(META) as f:
        meta = json.load(f)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cuda":
        from sivae_torch.utils.device import resolve_device

        dev = resolve_device("cuda")  # TF32 off
    cfg = SpatialVAEConfig(in_ch=meta["in_ch"],
                           block_setting=tuple(tuple(b) for b in meta["block_setting"]),
                           input_shape=tuple(meta["input_shape"]))
    cfg = dataclasses.replace(cfg, act=cfg.act.with_no_dropout())
    model = make_model(cfg, device=dev)
    load_reference_pth(model, {k: torch.from_numpy(v) for k, v in _sub(data, "init/").items()})
    state = create_train_state(model, seed=0)

    rng = np.random.RandomState(meta["data_seed"])
    x_train = rng.rand(meta["batch"], 1, *cfg.input_shape).astype(np.float32)
    x_val = rng.rand(meta["batch"], 1, *cfg.input_shape).astype(np.float32)
    assert hashlib.sha256(x_train.tobytes()).hexdigest() == meta["x_train_sha256"]
    assert hashlib.sha256(x_val.tobytes()).hexdigest() == meta["x_val_sha256"]
    loss_cfg = SoftIntroLossConfig(beta_rec=meta["beta_rec"], beta_neg=meta["beta_neg"],
                                   beta_kl=meta["beta_kl"])
    step = make_soft_intro_train_step(model, loss_cfg, OptimConfig(), 1, cfg.input_shape,
                                      zero_noise=True)
    eval_step = make_soft_intro_eval_step(model, loss_cfg, cfg.input_shape, zero_noise=True)
    xt, xv = torch.from_numpy(x_train).to(dev), torch.from_numpy(x_val).to(dev)
    losses = {"lossE": [], "lossD": [], "val": {}}
    for i in range(meta["steps"]):
        _, m = step(state, xt)
        losses["lossE"].append(float(m["lossE"]))
        losses["lossD"].append(float(m["lossD"]))
        if i in (0, meta["steps"] - 1):
            vm = eval_step(state, xv)
            losses["val"][i] = (float(vm["lossE"]), float(vm["lossD"]))
    perturbed = next((np.load(p) for p in PERTURBED if os.path.exists(p)), None)
    return data, meta, state, losses, perturbed


def _tracks(ours, final, init, what, frac=0.05, floor=1e-7, adam_noise_floor=0.0, chaos=None,
            chaos_mult=3.0):
    """Per tensor: ||ours - final|| <= frac * ||final - init|| + floor
    + adam_noise_floor * sqrt(numel) + chaos_mult * ||chaos - final||
    (test_reference_oracle.py:_assert_tree_tracks). Every failing tensor is
    listed."""
    assert set(ours) == set(final) and len(ours) > 5, what
    failures = []
    for name in sorted(ours):
        o, f, i = (np.asarray(t, np.float64) for t in (ours[name], final[name], init[name]))
        err = np.linalg.norm(o - f)
        tol = frac * np.linalg.norm(f - i) + floor + adam_noise_floor * np.sqrt(o.size)
        if chaos is not None:
            tol += chaos_mult * np.linalg.norm(np.asarray(chaos[name], np.float64) - f)
        if err > tol:
            failures.append(f"  {name}: ||ours-ref||={err:.3e} > tol={tol:.3e} "
                            f"(moved {np.linalg.norm(f - i):.3e}, numel {o.size})")
    assert not failures, f"{what}: {len(failures)}/{len(ours)} out of tolerance\n" + \
        "\n".join(failures)


def test_train_loss_trajectory(replay):
    data, _, _, losses, _ = replay
    np.testing.assert_allclose(losses["lossE"], data["lossE"], rtol=5e-3)
    np.testing.assert_allclose(losses["lossD"], data["lossD"], rtol=5e-3)


def test_val_loss_trajectory(replay):
    data, meta, _, losses, _ = replay
    first, last = 0, meta["steps"] - 1
    for j, key in enumerate(("val_lossE", "val_lossD")):
        np.testing.assert_allclose([losses["val"][first][j], losses["val"][last][j]],
                                   [data[key][first], data[key][last]], rtol=2.5e-2)


def _port_state(state, kinds):
    sd = {k: v.detach().cpu().numpy() for k, v in state.model.state_dict().items()}
    return {k: v for k, v in sd.items() if k.rsplit(".", 1)[-1] in kinds}


@pytest.mark.parametrize("kind", ["params", "bn_stats"])
def test_final_params_and_bn_stats(replay, kind):
    """As the JAX replay, BN running variances compare the port's biased
    statistic with torch's unbiased one: a factor n/(n-1), n = 8 * 614400 at
    the full-resolution sites, ~2e-7 relative."""
    data, meta, state, _, perturbed = replay
    names = {"params": ("weight", "bias"), "bn_stats": ("running_mean", "running_var")}[kind]
    ours = _port_state(state, names)

    def pick(d):
        return {k: d[k] for k in ours}

    final, init = pick(_sub(data, "final/")), pick(_sub(data, "init/"))
    chaos = pick(_sub(perturbed, "final/")) if perturbed is not None else None
    if kind == "params":
        _tracks(ours, final, init, "params", adam_noise_floor=2 * meta["steps"] * LR,
                chaos=chaos)
    else:
        _tracks(ours, final, init, "bn stats", floor=1e-4, chaos=chaos)


@pytest.mark.parametrize("side", ["e", "d"])
def test_adam_moments(replay, side):
    data, meta, state, _, perturbed = replay
    half = state.model.encoder if side == "e" else state.model.decoder
    opt = state.opt_e if side == "e" else state.opt_d
    for kind, kw in (("exp_avg", dict(frac=0.15, adam_noise_floor=1e-4)),
                     ("exp_avg_sq", dict(frac=0.15, floor=1e-12, adam_noise_floor=1e-8))):
        ours, want, chaos = {}, {}, {}
        for name, p in half.named_parameters():
            st = opt.state[p]
            assert int(st["step"]) == meta["steps"]
            ours[name] = st[kind].detach().cpu().numpy()
            want[name] = np.asarray(data[f"adam_{side}/{name}.{kind}"])
            if perturbed is not None:
                chaos[name] = np.asarray(perturbed[f"adam_{side}/{name}.{kind}"])
        zeros = {k: np.zeros_like(v) for k, v in want.items()}
        _tracks(ours, want, zeros, f"adam_{side} {kind}", chaos=chaos or None, **kw)
