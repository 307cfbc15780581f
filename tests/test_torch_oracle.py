"""Golden replays of the reference trainers through the port (slow tier).

Each golden under tests/golden/ holds single-batch epochs of a reference
trainer (torch on the CPU, fixed or zero noise) at 80x96x80, batch 8: the
initial and final state_dicts, both Adams' moments and the losses
(tools/gen_reference_golden.py). This file replays them through the port's
two-phase step and validation step from the golden's `init/` state dict,
loaded with `load_state_dict`, at the tolerances of the JAX package's own
replays:

- reference_oracle.npz (tests/test_reference_oracle.py): 5 steps of
  `utils/my_trainer.py` on a 2-channel flagship-topology model:
  1. per-step train lossE / lossD, rtol 5e-3;
  2. val lossE / lossD after the first and the last step, rtol 2.5e-2;
  3. final parameters and BN running statistics, per tensor within 5% of
     its own movement over the 5 steps, plus floors for exactly-zero
     gradients (Adam's random-sign first steps) and 3x the reference's own
     divergence under a 1e-6 init perturbation (`_perturbed` goldens);
  4. both Adams' first and second moments, within 15% of their magnitude
     plus the same kinds of floor.
- reference_oracle_s1.npz (test_reference_oracle.py:306): one step with a
  fixed noise batch: losses rtol 5e-3, BN running statistics within 2% of
  their movement (floor 1e-4), first moments (the gradients) within 5%
  (floors 1e-9 and 2e-5 * sqrt(numel)), and at most 5% of each half's
  parameters a different Adam update (more than lr/2 apart).
- reference_oracle_dp_s1.npz / _dp_s3.npz (test_reference_oracle_dp.py):
  main_DataParallel.py's trainer and its own model (ReLU body and tail, no
  dropout) with `dp_semantics=True`: the accumulated val losses (rtol 1e-2
  and 5e-3 after one step, 2.5e-2 and 1e-2 after three), the one-step state
  as for s1, and after three steps the parameters and BN statistics within
  10% of their movement (Adam floor 2 * steps * lr, BN floor 1e-4).
- reference_oracle_fc_s1.npz / reference_oracle_fc.npz
  (test_reference_oracle_fc.py): `utils/trainer_fc.py` on a 2-channel FC
  model, no logvar clip or zero init, the upsample before its conv as the
  reference (`fuse_upconv=False`): one step as s1 with a 2e-4 Adam floor;
  five steps as reference_oracle.npz, with reference_oracle_perturbed_fc.npz
  as the chaos floor and first and second moments within 30% (floors 2e-4
  and 1e-7); validation with eps 0 and the FC trainer's x10.

The 5-step spatial replay keeps the port's fused upsample + conv (the JAX
replay materialises the upsample, test_reference_oracle.py:80-88, because
fusing made one BN statistic an outlier over 5 steps; the port passes
fused).

It runs on the card when there is one (every conv through the kernels, in
fp32 with TF32 off), else on the CPU (the plain versions; minutes each).
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

from sivae_torch.config import FCVAEConfig, OptimConfig, SoftIntroLossConfig, SpatialVAEConfig
from sivae_torch.models.registry import make_model
from sivae_torch.train.state import create_train_state
from sivae_torch.train.step import make_soft_intro_eval_step, make_soft_intro_train_step
from sivae_torch.utils.jax_import import load_reference_pth

pytestmark = [pytest.mark.slow, pytest.mark.oracle]

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
PERTURBED = [os.path.join(GOLDEN_DIR, n) for n in
             ("reference_oracle_perturbed_1e-6.npz", "reference_oracle_perturbed.npz")]
LR = 2e-4


def _sub(data, prefix):
    return {k[len(prefix):]: np.asarray(data[k]) for k in data.files if k.startswith(prefix)}


def _device() -> torch.device:
    if torch.cuda.is_available():
        from sivae_torch.utils.device import resolve_device

        return resolve_device("cuda")  # TF32 off
    return torch.device("cpu")


def _golden(name):
    data = np.load(os.path.join(GOLDEN_DIR, name + ".npz"))
    with open(os.path.join(GOLDEN_DIR, name + ".json")) as f:
        return data, json.load(f)


def _spatial_cfg(meta, relu: bool = False) -> SpatialVAEConfig:
    cfg = SpatialVAEConfig(in_ch=meta["in_ch"],
                           block_setting=tuple(tuple(b) for b in meta["block_setting"]),
                           input_shape=tuple(meta["input_shape"]))
    act = cfg.act.with_no_dropout()
    if relu:  # main_DataParallel.py's own model (test_reference_oracle_dp.py:52-68)
        act = dataclasses.replace(act, body_act="relu")
    return dataclasses.replace(cfg, act=act)


def _fc_cfg(meta) -> FCVAEConfig:
    f1, f2, f3, f4 = meta["fc_channels"]
    return FCVAEConfig(first_ch=f1, second_ch=f2, third_ch=f3, forth_ch=f4, z_ch=meta["z_ch"],
                       input_shape=tuple(meta["input_shape"]), logvar_head_zero_init=False,
                       logvar_clip=None, fuse_upconv=False)


def _start(data, meta, cfg, dev):
    """The port's state from the golden's init, and its train / val batches
    (checked against the golden's hashes) on `dev`."""
    model = make_model(cfg, device=dev)
    load_reference_pth(model, {k: torch.from_numpy(v) for k, v in _sub(data, "init/").items()})
    rng = np.random.RandomState(meta["data_seed"])
    x_train = rng.rand(meta["batch"], 1, *cfg.input_shape).astype(np.float32)
    x_val = rng.rand(meta["batch"], 1, *cfg.input_shape).astype(np.float32)
    assert hashlib.sha256(x_train.tobytes()).hexdigest() == meta["x_train_sha256"]
    assert hashlib.sha256(x_val.tobytes()).hexdigest() == meta["x_val_sha256"]
    return (model, create_train_state(model, seed=0), torch.from_numpy(x_train).to(dev),
            torch.from_numpy(x_val).to(dev))


def _fixed_noise(meta, shape):
    """The golden's fixed noise batch: the same seeded values for every draw."""
    assert meta["noise"]["kind"] == "fixed"
    return np.random.RandomState(meta["noise"]["seed"]).randn(*shape).astype(np.float32)


@pytest.fixture(scope="module")
def replay():
    data, meta = _golden("reference_oracle")
    dev = _device()
    cfg = _spatial_cfg(meta)
    model, state, xt, xv = _start(data, meta, cfg, dev)
    loss_cfg = SoftIntroLossConfig(beta_rec=meta["beta_rec"], beta_neg=meta["beta_neg"],
                                   beta_kl=meta["beta_kl"])
    step = make_soft_intro_train_step(model, loss_cfg, OptimConfig(), 1, cfg.input_shape,
                                      zero_noise=True)
    eval_step = make_soft_intro_eval_step(model, loss_cfg, cfg.input_shape, zero_noise=True)
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


# ---------------------------------------------------------------------------
# the one-step goldens, the DataParallel goldens, the FC goldens
# ---------------------------------------------------------------------------


def _moments(state, side, kind="exp_avg"):
    """{parameter name within its half: the Adam moment}; a joint Adam is
    not used here, each half has its own."""
    half = state.model.encoder if side == "e" else state.model.decoder
    opt = state.opt_e if side == "e" else state.opt_d
    return {name: opt.state[p][kind].detach().cpu().numpy() for name, p in half.named_parameters()}


def _one_step_parity(data, state, what, mu_noise_floor):
    """BN running statistics, first moments (the gradients) and Adam's
    first updates after one step (test_reference_oracle.py:395-441)."""
    ours = _port_state(state, ("running_mean", "running_var"))
    final, init = _sub(data, "final/"), _sub(data, "init/")
    _tracks(ours, {k: final[k] for k in ours}, {k: init[k] for k in ours},
            f"{what} bn stats", frac=0.02, floor=1e-4)
    for side in ("e", "d"):
        mu = _moments(state, side)
        want = {k: np.asarray(data[f"adam_{side}/{k}.exp_avg"]) for k in mu}
        _tracks(mu, want, {k: np.zeros_like(v) for k, v in want.items()},
                f"{what} adam_{side} exp_avg", frac=0.05, floor=1e-9,
                adam_noise_floor=mu_noise_floor)
    params = _port_state(state, ("weight", "bias"))
    for half in ("encoder.", "decoder."):
        keys = [k for k in params if k.startswith(half)]
        mism = sum(int(np.sum(np.abs(params[k].astype(np.float64) - final[k]) > 0.5 * LR))
                   for k in keys)
        tot = sum(params[k].size for k in keys)
        assert mism / tot <= 0.05, f"{what} {half}: {mism / tot:.2%} took another Adam update"


def test_one_step_golden():
    """reference_oracle_s1: my_trainer.py, one step, a fixed noise batch."""
    data, meta = _golden("reference_oracle_s1")
    assert meta["steps"] == 1
    cfg = _spatial_cfg(meta)
    model, state, xt, _ = _start(data, meta, cfg, _device())
    loss_cfg = SoftIntroLossConfig(beta_rec=meta["beta_rec"], beta_neg=meta["beta_neg"],
                                   beta_kl=meta["beta_kl"])
    fixed = _fixed_noise(meta, (meta["batch"],) + cfg.latent_shape)
    _, m = make_soft_intro_train_step(model, loss_cfg, OptimConfig(), 1, cfg.input_shape,
                                      zero_noise=True, fixed_noise=fixed)(state, xt)
    np.testing.assert_allclose(float(m["lossE"]), meta["lossE"][0], rtol=5e-3)
    np.testing.assert_allclose(float(m["lossD"]), meta["lossD"][0], rtol=5e-3)
    _one_step_parity(data, state, "s1", 2e-5)


def _dp_replay(name):
    """main_DataParallel.py's trainer: train step then the per-epoch val
    pass (eps 0, no x10), the val losses summed over the epochs as the
    reference returns them (test_reference_oracle_dp.py:99-156)."""
    data, meta = _golden(name)
    cfg = _spatial_cfg(meta, relu=True)
    model, state, xt, xv = _start(data, meta, cfg, _device())
    # main_DataParallel.py:411 (scale 1/N), :470 (0.25 expELBO, no x10),
    # :613-616 (beta_neg=256, beta_kl=1)
    loss_cfg = SoftIntroLossConfig(beta_rec=1.0, beta_neg=256.0, beta_kl=1.0,
                                   scale=1.0 / (80 * 96 * 80), exp_elbo_weight=0.25,
                                   loss_multiplier=1.0, dp_semantics=True)
    fixed = _fixed_noise(meta, meta["noise"]["shape"])
    step = make_soft_intro_train_step(model, loss_cfg, OptimConfig(), 1, cfg.input_shape,
                                      zero_noise=True, fixed_noise=fixed)
    eval_step = make_soft_intro_eval_step(model, loss_cfg, cfg.input_shape, val_eps=0.0,
                                          zero_noise=True, fixed_noise=fixed,
                                          val_loss_multiplier=1.0)
    val_e = val_d = 0.0
    for _ in range(meta["steps"]):
        step(state, xt)
        vm = eval_step(state, xv)
        val_e += float(vm["lossE"])
        val_d += float(vm["lossD"])
    return data, meta, state, (val_e, val_d)


def test_dp_one_step_golden():
    data, meta, state, (val_e, val_d) = _dp_replay("reference_oracle_dp_s1")
    assert meta["steps"] == 1
    np.testing.assert_allclose(val_e, float(data["val_lossE"][0]), rtol=1e-2)
    np.testing.assert_allclose(val_d, float(data["val_lossD"][0]), rtol=5e-3)
    _one_step_parity(data, state, "dp s1", 2e-5)


def test_dp_three_step_golden():
    data, meta, state, (val_e, val_d) = _dp_replay("reference_oracle_dp_s3")
    assert meta["steps"] == 3
    np.testing.assert_allclose(val_e, float(data["val_lossE"][0]), rtol=2.5e-2)
    np.testing.assert_allclose(val_d, float(data["val_lossD"][0]), rtol=1e-2)
    final, init = _sub(data, "final/"), _sub(data, "init/")
    for kinds, kw in ((("weight", "bias"), dict(adam_noise_floor=2 * meta["steps"] * LR)),
                      (("running_mean", "running_var"), dict(floor=1e-4))):
        ours = _port_state(state, kinds)
        _tracks(ours, {k: final[k] for k in ours}, {k: init[k] for k in ours},
                f"dp s3 {kinds[0]}", frac=0.1, **kw)


def _fc_loss_cfg(meta):
    return SoftIntroLossConfig(beta_rec=meta["beta_rec"], beta_neg=meta["beta_neg"],
                               beta_kl=meta["beta_kl"])


def test_fc_one_step_golden():
    """reference_oracle_fc_s1: trainer_fc.py, one step; the fixed noise
    batch is (batch, z_ch)."""
    data, meta = _golden("reference_oracle_fc_s1")
    assert meta["steps"] == 1 and meta["family"] == "fc"
    cfg = _fc_cfg(meta)
    model, state, xt, _ = _start(data, meta, cfg, _device())
    fixed = _fixed_noise(meta, (meta["batch"], cfg.z_ch))
    _, m = make_soft_intro_train_step(model, _fc_loss_cfg(meta), OptimConfig(), 1,
                                      cfg.input_shape, zero_noise=True, fixed_noise=fixed)(state, xt)
    np.testing.assert_allclose(float(m["lossE"]), meta["lossE"][0], rtol=5e-3)
    np.testing.assert_allclose(float(m["lossD"]), meta["lossD"][0], rtol=5e-3)
    # the 2-element conv biases in front of a BN carry summation noise up to
    # 1.9e-4 in this C=2 model (test_reference_oracle_fc.py:370-380)
    _one_step_parity(data, state, "fc s1", 2e-4)


@pytest.fixture(scope="module")
def fc_replay():
    """reference_oracle_fc: 5 steps, the val pass after the first and the
    last (trainer_fc.py has no fixed-eps val mode and keeps the x10)."""
    data, meta = _golden("reference_oracle_fc")
    cfg = _fc_cfg(meta)
    model, state, xt, xv = _start(data, meta, cfg, _device())
    fixed = _fixed_noise(meta, (meta["batch"], cfg.z_ch))
    loss_cfg = _fc_loss_cfg(meta)
    step = make_soft_intro_train_step(model, loss_cfg, OptimConfig(), 1, cfg.input_shape,
                                      zero_noise=True, fixed_noise=fixed)
    eval_step = make_soft_intro_eval_step(model, loss_cfg, cfg.input_shape, val_eps=0.0,
                                          zero_noise=True, fixed_noise=fixed,
                                          val_loss_multiplier=10.0)
    losses = {"lossE": [], "lossD": [], "val": {}}
    for i in range(meta["steps"]):
        _, m = step(state, xt)
        losses["lossE"].append(float(m["lossE"]))
        losses["lossD"].append(float(m["lossD"]))
        if i in (0, meta["steps"] - 1):
            vm = eval_step(state, xv)
            losses["val"][i] = (float(vm["lossE"]), float(vm["lossD"]))
    return data, meta, state, losses, np.load(os.path.join(GOLDEN_DIR,
                                                           "reference_oracle_perturbed_fc.npz"))


def test_fc_five_step_loss_trajectory(fc_replay):
    data, meta, _, losses, _ = fc_replay
    np.testing.assert_allclose(losses["lossE"], data["lossE"], rtol=5e-3)
    np.testing.assert_allclose(losses["lossD"], data["lossD"], rtol=5e-3)
    first, last = 0, meta["steps"] - 1
    for j, key in enumerate(("val_lossE", "val_lossD")):
        np.testing.assert_allclose([losses["val"][first][j], losses["val"][last][j]],
                                   [data[key][first], data[key][last]], rtol=2.5e-2)


@pytest.mark.parametrize("kind", ["params", "bn_stats"])
def test_fc_five_step_final_state(fc_replay, kind):
    data, meta, state, _, perturbed = fc_replay
    names = {"params": ("weight", "bias"), "bn_stats": ("running_mean", "running_var")}[kind]
    ours = _port_state(state, names)

    def pick(d):
        return {k: d[k] for k in ours}

    final, init = pick(_sub(data, "final/")), pick(_sub(data, "init/"))
    chaos = pick(_sub(perturbed, "final/"))
    if kind == "params":
        _tracks(ours, final, init, "fc params", adam_noise_floor=2 * meta["steps"] * LR,
                chaos=chaos)
    else:
        _tracks(ours, final, init, "fc bn stats", floor=1e-4, chaos=chaos)


@pytest.mark.parametrize("side", ["e", "d"])
def test_fc_five_step_adam_moments(fc_replay, side):
    """Within 30% of each moment (the FC replay's calibration,
    test_reference_oracle_fc.py:236-248) plus floors and the chaos term."""
    data, meta, state, _, perturbed = fc_replay
    for kind, kw in (("exp_avg", dict(frac=0.3, adam_noise_floor=2e-4)),
                     ("exp_avg_sq", dict(frac=0.3, floor=1e-12, adam_noise_floor=1e-7))):
        ours = _moments(state, side, kind)
        want = {k: np.asarray(data[f"adam_{side}/{k}.{kind}"]) for k in ours}
        chaos = {k: np.asarray(perturbed[f"adam_{side}/{k}.{kind}"]) for k in ours}
        _tracks(ours, want, {k: np.zeros_like(v) for k, v in want.items()},
                f"fc adam_{side} {kind}", chaos=chaos, **kw)
