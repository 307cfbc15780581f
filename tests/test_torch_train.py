"""sivae_torch training slice against the JAX package on the same inputs: the
losses, the LR schedule, the train-state carry, and the Soft-IntroVAE
two-phase train step and validation step on `tiny_spatial`.

The two stacks cannot draw the same random bits, so the step comparison
runs without dropout, with `zero_noise=True` (every reparameterize returns
mu) and a numpy `fixed_noise` batch (a zero noise batch makes the fake
path's BN variance 0 and the comparison meaningless). The JAX step goes
through XLA's convs and is jitted once per module; the port takes its plain
kernel versions on the CPU. Dropout and noise are tested in the port alone.

Tolerances (fp32, the two stacks sum the same products in other orders):
metrics rtol 1e-4 after one step and 1e-3 after two (the moments and the
moved statistics feed in), with atol 1e-30 because XLA flushes the
denormal expELBO values that torch keeps; BN running statistics atol 1e-5;
Adam's first moments (= 0.1 * gradient after one step, so this is the
gradient comparison) 1e-3 * max|m| per tensor. Parameters are compared only
where |g| > 1e-3 * max|g| of their tensor (atol 2e-5): Adam's first update
is lr * sign(g), and where the gradient is exactly zero (a conv bias that
feeds a BN: the mean subtraction cancels it) its sign is rounding noise in
both stacks. Two places inherit that noise and are held accordingly: the
first moment of such a bias is asserted to be noise (< 1e-5) in both
stacks, and the running MEAN of the encoder stem's BN, whose conv has such
a bias, may differ by the two random-sign bias steps seen by phase D's two
encoder forwards, 2 * lr * (0.1 + 0.09) = 7.6e-5, so it gets atol 1e-4."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sivae_tpu.config import OptimConfig as JaxOptimConfig
from sivae_tpu.config import SoftIntroLossConfig as JaxLossConfig
from sivae_tpu.data.pipeline import BrainDataSource as JaxBrainDataSource
from sivae_tpu.data.pipeline import DataPipeline as JaxDataPipeline
from sivae_tpu.models.registry import get_model_config as jax_get_model_config
from sivae_tpu.models.registry import make_model as jax_make_model
from sivae_tpu.ops import losses as jax_losses
from sivae_tpu.train.loop import SoftIntroTrainer as JaxSoftIntroTrainer
from sivae_tpu.train.state import create_train_state as jax_create_train_state
from sivae_tpu.train.state import param_count as jax_param_count
from sivae_tpu.train.step import make_soft_intro_eval_step as jax_make_eval_step
from sivae_tpu.train.step import make_soft_intro_train_step as jax_make_train_step
from sivae_torch.config import OptimConfig, SoftIntroLossConfig
from sivae_torch.data.pipeline import BrainDataSource, DataPipeline
from sivae_torch.data.synthetic import SyntheticBrainSource
from sivae_torch.models.registry import get_model_config, make_model
from sivae_torch.ops import losses
from sivae_torch.train.loop import SoftIntroTrainer
from sivae_torch.train.state import create_train_state, learning_rate, param_count
from sivae_torch.train.step import make_soft_intro_eval_step, make_soft_intro_train_step
from sivae_torch.utils.jax_import import export_train_state, load_jax_train_state
from torch_port_common import (LATENT_CONV_KERNEL, assert_nearer_float64, flat_random_draws,
                               perturb, to_ncdhw)

torch.set_num_threads(2)

BATCH = 4
METRIC_KEYS = ["lossE", "lossD", "loss_rec", "kl_real", "rec_kl", "fake_kl", "exp_elbo_fake",
               "exp_elbo_rec", "diff_kl", "nan"]


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _loss_inputs(dtype):
    rng = np.random.RandomState(0)
    a = {"x": rng.rand(3, 6, 5, 4, 1), "y": rng.rand(3, 6, 5, 4, 1),
         "mu": rng.randn(3, 2, 3, 2, 1), "logvar": 0.3 * rng.randn(3, 2, 3, 2, 1),
         "mu_o": 0.5 * rng.randn(3, 2, 3, 2, 1), "logvar_o": 0.2 * rng.randn(3, 2, 3, 2, 1),
         "loc": rng.rand(3, 7), "rec_b": 50 * rng.rand(3), "kl_b": 0.02 * rng.rand(3)}
    a = {k: v.astype(np.float32) for k, v in a.items()}
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    # rec_b / kl_b stand for per-sample reductions, which are fp32 in every step
    t = {k: (to_ncdhw(v) if v.ndim == 5 else torch.from_numpy(v)).to(
        torch.float32 if k.endswith("_b") else tdt) for k, v in a.items()}
    # the same (possibly bf16-rounded) values for JAX, in its NDHWC layout
    j = {k: jnp.asarray((v.permute(0, 2, 3, 4, 1) if v.dim() == 5 else v).float().numpy())
         .astype(jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32)
         for k, v in t.items()}
    return t, j


_KW = dict(scale=1e-3, beta_rec=1.0, beta_neg=256.0, beta_kl=0.75)
LOSS_CASES = {
    "recon_none": lambda m, a: m.calc_reconstruction_loss(a["x"], a["y"]),
    "recon_mean": lambda m, a: m.calc_reconstruction_loss(a["x"], a["y"], reduction="mean"),
    "kl_none": lambda m, a: m.calc_kl(a["logvar"], a["mu"]),
    "kl_mean": lambda m, a: m.calc_kl(a["logvar"], a["mu"], reduce="mean"),
    "kl_sum": lambda m, a: m.calc_kl(a["logvar"], a["mu"], reduce="sum"),
    "kl_general": lambda m, a: m.calc_kl_general(a["logvar"], a["mu"], a["mu_o"], a["logvar_o"]),
    "kl_general_scalar_prior": lambda m, a: m.calc_kl_general(a["logvar"], a["mu"], 0.1, -0.2,
                                                              reduce="mean"),
    "kl_per_position_none": lambda m, a: m.calc_kl_per_position(a["logvar"], a["mu"]),
    "kl_per_position_mean": lambda m, a: m.calc_kl_per_position(a["logvar"], a["mu"], "mean"),
    "mse": lambda m, a: m.mse_loss(a["y"], a["x"]),
    "kld": lambda m, a: m.kld_loss(a["mu"], a["logvar"]),
    "normal": lambda m, a: m.normal_loss(a["y"], a["mu"], a["logvar"], a["x"], 2.0, 5.0),
    "localized": lambda m, a: m.localized_loss(a["y"], a["mu"], a["logvar"], a["loc"], a["x"],
                                               1.0, 2.0, 3.0),
    "exp_elbo": lambda m, a: m.exp_elbo(a["rec_b"], a["kl_b"], scale=1e-3, beta_rec=1.0,
                                        beta_neg=256.0),
    "encoder_loss": lambda m, a: m.soft_intro_encoder_loss(
        loss_rec=a["rec_b"].mean(), kl_real=a["kl_b"].mean(), loss_fake_rec=a["rec_b"],
        loss_rec_rec=a["rec_b"] * 0.5, fake_kl=a["kl_b"], rec_kl=a["kl_b"] * 2.0, **_KW),
    "decoder_loss": lambda m, a: m.soft_intro_decoder_loss(
        loss_rec=a["rec_b"].mean(), rec_kl=a["kl_b"].mean(), fake_kl=a["kl_b"].mean() * 2.0,
        loss_rec_rec=a["rec_b"].mean() * 0.5, loss_fake_rec=a["rec_b"].mean() * 0.25,
        scale=1e-3, beta_rec=1.0, beta_kl=0.75, gamma_r=1e-2),
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_matches_jax(case, dtype):
    """Both stacks reduce in fp32 whatever the inputs' type: fp32 inputs
    rtol 1e-6, bf16 inputs (the same rounded values) rtol 1e-5."""
    t, j = _loss_inputs(dtype)
    got, want = LOSS_CASES[case](losses, t), LOSS_CASES[case](jax_losses, j)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape, (g.shape, w.shape)  # per-position KL: (B, d, h, w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6 if dtype == "fp32" else 1e-5)


def test_resolved_scale_and_defaults_match_jax():
    for field in dataclasses.fields(JaxLossConfig):
        assert getattr(SoftIntroLossConfig(), field.name) == getattr(JaxLossConfig(), field.name)
    for field in dataclasses.fields(JaxOptimConfig):
        assert getattr(OptimConfig(), field.name) == getattr(JaxOptimConfig(), field.name)
    assert SoftIntroLossConfig().resolved_scale((80, 96, 80)) == \
        JaxLossConfig().resolved_scale((80, 96, 80))
    assert SoftIntroLossConfig(scale=0.5).resolved_scale((2, 2, 2)) == 0.5


# ---------------------------------------------------------------------------
# LR schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("milestones,spe", [((1,), 1), ((2, 3), 2), ((350,), 3)])
def test_learning_rate_matches_optax_schedule(milestones, spe):
    cfg = OptimConfig(milestones=milestones)
    sched = optax.piecewise_constant_schedule(
        cfg.lr, {int(m) * spe: cfg.gamma for m in milestones})
    for count in list(range(10)) + [350 * spe - 1, 350 * spe, 350 * spe + 1]:
        np.testing.assert_allclose(learning_rate(cfg, spe, count), float(sched(count)), rtol=1e-6)


# ---------------------------------------------------------------------------
# the step against JAX
# ---------------------------------------------------------------------------


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_state_trees(st):
    """A JAX SIVAETrainState as the plain numpy trees the state carry takes."""
    def adam(o):
        return {"mu": _np_tree(o[0].mu), "nu": _np_tree(o[0].nu), "count": int(o[0].count)}
    return {"enc_params": _np_tree(st.enc_params), "dec_params": _np_tree(st.dec_params),
            "enc_stats": _np_tree(st.enc_stats), "dec_stats": _np_tree(st.dec_stats),
            "opt_e": adam(st.opt_e), "opt_d": adam(st.opt_d), "step": int(st.step)}


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def _flat_state(trees):
    out = {}
    for name in ("enc_params", "dec_params", "enc_stats", "dec_stats"):
        out.update(_flat(trees[name], (name,)))
    for o in ("opt_e", "opt_d"):
        out.update(_flat(trees[o]["mu"], (o, "mu")))
        out.update(_flat(trees[o]["nu"], (o, "nu")))
        out[f"{o}/count"] = np.asarray(trees[o]["count"])
    out["step"] = np.asarray(trees["step"])
    return out


def _jax_setup(seed=0):
    cfg = jax_get_model_config("tiny_spatial")
    cfg = dataclasses.replace(cfg, act=cfg.act.with_no_dropout(), remat=False)
    model = jax_make_model(cfg)
    x0 = jnp.zeros((1,) + cfg.input_shape + (1,), jnp.float32)
    with flat_random_draws():  # the same bits, compiled faster
        state = jax_create_train_state(model, jax.random.key(seed), x0, JaxOptimConfig(), 1)
    v = perturb({"enc": {"params": state.enc_params, "batch_stats": state.enc_stats},
                 "dec": {"params": state.dec_params, "batch_stats": state.dec_stats}}, seed)
    state = state.replace(enc_params=v["enc"]["params"], enc_stats=v["enc"]["batch_stats"],
                          dec_params=v["dec"]["params"], dec_stats=v["dec"]["batch_stats"])
    return cfg, model, state


def _port_setup(trees, dtype=torch.float32):
    cfg = get_model_config("tiny_spatial")
    cfg = dataclasses.replace(cfg, act=cfg.act.with_no_dropout(), dtype=dtype, param_dtype=dtype)
    model = make_model(cfg, device="cpu")
    return cfg, model, load_jax_train_state(create_train_state(model, seed=0), trees)


def _metrics_np(m):
    return {k: np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in m.items()}


@pytest.fixture(scope="module")
def run():
    """Two steps of both stacks from one initial state, and what each left."""
    rng = np.random.RandomState(11)
    cfg_j, model_j, state_j = _jax_setup()
    real = rng.rand(BATCH, *cfg_j.input_shape, 1).astype(np.float32)
    fixed = rng.randn(BATCH, cfg_j.latent_dim).astype(np.float32)
    trees0 = _jax_state_trees(state_j)
    step_j = jax.jit(jax_make_train_step(model_j, JaxLossConfig(), JaxOptimConfig(), 1,
                                         cfg_j.input_shape, zero_noise=True, fixed_noise=fixed))
    cfg_t, model_t, state_t = _port_setup(trees0)
    step_t = make_soft_intro_train_step(model_t, SoftIntroLossConfig(), OptimConfig(), 1,
                                        cfg_t.input_shape, zero_noise=True, fixed_noise=fixed)
    out = {"trees0": trees0, "real": real, "fixed": fixed, "carried": export_train_state(
        state_t, trees0), "model_j": model_j, "cfg_j": cfg_j, "state_j0": state_j,
        "step_j": step_j}
    real_t = to_ncdhw(real)
    for n in (1, 2):
        state_j, m_j = step_j(state_j, jnp.asarray(real))
        state_t, m_t = step_t(state_t, real_t)
        out[f"metrics_j{n}"], out[f"metrics_t{n}"] = _metrics_np(m_j), _metrics_np(m_t)
        if n == 1:
            out["state_j1"] = _flat_state(_jax_state_trees(state_j))
            out["state_t1"] = export_train_state(state_t, trees0)
    out["state_j2"], out["state_t2"] = state_j, state_t
    # the port's first step in float64 (plain versions), the yardstick of
    # the moment whose exact value both fp32 stacks miss (LATENT_CONV_KERNEL)
    _, model64, state64 = _port_setup(trees0, torch.float64)
    make_soft_intro_train_step(model64, SoftIntroLossConfig(), OptimConfig(), 1,
                               cfg_t.input_shape, zero_noise=True,
                               fixed_noise=fixed)(state64, real_t.double())
    out["state_f64"] = export_train_state(state64, trees0)
    return out


def test_state_carry_round_trips_every_leaf(run):
    """Loading a JAX state and writing it back out gives every array under
    its JAX name, bit for bit (layouts DHWIO <-> OIDHW, scale <-> weight,
    mean / var <-> running_*), the Adam moments and counts included."""
    want = _flat_state(run["trees0"])
    got = run["carried"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert any(k.startswith("opt_d/nu/") for k in got) and "opt_e/count" in got


@pytest.mark.parametrize("key", METRIC_KEYS)
def test_first_step_metric_matches_jax(run, key):
    got, want = run["metrics_t1"], run["metrics_j1"]
    assert set(got) == set(want) == set(METRIC_KEYS)
    assert got[key].shape == () and np.isfinite(want[key])
    if key == "nan":
        assert not got[key] and not want[key]
    else:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-30)


def test_second_step_metrics_match_jax(run):
    for key in METRIC_KEYS[:-1]:
        np.testing.assert_allclose(run["metrics_t2"][key], run["metrics_j2"][key], rtol=1e-3,
                                   atol=1e-30, err_msg=key)
    assert abs(run["metrics_j2"]["lossE"] - run["metrics_j1"]["lossE"]) > 0


@pytest.mark.parametrize("side", ["enc", "dec"])
def test_bn_running_stats_match_jax_after_a_step(run, side):
    """Every forward of the 13 moved them, in the JAX step's order."""
    keys = [k for k in run["state_j1"] if k.startswith(f"{side}_stats/")]
    assert len(keys) >= 8
    moved = 0
    for k in keys:
        noisy_bias = k == "enc_stats/ConvBNAct_0/BatchNorm_0/BatchNorm_0/mean"
        np.testing.assert_allclose(run["state_t1"][k], run["state_j1"][k], rtol=0,
                                   atol=1e-4 if noisy_bias else 1e-5, err_msg=k)
        moved += not np.allclose(run["state_j1"][k], _flat_state(run["trees0"])[k])
    assert moved == len(keys)


@pytest.mark.parametrize("opt", ["opt_e", "opt_d"])
def test_adam_first_moments_match_jax_after_a_step(run, opt):
    keys = [k for k in run["state_j1"] if k.startswith(f"{opt}/mu/")]
    assert len(keys) >= 10
    bad = []
    for k in keys:
        got, want = run["state_t1"][k], run["state_j1"][k]
        if k.endswith("ConvBNAct_0/Conv3d_0/Conv_0/bias"):  # exactly-zero gradient: noise
            assert max(np.abs(got).max(), np.abs(want).max()) < 1e-5, k
        elif k == f"opt_d/mu/{LATENT_CONV_KERNEL}":   # a near-cancelling sum: vs float64
            assert_nearer_float64(got, want, run["state_f64"][k], k)
        elif np.abs(got - want).max() > 1e-3 * np.abs(want).max():
            bad.append((k, float(np.abs(got - want).max()), float(np.abs(want).max())))
    assert not bad, bad
    assert run["state_t1"][f"{opt}/count"] == run["state_j1"][f"{opt}/count"] == 1
    assert run["state_t1"]["step"] == run["state_j1"]["step"] == 1


@pytest.mark.parametrize("side,opt", [("enc", "opt_e"), ("dec", "opt_d")])
def test_parameters_match_jax_where_the_gradient_is_significant(run, side, opt):
    shared = total = 0
    for k, want in run["state_j1"].items():
        if not k.startswith(f"{side}_params/"):
            continue
        g = run["state_j1"][k.replace(f"{side}_params/", f"{opt}/mu/")]
        mask = np.abs(g) > 1e-3 * np.abs(g).max()
        if k.endswith("ConvBNAct_0/Conv3d_0/Conv_0/bias"):  # exactly-zero gradient: excluded
            mask = np.zeros_like(mask)
        shared += mask.sum()
        total += mask.size
        np.testing.assert_allclose(run["state_t1"][k][mask], want[mask], atol=2e-5, err_msg=k)
        # every parameter moved by at most one Adam step of lr
        assert np.abs(run["state_t1"][k] - _flat_state(run["trees0"])[k]).max() <= 2.002e-4
    assert shared > 0.9 * total, (shared, total)


def test_param_count_matches_jax(run):
    assert param_count(run["state_t2"]) == jax_param_count(run["state_j2"])


def test_eval_step_matches_jax(run):
    fixed, real = run["fixed"], run["real"]
    eval_j = jax.jit(jax_make_eval_step(run["model_j"], JaxLossConfig(), run["cfg_j"].input_shape,
                                        zero_noise=True, fixed_noise=fixed,
                                        val_loss_multiplier=10.0))
    want = _metrics_np(eval_j(run["state_j0"], jnp.asarray(real), jax.random.key(0)))
    _, _, state_t = _port_setup(run["trees0"])
    eval_t = make_soft_intro_eval_step(state_t.model, SoftIntroLossConfig(),
                                       state_t.model.cfg.input_shape, zero_noise=True,
                                       fixed_noise=fixed, val_loss_multiplier=10.0)
    got = _metrics_np(eval_t(state_t, to_ncdhw(real)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-30, err_msg=k)
    raw = _metrics_np(make_soft_intro_eval_step(
        state_t.model, SoftIntroLossConfig(), state_t.model.cfg.input_shape, zero_noise=True,
        fixed_noise=fixed)(state_t, to_ncdhw(real)))
    np.testing.assert_allclose(raw["lossD"] * 10.0, got["lossD"], rtol=1e-6)


def test_dp_semantics_step_metrics_match_jax(run):
    """The DataParallel trainer's step: per-position KL, scalar expELBO recon
    terms, detached rec in phase D's loss_rec, attached z_rec / z_fake."""
    kw = dict(loss_multiplier=1.0, exp_elbo_weight=0.25, dp_semantics=True)
    _, model_j, state_j = _jax_setup(seed=2)
    step_j = jax.jit(jax_make_train_step(model_j, JaxLossConfig(**kw), JaxOptimConfig(), 1,
                                         run["cfg_j"].input_shape, zero_noise=True,
                                         fixed_noise=run["fixed"]))
    cfg_t, model_t, state_t = _port_setup(_jax_state_trees(state_j))
    step_t = make_soft_intro_train_step(model_t, SoftIntroLossConfig(**kw), OptimConfig(), 1,
                                        cfg_t.input_shape, zero_noise=True,
                                        fixed_noise=run["fixed"])
    _, m_j = step_j(state_j, jnp.asarray(run["real"]))
    _, m_t = step_t(state_t, to_ncdhw(run["real"]))
    m_j, m_t = _metrics_np(m_j), _metrics_np(m_t)
    for k in METRIC_KEYS[:-1]:
        np.testing.assert_allclose(m_t[k], m_j[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("n_steps,rtol", [(1, 1e-4), (2, 1e-3)])
def test_train_epoch_averages_match_jax(run, n_steps, rtol):
    """The slice as a whole: the pipeline (shuffle, preprocess) feeding the
    trainer's epoch (device-side sums, one read, rmse) in both stacks, from
    the same state, over the same synthetic volumes, with the fixture's
    zero_noise / fixed_noise steps. JAX's `SoftIntroTrainer.train_epoch`
    runs unbound on a namespace holding its jitted step; the port's on one
    holding the port step. Every epoch average and rmse at the step tests'
    tolerances (one step 1e-4, two steps 1e-3)."""
    records = SyntheticBrainSource(BATCH * n_steps + 1, (16, 16, 16), seed=21).records
    pipe_j = JaxDataPipeline(JaxBrainDataSource(records), BATCH, seed=5)
    pipe_t = DataPipeline(BrainDataSource(records), BATCH, device="cpu", seed=5)
    assert pipe_j.steps_per_epoch == pipe_t.steps_per_epoch == n_steps
    n_voxels = 16 ** 3
    want = JaxSoftIntroTrainer.train_epoch(
        types.SimpleNamespace(_step=run["step_j"], state=run["state_j0"], n_voxels=n_voxels),
        pipe_j, 1)
    _, model_t, state_t = _port_setup(run["trees0"])
    step_t = make_soft_intro_train_step(model_t, SoftIntroLossConfig(), OptimConfig(), 1,
                                        model_t.cfg.input_shape, zero_noise=True,
                                        fixed_noise=run["fixed"])
    port = types.SimpleNamespace(_step=step_t, state=state_t, n_voxels=n_voxels)
    got = SoftIntroTrainer.train_epoch(port, pipe_t, 1)
    assert set(got) == set(want) == set(METRIC_KEYS[:-1]) | {"rmse"}
    assert port.state.step == n_steps
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-30, err_msg=k)


# ---------------------------------------------------------------------------
# the port's step alone: schedule, freezing, dropout, noise
# ---------------------------------------------------------------------------


def _port_state(dropout: bool, seed: int = 0, optim=OptimConfig()):
    cfg = get_model_config("tiny_spatial")
    if not dropout:
        cfg = dataclasses.replace(cfg, act=cfg.act.with_no_dropout())
    model = make_model(cfg, device="cpu", seed=1)
    return cfg, model, create_train_state(model, seed=seed, optim_cfg=optim)


def _real(cfg, n=2):
    return torch.from_numpy(np.random.RandomState(3).rand(n, 1, *cfg.input_shape)
                            .astype(np.float32))


def test_lr_follows_the_optax_schedule_over_three_steps():
    optim = OptimConfig(milestones=(1,))
    cfg, model, state = _port_state(False, optim=optim)
    step = make_soft_intro_train_step(model, SoftIntroLossConfig(), optim, 1, cfg.input_shape,
                                      zero_noise=True, fixed_noise=np.ones((2, cfg.latent_dim)))
    sched = optax.piecewise_constant_schedule(optim.lr, {1: optim.gamma})
    for count in range(3):
        assert state.step == count
        before = [p.detach().clone() for p in model.parameters()]
        step(state, _real(cfg))
        for opt in (state.opt_e, state.opt_d):
            np.testing.assert_allclose(opt.param_groups[0]["lr"], float(sched(count)), rtol=1e-6)
        moved = max((p.detach() - q).abs().max().item()
                    for p, q in zip(model.parameters(), before))
        # Adam's first update is lr * sign(g); later ones stay within a small
        # multiple of lr, far below the undropped rate
        assert 0 < moved <= (1.001 if count == 0 else 3.0) * float(sched(count)) + 1e-7


def test_each_phase_touches_only_its_half():
    """At the encoder's update the decoder holds no gradient (phase E's graph
    left none there), and the encoder's gradients are not touched by phase D."""
    cfg, model, state = _port_state(False)
    step = make_soft_intro_train_step(model, SoftIntroLossConfig(), OptimConfig(), 1,
                                      cfg.input_shape, zero_noise=True,
                                      fixed_noise=np.ones((2, cfg.latent_dim)))
    seen = {}

    def at_e(opt, args, kwargs):
        seen["dec_none"] = all(p.grad is None for p in model.decoder.parameters())
        seen["enc_grads"] = [p.grad.clone() for p in model.encoder.parameters()]

    def at_d(opt, args, kwargs):
        seen["enc_same"] = all(torch.equal(p.grad, g) for p, g in
                               zip(model.encoder.parameters(), seen["enc_grads"]))
        seen["dec_all"] = all(p.grad is not None for p in model.decoder.parameters())

    state.opt_e.register_step_pre_hook(at_e)
    state.opt_d.register_step_pre_hook(at_d)
    assert not model.training
    step(state, _real(cfg))
    assert seen["dec_none"] and seen["enc_same"] and seen["dec_all"]
    assert all(p.requires_grad for p in model.parameters()) and not model.training


def _decoder_outputs(share: bool, seed: int):
    cfg, model, state = _port_state(True, seed=seed)
    outs = []
    handle = model.decoder.register_forward_hook(lambda m, a, out: outs.append(out.detach().clone()))
    step = make_soft_intro_train_step(model, SoftIntroLossConfig(), OptimConfig(), 1,
                                      cfg.input_shape, share_phase_d_dropout_keys=share)
    _, metrics = step(state, _real(cfg))
    handle.remove()
    assert len(outs) == 8  # 4 decodes in each phase
    return outs, _metrics_np(metrics), state


@pytest.mark.parametrize("share", [True, False])
def test_phase_d_dropout_masks(share):
    """Decoder forwards, in order: E fake, rec, rec_rec, rec_fake; D fake,
    rec, rec_rec, rec_fake. Shared masks make phase D's fake / rec equal
    phase E's (the decoder's parameters do not change in between and
    train-mode BN normalizes by batch statistics), up to the library's
    choice of algorithm for a forward with and without a graph (~2e-6 on the
    CPU); fresh masks give other volumes (O(1) apart)."""
    outs, _, _ = _decoder_outputs(share, seed=5)
    for e, d in ((0, 4), (1, 5)):
        diff = (outs[e] - outs[d]).abs().max().item()
        assert diff <= 1e-5 if share else diff > 0.1, diff
    assert (outs[2] - outs[6]).abs().max().item() > 0.1  # the encoder moved in between


def test_step_with_dropout_and_noise_is_deterministic_given_the_seed():
    a_outs, a_m, a_state = _decoder_outputs(True, seed=9)
    b_outs, b_m, b_state = _decoder_outputs(True, seed=9)
    c_outs, c_m, _ = _decoder_outputs(True, seed=10)
    assert all(torch.equal(x, y) for x, y in zip(a_outs, b_outs))
    assert all(np.array_equal(a_m[k], b_m[k]) for k in a_m)
    assert all(torch.equal(p, q) for p, q in zip(a_state.model.parameters(),
                                                 b_state.model.parameters()))
    assert not torch.equal(a_outs[0], c_outs[0]) and a_m["lossE"] != c_m["lossE"]
    assert all(np.isfinite(v) for v in a_m.values()) and not a_m["nan"]


def test_step_refuses_a_state_around_another_model():
    cfg, model, state = _port_state(False)
    _, _, other = _port_state(False)
    step = make_soft_intro_train_step(model, SoftIntroLossConfig(), OptimConfig(), 1,
                                      cfg.input_shape)
    with pytest.raises(ValueError):
        step(other, _real(cfg))
