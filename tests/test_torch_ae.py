"""sivae_torch plain VAE, CAE and classifier against the JAX package, and
the trainers and presets that run them.

Against JAX on the same inputs and weights (`tiny_spatial` at 16^3, fp32,
no dropout; the port's seeded init with random BN statistics, carried to
JAX by `state_dict_to_jax` into the tree `jax.eval_shape` gives for the
JAX init; JAX jitted, XLA's convs; the port's plain kernel versions):
- one VAE step (vae_150's ReLU scheme) and its eval step;
- one CAE step (a 1x1 latent head, `variational=False`);
- one classifier step and its eval step on fixed labels;
- the lucky AE's forward in eval mode and its shapes and BN update
  (`tests/test_classifier_lucky.py` is the JAX twin);
- the confusion matrix.
The JAX VAE step draws its reparameterisation noise from its key, which
the port cannot draw: both steps run with `reparameterize` replaced by
mu + eps * std for one fixed numpy eps batch.

Tolerances (fp32): losses rtol 1e-4; Adam's first moments within
1e-3 * max|m| where |m| > 1e-3 * max|m| of their tensor, except where the
exact gradient is 0 (`_compare_states` lists them), which must be rounding
noise below 1e-4 of the largest moment in both stacks; BN running
statistics atol 1e-5; forwards max|diff| <= 1e-4 * max(1, max|ref|).

Then, in the port alone: one epoch of the classifier trainer, the
joint-optimizer checkpoint restored bit for bit,
`python -m sivae_torch.cli.train` for z600, z600-wide, vae, cae and
vae2soft at tiny models on the CPU, and a z600 run through the health gate
and the eval CLI.
"""

import dataclasses
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import confusion_matrix

import sivae_tpu.train.step as jax_step
import sivae_torch.train.step as port_step
from sivae_tpu.config import OptimConfig as JaxOptimConfig
from sivae_tpu.models.classifier import ResNetClassifier as JaxClassifier
from sivae_tpu.models.lucky_ae import LuckyDecoder as JaxLuckyDecoder
from sivae_tpu.models.lucky_ae import LuckyEncoder as JaxLuckyEncoder
from sivae_tpu.models.registry import get_model_config as jax_get_model_config
from sivae_tpu.models.registry import make_model as jax_make_model
from sivae_tpu.models.resnet_vae import SpatialDecoder as JaxSpatialDecoder
from sivae_tpu.models.resnet_vae import SpatialEncoder as JaxSpatialEncoder
from sivae_tpu.train.state import SIVAETrainState as JaxTrainState
from sivae_tpu.train.state import make_optimizer as jax_make_optimizer
from sivae_torch.cli import eval as cli_eval
from sivae_torch.cli import train as cli_train
from sivae_torch.config import OptimConfig, TrainConfig
from sivae_torch.data.pipeline import BrainDataSource, DataPipeline
from sivae_torch.data.synthetic import SyntheticBrainSource
from sivae_torch.eval.confusion import make_confusion_matrix
from sivae_torch.models.classifier import ResNetClassifier
from sivae_torch.models.lucky_ae import LuckyDecoder, LuckyEncoder
from sivae_torch.models.registry import get_model_config, make_model
from sivae_torch.models.resnet_vae import SoftIntroVAE, SpatialDecoder, SpatialEncoder
from sivae_torch.train.loop import ClassifierTrainer, VAETrainer
from sivae_torch.train.state import create_train_state
from sivae_torch.utils.checkpoint import CheckpointManager
from sivae_torch.utils.jax_import import (export_train_state, load_jax_train_state,
                                          state_dict_to_jax)
from torch_port_common import (assert_close_scaled, assert_moments_close, flat_state,
                               jax_state_trees, lucky_to_port, perturb, to_ncdhw, to_ndhwc)

torch.set_num_threads(2)

BATCH = 4
SHAPE = (16, 16, 16)


def _cfgs(body_act="leaky_relu", variational=True):
    cfg_t = get_model_config("tiny_spatial")
    act = dataclasses.replace(cfg_t.act.with_no_dropout(), body_act=body_act)
    cfg_t = dataclasses.replace(cfg_t, act=act, variational=variational)
    cfg_j = dataclasses.replace(jax_get_model_config("tiny_spatial"), act=act,
                                variational=variational, remat=False)
    return cfg_j, cfg_t


def _x(seed=11):
    return np.random.RandomState(seed).rand(BATCH, *SHAPE, 1).astype(np.float32)


def _jax_state(params, stats, joint_pair=True):
    """A JAX train state with one Adam over `params` (an (enc, dec) pair, or
    one tree and empty decoder trees for a classifier)."""
    opt = jax_make_optimizer(JaxOptimConfig(), 1)
    if joint_pair:
        (ep, dp), (es, ds) = params, stats
    else:
        ep, dp, es, ds = params, {}, stats, {}
    return JaxTrainState(enc_params=ep, dec_params=dp, enc_stats=es, dec_stats=ds,
                         opt_e=opt.init(params), opt_d=(), rng=jax.random.key(1),
                         step=jnp.zeros((), jnp.int32))


def _compare_states(want, got, n_moments):
    """First moments, BN statistics and the count of one joint Adam."""
    mu = {k: v for k, v in want.items() if k.startswith("opt_e/mu/")}
    assert len(mu) == n_moments
    # exact gradient 0: the biases of the conv-BN units (the encoder's stem,
    # the decoder's 1x1 input conv), and that 1x1 conv's weight, which scales
    # each channel of a 1-channel latent before a BN; the CAE head's bias
    # shifts that latent, which the same BN cancels
    zero = {k for k in mu if k.endswith(("ConvBNAct_0/Conv3d_0/Conv_0/bias", "head/Conv_0/bias"))
            or k.endswith("1/ConvBNAct_0/Conv3d_0/Conv_0/kernel")}
    assert zero
    assert_moments_close(got, mu, zero_grad=zero)
    stats = [k for k in want if "_stats/" in k]
    assert stats
    for k in stats:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    assert got["opt_e/count"] == want["opt_e/count"] == 1 and "opt_d/count" not in got


@pytest.fixture()
def fixed_eps(monkeypatch):
    """Both stacks' `reparameterize` inside their step modules as
    mu + eps * exp(logvar / 2) for one numpy eps batch (latent 1x4x4x4)."""
    eps = np.random.RandomState(7).randn(BATCH, 1, 4, 4, 4).astype(np.float32)
    eps_j, eps_t = jnp.asarray(np.moveaxis(eps, 1, -1)), torch.from_numpy(eps)

    def jax_reparam(rng, mu, logvar, val_eps=None):
        return mu.astype(jnp.float32) + eps_j * jnp.exp(0.5 * logvar.astype(jnp.float32))

    def port_reparam(mu, logvar, val_eps=None, generator=None):
        return mu.float() + eps_t.to(mu.device) * torch.exp(0.5 * logvar.float())

    monkeypatch.setattr(jax_step, "reparameterize", jax_reparam)
    monkeypatch.setattr(port_step, "reparameterize", port_reparam)


# ---------------------------------------------------------------------------
# steps against JAX
# ---------------------------------------------------------------------------


def test_vae_step_and_eval_step_match_jax(fixed_eps):
    cfg_j, cfg_t = _cfgs(body_act="relu")
    model_j = jax_make_model(cfg_j)
    model_t = make_model(cfg_t, device="cpu", seed=0)
    shapes = jax.eval_shape(model_j.init, jax.random.key(0),
                            jnp.zeros((1,) + SHAPE + (1,), jnp.float32))
    v = perturb(state_dict_to_jax(model_t, shapes))
    st = _jax_state((v["enc"]["params"], v["dec"]["params"]),
                    (v["enc"]["batch_stats"], v["dec"]["batch_stats"]))
    trees0 = jax_state_trees(st)
    x = _x()
    # the eval step first, from the initial state (kl_w 10, the reference's
    # validation default, whatever the training weights)
    m_j = jax.jit(jax_step.make_vae_eval_step(model_j))(st, jnp.asarray(x), jax.random.key(0))
    state_t = load_jax_train_state(create_train_state(model_t, seed=0, joint_optimizer=True),
                                   trees0)
    m_t = port_step.make_vae_eval_step(model_t)(state_t, to_ncdhw(x), None)
    for k in ("loss", "mse", "kl"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(m_t["loss"]), float(m_t["mse"] + m_t["kl"]), rtol=1e-6)

    st1, m_j = jax.jit(jax_step.make_vae_train_step(model_j, JaxOptimConfig(), 1, mse_w=1.0,
                                                    kl_w=2.0))(st, jnp.asarray(x))
    _, m_t = port_step.make_vae_train_step(model_t, OptimConfig(), 1, mse_w=1.0, kl_w=2.0)(
        state_t, to_ncdhw(x))
    assert set(m_t) == set(m_j) == {"loss", "mse", "kl", "nan"} and not bool(m_t["nan"])
    for k in ("loss", "mse", "kl"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-4, err_msg=k)
    want = flat_state(jax_state_trees(st1))
    _compare_states(want, export_train_state(state_t, trees0),
                    sum(1 for k in want if k.startswith("enc_params/") or
                        k.startswith("dec_params/")))
    assert state_t.step == 1 and not model_t.training


def test_cae_step_matches_jax():
    cfg_j, cfg_t = _cfgs(variational=False)
    enc_j, dec_j = JaxSpatialEncoder(cfg_j), JaxSpatialDecoder(cfg_j)
    x0 = jnp.zeros((1,) + SHAPE + (1,), jnp.float32)
    shapes = {"enc": jax.eval_shape(enc_j.init, jax.random.key(0), x0)}
    shapes["dec"] = jax.eval_shape(dec_j.init, jax.random.key(1),
                                   jnp.zeros((1, 4, 4, 4, 1), jnp.float32))
    gen = torch.Generator().manual_seed(0)
    model_t = SoftIntroVAE(cfg_t, SpatialEncoder(cfg_t, gen), SpatialDecoder(cfg_t, gen))
    assert "encoder.conv.0.weight" in model_t.state_dict()
    v = perturb(state_dict_to_jax(model_t, shapes))
    st = _jax_state((v["enc"]["params"], v["dec"]["params"]),
                    (v["enc"]["batch_stats"], v["dec"]["batch_stats"]))
    trees0 = jax_state_trees(st)
    x = _x(12)
    st1, m_j = jax.jit(jax_step.make_cae_train_step(enc_j, dec_j, JaxOptimConfig(), 1))(
        st, jnp.asarray(x))
    state_t = load_jax_train_state(create_train_state(model_t, seed=0, joint_optimizer=True),
                                   trees0)
    _, m_t = port_step.make_cae_train_step(model_t, OptimConfig(), 1)(state_t, to_ncdhw(x))
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]), rtol=1e-4)
    want = flat_state(jax_state_trees(st1))
    _compare_states(want, export_train_state(state_t, trees0),
                    sum(1 for k in want if k.startswith(("enc_params/", "dec_params/"))))


def test_classifier_step_and_eval_step_match_jax():
    cfg_j, cfg_t = _cfgs()
    clf_j = JaxClassifier(cfg_j, num_classes=3)
    model_t = ResNetClassifier(cfg_t, num_classes=3,
                               generator=torch.Generator().manual_seed(0)).eval()
    shapes = jax.eval_shape(clf_j.init, jax.random.key(0),
                            jnp.zeros((1,) + SHAPE + (1,), jnp.float32))
    v = perturb(state_dict_to_jax(model_t, {"enc": shapes}))["enc"]
    st = _jax_state(v["params"], v["batch_stats"], joint_pair=False)
    trees0 = jax_state_trees(st)
    assert "dec_params" in trees0 and not trees0["dec_params"]
    x, labels = _x(13), np.array([0, 2, 1, 2], np.int32)

    (m_j, pred_j) = jax.jit(jax_step.make_classifier_eval_step(clf_j))(st, jnp.asarray(x),
                                                                      jnp.asarray(labels))
    state_t = load_jax_train_state(create_train_state(model_t, seed=0, joint_optimizer=True),
                                   trees0)
    m_t, pred_t = port_step.make_classifier_eval_step(model_t)(state_t, to_ncdhw(x), labels)
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]), rtol=1e-4)
    assert float(m_t["acc"]) == float(m_j["acc"])
    np.testing.assert_array_equal(pred_t.numpy(), np.asarray(pred_j))
    logits = model_t(to_ncdhw(x))
    assert logits.dtype == torch.float32 and logits.shape == (BATCH, 3)

    st1, m_j = jax.jit(jax_step.make_classifier_train_step(clf_j, JaxOptimConfig(), 1))(
        st, jnp.asarray(x), jnp.asarray(labels))
    _, m_t = port_step.make_classifier_train_step(model_t, OptimConfig(), 1)(
        state_t, to_ncdhw(x), labels)
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]), rtol=1e-4)
    assert float(m_t["acc"]) == float(m_j["acc"]) and not bool(m_t["nan"])
    want = flat_state(jax_state_trees(st1))
    _compare_states(want, export_train_state(state_t, trees0),
                    sum(1 for k in want if k.startswith("enc_params/")))


def test_plain_steps_refuse_a_state_with_two_adams():
    _, cfg_t = _cfgs()
    model = make_model(cfg_t, device="cpu")
    step = port_step.make_cae_train_step(model, OptimConfig(), 1)
    with pytest.raises(ValueError, match="joint"):
        step(create_train_state(model, seed=0), to_ncdhw(_x()))


# ---------------------------------------------------------------------------
# the lucky AE
# ---------------------------------------------------------------------------


def test_lucky_ae_eval_forward_matches_jax_and_trains_its_bn():
    shape, bottleneck = (16, 24, 16), (2, 3, 2)
    x = np.random.RandomState(3).rand(2, *shape, 1).astype(np.float32)
    enc_j, dec_j = JaxLuckyEncoder(), JaxLuckyDecoder(bottleneck=bottleneck)
    rng = np.random.RandomState(5)

    def draw(shapes, seed):
        """Variables of the init's shapes: kernels of flax's lecun-normal
        scale, then perturb's BN statistics, scales and biases."""
        def one(path, s):
            fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        return perturb(jax.tree_util.tree_map_with_path(one, shapes), seed)

    ev = draw(jax.eval_shape(enc_j.init, jax.random.key(0), jnp.asarray(x)), 1)
    z_j = jax.jit(functools.partial(enc_j.apply, train=False))(ev, jnp.asarray(x))
    dv = draw(jax.eval_shape(dec_j.init, jax.random.key(1), z_j), 2)
    y_j = jax.jit(functools.partial(dec_j.apply, train=False))(dv, z_j)
    enc, dec = LuckyEncoder(shape), LuckyDecoder(bottleneck)
    lucky_to_port(ev, dv, enc, dec, bottleneck)
    enc.eval()
    dec.eval()
    with torch.no_grad():
        z = enc(to_ncdhw(x))
        y = dec(z)
    assert z.shape == (2, 512) and y.shape == (2, 1) + shape
    assert_close_scaled(z.numpy(), np.asarray(z_j), 1e-4)
    assert_close_scaled(to_ndhwc(y), np.asarray(y_j), 1e-4)
    assert 0.0 <= y.min().item() and y.max().item() <= 1.0   # sigmoid
    before = {k: v.clone() for k, v in enc.state_dict().items() if "running" in k}
    enc.train()
    with torch.no_grad():
        enc(torch.ones(2, 1, *shape))
    after = enc.state_dict()
    assert any(not torch.equal(before[k], after[k]) for k in before)


# ---------------------------------------------------------------------------
# classifier trainer, confusion matrix, joint checkpoint, presets
# ---------------------------------------------------------------------------


def test_confusion_matrix_matches_jax(tmp_path, monkeypatch):
    """The JAX package's matrix is scikit-learn's `confusion_matrix` with
    `labels=` the mapped classes (sivae_tpu/eval/confusion.py:45-49); the
    port counts it with numpy and needs no matplotlib for it."""
    rng = np.random.RandomState(0)
    preds, labels = rng.randint(0, 4, 40), rng.randint(0, 3, 40)   # class 3 is not mapped
    class_map = {"CN": 0, "AD": 1, "MCI": 2}
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    got = make_confusion_matrix(preds, labels, class_map, str(tmp_path / "port.png"))
    np.testing.assert_array_equal(got, confusion_matrix(labels, preds, labels=[0, 1, 2]))
    assert not os.path.exists(tmp_path / "port.png")


def test_classifier_trainer_epoch_and_confusion(tmp_path):
    """The JAX twin is tests/test_classifier_lucky.py::test_classifier_fit_and_confusion."""
    _, cfg = _cfgs()
    src = BrainDataSource(SyntheticBrainSource(12, SHAPE, seed=0).records)
    train = DataPipeline(src, 4, device="cpu", seed=3)
    model = ResNetClassifier(cfg, num_classes=2, generator=torch.Generator().manual_seed(0))
    trainer = ClassifierTrainer(model, run_dir=str(tmp_path), steps_per_epoch=train.steps_per_epoch,
                                train_cfg=TrainConfig(epochs=1, batch_size=4))
    hist = trainer.fit(train, train, epochs=1)
    assert np.isfinite(hist["train_loss"][0]) and 0.0 <= hist["train_acc"][0] <= 1.0
    assert np.isfinite(hist["val_loss"][0]) and trainer.state.step == 3
    cm, acc = trainer.confusion_matrix(train, {"CN": 0, "AD": 1}, str(tmp_path / "cm.png"))
    assert cm.shape == (2, 2) and cm.sum() == 12 and 0.0 <= acc <= 1.0
    assert acc == pytest.approx(np.trace(cm) / 12)
    assert os.path.exists(tmp_path / "cm.png") and os.path.exists(tmp_path / "train_result.csv")


def _tensors(state):
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    for i, st in state.opt_e.state_dict()["state"].items():
        out.update({f"opt_e/{i}/{k}": torch.as_tensor(v) for k, v in st.items()})
    out["generator"] = state.generator.get_state()
    return {k: v.detach().cpu() for k, v in out.items()}


def test_joint_optimizer_checkpoint_restores_bit_for_bit(tmp_path):
    _, cfg = _cfgs(body_act="relu")
    src = BrainDataSource(SyntheticBrainSource(8, SHAPE, seed=1).records)
    train = DataPipeline(src, 4, device="cpu", shuffle=False)
    trainer = VAETrainer(make_model(cfg, device="cpu", seed=1), run_dir=str(tmp_path),
                         steps_per_epoch=2, checkpoint_every=1)
    trainer.fit(train, epochs=2, verbose=False)
    assert trainer.ckpt.all_steps() == [0, 1] and trainer.state.opt_d is None
    again = VAETrainer(make_model(cfg, device="cpu", seed=2), run_dir=str(tmp_path / "other"),
                       steps_per_epoch=2)
    CheckpointManager(str(tmp_path / "ckpt")).restore(again.state)
    a, b = _tensors(trainer.state), _tensors(again.state)
    assert set(a) == set(b) and len(a) > 20
    assert all(torch.equal(a[k], b[k]) for k in a) and again.state.step == 4
    with pytest.raises(ValueError, match="joint"):
        CheckpointManager(str(tmp_path / "ckpt")).restore(
            create_train_state(make_model(cfg, device="cpu"), seed=0))


PRESET_RUNS = {
    "z600": ("tiny_fc", ["args.json", "train_result.csv", "metrics.jsonl", "loss.txt",
                         "kl_losses.txt"], [0]),
    "z600-wide": ("tiny_fc", ["args.json", "train_result.csv", "metrics.jsonl", "loss.txt"], [0]),
    "vae": ("tiny_spatial", ["args.json", "train_result.csv", "metrics.jsonl",
                             "train_losses.txt"], [0]),
    "cae": ("tiny_spatial", ["args.json", "train_result.csv", "metrics.jsonl"], [0]),
    "vae2soft": ("tiny_spatial", ["args.json", "train_result.csv", "metrics.jsonl", "loss.txt",
                                  os.path.join("vae_stage", "train_losses.txt"),
                                  os.path.join("vae_stage", "ckpt", "0.pth")], [0]),
}


@pytest.mark.parametrize("preset", sorted(PRESET_RUNS))
def test_train_cli_runs_each_new_preset_on_the_cpu(preset, tmp_path, monkeypatch):
    """One epoch through `main` at a tiny model, without figures (the
    matplotlib import fails, as on the card's machine)."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    model, files, ckpts = PRESET_RUNS[preset]
    run_dir = str(tmp_path / preset)
    trainer = cli_train.main(["--preset", preset, "--model", model, "--synthetic", "10",
                              "--epochs", "1", "--batch", "2", "--no-bf16", "--device", "cpu",
                              "--run-dir", run_dir])
    for name in files:
        assert os.path.exists(os.path.join(run_dir, name)), name
    assert CheckpointManager(os.path.join(run_dir, "ckpt")).all_steps() == ckpts
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f.read().splitlines()]
    assert len(rows) == 1
    assert all(np.isfinite(v) for k, v in rows[0].items() if k.startswith("train"))
    with open(os.path.join(run_dir, "args.json")) as f:
        assert json.load(f)["preset"] == preset
    assert trainer.state.step == 4   # fold 4 of 5 leaves 8 train volumes: 4 steps of 2
    assert (trainer.state.opt_d is None) == (preset in ("vae", "cae"))


def test_fc_run_through_the_health_gate_and_the_eval_cli(tmp_path, monkeypatch):
    """z600 at `tiny_fc`: one epoch, the health gate's sweep of its
    checkpoint (encode_dataset and reconstruction_report on a vector
    latent), then `python -m sivae_torch.cli.eval` over the run's ckpt/."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    run_dir = str(tmp_path / "z600")
    code = 0
    try:
        cli_train.main(["--preset", "z600", "--model", "tiny_fc", "--synthetic", "10",
                        "--epochs", "1", "--batch", "2", "--no-bf16", "--device", "cpu",
                        "--run-dir", run_dir, "--health-gate"])
    except SystemExit as e:  # the gate's verdict on a 1-epoch run
        code = e.code
    with open(os.path.join(run_dir, "health.json")) as f:
        health = json.load(f)
    with open(os.path.join(run_dir, "sweep.json")) as f:
        sweep = json.load(f)
    assert code == (0 if health["healthy"] else 1)
    assert [r["checkpoint"] for r in sweep] == ["0"]
    assert all(np.isfinite(r["rmse"]) and np.isfinite(r["ssim3d"]) for r in sweep)
    out = str(tmp_path / "report.json")
    cli_eval.main(["--model", "tiny_fc", "--ckpt", os.path.join(run_dir, "ckpt"),
                   "--synthetic", "10", "--batch", "5", "--out", out, "--device", "cpu"])
    with open(out) as f:
        report = json.load(f)
    assert {"retrieval_p_at_k", "rmse", "psnr", "ssim3d", "ssim_center_slice", "n"} <= set(report)
    assert report["n"] > 0 and all(np.isfinite(v) for v in report.values())


def test_train_cli_refuses_the_health_gate_for_vae_and_cae(capsys):
    for preset in ("vae", "cae"):
        with pytest.raises(SystemExit) as ei:
            cli_train.parse_args(["--preset", preset, "--health-gate", "--device", "cpu"])
        assert ei.value.code == 2 and "soft-intro trainers only" in capsys.readouterr().err
    assert cli_train.parse_args(["--preset", "vae2soft", "--health-gate", "--device", "cpu"])
