"""sivae_torch activation rematerialisation (`sivae_torch/models/remat.py`)
on the CPU: the JAX package's `remat` / `remat_policy` and its step's
`remat_calls`, against the port's own step without remat and against the
JAX step.

Every mode (`remat=True` with each of the five policies; `remat_calls`
with no policy and with "conv_outs") takes two Soft-IntroVAE steps of
`tiny_spatial` with dropout on, phase D's masks shared and drawn afresh,
and of `tiny_fc` (no dropout in that family), from the same seeded state
as the step without remat. Held to the JAX package's own remat tolerances
(tests/test_train_step.py:156-210): lossE and lossD rtol 1e-6, parameters
and both Adams' first moments atol 1e-6; the BN running statistics and
`num_batches_tracked` bit for bit (the reruns move none), and the same
`state_dict` keys. The conv dispatches of a step (the plain versions of
the three kernels, counted) must exceed the step's without remat by the
count the model's conv sites and the policy derive (`ConvSite`,
`soft_intro_step_recomputes`). The hi / lo split is exercised by lowering
the port's `HI_RES_VOXELS` (16^3 has no 200 000-voxel site) and checked at
full size against the JAX model's own tags, read from a shape-only trace.

Against JAX (`tiny_spatial`, no dropout, zero eps and a fixed noise batch,
weights carried): the port with `remat=True` and the default policy against
the JAX step with the same config, and the port's `remat_calls` against
JAX's, at tests/test_torch_train.py's tolerances. The modes' steps run in
worker processes (tests/torch_remat_worker.py) while this process compiles
the JAX steps in threads and runs the other tests.
"""

import dataclasses
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sivae_tpu.models.blocks as jax_blocks
from sivae_tpu.config import OptimConfig as JaxOptimConfig
from sivae_tpu.config import SoftIntroLossConfig as JaxLossConfig
from sivae_tpu.models.registry import get_model_config as jax_get_model_config
from sivae_tpu.models.registry import make_model as jax_make_model
from sivae_tpu.train.state import SIVAETrainState as JaxTrainState
from sivae_tpu.train.state import create_train_state as jax_create_train_state
from sivae_tpu.train.state import make_optimizer as jax_make_optimizer
from sivae_tpu.train.step import make_soft_intro_train_step as jax_make_train_step
from sivae_torch.config import OptimConfig, SoftIntroLossConfig
from sivae_torch.models import remat
from sivae_torch.models.classifier import ResNetClassifier
from sivae_torch.models.registry import get_model_config, make_model
from sivae_torch.models.resnet_vae import spatial_conv_sites
from sivae_torch.train.state import create_train_state
from sivae_torch.train.step import (make_classifier_train_step, make_soft_intro_train_step,
                                    make_vae_train_step)
from sivae_torch.utils.jax_import import export_train_state, jax_to_state_dict, state_dict_to_jax
from torch_port_common import (LATENT_CONV_KERNEL, assert_moments_close, flat_random_draws,
                               flat_state, jax_state_trees, perturb, to_ncdhw)
from torch_remat_worker import conv_sites, model_config, policy

torch.set_num_threads(2)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_remat_worker.py")
BATCH = 4
MODES = [f"remat-{p}" for p in remat.POLICIES] + ["calls-None", "calls-conv_outs"]
CASES = [("tiny_spatial", True), ("tiny_spatial", False), ("tiny_fc", True)]
HI_CASES = ["tiny_spatial", "tiny_fc_unfused"]
HI_POLICIES = ["conv_outs_lo", "conv_outs_no_dec_hi", "conv_outs_no_enc_hi"]
HI = 4096   # the lowered threshold: 16^3, the tiny models' full resolution
# the groups of runs, one worker process each: each case's modes in two
# halves (two steps each), the case's steps without remat with the first,
# and the hi / lo runs (one step; the unfused FC model's step without
# remat, tiny_spatial's is the first group's)
GROUPS = [[(n, share, m, 2, None) for m in part] for n, share in CASES
          for part in (["off"] + MODES[:4], MODES[4:])] + [
    [("tiny_fc_unfused", True, "off", 1, None)]
    + [(n, True, f"remat-{p}", 1, HI) for n in HI_CASES for p in HI_POLICIES]]
# a conv bias in front of a BN (the stem's, the decoder head's): its exact
# gradient is 0, its moment rounding noise
ZERO_GRAD = "ConvBNAct_0/Conv3d_0/Conv_0/bias"


# ---------------------------------------------------------------------------
# the workers' runs and the JAX steps, under way while the first tests run
# ---------------------------------------------------------------------------


def _jax_init():
    """tests/test_torch_train.py's JAX variables: flax's init of
    `tiny_spatial` without dropout, random BN statistics and logvar head."""
    cfg = dataclasses.replace(jax_get_model_config("tiny_spatial"), remat=False)
    cfg = dataclasses.replace(cfg, act=cfg.act.with_no_dropout())
    x0 = jnp.zeros((1,) + cfg.input_shape + (1,), jnp.float32)
    with flat_random_draws():  # the same bits, compiled faster
        st = jax_create_train_state(jax_make_model(cfg), jax.random.key(0), x0,
                                    JaxOptimConfig(), 1)
    return perturb({"enc": {"params": st.enc_params, "batch_stats": st.enc_stats},
                    "dec": {"params": st.dec_params, "batch_stats": st.dec_stats}}, 0)


def _jax_case(v0, remat_on: bool, calls: bool):
    """Two JAX steps of `tiny_spatial` (no dropout, zero eps, a fixed noise
    batch) from the variables `v0`, carried to the module names of
    `remat_on` through the port: the initial trees, metrics and flat state
    after each step."""
    cfg_t = get_model_config("tiny_spatial")
    cfg_t = dataclasses.replace(cfg_t, act=cfg_t.act.with_no_dropout())
    cfg_j = dataclasses.replace(jax_get_model_config("tiny_spatial"), act=cfg_t.act,
                                remat=remat_on)
    model_j = jax_make_model(cfg_j)
    v = v0
    if remat_on:   # flax's nn.remat prefixes "Checkpoint" to the block names
        port = make_model(cfg_t, device="cpu")
        port.load_state_dict(jax_to_state_dict(v0, port))
        x0 = jnp.zeros((1,) + cfg_j.input_shape + (1,), jnp.float32)
        v = state_dict_to_jax(port, jax.eval_shape(model_j.init, jax.random.key(0), x0))
    opt = jax_make_optimizer(JaxOptimConfig(), 1)
    st = JaxTrainState(enc_params=v["enc"]["params"], dec_params=v["dec"]["params"],
                       enc_stats=v["enc"]["batch_stats"], dec_stats=v["dec"]["batch_stats"],
                       opt_e=opt.init(v["enc"]["params"]), opt_d=opt.init(v["dec"]["params"]),
                       rng=jax.random.key(1), step=jnp.zeros((), jnp.int32))
    rng = np.random.RandomState(11)
    real = rng.rand(BATCH, *cfg_j.input_shape, 1).astype(np.float32)
    fixed = rng.randn(BATCH, cfg_j.latent_dim).astype(np.float32)
    step = jax.jit(jax_make_train_step(model_j, JaxLossConfig(), JaxOptimConfig(), 1,
                                       cfg_j.input_shape, remat_calls=calls, zero_noise=True,
                                       fixed_noise=fixed))
    out = {"trees0": jax_state_trees(st), "real": real, "fixed": fixed, "variables": v,
           "cfg_t": cfg_t}
    for n in (1, 2):
        st, m = step(st, jnp.asarray(real))
        out[f"metrics{n}"] = {k: float(np.asarray(x)) for k, x in m.items()}
        out[f"state{n}"] = flat_state(jax_state_trees(st))
    return out


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """Launches the workers and the JAX steps' compiles at the module's first
    test; kills what is left at its end."""
    out_dir = tmp_path_factory.mktemp("remat_runs")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [(subprocess.Popen([sys.executable, WORKER, str(out_dir / f"{i}.pth"),
                                json.dumps(g)], stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True, env=env),
              out_dir / f"{i}.pth") for i, g in enumerate(GROUPS)]
    pool = ThreadPoolExecutor(2)
    try:
        v0 = pool.submit(_jax_init)
        jax_jobs = {"remat": pool.submit(lambda: _jax_case(v0.result(), True, False)),
                    "calls": pool.submit(lambda: _jax_case(v0.result(), False, True))}
        yield {"procs": procs, "jax": jax_jobs}
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def runs(started):
    """Every group's runs, keyed (name, share, mode, threshold or None)."""
    out = {}
    for p, path in started["procs"]:
        text, _ = p.communicate(timeout=300)
        assert p.returncode == 0, text[-6000:]
        out.update(torch.load(path, weights_only=False))
    return out


@pytest.fixture(scope="module")
def jax_steps(started):
    return started["jax"]


# ---------------------------------------------------------------------------
# names, policies, config (while the workers run)
# ---------------------------------------------------------------------------


def test_tags_threshold_and_policy_names_match_jax():
    assert (remat.CONV_OUT, remat.CONV_OUT_HI_ENC, remat.CONV_OUT_HI_DEC, remat.BN_STAT) == (
        jax_blocks.CONV_OUT, jax_blocks.CONV_OUT_HI_ENC, jax_blocks.CONV_OUT_HI_DEC,
        jax_blocks.BN_STAT)
    assert remat.HI_RES_VOXELS == jax_blocks.HI_RES_VOXELS == 200_000
    for name in remat.POLICIES:
        jax_blocks.remat_policy_by_name(name)   # JAX takes every name the port takes
        assert remat.BN_STAT in remat.remat_policy_by_name(name)
    assert remat.remat_policy_by_name("conv_outs_no_dec_hi") == {
        remat.CONV_OUT, remat.CONV_OUT_HI_ENC, remat.BN_STAT}
    assert remat.remat_policy_by_name("conv_outs_lo") == {remat.CONV_OUT, remat.BN_STAT}
    for rm in (remat.remat_policy_by_name, jax_blocks.remat_policy_by_name):
        with pytest.raises(ValueError):
            rm("conv_outs_hi")


def test_config_defaults_and_registry():
    """The port's default is off (JAX's on), the policy JAX's; the fullsize
    entry keeps the least memory, as in JAX; an unknown policy raises when
    a model is built with remat on."""
    for name in ("spatial_1200", "fc_150", "tiny_spatial", "tiny_fc"):
        cfg_t, cfg_j = get_model_config(name), jax_get_model_config(name)
        assert cfg_t.remat is False and cfg_j.remat is True
        assert cfg_t.remat_policy == cfg_j.remat_policy == "conv_outs_no_dec_hi"
    assert get_model_config("spatial_1200_fullsize").remat_policy is None
    assert jax_get_model_config("spatial_1200_fullsize").remat_policy is None
    for name in ("tiny_spatial", "tiny_fc"):
        bad = dataclasses.replace(get_model_config(name), remat=True, remat_policy="bogus")
        with pytest.raises(ValueError):
            make_model(bad, device="cpu")


def test_remat_calls_refuses_a_model_with_block_remat():
    cfg = dataclasses.replace(get_model_config("tiny_spatial"), remat=True)
    model = make_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="twice"):
        make_soft_intro_train_step(model, SoftIntroLossConfig(), OptimConfig(), 1,
                                   cfg.input_shape, remat_calls=True)


@pytest.mark.parametrize("name", ["tiny_spatial", "tiny_fc"])
def test_regions_only_in_training_with_gradients(monkeypatch, name):
    """Eval mode and `torch.no_grad()` call the blocks plainly; training
    mode with gradients enters one region for every wrapped unit."""
    cfg = dataclasses.replace(get_model_config(name), remat=True,
                              act=get_model_config(name).act.with_no_dropout())
    model = make_model(cfg, device="cpu")
    entered = []
    monkeypatch.setattr(remat, "checkpoint", lambda fn, *a, **k: entered.append(fn) or fn(*a))
    x = torch.rand(2, 1, *cfg.input_shape)
    model.decode(model.encode(x)[0])
    with torch.no_grad():
        model.train()
        model.decode(model.encode(x)[0])
    assert entered == []
    model.decode(model.encode(x)[0])
    enc, dec = conv_sites(cfg)
    assert len(entered) == len({s.region for s in enc + dec if s.region is not None}) > 0


# ---------------------------------------------------------------------------
# conv sites: the tape against the derived list (the tags against JAX last)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("calls", [False, True])
@pytest.mark.parametrize("name", ["tiny_spatial", "tiny_fc", "tiny_fc_unfused"])
def test_conv_sites_are_those_a_forward_tapes(monkeypatch, name, calls):
    """The kernel and fused upsample convs a training forward meets inside
    its regions, in order, are the derived sites: block remat's regions, or
    with `remat_calls` every such conv of the call."""
    cfg = model_config(name)
    cfg = dataclasses.replace(cfg, act=cfg.act.with_no_dropout(), remat=not calls,
                              remat_policy=None)
    model = make_model(cfg, device="cpu").train()
    taped = []
    conv = remat._Tape.conv

    def logged(self, voxels, compute, replay):
        if not self.replaying:
            taped.append((self.scope, voxels))
        return conv(self, voxels, compute, replay)

    monkeypatch.setattr(remat._Tape, "conv", logged)
    x = torch.rand(2, 1, *cfg.input_shape)
    saves = remat.remat_policy_by_name(None)
    if calls:
        mu = remat.region(model.encode, saves, "enc", x)[0]
        remat.region(model.decode, saves, "dec", mu)
    else:
        model.decode(model.encode(x)[0])
    enc, dec = conv_sites(cfg)
    assert taped == [(s.scope, s.voxels) for s in enc + dec
                     if s.kind != "1x1" and (calls or s.region is not None)]


# ---------------------------------------------------------------------------
# the plain steps and the classifier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["vae", "classifier"])
def test_plain_steps_with_remat_take_the_step_without(which):
    """The VAE step and the classifier (block remat, boundaries only, as
    JAX's classifier) with dropout on, against the same steps without."""
    x = torch.rand(BATCH, 1, 16, 16, 16, generator=torch.Generator().manual_seed(2))

    def run(on):
        cfg = dataclasses.replace(get_model_config("tiny_spatial"), remat=on)
        if which == "vae":
            model = make_model(cfg, device="cpu", seed=0)
            step, args = make_vae_train_step(model, OptimConfig(), 1), (x,)
        else:
            model = ResNetClassifier(cfg, generator=torch.Generator().manual_seed(0)).eval()
            step, args = make_classifier_train_step(model, OptimConfig(), 1), (x, [0, 1, 1, 0])
        state = create_train_state(model, seed=0, joint_optimizer=True)
        losses = [float(step(state, *args)[1]["loss"]) for _ in range(2)]
        names = {p: k for k, p in model.named_parameters()}
        out = {k: v.clone() for k, v in model.state_dict().items()}
        out.update({"m/" + names[p]: s["exp_avg"] for p, s in state.opt_e.state.items()})
        return losses, out

    (la, sa), (lb, sb) = run(False), run(True)
    np.testing.assert_allclose(lb, la, rtol=1e-6)
    for k, v in sa.items():
        if "running" in k or "num_batches" in k:
            assert torch.equal(sb[k], v), k
        else:
            torch.testing.assert_close(sb[k], v, rtol=0, atol=1e-6, msg=k)


# ---------------------------------------------------------------------------
# every mode against the step without remat (the workers' runs)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name,share", CASES)
def test_mode_takes_the_step_without_remat(runs, name, share, mode):
    base, got = runs[(name, share, "off", None)], runs[(name, share, mode, None)]
    assert len(got) == len(base) == 2
    for n, (a, b) in enumerate(zip(base, got), 1):
        for k in ("lossE", "lossD"):
            np.testing.assert_allclose(b["metrics"][k], a["metrics"][k], rtol=1e-6,
                                       err_msg=f"step {n} {k}")
        assert list(b["sd"]) == list(a["sd"])
        for k, v in a["sd"].items():
            if "running" in k or "num_batches" in k:
                assert torch.equal(b["sd"][k], v), (n, k)
            else:
                torch.testing.assert_close(b["sd"][k], v, rtol=0, atol=1e-6, msg=f"{n} {k}")
        assert list(b["m"]) == list(a["m"])
        for k, v in a["m"].items():
            torch.testing.assert_close(b["m"][k], v, rtol=0, atol=1e-6, msg=f"{n} moment {k}")
    # the BN statistics moved once a forward: 5 encodes and 8 decodes a step
    for k, v in got[1]["sd"].items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 2 * (5 if k.startswith("encoder.") else 8), k


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name,share", CASES)
def test_recomputed_dispatches_match_the_derived_count(runs, name, share, mode):
    """The kernels' dispatches in a step exceed those without remat by the
    convs each differentiated forward reruns: `conv_outs*` at 16^3 (no
    "hi" site) none; None and `remat_calls` every conv of the regions."""
    kind, pol = policy(mode)
    enc, dec = conv_sites(model_config(name))
    want = remat.soft_intro_step_recomputes(enc, dec, pol, whole_call=kind == "calls")
    base = runs[(name, share, "off", None)]
    for a, b in zip(base, runs[(name, share, mode, None)]):
        assert {k: b["n"][k] - a["n"][k] for k in want} == want
    if pol is None:
        assert want["conv3d_same"] > 0 and want["conv3d_from1"] == 5
        assert want["conv3d_to1"] == (7 if kind == "calls" else 0)
    elif kind == "remat":
        assert want == dict.fromkeys(remat.KERNELS, 0)


@pytest.mark.parametrize("pol", HI_POLICIES)
@pytest.mark.parametrize("name", HI_CASES)
def test_hi_lo_split_with_a_lowered_threshold(runs, name, pol):
    """At HI_RES_VOXELS = 4096 the 16^3 sites are "hi": `conv_outs_lo`
    reruns them all, `conv_outs_no_enc_hi` the encoder's, and
    `conv_outs_no_dec_hi` the decoder's (in tiny_fc without the fused
    upsample a kernel conv; in tiny_spatial the fused upsample + conv, a
    library one). The step is unchanged."""
    base = runs[(name, True, "off", None)][0]
    got = runs[(name, True, f"remat-{pol}", HI)][0]
    for k in ("lossE", "lossD"):
        np.testing.assert_allclose(got["metrics"][k], base["metrics"][k], rtol=1e-6)
    for k, v in base["sd"].items():
        if "running" in k or "num_batches" in k:
            assert torch.equal(got["sd"][k], v), k
        else:
            torch.testing.assert_close(got["sd"][k], v, rtol=0, atol=1e-6, msg=k)
    for k, v in base["m"].items():
        torch.testing.assert_close(got["m"][k], v, rtol=0, atol=1e-6, msg=k)
    enc, dec = conv_sites(model_config(name))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(remat, "HI_RES_VOXELS", HI)
        want = remat.soft_intro_step_recomputes(enc, dec, pol)
        hi = {s.scope for s in enc + dec if s.region and s.tag != remat.CONV_OUT}
    assert {k: got["n"][k] - base["n"][k] for k in want} == want
    assert hi == {"enc", "dec"}
    if pol == "conv_outs_no_dec_hi":
        assert want["conv3d_same"] == (7 if name == "tiny_fc_unfused" else 0)
        assert want["conv3d_from1"] == 0
    else:   # the encoder's stem and its first full-resolution conv(s)
        assert want["conv3d_from1"] == 5 and want["conv3d_same"] >= 5


# ---------------------------------------------------------------------------
# against the JAX step, and the full-size tags against the JAX model's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["remat", "calls"])
def test_port_remat_matches_the_jax_step(jax_steps, case):
    """Port `remat=True` with the default policy against the JAX step with
    the same config, and the port's `remat_calls` against JAX's (remat off
    in both), weights carried; tests/test_torch_train.py's tolerances."""
    j = jax_steps[case].result()
    cfg = j["cfg_t"]
    if case == "remat":
        cfg = dataclasses.replace(cfg, remat=True)
    model = make_model(cfg, device="cpu")
    model.load_state_dict(jax_to_state_dict(j["variables"], model))
    state = create_train_state(model, seed=0)
    step = make_soft_intro_train_step(model, SoftIntroLossConfig(), OptimConfig(), 1,
                                      cfg.input_shape, remat_calls=case == "calls",
                                      zero_noise=True, fixed_noise=j["fixed"])
    real = to_ncdhw(j["real"])
    for n in (1, 2):
        _, m = step(state, real)
        for k in ("lossE", "lossD", "loss_rec", "kl_real", "rec_kl", "fake_kl"):
            np.testing.assert_allclose(float(m[k]), j[f"metrics{n}"][k],
                                       rtol=1e-4 if n == 1 else 1e-3, atol=1e-30, err_msg=k)
        if n == 1:
            got, want = export_train_state(state, j["trees0"]), j["state1"]
    for k in want:
        if "_stats/" in k:
            noisy = k.startswith("enc_stats/") and "ConvBNAct_0" in k and k.endswith("/mean")
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4 if noisy else 1e-5,
                                       err_msg=k)
    mu = [k for k in want if "/mu/" in k]
    # flax's remat names the decoder's head "CheckpointConvBNAct_0"
    latent = next(k for k in mu if k.startswith("opt_d/") and k.endswith(LATENT_CONV_KERNEL))
    assert_moments_close({k: got[k] for k in mu}, {k: want[k] for k in mu},
                         zero_grad=[k for k in mu if k.endswith(ZERO_GRAD)],
                         float64={latent: _float64_step(j)[latent]})
    for side, opt in (("enc", "opt_e"), ("dec", "opt_d")):
        for k in want:
            if not k.startswith(f"{side}_params/") or k.endswith(ZERO_GRAD):
                continue
            g = want[k.replace(f"{side}_params/", f"{opt}/mu/")]
            mask = np.abs(g) > 1e-3 * np.abs(g).max()
            np.testing.assert_allclose(got[k][mask], want[k][mask], atol=2e-5, err_msg=k)


def _float64_step(j):
    """The port's first step of `j`'s case in float64 without remat (the
    same step in exact arithmetic as every mode's), flat under JAX's names."""
    cfg = dataclasses.replace(j["cfg_t"], dtype=torch.float64, param_dtype=torch.float64)
    model = make_model(cfg, device="cpu")
    model.load_state_dict(jax_to_state_dict(j["variables"], model))
    state = create_train_state(model, seed=0)
    make_soft_intro_train_step(model, SoftIntroLossConfig(), OptimConfig(), 1, cfg.input_shape,
                               zero_noise=True, fixed_noise=j["fixed"])(
        state, to_ncdhw(j["real"]).double())
    return export_train_state(state, j["trees0"])


def _jax_tags(name):
    """(tag, voxels) of every conv output the JAX model tags, encoder then
    decoder, from `jax.eval_shape` of its init (no array is made)."""
    cfg = dataclasses.replace(jax_get_model_config(name), remat=False)
    seen = []
    name_fn = jax_blocks.checkpoint_name

    def record(y, tag):
        if tag != jax_blocks.BN_STAT:
            seen.append((tag, int(np.prod(y.shape[1:-1]))))
        return name_fn(y, tag)

    x = jax.ShapeDtypeStruct((1,) + cfg.input_shape + (1,), jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_blocks, "checkpoint_name", record)
        jax.eval_shape(jax_make_model(cfg).init, jax.random.key(0), x)
    return seen


@pytest.mark.parametrize("name", ["spatial_1200", "spatial_1200_fullsize"])
def test_site_tags_at_full_size_match_jax(jax_steps, name):
    """Every conv site of the full-size model, classified by the port's rule,
    against the tags the JAX model puts on the same outputs (voxels >=
    200 000: "hi", by encoder or decoder scope). After the JAX steps are
    traced: the recorder replaces a module global their tracing reads."""
    for job in jax_steps.values():
        job.result()
    enc, dec = spatial_conv_sites(get_model_config(name))
    assert [(s.tag, s.voxels) for s in enc + dec] == _jax_tags(name)
    hi = [(s.kind, s.scope) for s in enc + dec if s.tag != remat.CONV_OUT]
    # spatial_1200: the stem and the first block's full-resolution conv in
    # the encoder, the last UpBlock's fused upsample and the output conv in
    # the decoder; the fullsize model also its sites at 80x96x80
    if name == "spatial_1200":
        dec_hi = [("upconv", "dec")]
        enc_hi = [("conv3d_same", "enc")]
    else:
        dec_hi = [("upconv", "dec"), ("conv3d_same", "dec"), ("upconv", "dec")]
        enc_hi = [("conv3d_same", "enc")] * 3
    assert hi == [("conv3d_from1", "enc")] + enc_hi + dec_hi + [("conv3d_to1", "dec")]
