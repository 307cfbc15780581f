"""sivae_torch FC-latent family against the JAX package on the same inputs
and weights: `FCEncoder` / `FCDecoder` in eval and train mode, the
JAX -> port -> JAX carry of a whole FC train state, and one Soft-IntroVAE
train step of `tiny_fc`.

`tiny_fc` is run at 16x32x16 instead of its 16x16x16, so that the
bottleneck (1x2x1) has more than one voxel and the permutation between the
JAX package's (D, H, W, C) flatten and the port's (C, D, H, W) one (the
`encoder.fc` input features, the `decoder.dfc.0` output features) is
exercised. The weights are the port's seeded init with random BN
statistics and a non-zero logvar head (`torch_port_common.perturb`),
carried to JAX by `state_dict_to_jax` into the tree that `jax.eval_shape`
gives for the JAX model's init (no XLA compile of the init). The JAX side
runs XLA's convs on the CPU (its FC model routes no conv to a Pallas
kernel); the port takes its plain kernel versions on the CPU.

Tolerances (fp32, the two stacks sum the same products in other orders):
forwards max|diff| <= 1e-4 * max(1, max|ref|); the step's metrics rtol
1e-4; Adam's first moments (0.1 x the gradient after one step) within
1e-3 * max|m| where |m| > 1e-3 * max|m| of their tensor; BN running
statistics atol 1e-5. Every FC conv but the output one has a bias that
feeds a BN, so its exact gradient is 0: those moments are held to be
rounding noise (< 1e-4 of the largest first moment) in both stacks, and the
encoder's BN running means,
which phase D's encodes take after those biases moved by Adam's
random-sign first step (2 x lr x (0.1 + 0.09) = 7.6e-5), get atol 1e-4.

This tiny model's one-step first moments are badly conditioned in fp32:
the moments of its BN scales and biases are sums over many voxels that
nearly cancel, so two fp32 stacks that sum in other orders can differ on
them by more than 1e-3 of their maximum on other seeded weights and data,
while every forward agrees; a larger input (32^3, batch 4) does not help.
The comparison with JAX therefore runs on the port's seed-0 init with
`perturb`'s seed-0 statistics, the convention of the other port tests. What
does not depend on the seed is held without JAX: every backward pass the
port writes by hand (train-mode BN with each activation, and the three
conv wrappers) against float64 finite differences, by `gradcheck` on
several seeded inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sivae_tpu.config import OptimConfig as JaxOptimConfig
from sivae_tpu.config import SoftIntroLossConfig as JaxLossConfig
from sivae_tpu.models.registry import get_model_config as jax_get_model_config
from sivae_tpu.models.registry import make_model as jax_make_model
from sivae_tpu.train.state import SIVAETrainState as JaxTrainState
from sivae_tpu.train.state import make_optimizer as jax_make_optimizer
from sivae_tpu.train.step import make_soft_intro_train_step as jax_make_train_step
from sivae_torch.config import OptimConfig, SoftIntroLossConfig
from sivae_torch.kernels.conv3d import conv3d_same
from sivae_torch.kernels.conv3d_small import conv3d_from1, conv3d_to1
from sivae_torch.models.blocks import _BatchNormTrain
from sivae_torch.models.registry import get_model_config, make_model
from sivae_torch.train.state import create_train_state
from sivae_torch.train.step import make_soft_intro_train_step
from sivae_torch.utils.jax_import import (export_train_state, jax_to_state_dict,
                                          load_jax_train_state, load_reference_pth,
                                          state_dict_to_jax)
from torch_port_common import (assert_close_scaled, assert_moments_close, flat_state,
                               jax_state_trees, np_tree, perturb, to_ncdhw, to_ndhwc)

torch.set_num_threads(2)

SHAPE = (16, 32, 16)
BATCH = 3
TOL = 1e-4


def _cfgs(fuse: bool = True):
    cfg_j = dataclasses.replace(jax_get_model_config("tiny_fc"), input_shape=SHAPE,
                                remat=False, fuse_upconv=fuse)
    cfg_t = dataclasses.replace(get_model_config("tiny_fc"), input_shape=SHAPE, fuse_upconv=fuse)
    return cfg_j, cfg_t


def _port(variables, fuse: bool = True):
    m = make_model(_cfgs(fuse)[1], device="cpu")
    m.load_state_dict(jax_to_state_dict(variables, m))
    return m


@pytest.fixture(scope="module")
def pair():
    """The JAX model, the perturbed variables, and an input batch."""
    model_j = jax_make_model(_cfgs()[0])
    shapes = jax.eval_shape(model_j.init, jax.random.key(0),
                            jnp.zeros((1,) + SHAPE + (1,), jnp.float32))
    variables = perturb(state_dict_to_jax(make_model(_cfgs()[1], device="cpu", seed=0), shapes))
    x = np.random.RandomState(1).rand(BATCH, *SHAPE, 1).astype(np.float32)
    return model_j, variables, x


def test_fc_config_and_registry_match_jax():
    for name in ("fc_150", "fc_300", "fc_600", "tiny_fc"):
        cfg_t, cfg_j = get_model_config(name), jax_get_model_config(name)
        for f in dataclasses.fields(cfg_t):
            t, j = getattr(cfg_t, f.name), getattr(cfg_j, f.name)
            if f.name == "act":
                t, j = dataclasses.asdict(t), dataclasses.asdict(j)
            if f.name == "remat":   # off by default in the port, on in JAX (ROADMAP C)
                assert t is False and j is True, name
            elif f.name not in ("dtype", "param_dtype"):
                assert t == j, (name, f.name)
        assert cfg_t.latent_shape == cfg_j.latent_shape == (cfg_t.z_ch,)
        assert cfg_t.bottleneck_spatial_shape == cfg_j.bottleneck_spatial_shape


@pytest.mark.parametrize("fuse", [True, False])
def test_fc_encode_decode_eval_mode_match_jax(pair, fuse):
    """fuse=False is the reference's upsample-then-conv, which the FC
    goldens' JAX replay uses."""
    _, variables, x = pair
    model_j = jax_make_model(_cfgs(fuse)[0])
    (mu_j, lv_j), _ = model_j.encode(variables["enc"], jnp.asarray(x))
    y_j, _ = model_j.decode(variables["dec"], mu_j)
    with torch.no_grad():
        model_t = _port(variables, fuse)
        mu_t, lv_t = model_t.encode(to_ncdhw(x))
        y_t = model_t.decode(mu_t)
    assert mu_t.shape == lv_t.shape == (BATCH, 7)
    assert_close_scaled(mu_t.numpy(), np.asarray(mu_j), TOL)
    assert_close_scaled(lv_t.numpy(), np.asarray(lv_j), TOL)
    assert_close_scaled(to_ndhwc(y_t), np.asarray(y_j), TOL)


def test_fc_train_mode_forward_and_bn_statistics_match_jax(pair):
    model_j, variables, x = pair
    (mu_j, lv_j), ev = model_j.encode(variables["enc"], jnp.asarray(x), train=True)
    y_j, dv = model_j.decode(variables["dec"], mu_j, train=True)
    model_t = _port(variables).train()
    with torch.no_grad():
        mu_t, lv_t = model_t.encode(to_ncdhw(x))
        y_t = model_t.decode(mu_t)
    assert_close_scaled(mu_t.numpy(), np.asarray(mu_j), TOL)
    assert_close_scaled(lv_t.numpy(), np.asarray(lv_j), TOL)
    assert_close_scaled(to_ndhwc(y_t), np.asarray(y_j), TOL)
    want = jax_to_state_dict({"enc": np_tree(ev), "dec": np_tree(dv)}, model_t)
    before = jax_to_state_dict(variables, model_t)
    got = model_t.state_dict()
    keys = [k for k in got if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * (12 + 12)
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-5, err_msg=k)
        assert not torch.equal(got[k], before[k]), k


def test_fc_train_state_carries_jax_port_jax_bit_for_bit(pair):
    """Every parameter, BN statistic and Adam moment of a JAX FC state goes
    into the port and back out under its JAX name unchanged: the Dense
    heads' row split and both flatten permutations, forward and inverse."""
    _, variables, _ = pair
    rng = np.random.RandomState(3)

    def rand(tree):
        return jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(a.dtype), tree)

    trees = {"enc_params": variables["enc"]["params"], "dec_params": variables["dec"]["params"],
             "enc_stats": variables["enc"]["batch_stats"],
             "dec_stats": variables["dec"]["batch_stats"], "step": 3}
    for o, j in (("opt_e", "enc_params"), ("opt_d", "dec_params")):
        trees[o] = {"mu": rand(trees[j]), "nu": rand(trees[j]), "count": 3}
    model_t = make_model(_cfgs()[1], device="cpu")
    state = load_jax_train_state(create_train_state(model_t, seed=0), trees)
    got, want = export_train_state(state, trees), flat_state(trees)
    assert set(got) == set(want) and "opt_d/nu/Dense_0/kernel" in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the JAX mu head is encoder.fc's first 7 rows, its inputs permuted
    w = model_t.state_dict()["encoder.fc.weight"].numpy()
    mu_k = trees["enc_params"]["mu"]["kernel"]
    assert not np.array_equal(w[:7].T, mu_k)
    assert np.array_equal(np.sort(w[:7], axis=1), np.sort(mu_k.T, axis=1))


def test_reference_fc_pth_loads_with_its_orphan_block():
    """The reference FC encoder declares a `block8` its forward never calls
    (the FC goldens' state dicts hold it); the rest loads strictly."""
    cfg = _cfgs()[1]
    src = make_model(cfg, device="cpu", seed=1).state_dict()
    sd = dict(src, **{"encoder.block8.0.weight": torch.zeros(5, 5, 3, 3, 3)})
    model = load_reference_pth(make_model(cfg, device="cpu", seed=2), sd)
    assert all(torch.equal(model.state_dict()[k], v) for k, v in src.items())
    with pytest.raises(RuntimeError):
        load_reference_pth(make_model(cfg, device="cpu"),
                           dict(src, **{"encoder.blockX.weight": src["encoder.fc.bias"]}))


@pytest.fixture(scope="module")
def step_run(pair):
    """One Soft-IntroVAE step of both stacks from one state, zero_noise and
    a fixed numpy noise batch."""
    model_j, variables, x = pair
    opt = jax_make_optimizer(JaxOptimConfig(), 1)
    enc, dec = variables["enc"], variables["dec"]
    st = JaxTrainState(enc_params=enc["params"], dec_params=dec["params"],
                       enc_stats=enc["batch_stats"], dec_stats=dec["batch_stats"],
                       opt_e=opt.init(enc["params"]), opt_d=opt.init(dec["params"]),
                       rng=jax.random.key(4), step=jnp.zeros((), jnp.int32))
    trees0 = jax_state_trees(st)
    fixed = np.random.RandomState(6).randn(BATCH, 7).astype(np.float32)
    step_j = jax.jit(jax_make_train_step(model_j, JaxLossConfig(), JaxOptimConfig(), 1, SHAPE,
                                         zero_noise=True, fixed_noise=fixed))
    st1, m_j = step_j(st, jnp.asarray(x))
    model_t = make_model(_cfgs()[1], device="cpu")
    state_t = load_jax_train_state(create_train_state(model_t, seed=0), trees0)
    step_t = make_soft_intro_train_step(model_t, SoftIntroLossConfig(), OptimConfig(), 1, SHAPE,
                                        zero_noise=True, fixed_noise=fixed)
    _, m_t = step_t(state_t, to_ncdhw(x))
    return (flat_state(jax_state_trees(st1)), {k: np.asarray(v) for k, v in m_j.items()},
            export_train_state(state_t, trees0), {k: v.detach().numpy() for k, v in m_t.items()})


def test_fc_soft_intro_step_metrics_match_jax(step_run):
    _, m_j, _, m_t = step_run
    assert set(m_j) == set(m_t)
    assert not m_t["nan"] and not m_j["nan"]
    for k in m_j:
        if k != "nan":
            np.testing.assert_allclose(m_t[k], m_j[k], rtol=1e-4, atol=1e-30, err_msg=k)


def test_fc_soft_intro_step_state_matches_jax(step_run):
    want, _, got, _ = step_run
    mu = {k: v for k, v in want.items() if k.startswith(("opt_e/mu/", "opt_d/mu/"))}
    # conv biases feeding a BN: all but the output conv's (decoder Conv3d_2)
    zero = {k for k in mu if k.endswith("/Conv_0/bias")
            and not k.endswith("Conv3d_2/Conv_0/bias")}
    # 25 convs, 24 BNs and 3 Denses (mu, logvar, dfc), two tensors each
    assert len(zero) == 12 + 12 and len(mu) == 2 * (25 + 24 + 3)
    assert_moments_close(got, mu, zero_grad=zero)
    stats = [k for k in want if k.startswith(("enc_stats/", "dec_stats/"))]
    assert len(stats) == 2 * (12 + 12)
    for k in stats:
        noisy_mean = k.startswith("enc_stats/") and k.endswith("/mean")
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4 if noisy_mean else 1e-5,
                                   err_msg=k)
    assert got["opt_e/count"] == want["opt_e/count"] == got["opt_d/count"] == 1


def _bn_train(slope):
    return lambda x, w, b: _BatchNormTrain.apply(x, w, b, 1e-5, slope, torch.float64)[0]


BACKWARDS = {
    # name: (function, input shapes); BN over (B, C, D, H, W), convs NDHWC
    "bn": (_bn_train(None), [(2, 3, 2, 3, 2), (3,), (3,)]),
    "bn_relu": (_bn_train(0.0), [(2, 3, 2, 3, 2), (3,), (3,)]),
    "bn_leaky": (_bn_train(0.2), [(2, 3, 2, 3, 2), (3,), (3,)]),
    "conv3d_same": (conv3d_same, [(1, 2, 2, 3, 2), (3, 3, 3, 2, 2)]),
    "conv3d_to1": (conv3d_to1, [(1, 2, 2, 3, 2), (3, 3, 3, 2, 1)]),
    "conv3d_from1": (conv3d_from1, [(1, 2, 2, 3, 1), (3, 3, 3, 1, 2)]),
}


@pytest.mark.parametrize("name", sorted(BACKWARDS))
def test_hand_written_backward_matches_float64_finite_differences(name):
    """The port's own backward passes (the plain versions on the CPU, in
    float64) against central differences on three seeded inputs: every
    Jacobian entry, by `gradcheck` at its tolerances (atol 1e-5, rtol 1e-3)."""
    fn, shapes = BACKWARDS[name]
    for seed in range(3):
        rng = np.random.RandomState(seed)
        args = [torch.tensor(rng.randn(*s), dtype=torch.float64, requires_grad=True)
                for s in shapes]
        assert torch.autograd.gradcheck(fn, args), (name, seed)
