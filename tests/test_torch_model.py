"""sivae_torch model: eval-mode encode / decode of `tiny_spatial` against the
JAX model on the same weights (carried with `jax_to_state_dict`), train-mode
BatchNorm (output, running statistics, gradients) against flax's `_BNCore`
and against autograd of the naive formula, the fused upsample+conv against
JAX and against upsample-then-conv, the weight carry's completeness in both
directions, and reference-checkpoint loading.

fp32 tolerance: max|diff| <= 1e-4 * max(1, max|ref|) (the two stacks sum
the same products in other orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sivae_tpu.config import SpatialVAEConfig as JaxSpatialVAEConfig
from sivae_tpu.models.blocks import _BNCore
from sivae_tpu.models.registry import make_model as jax_make_model
from sivae_tpu.ops.fused_upconv import upsampled_conv3x3 as jax_upsampled_conv3x3
from sivae_tpu.utils.torch_import import import_spatial_soft_intro_vae
from sivae_torch.config import SpatialVAEConfig
from sivae_torch.kernels.conv3d import conv3d_same_plain
from sivae_torch.models.blocks import (BatchNorm, Dropout, UpBlock, UpsampleConv3d,
                                       upsample_nearest3d)
from sivae_torch.models.registry import get_model_config, make_model
from sivae_torch.models.resnet_vae import reparameterize
from sivae_torch.ops.fused_upconv import upsampled_conv3x3
from sivae_torch.utils.jax_import import jax_to_state_dict, load_reference_pth
from torch_port_common import assert_close_scaled, tiny_pair, to_ncdhw, to_ndhwc

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


def test_encode_matches_jax(pair):
    model_j, variables, model_t = pair
    x = np.random.RandomState(0).rand(2, 16, 16, 16, 1).astype(np.float32)
    (mu_j, lv_j), _ = jax.jit(lambda v, x: model_j.encode(v, x))(variables["enc"], x)
    with torch.no_grad():
        mu_t, lv_t = model_t.encode(to_ncdhw(x))
    assert mu_t.shape == (2, 1, 4, 4, 4)
    assert_close_scaled(to_ndhwc(mu_t), mu_j, 1e-4)
    assert_close_scaled(to_ndhwc(lv_t), lv_j, 1e-4)
    assert np.abs(np.asarray(lv_j)).max() > 1e-3  # the logvar head is live


def test_decode_matches_jax(pair):
    model_j, variables, model_t = pair
    z = np.random.RandomState(1).randn(2, 64).astype(np.float32)
    y_j, _ = jax.jit(lambda v, z: model_j.decode(v, z))(variables["dec"], z)
    with torch.no_grad():
        y_t = model_t.decode(torch.from_numpy(z))
    assert y_t.shape == (2, 1, 16, 16, 16)
    assert_close_scaled(to_ndhwc(y_t), y_j, 1e-4)


def test_bf16_model_runs_and_tracks_fp32(pair):
    _, _, model_t = pair
    cfg16 = dataclasses.replace(model_t.cfg, dtype=torch.bfloat16)
    m16 = make_model(cfg16, device="cpu")
    m16.load_state_dict(model_t.state_dict())
    x = torch.from_numpy(np.random.RandomState(2).rand(2, 1, 16, 16, 16).astype(np.float32))
    with torch.no_grad():
        mu16, _ = m16.encode(x)
        mu32, _ = model_t.encode(x)
    assert mu16.dtype == torch.bfloat16
    assert_close_scaled(mu16.float().numpy(), mu32.numpy(), 0.1)


@pytest.mark.parametrize("with_bias", [False, True])
def test_fused_upconv_matches_jax_and_upsample_conv(with_bias):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 4, 5, 6).astype(np.float32)             # NDHWC, Ci = 6
    w = (rng.randn(3, 3, 3, 6, 5) * 0.2).astype(np.float32)     # DHWIO, Co = 5
    b = rng.randn(5).astype(np.float32) if with_bias else None
    want = np.asarray(jax_upsampled_conv3x3(jnp.asarray(x), jnp.asarray(w),
                                            None if b is None else jnp.asarray(b)))
    wt = torch.from_numpy(w).permute(4, 3, 0, 1, 2).contiguous()  # OIDHW
    bt = None if b is None else torch.from_numpy(b)
    got = upsampled_conv3x3(to_ncdhw(x), wt, bt)
    assert got.shape == (2, 5, 6, 8, 10)
    np.testing.assert_allclose(to_ndhwc(got), want, atol=2e-5)
    up = upsample_nearest3d(to_ncdhw(x), 2).permute(0, 2, 3, 4, 1).contiguous()
    direct = conv3d_same_plain(up, torch.from_numpy(w))
    if bt is not None:
        direct = direct + bt
    np.testing.assert_allclose(to_ndhwc(got), direct.numpy(), atol=2e-5)


@pytest.mark.parametrize("remat", [True, False])
def test_weight_carry_covers_every_leaf_both_ways(remat):
    """Both module namings (remat's `Checkpoint*` and plain) carry over, and
    a missing or extra leaf on either side raises."""
    cfg_j = dataclasses.replace(JaxSpatialVAEConfig(
        in_ch=3, block_setting=((3, 1, 2), (5, 1, 1), (6, 1, 2)), input_shape=(8, 8, 8)),
        remat=remat)
    model_j = jax_make_model(cfg_j)
    shapes = jax.eval_shape(model_j.init, jax.random.key(0),
                            jnp.zeros((1, 8, 8, 8, 1), jnp.float32))
    variables = jax.tree_util.tree_map(lambda s: np.ones(s.shape, s.dtype), shapes)
    variables = jax.tree_util.tree_map(lambda a: a, variables)  # plain nested dicts
    model_t = make_model(SpatialVAEConfig(in_ch=3, block_setting=((3, 1, 2), (5, 1, 1), (6, 1, 2)),
                                          input_shape=(8, 8, 8)), device="cpu")
    sd = jax_to_state_dict(variables, model_t)
    assert set(sd) == set(model_t.state_dict())
    assert "encoder.blocks.2.0.shortcut.weight" in sd  # the 3 -> 5 stride-1 projection
    model_t.load_state_dict(sd)

    enc = dict(variables["enc"])
    enc["params"] = dict(enc["params"])
    stray = "CheckpointConvBlock_0" if remat else "ConvBlock_0"
    inner = dict(enc["params"][stray])
    inner["Conv3d_5"] = {"Conv_0": {"kernel": np.ones((3, 3, 3, 3, 3), np.float32)}}
    enc["params"][stray] = inner
    with pytest.raises(KeyError):
        jax_to_state_dict({"enc": enc, "dec": variables["dec"]}, model_t)

    enc = dict(variables["enc"])
    enc["params"] = {k: v for k, v in enc["params"].items() if k != "mu"}
    with pytest.raises(KeyError, match="without a JAX leaf"):
        jax_to_state_dict({"enc": enc, "dec": variables["dec"]}, model_t)


def test_reference_checkpoint_round_trip():
    """The reference torch init of tests/golden/reference_oracle.npz loads
    into the port with load_state_dict (orphans dropped), and carrying it
    through the JAX import and back reproduces every tensor."""
    z = np.load("tests/golden/reference_oracle.npz")
    sd = {k[len("init/"):]: z[k] for k in z.files if k.startswith("init/")}
    blocks = ((2, 1, 2), (2, 1, 2), (2, 2, 2))
    model_t = make_model(SpatialVAEConfig(in_ch=2, block_setting=blocks), device="cpu")
    load_reference_pth(model_t, {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    for k, v in model_t.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)

    cfg_j = JaxSpatialVAEConfig(in_ch=2, block_setting=blocks)
    model_j = jax_make_model(cfg_j)
    shapes = jax.eval_shape(model_j.init, jax.random.key(0),
                            jnp.zeros((1, 80, 96, 80, 1), jnp.float32))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    variables = import_spatial_soft_intro_vae(sd, cfg_j, template)
    back = jax_to_state_dict(variables, model_t)
    for k, v in back.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(v.numpy(), sd[k], rtol=0, atol=0, err_msg=k)


def test_registry_spatial_entries_build_to_their_latent_dims():
    want = {"spatial_150": 150, "spatial_1200": 1200, "spatial_1200_noreg": 1200,
            "vae_150": 150, "cae_150": 150, "spatial_1200_fullsize": 1200, "tiny_spatial": 64}
    for name, dim in want.items():
        assert get_model_config(name).latent_dim == dim, name
    cae = make_model(get_model_config("cae_150"), device="cpu")
    assert "encoder.conv.0.weight" in cae.state_dict()


def test_reparameterize_and_dropout_need_explicit_generators():
    mu = torch.randn(2, 1, 2, 2, 2)
    lv = torch.randn(2, 1, 2, 2, 2)
    torch.testing.assert_close(reparameterize(mu, lv, val_eps=0.1), mu + 0.1 * torch.exp(0.5 * lv))
    with pytest.raises(ValueError):
        reparameterize(mu, lv)
    a = reparameterize(mu, lv, generator=torch.Generator().manual_seed(3))
    b = reparameterize(mu, lv, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)

    drop = Dropout(0.5).train()
    x = torch.ones(2, 3, 4, 4, 4)
    with pytest.raises(RuntimeError):
        drop(x)
    drop.generator = torch.Generator().manual_seed(0)
    y1 = drop(x)
    drop.generator = torch.Generator().manual_seed(0)
    assert torch.equal(y1, drop(x))
    assert set(torch.unique(y1).tolist()) <= {0.0, 2.0}
    assert torch.equal(drop.eval()(x), x)


def test_eval_only_blocks_refuse_what_they_do_not_compute():
    """A fresh BatchNorm in eval mode is the identity up to eps, and UpBlock
    upsamples by 2 only (through the fused op)."""
    bn = BatchNorm(3)
    x = torch.randn(2, 3, 2, 2, 2)
    torch.testing.assert_close(bn.eval()(x), x / np.sqrt(1.0 + 1e-5))
    act = get_model_config("tiny_spatial").act
    assert isinstance(UpBlock(4, 3, 2, act).block[4], UpsampleConv3d)
    with pytest.raises(ValueError):
        UpBlock(4, 3, 3, act)


def _bn_inputs(seed, c=5):
    rng = np.random.RandomState(seed)
    x = (rng.randn(3, 4, 5, 6, c) * rng.uniform(0.5, 2.0, c) + rng.randn(c)).astype(np.float32)
    return {"x": x, "g": rng.randn(3, 4, 5, 6, c).astype(np.float32),
            "scale": (1.0 + 0.3 * rng.randn(c)).astype(np.float32),
            "bias": (0.2 * rng.randn(c)).astype(np.float32),
            "mean": (0.1 * rng.randn(c)).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}


def _port_bn(a, act_slope=None, dtype=torch.float32):
    bn = BatchNorm(a["x"].shape[-1], dtype=dtype, act_slope=act_slope).train()
    bn.load_state_dict({"weight": torch.from_numpy(a["scale"]), "bias": torch.from_numpy(a["bias"]),
                        "running_mean": torch.from_numpy(a["mean"]),
                        "running_var": torch.from_numpy(a["var"]),
                        "num_batches_tracked": torch.tensor(0)})
    return bn


@pytest.mark.parametrize("what", ["y", "running_mean", "running_var", "dx", "dweight", "dbias"])
def test_train_mode_batchnorm_matches_flax(what):
    """Output, moved running statistics (biased variance, momentum 0.9) and
    the three gradients against `_BNCore` under `jax.vjp`, fp32 atol 1e-5."""
    a = _bn_inputs(0)
    core = _BNCore()
    variables = {"params": {"scale": a["scale"], "bias": a["bias"]},
                 "batch_stats": {"mean": a["mean"], "var": a["var"]}}

    def apply(x, params):
        y, mut = core.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                            use_running_average=False, mutable=["batch_stats"])
        return y, mut["batch_stats"]

    y_j, vjp, stats_j = jax.vjp(apply, jnp.asarray(a["x"]), variables["params"], has_aux=True)
    dx_j, dparams_j = vjp(jnp.asarray(a["g"]))
    want = {"y": y_j, "running_mean": stats_j["mean"], "running_var": stats_j["var"], "dx": dx_j,
            "dweight": dparams_j["scale"], "dbias": dparams_j["bias"]}

    bn = _port_bn(a)
    x = to_ncdhw(a["x"]).requires_grad_()
    y = bn(x)
    dx, dweight, dbias = torch.autograd.grad(y, (x, bn.weight, bn.bias), to_ncdhw(a["g"]))
    got = {"y": to_ndhwc(y), "running_mean": bn.running_mean.numpy(),
           "running_var": bn.running_var.numpy(), "dx": to_ndhwc(dx),
           "dweight": dweight.numpy(), "dbias": dbias.numpy()}
    assert int(bn.num_batches_tracked) == 1
    np.testing.assert_allclose(got[what], np.asarray(want[what]), atol=1e-5, rtol=1e-5)


def _naive_bn(x, weight, bias, slope, eps=1e-5):
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3, 4))
    var = ((xf * xf).mean(dim=(0, 2, 3, 4)) - mean * mean).clamp_min(0.0)
    v = (1, -1, 1, 1, 1)
    y = ((x - mean.view(v)) * (torch.rsqrt(var.view(v) + eps) * weight.view(v))
         + bias.view(v)).to(x.dtype)
    if slope is None:
        return y
    return torch.relu(y) if slope == 0.0 else torch.nn.functional.leaky_relu(y, slope)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("slope", [None, 0.2, 0.0], ids=["no_act", "leaky", "relu"])
def test_lean_batchnorm_matches_autograd_of_the_naive_formula(slope, dtype):
    """The Function that saves only its input and the per-channel statistics
    gives the output and gradients of the formula written out in eager ops
    (which keeps every intermediate). bf16: same output bits; the naive
    backward rounds its intermediates to bf16, the lean one works in fp32."""
    a = _bn_inputs(1)
    bn = _port_bn(a, act_slope=slope, dtype=dtype)
    x = to_ncdhw(a["x"]).to(dtype).requires_grad_()
    g = to_ncdhw(a["g"]).to(dtype)
    y = bn(x)
    got = torch.autograd.grad(y, (x, bn.weight, bn.bias), g)
    x2 = x.detach().clone().requires_grad_()
    y2 = _naive_bn(x2, bn.weight, bn.bias, slope)
    want = torch.autograd.grad(y2, (x2, bn.weight, bn.bias), g)
    assert y.dtype == dtype and got[0].dtype == dtype and got[1].dtype == torch.float32
    assert torch.equal(y, y2)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    for p, q in zip(got, want):
        lim = tol * max(1.0, q.float().abs().max().item())
        assert (p.float() - q.float()).abs().max().item() <= lim


def test_batchnorm_constant_channel_takes_the_clamped_variance():
    """A constant channel has E[x^2] - mean^2 = 0 (or rounding below it):
    the variance is clamped at 0, the output is the bias, and the gradient
    stays finite (no path through the clamped variance)."""
    bn = BatchNorm(2).train()
    x = torch.full((2, 2, 3, 3, 3), 0.7)
    x[:, 1] = torch.randn(2, 3, 3, 3)
    x.requires_grad_()
    y = bn(x)
    (dx,) = torch.autograd.grad(y.sum() + (y * y).sum(), x)
    assert torch.allclose(y[:, 0], torch.zeros(()), atol=1e-3) and torch.isfinite(dx).all()
    assert bn.running_var[0] <= 0.9 + 1e-6


def test_block_fusion_keeps_module_names_and_eval_outputs():
    """The BNs apply their activations themselves; the reference's module
    indices (and so its state_dict keys) are unchanged."""
    act = get_model_config("tiny_spatial").act
    from sivae_torch.models.blocks import ConvBlock

    for blk, fused_out in ((ConvBlock(4, 4, 2, act), True), (ConvBlock(4, 6, 1, act), False),
                           (UpBlock(4, 3, 2, act), True), (UpBlock(4, 4, 1, act), False)):
        keys = {k.rsplit(".", 1)[0] for k in blk.state_dict()}
        assert {"block.0", "block.1", "block.4", "block.5"} <= keys
        assert blk.block[1].act_slope == 0.2
        assert (blk.block[5].act_slope == 0.2) == fused_out
        assert isinstance(blk.act, torch.nn.Identity) == fused_out
