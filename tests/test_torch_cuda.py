"""sivae_torch on a CUDA card: each CUDA kernel against its plain version,
the launch counters, the four differentiable wrappers' gradients against
autograd through the plain versions, a small model on the card against the
same model on the CPU, and one train step on the card against the CPU's.
Every test skips without a card. This file imports nothing of
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances as in chip_smoke.py: fp32 (TF32 off) 1e-4 * max(1, max|plain|)
(reassociation over K <= 6912); bf16 1e-2 * max(1, max|plain|) (one output
rounding; the plain version takes the same bf16 inputs, sums in fp32); the
fused kernel's plane sums 1e-3 * max(1, max|plain sum|) (fp32 atomics in
another order, over values a few of which differ by one rounding)."""

import dataclasses

import pytest
import torch

from sivae_torch.kernels import build
from sivae_torch.kernels.conv3d import conv3d_same, conv3d_same_plain
from sivae_torch.kernels.conv3d_fused import (conv3d_fused_stats, conv3d_fused_stats_plain,
                                              conv3d_stats)
from sivae_torch.kernels.conv3d_small import (conv3d_from1, conv3d_from1_plain, conv3d_to1,
                                              conv3d_to1_plain)

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
CASES = [  # kernel, plain version, x shape, w shape
    (conv3d_same, conv3d_same_plain, (2, 6, 8, 10, 64), (3, 3, 3, 64, 64)),    # mma body in bf16
    (conv3d_same, conv3d_same_plain, (1, 5, 6, 4, 64), (3, 3, 3, 64, 128)),
    (conv3d_same, conv3d_same_plain, (2, 4, 5, 6, 3), (3, 3, 3, 3, 4)),       # FMA body
    (conv3d_same, conv3d_same_plain, (2, 3, 4, 4, 1), (3, 3, 3, 1, 5)),
    (conv3d_to1, conv3d_to1_plain, (2, 6, 8, 10, 64), (3, 3, 3, 64, 1)),      # 16-byte body
    (conv3d_to1, conv3d_to1_plain, (2, 4, 5, 6, 5), (3, 3, 3, 5, 1)),         # scalar body
    (conv3d_from1, conv3d_from1_plain, (2, 6, 8, 10, 1), (3, 3, 3, 1, 64)),
    (conv3d_from1, conv3d_from1_plain, (2, 4, 5, 6, 1), (3, 3, 3, 1, 5)),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); run chip_smoke.py there")
    from sivae_torch.utils.device import resolve_device

    return resolve_device("cuda")  # also turns TF32 off


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kern,plain,x_shape,w_shape", CASES)
def test_kernel_matches_plain_and_counts_one_launch(cuda_device, dtype, kern, plain, x_shape,
                                                    w_shape):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(x_shape, generator=gen, device=cuda_device).to(dtype)
    w = (0.1 * torch.randn(w_shape, generator=gen, device=cuda_device)).to(dtype)
    name = kern.__name__
    before = build.launches[name]
    got = kern(x, w)
    torch.cuda.synchronize()
    assert build.launches[name] == before + 1
    want = plain(x, w)
    assert got.shape == want.shape and got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * max(1.0, want.float().abs().max().item())


# x shape, Co: the tensor-core body in bf16 inside one plane (16 * 8 = 128
# voxels a plane) and straddling planes (7 * 9 = 63), and the FMA body
FUSED_CASES = [((2, 3, 16, 8, 64), 64), ((2, 6, 7, 9, 64), 128), ((2, 6, 7, 9, 3), 5)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("x_shape,co", FUSED_CASES)
def test_fused_stats_kernel_matches_plain(cuda_device, dtype, prologue, x_shape, co):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    ci = x_shape[-1]
    x = torch.randn(x_shape, generator=gen, device=cuda_device).to(dtype)
    w = (0.1 * torch.randn((3, 3, 3, ci, co), generator=gen, device=cuda_device)).to(dtype)
    ab = ()
    if prologue:  # a shift well off 0: padding before the prologue would show
        ab = (0.5 + torch.rand(ci, generator=gen, device=cuda_device),
              0.3 + 0.3 * torch.rand(ci, generator=gen, device=cuda_device), 0.2)
    before = build.launches["conv3d_fused_stats"]
    got = conv3d_fused_stats(x, w, *ab)
    torch.cuda.synchronize()
    assert build.launches["conv3d_fused_stats"] == before + 1
    want = conv3d_fused_stats_plain(x, w, *ab)
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    for g, p, tol in zip(got, want, (TOL[dtype], 1e-3, 1e-3)):
        assert g.shape == p.shape
        err = (g.float() - p.float()).abs().max().item()
        assert err <= tol * max(1.0, p.float().abs().max().item())


def _stats_plain(x, w):
    y = conv3d_same_plain(x, w)
    return y, y.sum(dim=(2, 3)), (y * y).sum(dim=(2, 3))


GRAD_CASES = [  # differentiable wrapper, plain version, x shape, w shape
    (conv3d_same, conv3d_same_plain, (2, 6, 8, 10, 64), (3, 3, 3, 64, 128)),  # dgrad 128 -> 64
    (conv3d_same, conv3d_same_plain, (2, 4, 5, 6, 3), (3, 3, 3, 3, 4)),
    (conv3d_to1, conv3d_to1_plain, (2, 6, 8, 10, 64), (3, 3, 3, 64, 1)),
    (conv3d_from1, conv3d_from1_plain, (2, 6, 8, 10, 1), (3, 3, 3, 1, 64)),
    (conv3d_stats, _stats_plain, (2, 6, 7, 9, 64), (3, 3, 3, 64, 64)),
    (conv3d_stats, _stats_plain, (2, 4, 5, 6, 3), (3, 3, 3, 3, 4)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn,plain,x_shape,w_shape", GRAD_CASES)
def test_gradients_match_autograd_through_the_plain_version(cuda_device, dtype, fn, plain,
                                                            x_shape, w_shape):
    """dx (the kernels on flipped weights) and dw (the library) against fp32
    autograd through the plain version on the same values; every output gets
    a non-zero cotangent."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(x_shape, generator=gen, device=cuda_device).to(dtype)
    w = (0.1 * torch.randn(w_shape, generator=gen, device=cuda_device)).to(dtype)
    xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = sum(build.launches.values())
    out = fn(xk, wk)
    out = out if isinstance(out, tuple) else (out,)
    cot = [torch.randn(o.shape, generator=gen, device=cuda_device).to(o.dtype) for o in out]
    dx, dw = torch.autograd.grad(out, (xk, wk), cot)
    torch.cuda.synchronize()
    assert sum(build.launches.values()) == before + 2  # the forward, and dx
    xp, wp = x.float().requires_grad_(), w.float().requires_grad_()
    ref = plain(xp, wp)
    ref = ref if isinstance(ref, tuple) else (ref,)
    dx_p, dw_p = torch.autograd.grad(ref, (xp, wp), [c.float() for c in cot])
    assert dx.dtype == dw.dtype == dtype
    for g, p in ((dx, dx_p), (dw, dw_p)):
        err = (g.float() - p).abs().max().item()
        assert err <= TOL[dtype] * max(1.0, p.abs().max().item())


@pytest.mark.gpu
def test_kernels_reject_what_they_do_not_take(cuda_device):
    x = torch.zeros((1, 4, 4, 4, 8), device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        conv3d_same(x, torch.zeros((3, 3, 3, 8, 8), device=cuda_device, dtype=torch.float16))
    x = torch.zeros((1, 4, 4, 8, 4), device=cuda_device).transpose(2, 3)  # not contiguous
    with pytest.raises(ValueError):
        conv3d_same(x, torch.zeros((3, 3, 3, 4, 4), device=cuda_device))
    with pytest.raises(ValueError):  # operands on different devices
        conv3d_same(torch.zeros((1, 4, 4, 4, 4), device=cuda_device), torch.zeros((3, 3, 3, 4, 4)))


@pytest.mark.gpu
def test_tiny_model_on_the_card_matches_the_cpu(cuda_device):
    """fp32 model on the card (kernels) vs the same weights on the CPU
    (plain versions): relative error of mu and reconstruction <= 1e-3."""
    from sivae_torch.eval.recon_quality import reconstruct
    from sivae_torch.models.registry import get_model_config, make_model

    cfg = get_model_config("tiny_spatial")
    gpu_model = make_model(cfg, device=cuda_device, seed=3)
    cpu_model = make_model(cfg, device="cpu", seed=3)
    x = torch.rand((2, 1) + cfg.input_shape, generator=torch.Generator().manual_seed(0))
    build.reset_launches()
    with torch.no_grad():
        mu_g, _ = gpu_model.encode(x.to(cuda_device))
        y_g = reconstruct(gpu_model, x.to(cuda_device))
        mu_c, _ = cpu_model.encode(x)
        y_c = reconstruct(cpu_model, x)
    assert build.launches["conv3d_same"] > 0 and build.launches["conv3d_from1"] == 2
    assert build.launches["conv3d_to1"] == 1
    for g, c in ((mu_g, mu_c), (y_g, y_c)):
        err = (g.cpu() - c).abs().max().item()
        assert err <= 1e-3 * c.abs().max().item()

    m16 = make_model(dataclasses.replace(cfg, dtype=torch.bfloat16), device=cuda_device, seed=3)
    with torch.no_grad():
        y16 = reconstruct(m16, x.to(cuda_device))
    assert y16.dtype == torch.bfloat16 and torch.isfinite(y16.float()).all()


@pytest.mark.gpu
def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One fp32 two-phase step of `tiny_spatial` (no dropout, zero_noise, a
    fixed noise batch) through the kernels, forward and backward, against
    the same step through the plain versions: losses within 1e-4 relative,
    Adam's first moments within 1e-3 * max|m| per tensor (floored)."""
    import numpy as np

    from sivae_torch.config import OptimConfig, SoftIntroLossConfig
    from sivae_torch.models.registry import get_model_config, make_model
    from sivae_torch.train.state import create_train_state
    from sivae_torch.train.step import make_soft_intro_train_step

    cfg = get_model_config("tiny_spatial")
    cfg = dataclasses.replace(cfg, act=cfg.act.with_no_dropout())
    rng = np.random.RandomState(0)
    real = torch.from_numpy(rng.rand(4, 1, *cfg.input_shape).astype(np.float32))
    fixed = rng.randn(4, cfg.latent_dim).astype(np.float32)
    out = {}
    for where in (cuda_device, torch.device("cpu")):
        model = make_model(cfg, device=where, seed=3)
        state = create_train_state(model, seed=0)
        step = make_soft_intro_train_step(model, SoftIntroLossConfig(), OptimConfig(), 1,
                                          cfg.input_shape, zero_noise=True, fixed_noise=fixed)
        build.reset_launches()
        _, metrics = step(state, real.to(where))
        names = {p: k for k, p in model.named_parameters()}
        out[where.type] = ({k: float(v) for k, v in metrics.items()},
                           {names[p]: s["exp_avg"].cpu() for opt in (state.opt_e, state.opt_d)
                            for p, s in opt.state.items()}, dict(build.launches))
    (m_k, mom_k, n_k), (m_p, mom_p, n_p) = out["cuda"], out["cpu"]
    assert n_k["conv3d_same"] > 0 and n_k["conv3d_to1"] == 10 and n_k["conv3d_from1"] == 12
    assert not any(n_p.values())
    for key in ("lossE", "lossD"):
        assert abs(m_k[key] - m_p[key]) <= 1e-4 * abs(m_p[key])
    # a gradient that is (nearly) zero in exact arithmetic, such as a conv bias
    # or a 1-channel conv weight in front of a BN, holds cancellation noise:
    # the per-tensor scale has a floor of 1e-2 of the model's largest moment
    floor = 1e-2 * max(m.abs().max().item() for m in mom_p.values())
    for k, want in mom_p.items():
        scale = max(want.abs().max().item(), floor)
        assert (mom_k[k] - want).abs().max().item() <= 1e-3 * scale, k
