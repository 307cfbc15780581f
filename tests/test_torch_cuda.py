"""sivae_torch on a CUDA card: each CUDA kernel against its plain version,
the launch counters, and a small model on the card against the same model
on the CPU. Every test skips without a card. This file imports nothing of
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances as in chip_smoke.py: fp32 (TF32 off) 1e-4 * max(1, max|plain|)
(reassociation over K <= 6912); bf16 1e-2 * max(1, max|plain|) (one output
rounding; the plain version takes the same bf16 inputs, sums in fp32)."""

import dataclasses

import pytest
import torch

from sivae_torch.kernels import build
from sivae_torch.kernels.conv3d import conv3d_same, conv3d_same_plain
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
