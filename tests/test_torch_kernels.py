"""sivae_torch conv kernels: each plain PyTorch version against its Pallas
original (interpret mode on the CPU), the CPU routing of the wrappers, and
each wrapper's gradient (a `torch.autograd.Function`) against `jax.vjp` of
the Pallas original. The CUDA kernels themselves are tested in
test_torch_cuda.py.

Tolerances: fp32 atol 1e-4 (as tests/test_pallas_conv.py). bf16 atol/rtol
0.05: the plain version sums all 27 taps in fp32 and rounds once, the
Pallas v1 rounds its running sum to bf16 after every depth tap."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sivae_tpu.kernels.conv3d import conv3d_same_pallas
from sivae_tpu.kernels.conv3d_small import conv3d_from1 as jax_from1
from sivae_tpu.kernels.conv3d_small import conv3d_to1 as jax_to1
from sivae_torch.kernels import build
from sivae_torch.kernels.conv3d import conv3d_same, conv3d_same_plain
from sivae_torch.kernels.conv3d_small import (conv3d_from1, conv3d_from1_gemm_plain,
                                              conv3d_from1_plain, conv3d_to1,
                                              conv3d_to1_contract_first_plain, conv3d_to1_plain)

torch.set_num_threads(2)

CONV_SHAPES = [((2, 4, 5, 6), 3, 4), ((1, 6, 8, 6), 8, 8), ((2, 3, 4, 4), 1, 5)]
TO1_SHAPES = [((2, 4, 5, 6), 3), ((1, 6, 8, 6), 8), ((2, 3, 4, 4), 1)]
FROM1_SHAPES = [((2, 4, 5, 6), 3), ((1, 6, 8, 6), 8)]


def _inputs(seed, shape, cin, cout):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape, cin).astype(np.float32)
    w = (rng.randn(3, 3, 3, cin, cout) * 0.1).astype(np.float32)
    return x, w


def _bf16(a: np.ndarray):
    """The same bf16 values for both stacks."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("shape,cin,cout", CONV_SHAPES)
def test_conv3d_plain_matches_pallas(shape, cin, cout):
    x, w = _inputs(0, shape, cin, cout)
    got = conv3d_same_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = np.asarray(conv3d_same_pallas(jnp.asarray(x), jnp.asarray(w), True))
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("shape,cin,cout", CONV_SHAPES + [((1, 4, 4, 4), 4, 4)])
def test_conv3d_plain_matches_pallas_bf16(shape, cin, cout):
    x, w = _inputs(2, shape, cin, cout)
    (xt, xj), (wt, wj) = _bf16(x), _bf16(w)
    got = conv3d_same_plain(xt, wt).float().numpy()
    want = np.asarray(conv3d_same_pallas(xj, wj, True).astype(jnp.float32))
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0.05)


@pytest.mark.parametrize("shape,c", TO1_SHAPES)
def test_to1_plain_matches_pallas(shape, c):
    x, w = _inputs(0, shape, c, 1)
    got = conv3d_to1_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = np.asarray(jax_to1(jnp.asarray(x), jnp.asarray(w), True))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("shape,c", FROM1_SHAPES)
def test_from1_plain_matches_pallas(shape, c):
    x, w = _inputs(1, shape, 1, c)
    got = conv3d_from1_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = np.asarray(jax_from1(jnp.asarray(x), jnp.asarray(w), True))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_to1_plain_matches_pallas_bf16():
    x, w = _inputs(3, (1, 4, 6, 4), 8, 1)
    (xt, xj), (wt, wj) = _bf16(x), _bf16(w)
    got = conv3d_to1_plain(xt, wt).float().numpy()
    want = np.asarray(jax_to1(xj, wj, True).astype(jnp.float32))
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0.05)


# the tensor-core body's algorithm (channels contracted once per voxel, then
# 27 shifted adds), at grids no 16 x 16 patch divides
CONTRACT_SHAPES = [((1, 5, 7, 9), 16), ((2, 3, 5, 7), 64), ((1, 4, 18, 5), 32)]


@pytest.mark.parametrize("shape,c", CONTRACT_SHAPES)
def test_to1_contract_first_plain_matches_pallas(shape, c):
    x, w = _inputs(4, shape, c, 1)
    got = conv3d_to1_contract_first_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = np.asarray(jax_to1(jnp.asarray(x), jnp.asarray(w), True))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("shape,c", CONTRACT_SHAPES)
def test_to1_contract_first_plain_matches_plain(shape, c):
    """Same function, another order of the fp32 sums: 1e-5 of the largest."""
    x, w = _inputs(5, shape, c, 1)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got, want = conv3d_to1_contract_first_plain(xt, wt), conv3d_to1_plain(xt, wt)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())


def test_to1_contract_first_plain_matches_pallas_bf16():
    x, w = _inputs(6, (1, 5, 7, 9), 16, 1)
    (xt, xj), (wt, wj) = _bf16(x), _bf16(w)
    got = conv3d_to1_contract_first_plain(xt, wt)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_to1(xj, wj, True).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.05, rtol=0.05)


# the 1 -> C tensor-core body's algorithm (each voxel's 27-tap window,
# padded to 32, times the 32 x C weights), at the same grids and every C it
# takes
@pytest.mark.parametrize("shape,c", CONTRACT_SHAPES)
def test_from1_gemm_plain_matches_pallas(shape, c):
    x, w = _inputs(11, shape, 1, c)
    got = conv3d_from1_gemm_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = np.asarray(jax_from1(jnp.asarray(x), jnp.asarray(w), True))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("shape,c", CONTRACT_SHAPES)
def test_from1_gemm_plain_matches_plain(shape, c):
    """Same function, another order of the fp32 sums: 1e-5 of the largest."""
    x, w = _inputs(12, shape, 1, c)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got, want = conv3d_from1_gemm_plain(xt, wt), conv3d_from1_plain(xt, wt)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())


def test_from1_gemm_plain_matches_pallas_bf16():
    x, w = _inputs(13, (1, 5, 7, 9), 1, 16)
    (xt, xj), (wt, wj) = _bf16(x), _bf16(w)
    got = conv3d_from1_gemm_plain(xt, wt)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_from1(xj, wj, True).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.05, rtol=0.05)


def test_cpu_tensors_take_plain_versions_and_count_nothing():
    build.reset_launches()
    x, w = _inputs(4, (2, 3, 4, 5), 3, 4)
    x1, w1 = _inputs(5, (2, 3, 4, 5), 1, 6)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    assert torch.equal(conv3d_same(xt, wt), conv3d_same_plain(xt, wt))
    wt1 = torch.from_numpy(w[..., :1].copy())
    assert torch.equal(conv3d_to1(xt, wt1), conv3d_to1_plain(xt, wt1))
    x1t, w1t = torch.from_numpy(x1), torch.from_numpy(w1)
    assert torch.equal(conv3d_from1(x1t, w1t), conv3d_from1_plain(x1t, w1t))
    assert build.launches == {"conv3d_same": 0, "conv3d_to1": 0, "conv3d_from1": 0,
                              "conv3d_fused_stats": 0}


@pytest.mark.parametrize("fn,x_shape,w_shape", [
    (conv3d_same, (2, 3, 4, 5, 3), (3, 3, 3, 4, 4)),    # Ci mismatch
    (conv3d_same, (2, 3, 4, 5, 3), (1, 1, 1, 3, 4)),    # not 3x3x3
    (conv3d_to1, (2, 3, 4, 5, 3), (3, 3, 3, 3, 2)),     # Co != 1
    (conv3d_from1, (2, 3, 4, 5, 2), (3, 3, 3, 2, 4)),   # Ci != 1
])
def test_wrappers_reject_bad_shapes(fn, x_shape, w_shape):
    with pytest.raises(ValueError):
        fn(torch.zeros(x_shape), torch.zeros(w_shape))


def test_plain_conv_matches_torch_conv3d():
    """The plain version is a SAME 3x3x3 correlation (cross-check against
    torch's own conv on the CPU)."""
    x, w = _inputs(6, (2, 5, 6, 7), 5, 3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    want = torch.nn.functional.conv3d(xt.permute(0, 4, 1, 2, 3), wt.permute(4, 3, 0, 1, 2),
                                      padding=1).permute(0, 2, 3, 4, 1)
    torch.testing.assert_close(conv3d_same_plain(xt, wt), want, atol=1e-5, rtol=1e-5)


GRAD_CASES = (
    [("same", conv3d_same, conv3d_same_pallas, sh, ci, co) for sh, ci, co in CONV_SHAPES]
    + [("to1", conv3d_to1, jax_to1, sh, c, 1) for sh, c in TO1_SHAPES]
    + [("from1", conv3d_from1, jax_from1, sh, 1, c) for sh, c in FROM1_SHAPES])


@pytest.mark.parametrize("name,fn,jax_fn,shape,cin,cout", GRAD_CASES,
                         ids=[f"{c[0]}-{c[4]}to{c[5]}-{'x'.join(map(str, c[3]))}"
                              for c in GRAD_CASES])
def test_gradients_match_pallas_vjp(name, fn, jax_fn, shape, cin, cout):
    """dx (the kernel's plain version on flipped weights) and dw (the
    library's correlation) against `jax.vjp` of the Pallas original in
    interpret mode, fp32 atol 1e-4."""
    x, w = _inputs(7, shape, cin, cout)
    g = np.random.RandomState(8).randn(*shape, cout).astype(np.float32)
    y_j, vjp = jax.vjp(lambda a, b: jax_fn(a, b, True), jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y_t = fn(xt, wt)
    dx_t, dw_t = torch.autograd.grad(y_t, (xt, wt), torch.from_numpy(g))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), atol=1e-4)
    np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j), atol=1e-4)
    np.testing.assert_allclose(dw_t.numpy(), np.asarray(dw_j), atol=1e-4)


@pytest.mark.parametrize("fn,cin,cout", [(conv3d_same, 3, 4), (conv3d_to1, 3, 1),
                                         (conv3d_from1, 1, 4)])
def test_gradients_honour_needs_input_grad_and_bf16(fn, cin, cout):
    """Data needs no dx and a frozen weight no dw: each is computed only when
    asked for, and bf16 operands give bf16 gradients near the fp32 ones."""
    x, w = _inputs(9, (2, 3, 4, 5), cin, cout)
    g = torch.from_numpy(np.random.RandomState(10).randn(2, 3, 4, 5, cout).astype(np.float32))
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    dx, dw = torch.autograd.grad(fn(xt, wt), (xt, wt), g)
    (dw_only,) = torch.autograd.grad(fn(xt.detach(), wt), (wt,), g)
    (dx_only,) = torch.autograd.grad(fn(xt, wt.detach()), (xt,), g)
    assert torch.equal(dw_only, dw) and torch.equal(dx_only, dx)
    assert not fn(xt.detach(), wt.detach()).requires_grad
    xb = xt.detach().bfloat16().requires_grad_()
    wb = wt.detach().bfloat16().requires_grad_()
    dxb, dwb = torch.autograd.grad(fn(xb, wb), (xb, wb), g.bfloat16())
    assert dxb.dtype == dwb.dtype == torch.bfloat16
    for got, want in ((dxb, dx), (dwb, dw)):
        assert (got.float() - want).abs().max() <= 0.05 * max(1.0, want.abs().max().item())
