"""sivae_torch conv kernels: each plain PyTorch version against its Pallas
original (interpret mode on the CPU), the CPU routing of the wrappers, and
each wrapper's gradient (a `torch.autograd.Function`) against `jax.vjp` of
the Pallas original. The CUDA kernels themselves are tested in
test_torch_cuda.py.

Tolerances: fp32 atol 1e-4 (as tests/test_pallas_conv.py). bf16 atol/rtol
0.05: the plain version sums all 27 taps in fp32 and rounds once, the
Pallas v1 rounds its running sum to bf16 after every depth tap."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sivae_tpu.kernels.conv3d import conv3d_same_pallas
from sivae_tpu.kernels.conv3d_small import conv3d_from1 as jax_from1
from sivae_tpu.kernels.conv3d_small import conv3d_to1 as jax_to1
from sivae_torch.kernels import build
from sivae_torch.kernels.conv3d import (conv3d_same, conv3d_same_narrow_plain,
                                        conv3d_same_narrow_tf32x3_plain, conv3d_same_plain,
                                        conv3d_same_tf32x3_plain, tf32_round, tf32_split)
from sivae_torch.kernels.conv3d_small import (conv3d_from1, conv3d_from1_gemm_plain,
                                              conv3d_from1_plain, conv3d_from1_tf32x3_plain,
                                              conv3d_to1, conv3d_to1_contract_first_plain,
                                              conv3d_to1_plain, conv3d_to1_tf32x3_plain)

torch.set_num_threads(2)

CONV_SHAPES = [((2, 4, 5, 6), 3, 4), ((1, 6, 8, 6), 8, 8), ((2, 3, 4, 4), 1, 5)]
TO1_SHAPES = [((2, 4, 5, 6), 3), ((1, 6, 8, 6), 8), ((2, 3, 4, 4), 1)]
FROM1_SHAPES = [((2, 4, 5, 6), 3), ((1, 6, 8, 6), 8)]


def _inputs(seed, shape, cin, cout):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape, cin).astype(np.float32)
    w = (rng.randn(3, 3, 3, cin, cout) * 0.1).astype(np.float32)
    return x, w


@functools.lru_cache(maxsize=None)
def _pallas_ref(fn, seed, shape, cin, cout):
    """fp32 `fn` (a Pallas original, in interpret mode) on `_inputs(seed,
    shape, cin, cout)`, run once per inputs: several tests hold their plain
    versions to the same reference."""
    x, w = _inputs(seed, shape, cin, cout)
    return np.asarray(fn(jnp.asarray(x), jnp.asarray(w), True))


def _bf16(a: np.ndarray):
    """The same bf16 values for both stacks."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("shape,cin,cout", CONV_SHAPES)
def test_conv3d_plain_matches_pallas(shape, cin, cout):
    x, w = _inputs(0, shape, cin, cout)
    got = conv3d_same_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = _pallas_ref(conv3d_same_pallas, 0, shape, cin, cout)
    np.testing.assert_allclose(got, want, atol=1e-4)


# and 32 -> 64, the shape the wgmma body takes in 32-channel chunks
@pytest.mark.parametrize("shape,cin,cout", CONV_SHAPES + [((1, 4, 4, 4), 4, 4),
                                                          ((1, 3, 4, 5), 32, 64)])
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
    want = _pallas_ref(jax_to1, 0, shape, c, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("shape,c", FROM1_SHAPES)
def test_from1_plain_matches_pallas(shape, c):
    x, w = _inputs(1, shape, 1, c)
    got = conv3d_from1_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = _pallas_ref(jax_from1, 1, shape, 1, c)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_to1_plain_matches_pallas_bf16():
    x, w = _inputs(3, (1, 4, 6, 4), 8, 1)
    (xt, xj), (wt, wj) = _bf16(x), _bf16(w)
    got = conv3d_to1_plain(xt, wt).float().numpy()
    want = np.asarray(jax_to1(xj, wj, True).astype(jnp.float32))
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0.05)


# the narrow conv body's algorithm (channels padded to 16, output channels to
# a multiple of 8, taps summed in its order) at the FC family's channel counts
@pytest.mark.parametrize("cin,cout", [(12, 12), (12, 24), (24, 12), (16, 16), (16, 24)])
def test_conv3d_narrow_plain_matches_plain(cin, cout):
    """Same function, another order of the fp32 sums: 1e-5 of the largest."""
    x, w = _inputs(8, (1, 3, 4, 5), cin, cout)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got, want = conv3d_same_narrow_plain(xt, wt), conv3d_same_plain(xt, wt)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())


# the tensor-core body's algorithm (channels contracted once per voxel, then
# 27 shifted adds), at grids no 16 x 16 patch divides
CONTRACT_SHAPES = [((1, 5, 7, 9), 16), ((2, 3, 5, 7), 64), ((1, 4, 18, 5), 32)]


@pytest.mark.parametrize("shape,c", CONTRACT_SHAPES)
def test_to1_contract_first_plain_matches_pallas(shape, c):
    x, w = _inputs(4, shape, c, 1)
    got = conv3d_to1_contract_first_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = _pallas_ref(jax_to1, 4, shape, c, 1)
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
    want = _pallas_ref(jax_from1, 11, shape, 1, c)
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


# C = 12 and 24: the bf16 tensor-core body's N padded to the next n8 tile,
# and C = 12's 24-byte output rows
@pytest.mark.parametrize("c", [12, 24])
def test_from1_gemm_plain_matches_pallas_bf16_at_narrow_c(c):
    x, w = _inputs(14, (1, 5, 7, 9), 1, c)
    (xt, xj), (wt, wj) = _bf16(x), _bf16(w)
    got = conv3d_from1_gemm_plain(xt, wt)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_from1(xj, wj, True).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.05, rtol=0.05)


# the fp32 tensor-core bodies ("tf32x3"): each operand split into TF32 big
# and small parts, three products a k-step. fp32 tolerance 1e-4 *
# max(1, max|ref|), the kernels' own (chip_smoke.py, test_torch_cuda.py);
# K = 27 * 64 = 1728 is where one TF32 product misses it
TF32_CONV_SHAPES = CONV_SHAPES + [((1, 3, 4, 5), 64, 8)]


def _within(got: np.ndarray, want: np.ndarray, tol: float) -> float:
    """max |got - want| / max(1, max |want|), asserted <= tol."""
    rel = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert rel <= tol, rel
    return rel


@pytest.mark.parametrize("shape,cin,cout", TF32_CONV_SHAPES)
def test_conv3d_tf32x3_plain_matches_pallas(shape, cin, cout):
    x, w = _inputs(0, shape, cin, cout)
    got = conv3d_same_tf32x3_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32
    want = _pallas_ref(conv3d_same_pallas, 0, shape, cin, cout)
    _within(got.numpy(), want, 1e-4)


def test_one_tf32_product_misses_the_fp32_tolerance_at_k1728():
    """Why the fp32 bodies take three products: one TF32 product (both
    operands rounded to TF32, fp32 sums) over K = 1728 is off by more than
    1e-4 of the largest output (He-scaled weights, seeded); the three-product
    split holds it with room (~2e-7)."""
    shape, cin, cout = TF32_CONV_SHAPES[-1]
    rng = np.random.RandomState(15)
    x = rng.randn(*shape, cin).astype(np.float32)
    w = (rng.randn(3, 3, 3, cin, cout) * np.sqrt(2.0 / (27 * cin))).astype(np.float32)
    want = np.asarray(conv3d_same_pallas(jnp.asarray(x), jnp.asarray(w), True))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    one = conv3d_same_plain(tf32_round(xt), tf32_round(wt)).numpy()
    rel_one = np.abs(one - want).max() / np.abs(want).max()
    assert rel_one > 1e-4, rel_one
    assert _within(conv3d_same_tf32x3_plain(xt, wt).numpy(), want, 1e-4) < 1e-2 * rel_one


@pytest.mark.parametrize("shape,c", CONTRACT_SHAPES + [((1, 5, 7, 9), 12)])
def test_from1_tf32x3_plain_matches_pallas(shape, c):
    x, w = _inputs(11, shape, 1, c)
    got = conv3d_from1_tf32x3_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == shape + (c,)
    want = _pallas_ref(jax_from1, 11, shape, 1, c)
    _within(got.numpy(), want, 1e-4)


# the fp32 bodies at the FC family's and spatial_150's channels: conv3d_same's
# "narrow_tf32x3" (K = Ci rounded up to 8 in 32-channel chunks, 48 in two)
# and conv3d_to1's "tf32x3" (K = C rounded up to 8, the 27 taps summed after)
@pytest.mark.parametrize("cin,cout", [(12, 12), (12, 24), (24, 12), (32, 48), (48, 48)])
def test_conv3d_narrow_tf32x3_plain_matches_pallas(cin, cout):
    x, w = _inputs(16, (1, 3, 4, 5), cin, cout)
    got = conv3d_same_narrow_tf32x3_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32
    want = _pallas_ref(conv3d_same_pallas, 16, (1, 3, 4, 5), cin, cout)
    _within(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("shape,c", CONTRACT_SHAPES + [((1, 5, 7, 9), 12)])
def test_to1_tf32x3_plain_matches_pallas(shape, c):
    x, w = _inputs(4, shape, c, 1)
    got = conv3d_to1_tf32x3_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == shape + (1,)
    want = _pallas_ref(jax_to1, 4, shape, c, 1)
    _within(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("plain,ref,cout", [
    (conv3d_same_narrow_tf32x3_plain, conv3d_same_plain, 24),
    (conv3d_same_tf32x3_plain, conv3d_same_plain, 24),
    (conv3d_to1_tf32x3_plain, conv3d_to1_plain, 1)])
def test_tf32x3_plains_propagate_inf_and_nan_as_fp32(plain, ref, cout):
    """An inf and a NaN in the input (`tf32_split`: big = inf or NaN, small =
    cross = 0): each three-product algorithm gives inf of the product's sign
    and NaN exactly where fp32 does, not the inf - inf or inf * 0 = NaN of a
    naive split, and the finite outputs within the fp32 tolerance."""
    x, w = _inputs(18, (2, 3, 4, 5), 12, cout)
    x[0, 1, 2, 3, 0] = np.inf
    x[1, 1, 1, 1, 11] = -np.inf
    x[-1, -2, 3, 1, 5] = np.nan
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got, want = plain(xt, wt), ref(xt, wt)
    for mark in (torch.isnan, torch.isposinf, torch.isneginf):
        assert mark(want).any() and torch.equal(mark(got), mark(want))
    fin = torch.isfinite(want)
    _within(got[fin].numpy(), want[fin].numpy(), 1e-4)


def _bits(v: float) -> int:
    return int(np.array(v, dtype=np.float32).view(np.int32))


def test_tf32_round_ties_signs_zero_denormals_inf():
    """Round to nearest on the 13 dropped bits, ties away from zero, as
    cvt.rna.tf32.f32; the split leaves inf as big = inf, small = cross = 0."""
    one, ulp = 1.0, 2.0 ** -10            # a TF32 ulp at 1
    cases = [
        (one, one), (-one, -one), (0.0, 0.0),
        (one + ulp / 2, one + ulp), (-(one + ulp / 2), -(one + ulp)),         # ties: away
        (one + ulp / 2 - 2.0 ** -23, one), (one + ulp / 2 + 2.0 ** -23, one + ulp),
        (one + 1.5 * ulp, one + 2 * ulp),                                       # tie, odd below
        (float(np.inf), float(np.inf)), (float(-np.inf), float(-np.inf)),
    ]
    got = tf32_round(torch.tensor([a for a, _ in cases], dtype=torch.float32))
    assert got.tolist() == [b for _, b in cases]
    # -0 keeps its sign; denormals (bit patterns) round on the same 13 bits
    neg0 = tf32_round(torch.tensor([-0.0]))
    assert _bits(neg0.item()) == _bits(-0.0)
    neg_tie = -0x7FFFF000                                    # bits 0x80001000: -(a tie)
    den = torch.tensor([0x1, 0xFFF, 0x1000, 0x1FFF, 0x3000, neg_tie],
                       dtype=torch.int32).view(torch.float32)
    out = tf32_round(den).view(torch.int32).tolist()
    assert out == [0, 0, 0x2000, 0x2000, 0x4000, neg_tie + 0x1000]     # 0x80002000
    assert np.isnan(tf32_round(torch.tensor([float("nan")])).item())
    assert tf32_round(torch.tensor([3.4028235e38])).item() == float("inf")  # past the largest
    big, small, cross = tf32_split(torch.tensor([float("inf"), -float("inf"), 1.0 + 2.0 ** -20]))
    assert big.tolist()[:2] == [float("inf"), -float("inf")]
    assert small.tolist()[:2] == cross.tolist()[:2] == [0.0, 0.0]
    assert big[2].item() == cross[2].item() == 1.0 and small[2].item() == 2.0 ** -20
    for v in (big, small, cross):                            # the low 13 bits are clear
        assert not (v.view(torch.int32) & 0x1FFF).any()


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
                              "conv3d_fused_stats": 0, "bn_stats": 0, "bn_finalize": 0,
                              "bn_apply": 0, "bn_bwd_reduce": 0, "bn_bwd_finalize": 0,
                              "bn_bwd_apply": 0}


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
