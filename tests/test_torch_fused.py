"""sivae_torch fused conv + statistics (`kernels/conv3d_fused.py`): the plain
PyTorch version against the Pallas original `conv3d_fused_stats` in
interpret mode on the CPU, with and without the input prologue and with the
Pallas side in one and in several H-blocks; the fp32 "tf32x3" body's
algorithm (`conv3d_fused_stats_tf32x3_plain`) against the same; the differentiable
`conv3d_stats` against `jax.vjp` of its Pallas original with non-zero
cotangents on all three outputs. The CUDA kernel itself is tested in
test_torch_cuda.py.

Tolerances: fp32 y atol 1e-4 (the two sum the same products in other
orders), sums rtol 1e-5 of the largest sum (both add H*W fp32 values of that
y); the tf32x3 algorithm's y 1e-4 * max(1, max|y|) and sums 1e-3 of the
largest sum, as the card's check (three TF32 products are fp32 to ~2e-7 of
the largest output, not bit for bit); bf16 y within 0.02 * max(1, max|y|) (both sum in fp32 and round once, on
sums that differ in the last fp32 bits)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sivae_tpu.kernels.conv3d_fused import conv3d_fused_stats as jax_fused_stats
from sivae_tpu.kernels.conv3d_fused import conv3d_stats as jax_conv3d_stats
from sivae_torch.kernels import build
from sivae_torch.kernels.conv3d_fused import (conv3d_fused_stats,
                                              conv3d_fused_stats_earlier_body,
                                              conv3d_fused_stats_plain,
                                              conv3d_fused_stats_tf32x3_plain, conv3d_stats,
                                              conv3d_v2, prologue_plain)
from sivae_torch.kernels.conv3d import conv3d_same_plain, conv3d_same_tf32x3_plain

torch.set_num_threads(2)

# (B, D, H, W), Ci, Co: odd extents, and an H the Pallas side can split
SHAPES = [((2, 4, 8, 6), 4, 8), ((1, 3, 4, 5), 3, 5)]


def _inputs(seed, shape, ci, co):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(*shape, ci).astype(np.float32),
            "w": (0.2 * rng.randn(3, 3, 3, ci, co)).astype(np.float32),
            "a": rng.uniform(0.5, 1.5, ci).astype(np.float32),
            # a shift well away from 0: padding that came BEFORE the prologue
            # would put leaky_relu(b) != 0 into every halo tap
            "b": (0.5 + 0.3 * rng.rand(ci)).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _pallas_ref(seed, shape, ci, co, prologue, h_block=None):
    """fp32 Pallas `conv3d_fused_stats` (interpret mode) on `_inputs(seed,
    shape, ci, co)`, run once per inputs: several tests hold their plain
    versions to the same reference."""
    a = _inputs(seed, shape, ci, co)
    kw = dict(in_a=jnp.asarray(a["a"]), in_b=jnp.asarray(a["b"]), slope=0.2) if prologue else {}
    out = jax_fused_stats(jnp.asarray(a["x"]), jnp.asarray(a["w"]), interpret=True,
                          h_block=h_block, **kw)
    return tuple(np.asarray(o, np.float32) for o in out)


def _torch_args(a, prologue):
    x, w = torch.from_numpy(a["x"]), torch.from_numpy(a["w"])
    ab = (torch.from_numpy(a["a"]), torch.from_numpy(a["b"]), 0.2) if prologue else ()
    return x, w, ab


def _assert_sums(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("h_block", [None, 2], ids=["one_h_block", "h_blocks_of_2"])
@pytest.mark.parametrize("prologue", [False, True], ids=["no_prologue", "prologue"])
@pytest.mark.parametrize("shape,ci,co", SHAPES, ids=["2x4x8x6-4to8", "1x3x4x5-3to5"])
def test_plain_fused_stats_match_pallas_fp32(shape, ci, co, prologue, h_block):
    y_j, s1_j, s2_j = _pallas_ref(0, shape, ci, co, prologue, h_block)
    x, w, ab = _torch_args(_inputs(0, shape, ci, co), prologue)
    y_t, s1_t, s2_t = conv3d_fused_stats_plain(x, w, *ab)
    assert y_t.shape == shape + (co,) and s1_t.shape == s2_t.shape == shape[:2] + (co,)
    assert s1_t.dtype == s2_t.dtype == torch.float32
    np.testing.assert_allclose(y_t.numpy(), y_j, atol=1e-4)
    _assert_sums(s1_t, s1_j)
    _assert_sums(s2_t, s2_j)


# the fp32 "tf32x3" body's channels: SHAPES, and 64 -> 64 (two 32-channel
# chunks, K = 1728 as at the card's sites) on a grid of 63-voxel planes
TF32X3_SHAPES = SHAPES + [((1, 3, 7, 9), 64, 64)]


@pytest.mark.parametrize("prologue", [False, True], ids=["no_prologue", "prologue"])
@pytest.mark.parametrize("shape,ci,co", TF32X3_SHAPES,
                         ids=["2x4x8x6-4to8", "1x3x4x5-3to5", "1x3x7x9-64to64"])
def test_tf32x3_fused_stats_plain_matches_pallas_fp32(shape, ci, co, prologue):
    """The fp32 body's algorithm: the prologue, then the three-product TF32
    conv on its zero-padded output, then fp32 sums of y."""
    y_j, s1_j, s2_j = _pallas_ref(0, shape, ci, co, prologue)
    x, w, ab = _torch_args(_inputs(0, shape, ci, co), prologue)
    y_t, s1_t, s2_t = conv3d_fused_stats_tf32x3_plain(x, w, *ab)
    assert y_t.dtype == s1_t.dtype == s2_t.dtype == torch.float32
    assert y_t.shape == shape + (co,) and s1_t.shape == s2_t.shape == shape[:2] + (co,)
    for got, want, tol in ((y_t, y_j, 1e-4), (s1_t, s1_j, 1e-3), (s2_t, s2_j, 1e-3)):
        assert np.abs(got.numpy() - want).max() <= tol * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("prologue", [False, True], ids=["no_prologue", "prologue"])
def test_plain_fused_stats_match_pallas_bf16(prologue):
    """bf16: the sums are of the ROUNDED y in both, so they agree as far as
    the two y do (a last-bit difference of one y is 2^-8 of it)."""
    shape, ci, co = SHAPES[0]
    a = _inputs(1, shape, ci, co)
    xb, wb = torch.from_numpy(a["x"]).bfloat16(), torch.from_numpy(a["w"]).bfloat16()
    kw_j = dict(in_a=jnp.asarray(a["a"]), in_b=jnp.asarray(a["b"]), slope=0.2) if prologue else {}
    kw_t = dict(in_a=torch.from_numpy(a["a"]), in_b=torch.from_numpy(a["b"]),
                slope=0.2) if prologue else {}
    y_j, s1_j, s2_j = jax_fused_stats(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                                      jnp.asarray(wb.float().numpy()).astype(jnp.bfloat16),
                                      interpret=True, **kw_j)
    y_t, s1_t, s2_t = conv3d_fused_stats_plain(xb, wb, **kw_t)
    assert y_t.dtype == torch.bfloat16 and s1_t.dtype == torch.float32
    y_j = np.asarray(y_j, np.float32)
    assert np.abs(y_t.float().numpy() - y_j).max() <= 0.02 * max(1.0, np.abs(y_j).max())
    # the sums are exactly those of the rounded y that came out
    torch.testing.assert_close(s1_t, y_t.float().sum(dim=(2, 3)), rtol=1e-6, atol=1e-6)
    for got, want in ((s1_t, s1_j), (s2_t, s2_j)):
        want = np.asarray(want, np.float32)
        assert np.abs(got.numpy() - want).max() <= 0.02 * max(1.0, np.abs(want).max())


def test_padding_is_zero_after_the_prologue():
    """With in_b != 0 the prologue maps 0 to leaky_relu(b) != 0: the halo
    must stay 0 all the same. The plain version equals prologue-then-conv,
    and differs at the border from a conv whose padding went through g."""
    shape, ci, co = SHAPES[1]
    a = _inputs(2, shape, ci, co)
    x, w = torch.from_numpy(a["x"]), torch.from_numpy(a["w"])
    ia, ib = torch.from_numpy(a["a"]), torch.from_numpy(a["b"])
    y, _, _ = conv3d_fused_stats_plain(x, w, ia, ib, 0.2)
    torch.testing.assert_close(y, conv3d_same_plain(prologue_plain(x, ia, ib, 0.2), w))
    # the wrong order: pad first, then g on the padded volume, then a VALID conv
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    gp = prologue_plain(xp, ia, ib, 0.2)
    wrong = conv3d_same_plain(gp, w)[:, 1:-1, 1:-1, 1:-1]
    assert (wrong - y).abs().max() > 0.05                          # the border differs
    inner = (slice(None),) + (slice(1, -1),) * 3
    torch.testing.assert_close(wrong[inner], y[inner])             # the interior does not


def test_tf32x3_padding_is_zero_after_the_prologue():
    """The same for the fp32 body's algorithm: g, then the split conv on the
    zero-padded g(x); padding put through g changes the border only."""
    shape, ci, co = SHAPES[1]
    a = _inputs(2, shape, ci, co)
    x, w, (ia, ib, slope) = _torch_args(a, True)
    y, s1, _ = conv3d_fused_stats_tf32x3_plain(x, w, ia, ib, slope)
    gx = prologue_plain(x, ia, ib, slope)
    assert torch.equal(y, conv3d_same_tf32x3_plain(gx, w))
    assert torch.equal(s1, y.sum(dim=(2, 3)))
    gp = prologue_plain(torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1, 1, 1)), ia, ib, slope)
    wrong = conv3d_same_tf32x3_plain(gp, w)[:, 1:-1, 1:-1, 1:-1]
    assert (wrong - y).abs().max() > 0.05
    inner = (slice(None),) + (slice(1, -1),) * 3
    torch.testing.assert_close(wrong[inner], y[inner], rtol=0, atol=1e-5)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    """Every wrapper of the fused kernel, with and without the prologue and
    in both types (the card's bf16 64-channel calls take its wgmma body):
    on CPU tensors the plain version, no launch counted; the measuring entry
    of the earlier body takes CUDA tensors only."""
    shape, ci, co = SHAPES[1]
    a = _inputs(3, shape, ci, co)
    ia, ib = torch.from_numpy(a["a"]), torch.from_numpy(a["b"])
    build.reset_launches()
    for dtype in (torch.float32, torch.bfloat16):
        x, w = torch.from_numpy(a["x"]).to(dtype), torch.from_numpy(a["w"]).to(dtype)
        for ab in ((ia, ib, 0.2), ()):
            for got, want in zip(conv3d_fused_stats(x, w, *ab),
                                 conv3d_fused_stats_plain(x, w, *ab)):
                assert torch.equal(got, want)
        assert torch.equal(conv3d_v2(x, w), conv3d_same_plain(x, w))
        for got, want in zip(conv3d_stats(x, w), conv3d_fused_stats_plain(x, w)):
            assert torch.equal(got, want)
        with pytest.raises(ValueError):
            conv3d_fused_stats_earlier_body(x, w, ia, ib, 0.2)
    assert build.launches == {"conv3d_same": 0, "conv3d_to1": 0, "conv3d_from1": 0,
                              "conv3d_fused_stats": 0, "bn_stats": 0, "bn_finalize": 0,
                              "bn_apply": 0, "bn_bwd_reduce": 0, "bn_bwd_finalize": 0,
                              "bn_bwd_apply": 0}


@pytest.mark.parametrize("bad", ["one_of_a_b", "a_shape", "w_shape", "x_rank"])
def test_fused_stats_rejects_bad_arguments(bad):
    shape, ci, co = SHAPES[1]
    a = _inputs(4, shape, ci, co)
    x, w = torch.from_numpy(a["x"]), torch.from_numpy(a["w"])
    ia, ib = torch.from_numpy(a["a"]), torch.from_numpy(a["b"])
    args = {"one_of_a_b": (x, w, ia, None), "a_shape": (x, w, ia[:-1], ib[:-1]),
            "w_shape": (x, w[..., :-1, :]), "x_rank": (x[0], w)}[bad]
    with pytest.raises(ValueError):
        conv3d_fused_stats(*args)


def _stats_loss_parts(seed, shape, co):
    rng = np.random.RandomState(seed)
    return {"gy": rng.randn(*shape, co).astype(np.float32),
            "gs1": rng.randn(*shape[:2], co).astype(np.float32),
            "gs2": (0.1 * rng.randn(*shape[:2], co)).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _stats_vjp_both(case):
    """(port, JAX) outputs and gradients of conv3d_stats for one shape, with
    non-zero cotangents on y, s1 and s2."""
    shape, ci, co = SHAPES[case]
    a = _inputs(5, shape, ci, co)
    g = _stats_loss_parts(6, shape, co)
    out_j, vjp = jax.vjp(lambda x, w: jax_conv3d_stats(x, w, True), jnp.asarray(a["x"]),
                         jnp.asarray(a["w"]))
    dx_j, dw_j = vjp(tuple(jnp.asarray(g[k]) for k in ("gy", "gs1", "gs2")))
    want = dict(zip(("y", "s1", "s2"), out_j), dx=dx_j, dw=dw_j)

    x = torch.from_numpy(a["x"]).requires_grad_()
    w = torch.from_numpy(a["w"]).requires_grad_()
    out_t = conv3d_stats(x, w)
    dx_t, dw_t = torch.autograd.grad(out_t, (x, w),
                                     tuple(torch.from_numpy(g[k]) for k in ("gy", "gs1", "gs2")))
    got = dict(zip(("y", "s1", "s2"), (o.detach() for o in out_t)), dx=dx_t, dw=dw_t)
    return got, {k: np.asarray(v, np.float32) for k, v in want.items()}


@pytest.mark.parametrize("what", ["y", "s1", "s2", "dx", "dw"])
@pytest.mark.parametrize("case", [0, 1], ids=["2x4x8x6-4to8", "1x3x4x5-3to5"])
def test_conv3d_stats_matches_pallas_vjp(case, what):
    """dy = gy + gs1 + 2 y gs2, dx by the conv on flipped IO-swapped weights,
    dw by the library; fp32 atol 1e-4 (of the largest value, for the sums and
    dw) against `jax.vjp` of the Pallas original in interpret mode."""
    got, want = _stats_vjp_both(case)
    atol = 1e-4 if what in ("y", "dx") else 1e-4 * max(1.0, float(np.abs(want[what]).max()))
    np.testing.assert_allclose(got[what].numpy(), want[what], rtol=0, atol=atol)


def test_conv3d_stats_gradient_equals_autograd_of_the_written_out_function():
    """The Function's backward against autograd through conv + explicit sums
    (no custom gradient anywhere), and only what is asked for is computed."""
    shape, ci, co = SHAPES[0]
    a = _inputs(7, shape, ci, co)

    def loss(y, s1, s2):
        return 0.5 * (y * y).sum() + torch.sin(s1).sum() + torch.sqrt(s2 + 1.0).sum()

    x = torch.from_numpy(a["x"]).requires_grad_()
    w = torch.from_numpy(a["w"]).requires_grad_()
    got = torch.autograd.grad(loss(*conv3d_stats(x, w)), (x, w))
    y = torch.nn.functional.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                                   padding=1).permute(0, 2, 3, 4, 1)
    want = torch.autograd.grad(loss(y, y.sum(dim=(2, 3)), (y * y).sum(dim=(2, 3))), (x, w))
    for p, q in zip(got, want):
        assert (p - q).abs().max() <= 1e-4 * max(1.0, q.abs().max().item())
    (dw_only,) = torch.autograd.grad(loss(*conv3d_stats(x.detach(), w)), (w,))
    (dx_only,) = torch.autograd.grad(loss(*conv3d_stats(x, w.detach())), (x,))
    torch.testing.assert_close(dw_only, got[1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dx_only, got[0], rtol=1e-5, atol=1e-5)
