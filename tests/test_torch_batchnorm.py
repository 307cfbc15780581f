"""Train-mode BatchNorm (`sivae_torch/kernels/batchnorm.py`) on the CPU: a
CPU tensor takes the plain version and counts no launch; the plain version is
bit for bit the arithmetic `models/blocks.py` `_BatchNormTrain` had before
the BN kernels (frozen below as `_FrozenBatchNormTrain`), on whole tiny
training steps; the launch shape `bn_grid` picks for an [M, C] matrix; and
`reset_launches` clears the BN counters. The kernels themselves are held
against the plain version on the card (`tests/test_torch_cuda.py`)."""

import dataclasses
import math

import pytest
import torch

from sivae_torch.config import OptimConfig, SoftIntroLossConfig
from sivae_torch.kernels import build
from sivae_torch.kernels.batchnorm import (BnGrid, act, batchnorm_train,
                                           batchnorm_train_backward,
                                           batchnorm_train_backward_plain,
                                           batchnorm_train_plain, bn_grid)
from sivae_torch.models import blocks
from sivae_torch.models.blocks import BatchNorm
from sivae_torch.models.registry import get_model_config, make_model
from sivae_torch.train.state import create_train_state
from sivae_torch.train.step import make_soft_intro_train_step
from sivae_torch.utils.dtypes import widen

_AXES = (0, 2, 3, 4)
_VIEW = (1, -1, 1, 1, 1)
BN_KEYS = ("bn_stats", "bn_finalize", "bn_apply", "bn_bwd_reduce", "bn_bwd_finalize",
           "bn_bwd_apply")


class _FrozenBatchNormTrain(torch.autograd.Function):
    """`_BatchNormTrain` as it was before the BN kernels, one process."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, slope, out_dtype, stats=None, rows_only=False):
        if stats:
            mean, raw_var, ctx.n = stats
        else:
            xf = widen(x)
            ctx.n = x.numel() // x.shape[1]
            mean = xf.mean(dim=_AXES)
            raw_var = (xf * xf).mean(dim=_AXES) - mean * mean
            del xf
            if stats is not None:
                stats += [mean, raw_var, ctx.n]
        var = raw_var.clamp_min(0.0)
        rstd = torch.rsqrt(var + eps)
        y = x - mean.view(_VIEW)
        y = y.mul_((rstd * weight.to(rstd.dtype)).view(_VIEW))
        y = y.add_(bias.to(rstd.dtype).view(_VIEW))
        y = act(y.to(out_dtype), slope)
        k = (raw_var > 0).to(rstd.dtype) + 0.5 * (raw_var == 0).to(rstd.dtype)
        ctx.save_for_backward(x, weight, bias, mean, rstd, k)
        ctx.slope = slope
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        x, weight, bias, mean, rstd, k = ctx.saved_tensors
        n = ctx.n
        d = x - mean.view(_VIEW)
        mul = rstd * weight.to(rstd.dtype)
        gf = g.to(rstd.dtype)
        if ctx.slope is not None:
            pos = (d * mul.view(_VIEW) + bias.to(rstd.dtype).view(_VIEW)) > 0
            gf = torch.where(pos, gf, gf * ctx.slope)
        xhat = d.mul_(rstd.view(_VIEW))
        dbias = gf.sum(dim=_AXES)
        dweight = (gf * xhat).sum(dim=_AXES)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = xhat.mul_((-k * dweight / n).view(_VIEW)).add_(gf)
            dx = dx.sub_((dbias / n).view(_VIEW)).mul_(mul.view(_VIEW)).to(x.dtype)
        return dx, dweight.to(weight.dtype), dbias.to(bias.dtype), None, None, None, None, None


def _inputs(shape, dtype, seed=0, constant_channel=False):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=gen) * 1.5 + 0.3).to(dtype)
    if constant_channel:
        x[:, 1] = 0.75  # raw variance exactly 0: the tie factor 1/2
    x = x.contiguous(memory_format=torch.channels_last_3d)
    c = shape[1]
    w = 1.0 + 0.1 * torch.randn(c, generator=gen)
    b = 0.1 * torch.randn(c, generator=gen)
    g = torch.randn(shape, generator=gen).to(dtype).contiguous(
        memory_format=torch.channels_last_3d)
    return x, w, b, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("slope", [None, 0.0, 0.2])
def test_cpu_tensor_takes_the_plain_version_and_counts_nothing(dtype, slope):
    """Forward and backward of a CPU tensor are the plain version's, with a
    constant channel (k = 1/2) and a remat replay's filled statistics, and no
    BN counter moves."""
    x, w, b, g = _inputs((2, 5, 3, 4, 6), dtype, constant_channel=True)
    build.reset_launches()
    stats = []
    got = batchnorm_train(x, w, b, 1e-5, slope, dtype, stats)
    want = batchnorm_train_plain(x, w, b, 1e-5, slope, dtype)
    for a, e in zip(got[:6], want[:6]):
        assert a == e if isinstance(a, int) else torch.equal(a, e)
    assert got[6] is x and float(got[4][1]) == 0.5 and len(stats) == 3
    replay = batchnorm_train(x, w, b, 1e-5, slope, dtype, list(stats))
    assert torch.equal(replay[0], got[0])
    _, mean, _, rstd, k, n, _ = got
    for need_dx in (True, False):
        bwd = batchnorm_train_backward(g, x, w, b, mean, rstd, k, n, slope, need_dx)
        ref = batchnorm_train_backward_plain(g, x, w, b, mean, rstd, k, n, slope, need_dx)
        assert (bwd[0] is None) == (not need_dx)
        for a, e in zip(bwd, ref):
            assert a is None and e is None or torch.equal(a, e)
    assert all(build.launches[key] == 0 for key in BN_KEYS)
    assert build.bn_sites == {} and build.bn_layout_copies == 0


def _step_result(name, dtype, remat, frozen, monkeypatch):
    cfg = dataclasses.replace(get_model_config(name), dtype=dtype, remat=remat)
    if frozen:
        monkeypatch.setattr(blocks, "_BatchNormTrain", _FrozenBatchNormTrain)
    model = make_model(cfg, device="cpu", seed=1)
    state = create_train_state(model, seed=0, optim_cfg=OptimConfig())
    step = make_soft_intro_train_step(model, SoftIntroLossConfig(), OptimConfig(), 1,
                                      cfg.input_shape)
    real = torch.rand((2, 1) + tuple(cfg.input_shape), generator=torch.Generator().manual_seed(3))
    _, metrics = step(state, real)
    monkeypatch.undo()
    bufs = [t.clone() for m in model.modules() if isinstance(m, BatchNorm)
            for t in (m.running_mean, m.running_var)]
    moments = [s["exp_avg"].clone() for opt in (state.opt_e, state.opt_d)
               for s in opt.state.values()]
    return [p.detach().clone() for p in model.parameters()] + bufs + moments, metrics


@pytest.mark.parametrize("name,dtype,remat", [
    ("tiny_spatial", torch.float32, False), ("tiny_spatial", torch.bfloat16, False),
    ("tiny_spatial", torch.bfloat16, True), ("tiny_fc", torch.float32, False),
    ("tiny_fc", torch.bfloat16, False)])
def test_plain_version_keeps_the_earlier_arithmetic_in_a_train_step(name, dtype, remat,
                                                                    monkeypatch):
    """One two-phase step through the plain version moves every parameter,
    running statistic and first moment to the same bits as the frozen
    earlier `_BatchNormTrain` (dropout masks from the same seeded state)."""
    got, got_m = _step_result(name, dtype, remat, False, monkeypatch)
    want, want_m = _step_result(name, dtype, remat, True, monkeypatch)
    assert len(got) == len(want)
    for a, e in zip(got, want):
        assert torch.equal(a, e)
    for key in want_m:
        assert torch.equal(torch.as_tensor(got_m[key]), torch.as_tensor(want_m[key])), key


def _phases(c, v):
    return math.lcm(v, c) // v


@pytest.mark.parametrize("m,c,elem_bytes", [
    (8 * 80 * 96 * 80, 64, 2), (32 * 80 * 96 * 80, 12, 2), (32 * 40 * 48 * 40, 24, 2),
    (8 * 20 * 24 * 20, 128, 2), (8 * 10 * 12 * 10, 256, 2), (32 * 5 * 6 * 5, 48, 2),
    (8 * 80 * 96 * 80, 32, 4), (2 * 16 * 16 * 16, 3, 2), (2 * 16 * 16 * 16, 3, 4),
    (1001, 12, 2), (7, 5, 4)])
def test_bn_grid_takes_rows_with_whole_channel_phases(m, c, elem_bytes):
    """Conv sites take "rows": a block of whole channel phases (a multiple
    of lcm(V, C) / V threads and of a warp, at most 512), at most one
    resident wave of blocks and no more blocks than vectors need."""
    v = 16 // elem_bytes
    grid = bn_grid(m, c, elem_bytes, sms=132)
    assert grid.layout == "rows"
    assert grid.threads % 32 == 0 and grid.threads % _phases(c, v) == 0
    assert 32 <= grid.threads <= 512
    vecs = -(-m * c // v)
    assert 1 <= grid.blocks <= min(-(-vecs // grid.threads), 132 * (2048 // grid.threads))
    if vecs >= 132 * 2048:
        assert grid.blocks == 132 * (2048 // grid.threads)


def test_bn_grid_shapes_at_the_train_cells_sites():
    assert bn_grid(8 * 80 * 96 * 80, 64, 2, 132) == BnGrid("rows", 256, 1056)
    assert bn_grid(32 * 80 * 96 * 80, 12, 2, 132) == BnGrid("rows", 192, 1320)
    assert bn_grid(8 * 80 * 96 * 80, 64, 4, 132) == BnGrid("rows", 256, 1056)


@pytest.mark.parametrize("m,c,elem_bytes", [
    (8, 30000, 2), (8, 76800, 4), (32, 2048, 2), (4096, 250, 2)])
def test_bn_grid_takes_cols_for_large_c(m, c, elem_bytes):
    """A `FeatureBatchNorm`'s features (small M, large C) or a C whose
    channel phases outgrow a block take "cols": 32 channels a block, row
    groups no more than the rows' eighths. (An operand off 16-byte
    alignment is copied to aligned memory first and keeps its shape's
    layout: `test_unaligned_or_strided_operands_are_copied_once`.)"""
    grid = bn_grid(m, c, elem_bytes, sms=132)
    assert grid.layout == "cols" and grid.threads == 256
    assert 1 <= grid.blocks <= -(-m // 8)
    assert grid.blocks * -(-c // 32) <= 8 * 132 + -(-c // 32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_unaligned_or_strided_operands_are_copied_once(dtype):
    """The kernels' [M, C] operand (`_matrix`): a channels-last tensor at an
    aligned address is a view; one 2 bytes off 16-byte alignment, or one in
    NCDHW memory, is copied once to aligned channels-last memory, counted in
    `bn_layout_copies`, with the same values."""
    from sivae_torch.kernels.batchnorm import _matrix

    build.reset_launches()
    base = torch.randn(1 + 2 * 4 * 5 * 6 * 64, dtype=torch.float32).to(dtype)
    x = base[1:].view(2, 4, 5, 6, 64).permute(0, 4, 1, 2, 3)   # channels-last, offset 1
    assert x.data_ptr() % 16 != 0
    aligned = x.clone(memory_format=torch.channels_last_3d)
    m = _matrix(aligned)
    assert m.data_ptr() == aligned.data_ptr() and build.bn_layout_copies == 0
    for t in (x, aligned.contiguous()):
        m = _matrix(t)
        assert m.shape == (2 * 4 * 5 * 6, 64) and m.data_ptr() % 16 == 0
        assert torch.equal(m, t.permute(0, 2, 3, 4, 1).reshape(-1, 64))
    assert build.bn_layout_copies == 2
    build.reset_launches()


def test_reset_launches_clears_the_bn_counters():
    for key in BN_KEYS:
        build.launches[key] = 3
    build.bn_sites["64@4915200 bfloat16"] = 2
    build.bn_layout_copies = 1
    build.reset_launches()
    assert all(build.launches[key] == 0 for key in BN_KEYS)
    assert build.bn_sites == {} and build.bn_layout_copies == 0
    assert set(build.conv_launches()) == set(build.CONV_KERNELS)
