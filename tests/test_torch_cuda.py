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
import os
import socket
import subprocess
import sys

import pytest
import torch

from sivae_torch.kernels import build
from sivae_torch.kernels.conv3d import (WGMMA_SHAPES, conv3d_same, conv3d_same_body,
                                        conv3d_same_earlier_body, conv3d_same_narrow_plain,
                                        conv3d_same_narrow_tf32x3_plain, conv3d_same_plain,
                                        conv3d_same_tf32x3_plain, conv3d_same_wgmma_blocks,
                                        conv3d_same_wgmma_shape)
from sivae_torch.kernels.conv3d_fused import (conv3d_fused_stats, conv3d_fused_stats_body,
                                              conv3d_fused_stats_earlier_body,
                                              conv3d_fused_stats_plain,
                                              conv3d_fused_stats_tf32x3_plain,
                                              conv3d_fused_stats_wgmma_blocks,
                                              conv3d_fused_stats_wgmma_shape, conv3d_stats)
from sivae_torch.kernels.conv3d_small import (conv3d_from1, conv3d_from1_body,
                                              conv3d_from1_earlier_body, conv3d_from1_gemm_plain,
                                              conv3d_from1_plain, conv3d_from1_tf32x3_plain,
                                              conv3d_to1, conv3d_to1_body,
                                              conv3d_to1_contract_first_plain,
                                              conv3d_to1_earlier_body, conv3d_to1_plain,
                                              conv3d_to1_tf32x3_plain)

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
CASES = [  # kernel, plain version, x shape, w shape
    (conv3d_same, conv3d_same_plain, (2, 6, 8, 10, 64), (3, 3, 3, 64, 64)),    # wgmma body in bf16
    (conv3d_same, conv3d_same_plain, (1, 5, 6, 4, 64), (3, 3, 3, 64, 128)),
    (conv3d_same, conv3d_same_plain, (2, 4, 5, 6, 3), (3, 3, 3, 3, 4)),       # FMA body
    (conv3d_same, conv3d_same_plain, (2, 3, 4, 4, 1), (3, 3, 3, 1, 5)),
    (conv3d_to1, conv3d_to1_plain, (2, 6, 8, 10, 64), (3, 3, 3, 64, 1)),      # mma body in bf16
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


# shapes of conv3d_same, the body each must take, and the type (bf16 unless
# said). The wgmma body walks 128 or 256 consecutive voxels a block: W and H
# that no tile divides, M not a multiple of 64, B = 1 and 3, tiles that
# straddle rows, planes and batch elements, Ci != Co, K of several 64-channel
# chunks, a grid large enough for several rounds of blocks (36864 voxels x
# 128 channels); and the same walks in 32-channel chunks (Ci = 32, fc_600's
# and spatial_1200_fullsize's 32 -> 64, and Ci = 96, three chunks). The narrow body marches 16-wide patches along d: every
# pairing of the FC and spatial_150 forwards and input gradients at a grid no
# patch divides (7 wide, 6 high), Co > 32 in two channel halves. The fp32
# "tf32x3" body walks 128 or 256 consecutive voxels a block, as "wgmma": the
# spatial_1200 pairings (64-256 channels, forward and input gradient) and
# spatial_1200_fullsize's 32 channels (32-wide blocks where Co is not a
# multiple of 64), at grids no tile divides, a row longer than a block,
# 128-row blocks (a grid too small to fill the card) and 256-row ones. Its
# narrow form, "narrow_tf32x3", at the fp32 pairings of the FC and
# spatial_150 forwards and input gradients (12/16/24/32/48 channels: K of one
# chunk of 2 or 3 k8 steps, or of two chunks; the kw taps in N at Co <= 32,
# N = 48, 72, 96, and one wgmma a tap at Co = 48; the input line by bulk copy
# at Ci = 12, by TMA at 16-64), at several blocks and rounds of blocks, a row
# longer than a block, planes of one row and a 20 x 37 x 41 grid; Ci = 5
# stays on "fma".
BODY_CASES = [
    ((1, 3, 5, 7, 64), 64, "wgmma", torch.bfloat16),        # M = 105: one ragged block
    ((3, 5, 7, 9, 64), 128, "wgmma", torch.bfloat16),       # M = 945, 63 voxels a plane
    ((1, 2, 3, 200, 64), 64, "wgmma", torch.bfloat16),      # a row longer than a block
    ((3, 4, 6, 5, 256), 128, "wgmma", torch.bfloat16),      # the 256 -> 128 dgrad's channels
    ((2, 9, 11, 13, 128), 64, "wgmma", torch.bfloat16),
    ((1, 32, 36, 32, 64), 128, "wgmma", torch.bfloat16),    # several rounds of blocks
    ((1, 3, 5, 7, 32), 64, "wgmma", torch.bfloat16),        # 32-channel chunks: one ragged block
    ((3, 5, 7, 9, 32), 64, "wgmma", torch.bfloat16),        # 63 voxels a plane
    ((1, 2, 3, 200, 32), 64, "wgmma", torch.bfloat16),      # a row longer than a block
    ((2, 9, 11, 13, 32), 128, "wgmma", torch.bfloat16),     # 128-wide blocks
    ((1, 32, 36, 32, 32), 64, "wgmma", torch.bfloat16),     # several rounds of blocks
    ((2, 5, 6, 7, 96), 64, "wgmma", torch.bfloat16),        # Ci = 32 * 3: three chunks
    ((2, 4, 5, 6, 64), 24, "narrow", torch.bfloat16),
    ((2, 5, 6, 7, 12), 12, "narrow", torch.bfloat16),
    ((2, 5, 6, 7, 12), 24, "narrow", torch.bfloat16),
    ((2, 5, 6, 7, 24), 12, "narrow", torch.bfloat16),
    ((2, 5, 6, 7, 16), 16, "narrow", torch.bfloat16),
    ((2, 5, 6, 7, 16), 32, "narrow", torch.bfloat16),
    ((2, 5, 6, 7, 32), 16, "narrow", torch.bfloat16),
    ((2, 5, 6, 7, 32), 32, "narrow", torch.bfloat16),
    ((2, 5, 6, 7, 24), 32, "narrow", torch.bfloat16),
    ((2, 5, 6, 7, 32), 48, "narrow", torch.bfloat16),
    ((2, 5, 6, 7, 48), 32, "narrow", torch.bfloat16),
    ((2, 5, 6, 7, 48), 48, "narrow", torch.bfloat16),
    ((2, 5, 6, 7, 64), 32, "narrow", torch.bfloat16),       # fc_600's 32 -> 64 dgrad
    ((3, 20, 37, 41, 12), 12, "narrow", torch.bfloat16),    # several patches and segments
    ((2, 5, 6, 7, 5), 12, "fma", torch.bfloat16),           # Ci not a multiple of 4
    ((2, 5, 6, 7, 12), 12, "narrow_tf32x3", torch.float32),  # Ci not a multiple of 32
    ((2, 5, 6, 7, 5), 12, "fma", torch.float32),            # Ci not a multiple of 4
    ((2, 5, 6, 7, 12), 24, "narrow_tf32x3", torch.float32),
    ((2, 5, 6, 7, 24), 12, "narrow_tf32x3", torch.float32),
    ((2, 5, 6, 7, 16), 32, "narrow_tf32x3", torch.float32),
    ((2, 1, 1, 300, 12), 16, "narrow_tf32x3", torch.float32),  # rows of one voxel's planes
    ((2, 5, 6, 7, 16), 16, "narrow_tf32x3", torch.float32),
    ((2, 5, 6, 7, 24), 32, "narrow_tf32x3", torch.float32),
    ((2, 5, 6, 7, 32), 48, "narrow_tf32x3", torch.float32),
    ((2, 5, 6, 7, 48), 48, "narrow_tf32x3", torch.float32),  # two chunks, the second of 16
    ((2, 5, 6, 7, 64), 12, "narrow_tf32x3", torch.float32),
    ((3, 20, 37, 41, 12), 12, "narrow_tf32x3", torch.float32),  # several rounds of blocks
    ((1, 32, 36, 32, 16), 16, "narrow_tf32x3", torch.float32),
    ((1, 2, 3, 200, 12), 24, "narrow_tf32x3", torch.float32),   # a row longer than a block
    ((2, 5, 6, 7, 64), 64, "tf32x3", torch.float32),
    ((1, 3, 5, 7, 64), 128, "tf32x3", torch.float32),       # M = 105: one ragged block
    ((3, 4, 6, 5, 128), 64, "tf32x3", torch.float32),       # the 128 -> 64 dgrad
    ((2, 3, 4, 5, 128), 256, "tf32x3", torch.float32),
    ((3, 4, 6, 5, 256), 128, "tf32x3", torch.float32),      # the 256 -> 128 dgrad
    ((1, 3, 4, 5, 256), 256, "tf32x3", torch.float32),
    ((2, 5, 6, 7, 32), 32, "tf32x3", torch.float32),        # fullsize: 32-wide tiles
    ((2, 5, 6, 7, 32), 64, "tf32x3", torch.float32),
    ((2, 5, 6, 7, 64), 32, "tf32x3", torch.float32),
    ((1, 2, 3, 200, 64), 64, "tf32x3", torch.float32),      # a row longer than a block
    ((1, 32, 36, 32, 64), 64, "tf32x3", torch.float32),     # 256-row blocks, several rounds
    ((1, 32, 36, 32, 32), 32, "tf32x3", torch.float32),     # 256 x 32 blocks
]


@pytest.mark.gpu
@pytest.mark.parametrize("x_shape,co,body,dtype", BODY_CASES)
def test_conv3d_same_bodies_match_plain(cuda_device, x_shape, co, body, dtype):
    """Each body the dispatch chooses, and the body it superseded on the same
    operands ("mma" for wgmma's, "fma" for the others'), against the plain
    version and against each other."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(x_shape, generator=gen, device=cuda_device).to(dtype)
    w = (0.1 * torch.randn((3, 3, 3, x_shape[-1], co), generator=gen,
                           device=cuda_device)).to(dtype)
    got = conv3d_same(x, w)
    assert conv3d_same_body(x, w, got) == body
    before = dict(build.launches)
    earlier = conv3d_same_earlier_body(x, w)
    if body == "wgmma":  # the dispatch runs the body in the shape it names, bit for bit
        shape = conv3d_same_wgmma_shape(x, co)
        assert torch.equal(got, conv3d_same_wgmma_blocks(x, w, shape))
    torch.cuda.synchronize()
    assert build.launches == before  # the measuring entries count nothing
    want = conv3d_same_plain(x, w).float()
    tol = TOL[dtype] * max(1.0, want.abs().max().item())
    assert (got.float() - want).abs().max().item() <= tol
    assert (earlier.float() - want).abs().max().item() <= tol
    assert (got.float() - earlier.float()).abs().max().item() <= tol
    if body == "narrow":  # its own algorithm, in PyTorch, on the same bf16 values
        assert (got.float() - conv3d_same_narrow_plain(x, w).float()).abs().max().item() <= tol
    if body == "tf32x3":  # its own algorithm, in PyTorch (split operands, three products)
        assert (got - conv3d_same_tf32x3_plain(x, w)).abs().max().item() <= tol
    if body == "narrow_tf32x3":  # the same, K padded to 8s in 32-channel chunks
        assert (got - conv3d_same_narrow_tf32x3_plain(x, w)).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("shape", WGMMA_SHAPES)
def test_conv3d_same_wgmma_block_shapes_agree(cuda_device, shape):
    """The wgmma body in each block shape (the measuring entry), in 64- and in
    32-channel chunks: another shape regroups whole fp32 sums only, so the
    outputs are bit-identical to the dispatch's, which picks one of them; a
    128-wide shape refuses Co = 64."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    for ci in (128, 32):
        x = torch.randn((3, 5, 7, 9, ci), generator=gen, device=cuda_device).bfloat16()
        w = (0.1 * torch.randn((3, 3, 3, ci, 128), generator=gen, device=cuda_device)).bfloat16()
        assert conv3d_same_wgmma_shape(x, 128) in WGMMA_SHAPES
        before = dict(build.launches)
        got = conv3d_same_wgmma_blocks(x, w, shape)
        assert build.launches == before
        assert torch.equal(got, conv3d_same(x, w))
        if shape % 10 == 2:
            with pytest.raises(RuntimeError):
                conv3d_same_wgmma_blocks(x, w[..., :64].contiguous(), shape)


# bf16 shapes of conv3d_to1: the mma body marches 16 x 16 patches along d, so
# H and W below, at and above one patch, D = 1, B = 1 and 3, C = 16, 32 and
# 64 by TMA, 12 by cp.async, 24 and 48 by a TMA box wider than the channels;
# C = 5 falls to the CUDA-core body
TO1_CASES = [((1, 1, 3, 4, 64), "mma"), ((3, 5, 7, 9, 64), "mma"), ((1, 9, 16, 16, 64), "mma"),
             ((2, 3, 17, 33, 64), "mma"), ((1, 90, 18, 20, 16), "mma"), ((2, 4, 35, 6, 32), "mma"),
             ((2, 4, 5, 6, 5), "fma"), ((1, 4, 5, 6, 48), "mma"), ((2, 6, 19, 37, 12), "mma"),
             ((3, 5, 17, 21, 24), "mma"), ((1, 1, 3, 4, 12), "mma")]


@pytest.mark.gpu
@pytest.mark.parametrize("x_shape,body", TO1_CASES)
def test_conv3d_to1_bodies_match_plain(cuda_device, x_shape, body):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn(x_shape, generator=gen, device=cuda_device).bfloat16()
    w = (0.1 * torch.randn((3, 3, 3, x_shape[-1], 1), generator=gen,
                           device=cuda_device)).bfloat16()
    assert conv3d_to1_body(x) == body
    # fp32 takes the three-product TF32 form of the same contraction
    assert conv3d_to1_body(x.float()) == ("tf32x3" if body == "mma" else "fma")
    got = conv3d_to1(x, w)
    before = dict(build.launches)
    earlier = conv3d_to1_earlier_body(x, w)  # the CUDA-core body on the same operands
    torch.cuda.synchronize()
    assert build.launches == before
    want = conv3d_to1_plain(x, w).float()
    tol = TOL[torch.bfloat16] * max(1.0, want.abs().max().item())
    assert got.shape == want.shape
    assert (got.float() - want).abs().max().item() <= tol
    assert (earlier.float() - want).abs().max().item() <= tol
    if body == "mma":  # its own algorithm, in PyTorch, on the same bf16 values
        assert (got.float() - conv3d_to1_contract_first_plain(x, w).float()).abs().max() <= tol


# fp32 shapes of conv3d_to1: the "tf32x3" body at the tails' C (12 and 16 of
# the FC and spatial_150 families, 64 of spatial_1200), at 24 and 48 (a box
# wider than the channels; 48 in two 32-channel sub-buffers), at grids no
# patch divides, D = 1 and B = 3
TO1_FP32_CASES = [(2, 6, 19, 37, 12), (1, 90, 18, 20, 16), (3, 5, 17, 21, 24),
                  (1, 4, 5, 6, 48), (2, 3, 17, 33, 64), (1, 1, 3, 4, 12)]


@pytest.mark.gpu
@pytest.mark.parametrize("x_shape", TO1_FP32_CASES)
def test_conv3d_to1_tf32x3_body_matches_plain(cuda_device, x_shape):
    """The fp32 channel contraction against the plain version, its own
    algorithm in PyTorch and the CUDA-core body it superseded, at the fp32
    tolerance."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.randn(x_shape, generator=gen, device=cuda_device)
    w = 0.1 * torch.randn((3, 3, 3, x_shape[-1], 1), generator=gen, device=cuda_device)
    assert conv3d_to1_body(x) == "tf32x3"
    before = build.launches["conv3d_to1"]
    got = conv3d_to1(x, w)
    earlier = conv3d_to1_earlier_body(x, w)
    torch.cuda.synchronize()
    assert build.launches["conv3d_to1"] == before + 1
    want = conv3d_to1_plain(x, w)
    tol = TOL[torch.float32] * max(1.0, want.abs().max().item())
    for out in (got, earlier, conv3d_to1_tf32x3_plain(x, w)):
        assert out.shape == want.shape and out.dtype == torch.float32
        assert (out - want).abs().max().item() <= tol


# (B, D, H, W) and C of conv3d_from1 in bf16: the mma body marches 16 x 16
# patches along d, so H and W below, at and above one patch, D = 1, B = 1
# and 3, C = 16, 32 and 64 (16-byte output pieces), 12 (24-byte rows in
# 8-byte pieces), 24 and 48 (N padded to the next n8 tile); C = 5 falls to
# the CUDA-core body
FROM1_CASES = [((1, 1, 3, 4), 64, "mma"), ((3, 5, 7, 9), 64, "mma"), ((1, 9, 16, 16), 64, "mma"),
               ((2, 3, 17, 33), 64, "mma"), ((1, 90, 18, 20), 16, "mma"),
               ((2, 4, 35, 6), 32, "mma"), ((2, 4, 5, 6), 5, "fma"), ((1, 4, 5, 6), 48, "mma"),
               ((2, 6, 19, 37), 12, "mma"), ((1, 1, 3, 4), 12, "mma"), ((3, 5, 17, 21), 24, "mma"),
               ((2, 3, 17, 33), 48, "mma"), ((1, 4, 5, 6), 4, "mma"), ((1, 4, 18, 20), 20, "mma")]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,c,body", FROM1_CASES)
def test_conv3d_from1_bodies_match_plain(cuda_device, shape, c, body):
    """Each body against the plain version and against the tensor-core
    body's algorithm in PyTorch (the same bf16 inputs, fp32 sums); the
    CUDA-core body it superseded on the same operands too."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    x = torch.randn(shape + (1,), generator=gen, device=cuda_device).bfloat16()
    w = (0.3 * torch.randn((3, 3, 3, 1, c), generator=gen, device=cuda_device)).bfloat16()
    assert conv3d_from1_body(x, c) == body
    # fp32 takes the three-product TF32 form of the same tap product
    assert conv3d_from1_body(x.float(), c) == ("tf32x3" if body == "mma" else "fma")
    got = conv3d_from1(x, w)
    before = dict(build.launches)
    earlier = conv3d_from1_earlier_body(x, w)
    torch.cuda.synchronize()
    assert build.launches == before  # the measuring entry counts nothing
    for want in (conv3d_from1_plain(x, w).float(), conv3d_from1_gemm_plain(x, w).float()):
        assert got.shape == want.shape
        tol = TOL[torch.bfloat16] * max(1.0, want.abs().max().item())
        assert (got.float() - want).abs().max().item() <= tol
        assert (earlier.float() - want).abs().max().item() <= tol


# (B, D, H, W) and C of conv3d_from1 in fp32: the "tf32x3" body at the
# stems' C (12 and 16 of the FC and spatial_150 families, 32 and 64 of
# spatial_1200_fullsize and spatial_1200) and at C = 20 (N padded), at grids
# no patch divides
FROM1_FP32_CASES = [((2, 6, 19, 37), 12), ((1, 90, 18, 20), 16), ((2, 4, 35, 6), 32),
                    ((3, 5, 7, 9), 64), ((2, 3, 17, 33), 64), ((1, 4, 18, 20), 20)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,c", FROM1_FP32_CASES)
def test_conv3d_from1_tf32x3_body_matches_plain(cuda_device, shape, c):
    """The fp32 tap product against the plain version, its own algorithm in
    PyTorch and the CUDA-core body it superseded, at the fp32 tolerance."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    x = torch.randn(shape + (1,), generator=gen, device=cuda_device)
    w = 0.3 * torch.randn((3, 3, 3, 1, c), generator=gen, device=cuda_device)
    assert conv3d_from1_body(x, c) == "tf32x3"
    before = build.launches["conv3d_from1"]
    got = conv3d_from1(x, w)
    earlier = conv3d_from1_earlier_body(x, w)
    torch.cuda.synchronize()
    assert build.launches["conv3d_from1"] == before + 1
    want = conv3d_from1_plain(x, w)
    tol = TOL[torch.float32] * max(1.0, want.abs().max().item())
    for out in (got, earlier, conv3d_from1_tf32x3_plain(x, w)):
        assert out.shape == want.shape and out.dtype == torch.float32
        assert (out - want).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("kern,plain,x_shape,w_shape", [
    (conv3d_same, conv3d_same_plain, (2, 5, 6, 7, 64), (3, 3, 3, 64, 64)),
    (conv3d_same, conv3d_same_plain, (2, 5, 6, 7, 32), (3, 3, 3, 32, 32)),
    (conv3d_from1, conv3d_from1_plain, (2, 5, 6, 7, 1), (3, 3, 3, 1, 64)),
    (conv3d_from1, conv3d_from1_plain, (2, 5, 6, 7, 1), (3, 3, 3, 1, 12)),
    (conv3d_same, conv3d_same_plain, (2, 5, 6, 7, 12), (3, 3, 3, 12, 24)),   # narrow_tf32x3
    (conv3d_same, conv3d_same_plain, (2, 5, 6, 7, 48), (3, 3, 3, 48, 48)),
    (conv3d_to1, conv3d_to1_plain, (2, 5, 6, 7, 12), (3, 3, 3, 12, 1)),      # to1 tf32x3
    (conv3d_to1, conv3d_to1_plain, (2, 5, 6, 7, 64), (3, 3, 3, 64, 1))])
def test_tf32x3_bodies_propagate_inf_and_nan_as_fp32(cuda_device, kern, plain, x_shape,
                                                      w_shape):
    """An inf and a NaN in the input: the fp32 tensor-core bodies give inf
    (of the product's sign) and NaN where the plain version does, not the
    inf - inf = NaN of a naive split, and the other outputs within the fp32
    tolerance."""
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    x = torch.randn(x_shape, generator=gen, device=cuda_device)
    w = 0.1 * torch.randn(w_shape, generator=gen, device=cuda_device)
    x[0, 1, 2, 3, 0] = float("inf")
    x[-1, -2, 1, 1, -1] = float("nan")
    got, want = kern(x, w), plain(x, w)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isposinf(got), torch.isposinf(want))
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    assert torch.isposinf(want).any() and torch.isneginf(want).any() and torch.isnan(want).any()
    fin = torch.isfinite(want)
    tol = TOL[torch.float32] * max(1.0, want[fin].abs().max().item())
    assert (got[fin] - want[fin]).abs().max().item() <= tol


# x shape, Co: the tensor-core bodies (bf16 "wgmma", fp32 "tf32x3") inside
# one plane (16 * 8 = 128 voxels a plane) and straddling planes (7 * 9 = 63),
# and the FMA body
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


# x shape, Co of conv3d_fused_stats in bf16 that the wgmma body takes: its
# plane sums come from warps whose 16 rows lie in one plane (summed in the
# block) or straddle planes (added row by row)
FUSED_WGMMA_CASES = [
    ((2, 3, 16, 8, 64), 64),      # 128 voxels a plane: every warp's rows in one plane
    ((2, 6, 7, 9, 64), 128),      # 63 a plane: warps straddle planes; a ragged last tile
    ((2, 5, 3, 4, 64), 64),       # 12 a plane: fewer than a warp's 16 rows
    ((1, 300, 1, 1, 64), 64),     # 1 a plane: every row its own plane
    ((2, 4, 6, 5, 128), 64),      # Ci = 128: two 64-channel chunks a (kd, kh)
    ((3, 5, 7, 9, 64), 64),       # B = 3, a ragged last tile
    ((1, 32, 36, 32, 64), 128),   # several rounds of blocks over the SMs
]


@pytest.mark.gpu
@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("x_shape,co", FUSED_WGMMA_CASES)
def test_fused_stats_wgmma_body_matches_plain_and_the_earlier_body(cuda_device, prologue,
                                                                   x_shape, co):
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    ci = x_shape[-1]
    x = torch.randn(x_shape, generator=gen, device=cuda_device).bfloat16()
    w = (0.1 * torch.randn((3, 3, 3, ci, co), generator=gen, device=cuda_device)).bfloat16()
    ab = ()
    if prologue:  # a shift well off 0: padding before the prologue would show
        ab = (0.5 + torch.rand(ci, generator=gen, device=cuda_device),
              0.3 + 0.3 * torch.rand(ci, generator=gen, device=cuda_device), 0.2)
    assert conv3d_fused_stats_body(x, w) == "wgmma"
    before = dict(build.launches)
    earlier = conv3d_fused_stats_earlier_body(x, w, *ab)
    torch.cuda.synchronize()
    assert build.launches == before  # the measuring entry counts nothing
    got = conv3d_fused_stats(x, w, *ab)
    torch.cuda.synchronize()
    assert build.launches["conv3d_fused_stats"] == before["conv3d_fused_stats"] + 1
    want = conv3d_fused_stats_plain(x, w, *ab)
    # a plane of one voxel sums one rounded value, whose last bit (4e-3 of it)
    # may differ from the plain version's: there the sums are held to y's tolerance
    tol_sums = 1e-3 if x_shape[2] * x_shape[3] > 1 else TOL[torch.bfloat16]
    for out in (got, earlier):
        for g, p, tol in zip(out, want, (TOL[torch.bfloat16], tol_sums, tol_sums)):
            assert g.shape == p.shape and g.dtype == p.dtype
            err = (g.float() - p.float()).abs().max().item()
            assert err <= tol * max(1.0, p.float().abs().max().item())
        # and exactly the sums of the y that came out, up to the order of fp32 additions
        yf = out[0].float()
        for g, p in zip(out[1:], (yf.sum(dim=(2, 3)), (yf * yf).sum(dim=(2, 3)))):
            assert (g - p).abs().max().item() <= 1e-5 * max(1.0, p.abs().max().item())


# x shape, Co of conv3d_fused_stats in fp32 that the "tf32x3" body takes: its
# plane sums come from warp tiles whose 16 rows lie in one plane (shuffled
# into a slot, summed in the block) or not (added value by value)
FUSED_TF32X3_CASES = [
    ((2, 3, 16, 8, 64), 64),      # 128 voxels a plane: every warp's rows in one plane
    ((2, 6, 7, 9, 64), 128),      # 63 a plane: warps straddle planes; Co = 128, a ragged tile
    ((2, 5, 3, 4, 32), 32),       # 12 a plane: fewer than a warp's 16 rows; 32-wide blocks
    ((1, 300, 1, 1, 32), 64),     # 1 a plane: every row its own plane
    ((2, 4, 6, 5, 64), 32),       # Ci = 64: two 32-channel chunks a (kd, kh); Co = 32
    ((3, 5, 7, 9, 32), 64),       # B = 3, M = 945: not a multiple of a block
    ((1, 32, 36, 32, 64), 64),    # 256-row blocks, several rounds over the SMs
]


def _prologue_operands(ci, gen, dev):
    """in_a, in_b, slope, with a shift well off 0: padding before the
    prologue would show."""
    return (0.5 + torch.rand(ci, generator=gen, device=dev),
            0.3 + 0.3 * torch.rand(ci, generator=gen, device=dev), 0.2)


@pytest.mark.gpu
@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("x_shape,co", FUSED_TF32X3_CASES)
def test_fused_stats_tf32x3_body_matches_plain_and_the_earlier_body(cuda_device, prologue,
                                                                    x_shape, co):
    """The fp32 body against the plain version, its own algorithm in PyTorch
    and the "fma" body it superseded on the same operands: y at the fp32
    tolerance, the sums at 1e-3, and the sums exactly those of the y that
    came out up to the order of fp32 additions."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    ci = x_shape[-1]
    x = torch.randn(x_shape, generator=gen, device=cuda_device)
    w = 0.1 * torch.randn((3, 3, 3, ci, co), generator=gen, device=cuda_device)
    ab = _prologue_operands(ci, gen, cuda_device) if prologue else ()
    assert conv3d_fused_stats_body(x, w) == "tf32x3"
    before = dict(build.launches)
    earlier = conv3d_fused_stats_earlier_body(x, w, *ab)
    torch.cuda.synchronize()
    assert build.launches == before  # the measuring entry counts nothing
    got = conv3d_fused_stats(x, w, *ab)
    torch.cuda.synchronize()
    assert build.launches["conv3d_fused_stats"] == before["conv3d_fused_stats"] + 1
    for want in (conv3d_fused_stats_plain(x, w, *ab), conv3d_fused_stats_tf32x3_plain(x, w, *ab)):
        for out in (got, earlier):
            for g, p, tol in zip(out, want, (TOL[torch.float32], 1e-3, 1e-3)):
                assert g.shape == p.shape and g.dtype == p.dtype == torch.float32
                assert (g - p).abs().max().item() <= tol * max(1.0, p.abs().max().item())
    y = got[0]
    for g, p in zip(got[1:], (y.sum(dim=(2, 3)), (y * y).sum(dim=(2, 3)))):
        assert (g - p).abs().max().item() <= 1e-5 * max(1.0, p.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("prologue", [False, True])
def test_fused_stats_tf32x3_body_propagates_inf_and_nan(cuda_device, prologue):
    """An inf and a NaN in the input (g keeps both: inf * a + b with a > 0):
    y and both sums inf or NaN where the plain version's are, the other
    values within the tolerances."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    x = torch.randn((2, 5, 6, 7, 64), generator=gen, device=cuda_device)
    w = 0.1 * torch.randn((3, 3, 3, 64, 64), generator=gen, device=cuda_device)
    x[0, 1, 2, 3, 0] = float("inf")
    x[-1, -2, 1, 1, -1] = float("nan")
    ab = _prologue_operands(64, gen, cuda_device) if prologue else ()
    got, want = conv3d_fused_stats(x, w, *ab), conv3d_fused_stats_plain(x, w, *ab)
    torch.cuda.synchronize()
    for g, p, tol in zip(got, want, (TOL[torch.float32], 1e-3, 1e-3)):
        assert torch.equal(torch.isnan(g), torch.isnan(p))
        assert torch.equal(torch.isposinf(g), torch.isposinf(p))
        assert torch.equal(torch.isneginf(g), torch.isneginf(p))
        fin = torch.isfinite(p)
        assert (g[fin] - p[fin]).abs().max().item() <= tol * max(1.0, p[fin].abs().max().item())
    assert torch.isinf(want[0]).any() and torch.isnan(want[0]).any()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", WGMMA_SHAPES)
def test_fused_stats_wgmma_block_shapes_agree(cuda_device, shape):
    """The fused kernel's wgmma body in each block shape (the measuring
    entry), with the prologue: the same y bit for bit as the dispatch's
    shape, which never takes 256 x 128, and the same sums up to the order of
    the fp32 additions."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    x = torch.randn((2, 5, 7, 9, 128), generator=gen, device=cuda_device).bfloat16()
    w = (0.1 * torch.randn((3, 3, 3, 128, 128), generator=gen, device=cuda_device)).bfloat16()
    ab = (0.5 + torch.rand(128, generator=gen, device=cuda_device),
          0.3 + 0.3 * torch.rand(128, generator=gen, device=cuda_device), 0.2)
    assert conv3d_fused_stats_wgmma_shape(x, 128) in (11, 21, 12)
    before = dict(build.launches)
    got = conv3d_fused_stats_wgmma_blocks(x, w, *ab, shape=shape)
    assert build.launches == before
    want = conv3d_fused_stats(x, w, *ab)
    assert torch.equal(got[0], want[0])
    for g, p in zip(got[1:], want[1:]):
        assert (g - p).abs().max().item() <= 1e-5 * max(1.0, p.abs().max().item())


def _stats_plain(x, w):
    y = conv3d_same_plain(x, w)
    return y, y.sum(dim=(2, 3)), (y * y).sum(dim=(2, 3))


GRAD_CASES = [  # differentiable wrapper, plain version, x shape, w shape
    (conv3d_same, conv3d_same_plain, (2, 6, 8, 10, 64), (3, 3, 3, 64, 128)),  # dgrad 128 -> 64
    (conv3d_same, conv3d_same_plain, (3, 5, 7, 9, 128), (3, 3, 3, 128, 256)),  # dgrad 256 -> 128
    (conv3d_same, conv3d_same_plain, (2, 4, 5, 6, 3), (3, 3, 3, 3, 4)),
    # dgrad 24 -> 12: "narrow" in bf16, "narrow_tf32x3" in fp32, forward and dx
    (conv3d_same, conv3d_same_plain, (2, 5, 6, 7, 12), (3, 3, 3, 12, 24)),
    (conv3d_same, conv3d_same_plain, (2, 5, 6, 7, 16), (3, 3, 3, 16, 48)),  # dgrad 48 -> 16
    (conv3d_same, conv3d_same_plain, (2, 5, 6, 7, 32), (3, 3, 3, 32, 64)),  # fp32: 32-wide dgrad
    (conv3d_to1, conv3d_to1_plain, (2, 6, 8, 10, 64), (3, 3, 3, 64, 1)),
    (conv3d_to1, conv3d_to1_plain, (2, 5, 6, 7, 12), (3, 3, 3, 12, 1)),    # dx: from1 at C = 12
    (conv3d_to1, conv3d_to1_plain, (2, 5, 6, 7, 16), (3, 3, 3, 16, 1)),
    (conv3d_from1, conv3d_from1_plain, (2, 6, 8, 10, 1), (3, 3, 3, 1, 64)),
    (conv3d_from1, conv3d_from1_plain, (2, 5, 6, 7, 1), (3, 3, 3, 1, 12)),
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


@pytest.mark.gpu
def test_pipeline_batches_on_the_card_equal_the_cpus(cuda_device):
    """The same epochs through the prefetching pipeline on the card (pinned
    buffers, side-stream copies, events) and on the CPU give the same bits,
    augmentation off, while the consumer keeps the card busy between
    batches so that a batch read before its copy or its preprocessing
    finished, or a pinned buffer refilled too early, would show."""
    import numpy as np

    from sivae_torch.data.pipeline import BrainDataSource, DataPipeline
    from sivae_torch.data.synthetic import SyntheticBrainSource

    src = BrainDataSource(SyntheticBrainSource(10, (40, 48, 40), seed=3).records)
    busy = torch.ones((2048, 2048), device=cuda_device)
    for epoch in (0, 1):
        cpu = list(DataPipeline(src, 2, device="cpu", seed=5).epoch(epoch))
        card = []
        for vox, lab in DataPipeline(src, 2, device=cuda_device, seed=5).epoch(epoch):
            for _ in range(20):
                busy = busy @ busy / 2048.0
            card.append((vox.clone(), lab))
        assert len(card) == len(cpu) == 5
        for (v_g, l_g), (v_c, l_c) in zip(card, cpu):
            assert v_g.device.type == "cuda" and v_g.shape == (2, 1, 40, 48, 40)
            np.testing.assert_array_equal(l_g, l_c)
            torch.testing.assert_close(v_g.cpu(), v_c, rtol=0, atol=0)


@pytest.mark.gpu
def test_affine_resample_on_the_card_matches_the_cpu(cuda_device):
    """A fixed rotation + scale + shift of preprocessed volumes (values in
    [0, 1]) through `F.grid_sample` on the card and on the CPU: 1e-5."""
    import numpy as np

    from sivae_torch.data.augment import _affine_resample, _rotation_matrix
    from sivae_torch.data.preprocess import preprocess_batch
    from sivae_torch.data.synthetic import synthetic_brain_batch

    vox, _ = synthetic_brain_batch(2, (80, 96, 80), seed=4)
    x = preprocess_batch(torch.from_numpy(vox))[:, 0]
    rot = _rotation_matrix(torch.deg2rad(torch.tensor([8.0, -5.0, 10.0])))
    inv = rot.T / torch.tensor([1.05, 0.95, 1.0])[None, :]
    t = torch.tensor([1.5, -2.0, 0.5])
    got = _affine_resample(x.to(cuda_device), inv, t)
    want = _affine_resample(x, inv, t)
    assert got.shape == want.shape and got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_checkpoint_restores_on_the_card_bit_for_bit(cuda_device, tmp_path):
    """A state on the card, saved and restored into another state on the
    card: every tensor, the generator and the step equal. A CPU state takes
    no card generator."""
    from sivae_torch.config import OptimConfig, SoftIntroLossConfig
    from sivae_torch.models.registry import get_model_config, make_model
    from sivae_torch.train.state import create_train_state
    from sivae_torch.train.step import make_soft_intro_train_step
    from sivae_torch.utils.checkpoint import CheckpointManager

    cfg = get_model_config("tiny_spatial")
    model = make_model(cfg, device=cuda_device, seed=3)
    state = create_train_state(model, seed=2)
    step = make_soft_intro_train_step(model, SoftIntroLossConfig(), OptimConfig(), 1,
                                      cfg.input_shape)
    step(state, torch.rand((2, 1) + cfg.input_shape, device=cuda_device))
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(0, state)
    other = create_train_state(make_model(cfg, device=cuda_device, seed=4), seed=5)
    mgr.restore(other)
    for (k, a), (_, b) in zip(state.model.state_dict().items(),
                              other.model.state_dict().items()):
        assert b.device.type == "cuda" and torch.equal(a, b), k
    for name in ("opt_e", "opt_d"):
        for p, q in zip(getattr(state, name).param_groups[0]["params"],
                        getattr(other, name).param_groups[0]["params"]):
            sa, sb = getattr(state, name).state[p], getattr(other, name).state[q]
            assert set(sa) == set(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert torch.equal(torch.rand(8, generator=state.generator, device=cuda_device),
                       torch.rand(8, generator=other.generator, device=cuda_device))
    assert other.step == state.step == 1
    with pytest.raises(ValueError, match="generator"):
        mgr.restore(create_train_state(make_model(cfg, device="cpu", seed=4), seed=5))


@pytest.mark.gpu
def test_two_gloo_ranks_on_one_card_match_one_process(cuda_device, tmp_path):
    """Data parallelism on the card: 2 gloo ranks sharing it
    (tests/torch_ddp_worker.py --card), each with 2 rows of a global batch
    of 4, take one fp32 tiny_spatial step through the kernels; one process
    on the card takes the same step on the whole batch. The ranks end bit
    for bit alike; against one process the mean of their metrics within
    1e-4 relative, BN running statistics within 1e-5 (the stem BN's mean
    1e-4: its conv bias has a zero gradient whose sign is rounding noise),
    first moments within 1e-3 of their tensor's largest plus 1e-4 of the
    model's largest (rounding noise where the exact gradient is 0)."""
    import numpy as np

    from torch_ddp_worker import card_step

    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_ddp_worker.py")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, worker, "--card", str(tmp_path)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "RANK": str(r), "LOCAL_RANK": "0", "WORLD_SIZE": "2",
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    ranks = [torch.load(tmp_path / f"rank{r}.pth", weights_only=False) for r in range(2)]
    assert ranks[0]["digest"] == ranks[1]["digest"]
    one = card_step(cuda_device)
    for k, v in one["metrics"].items():
        got = np.mean([r["metrics"][k] for r in ranks])
        assert abs(got - v) <= 1e-4 * abs(v) + 1e-30, (k, got, v)
    two = ranks[0]["payload"]
    for k, x in one["payload"]["model"].items():
        if "running" in k:
            tol = 1e-4 if k == "encoder.blocks.0.1.running_mean" else 1e-5
            assert (two["model"][k] - x).abs().max().item() <= tol * max(1.0, x.abs().max())
    moments = [(s["exp_avg"], two[o]["state"][i]["exp_avg"]) for o in ("opt_e", "opt_d")
               for i, s in one["payload"][o]["state"].items()]
    noise = 1e-4 * max(a.abs().max().item() for a, _ in moments)
    for a, b in moments:
        assert (a - b).abs().max().item() <= 1e-3 * a.abs().max().item() + noise


@pytest.mark.gpu
def test_remat_modes_on_the_card_take_the_step_without(cuda_device):
    """Two fp32 steps of `tiny_spatial` with dropout on, through the kernels,
    in every rematerialisation mode (`remat=True` with each policy, the
    step's `remat_calls`) against the same steps without remat. The library
    calls of the backward (weight gradients, matrix products on tensors the
    reruns placed elsewhere) may sum in another order on the card, and
    Adam's first step moves a parameter whose gradient is rounding noise
    (the stem's conv bias in front of its BN) by lr of either sign. After
    the first step: losses within 1e-5 relative; first moments within 1e-5
    of their tensor's largest with phase 7's floor; parameters where their
    moment is above 1e-3 of that scale; running statistics within 1e-5
    (phase D's encodes run the updated encoder: tests/test_torch_train.py's
    rule), the stem BN's mean, which sees that bias move, within 1e-4,
    `num_batches_tracked` equal. After the second: losses within 1e-4. Each
    step's launches equal the step's without remat plus the reruns'
    derived counts (conv kernels), and the same BatchNorm statistics and
    backward launches."""
    import numpy as np

    from sivae_torch.config import OptimConfig, SoftIntroLossConfig
    from sivae_torch.models import remat
    from sivae_torch.models.registry import get_model_config, make_model
    from sivae_torch.models.resnet_vae import spatial_conv_sites
    from sivae_torch.train.state import create_train_state
    from sivae_torch.train.step import make_soft_intro_train_step

    cfg0 = get_model_config("tiny_spatial")
    real = torch.from_numpy(np.random.RandomState(1).rand(4, 1, *cfg0.input_shape)
                            .astype(np.float32)).to(cuda_device)

    def run(kind, pol):
        cfg = cfg0 if kind != "block" else dataclasses.replace(cfg0, remat=True, remat_policy=pol)
        model = make_model(cfg, device=cuda_device, seed=0)
        state = create_train_state(model, seed=0)
        step = make_soft_intro_train_step(model, SoftIntroLossConfig(), OptimConfig(), 1,
                                          cfg.input_shape, remat_calls=kind == "calls",
                                          remat_calls_policy=pol if kind == "calls" else None)
        names = {p: k for k, p in model.named_parameters()}
        out = []
        for _ in range(2):
            build.reset_launches()
            _, m = step(state, real)
            out.append(({k: float(m[k]) for k in ("lossE", "lossD")},
                        {k: v.cpu() for k, v in model.state_dict().items()},
                        {names[p]: s["exp_avg"].cpu() for opt in (state.opt_e, state.opt_d)
                         for p, s in opt.state.items()}, dict(build.launches)))
        return out

    base = run(None, None)
    floor = 1e-2 * max(v.abs().max().item() for v in base[0][2].values())
    sites = spatial_conv_sites(cfg0)
    for kind, pol in [("block", p) for p in remat.POLICIES] + [("calls", None),
                                                               ("calls", "conv_outs")]:
        extra = remat.soft_intro_step_recomputes(*sites, pol, whole_call=kind == "calls")
        got = run(kind, pol)
        for n, ((ma, sa, mo_a, na), (mb, sb, mo_b, nb)) in enumerate(zip(base, got)):
            for k, v in ma.items():
                assert abs(mb[k] - v) <= (1e-5 if n == 0 else 1e-4) * abs(v), (kind, pol, n, k)
            assert ({k: nb[k] for k in build.CONV_KERNELS}
                    == {k: na[k] + extra.get(k, 0) for k in build.CONV_KERNELS}), (kind, pol, n)
            # a rerun normalises with its first forward's statistics: no statistics
            # kernel, and its node is never differentiated
            for k in ("bn_stats", "bn_bwd_reduce", "bn_bwd_apply"):
                assert nb[k] == na[k], (kind, pol, n, k)
        (_, sa, mo_a, _), (_, sb, mo_b, _) = base[0], got[0]
        for k, v in mo_a.items():
            scale = max(v.abs().max().item(), floor)
            assert (mo_b[k] - v).abs().max().item() <= 1e-5 * scale, (kind, pol, k)
            mask = v.abs() > 1e-3 * scale   # below, a gradient of rounding noise
            if mask.any():
                w = sa[k]
                err = (sb[k] - w)[mask].abs().max().item()
                assert err <= 1e-5 * max(w.abs().max().item(), 1e-12), (kind, pol, k)
        for k, v in sa.items():
            if k.endswith("num_batches_tracked"):
                assert torch.equal(sb[k], v), (kind, pol, k)
            elif "running" in k:
                # phase D's two encodes see the stem's conv bias after a step
                # of lr of either sign: 2 * lr * (0.1 + 0.09) = 7.6e-5
                tol = 1e-4 if k == "encoder.blocks.0.1.running_mean" else 1e-5
                assert (sb[k] - v).abs().max().item() <= tol, (kind, pol, k)


def check_sharded_sites(ranks, dev):
    """tests/torch_depth_worker.py's `card_sites` of 2 ranks on a 1 x 2 grid
    against each conv site on the whole volume on `dev` (forward and the
    input gradient within the fp32 tolerance 1e-4 * max(1, max|ref|): the
    same kernel on halo-padded slabs; the two ranks' weight and bias
    gradients, each its slab's part, summed: 1e-4 of max(1, max|ref|)); the halo planes exchanged
    exactly (zeros at the grid's edges); each rank's launches and halo
    exchanges, and on CUDA tensors under gloo the host copies counted."""
    from sivae_torch.models.blocks import Conv3d, UpsampleConv3d

    for name, cls in (("from1", Conv3d), ("same", Conv3d), ("to1", Conv3d),
                      ("upconv", UpsampleConv3d)):
        got = [r[name] for r in ranks]
        ci, co = got[0]["w"].shape[1], got[0]["w"].shape[0]
        conv = cls(ci, co, use_bias=True).to(dev)
        with torch.no_grad():
            conv.weight.copy_(got[0]["w"])
            conv.bias.copy_(got[0]["b"])
        x = got[0]["x"].to(dev).contiguous(memory_format=torch.channels_last_3d)
        x.requires_grad_(True)
        y = conv(x)
        (y.float() * got[0]["g"].to(dev)).sum().backward()
        want = {"y": y.detach().float().cpu(), "dx": x.grad.float().cpu(),
                "dw": conv.weight.grad.cpu(), "db": conv.bias.grad.cpu()}
        summed = {"dw": sum(r["dw"] for r in got), "db": sum(r["db"] for r in got)}
        # each rank's whole y and dx; the slabs' parts of dw and db summed
        for r, keys in [(r, ("y", "dx")) for r in got] + [(summed, ("dw", "db"))]:
            for k in keys:
                err = (r[k] - want[k]).abs().max().item()
                assert err <= 1e-4 * max(1.0, want[k].abs().max().item()), (name, k, err)
    whole = ranks[0]["planes"]["whole"]
    assert torch.equal(ranks[0]["planes"]["below"], torch.zeros_like(whole[:, :1]))
    assert torch.equal(ranks[0]["planes"]["above"], whole[:, 2:3])
    assert torch.equal(ranks[1]["planes"]["below"], whole[:, 1:2])
    assert torch.equal(ranks[1]["planes"]["above"], torch.zeros_like(whole[:, :1]))
    for r in ranks:
        c = r["collectives"]
        assert c["halo"][0] == 2 * 4 + 1, c   # 4 sites forward and backward, the planes
        assert ("halo_host" in c) == (dev.type == "cuda"), c
    return ranks[0]["launches"]


@pytest.mark.gpu
def test_depth_sharded_conv_sites_on_the_card_match_the_whole_volume(cuda_device, tmp_path):
    """Depth sharding on the card: 2 gloo ranks sharing it on a 1 x 2 grid
    (tests/torch_depth_worker.py --card) run the halo exchange and one
    sharded conv site of each kernel kind (`conv3d_from1`, `conv3d_same`,
    `conv3d_to1`, the upsample + conv) forward and backward through the
    kernels, fp32; held against the same sites on the whole volume
    (`check_sharded_sites`). Each rank launches each kernel twice: its
    forward, and the input gradient of another site (`conv3d_to1`'s is a
    `conv3d_from1` launch and the other way round)."""
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_depth_worker.py")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, worker, "--card", str(tmp_path)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "RANK": str(r), "LOCAL_RANK": "0", "WORLD_SIZE": "2",
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    ranks = [torch.load(tmp_path / f"rank{r}.pth", weights_only=False) for r in range(2)]
    launches = check_sharded_sites(ranks, cuda_device)
    assert launches == {"conv3d_same": 2, "conv3d_to1": 2, "conv3d_from1": 2,
                        "conv3d_fused_stats": 0, "bn_stats": 0, "bn_finalize": 0,
                        "bn_apply": 0, "bn_bwd_reduce": 0, "bn_bwd_finalize": 0,
                        "bn_bwd_apply": 0}, launches


@pytest.mark.gpu
def test_classifier_steps_take_labels_on_the_card(cuda_device):
    """The classifier's train and eval steps take their labels as a host
    array or as a tensor on the card, alike (numpy cannot read a CUDA
    tensor: a step that converted it through numpy raised)."""
    from sivae_torch.config import OptimConfig
    from sivae_torch.models.classifier import ResNetClassifier
    from sivae_torch.models.registry import get_model_config
    from sivae_torch.train.state import create_train_state
    from sivae_torch.train.step import make_classifier_eval_step, make_classifier_train_step

    cfg = get_model_config("tiny_spatial")
    cfg = dataclasses.replace(cfg, act=cfg.act.with_no_dropout())
    x = torch.rand((2, 1) + cfg.input_shape, generator=torch.Generator().manual_seed(3))
    x = x.to(cuda_device)
    losses = []
    for labels in ([0, 1], torch.tensor([0, 1], device=cuda_device)):
        model = ResNetClassifier(cfg, num_classes=2, generator=torch.Generator().manual_seed(0))
        model = model.to(cuda_device).eval()
        state = create_train_state(model, seed=0, joint_optimizer=True)
        metrics, pred = make_classifier_eval_step(model)(state, x, labels)
        _, m = make_classifier_train_step(model, OptimConfig(), 1)(state, x, labels)
        losses.append((metrics["loss"].item(), m["loss"].item(), pred.cpu().tolist()))
    assert losses[0] == losses[1]



# train-mode BatchNorm sites (N, C, D, H, W): the train cells' full-resolution
# sites and their coarser ones (spatial_1200 at batch 8, fc_150 at batch 32),
# an M (2079 rows) that no block size divides with a partial last vector, the
# lucky AE's 3 channels, and a FeatureBatchNorm's features (M = 8, "cols")
BN_SITES = [(8, 64, 80, 96, 80), (32, 12, 80, 96, 80), (32, 24, 40, 48, 40),
            (32, 32, 20, 24, 20), (32, 48, 10, 12, 10), (8, 128, 20, 24, 20),
            (8, 256, 10, 12, 10), (3, 12, 7, 9, 11), (2, 3, 16, 16, 16), (8, 30720, 1, 1, 1)]
BN_SMALL = [(3, 12, 7, 9, 11), (2, 3, 16, 16, 16), (4, 64, 8, 10, 12), (2, 24, 5, 6, 7),
            (8, 3000, 1, 1, 1)]


def _bn_operands(shape, dtype, dev, seed, constant_channel=False):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=dev) * 1.5 + 0.3
    if constant_channel:
        x[:, 1] = 0.75  # raw variance exactly 0: the tie factor 1/2
    x = x.to(dtype).contiguous(memory_format=torch.channels_last_3d)
    c = shape[1]
    w = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
    b = 0.1 * torch.randn(c, generator=gen, device=dev)
    g = torch.randn(shape, generator=gen, device=dev).to(dtype).contiguous(
        memory_format=torch.channels_last_3d)
    return x, w, b, g


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at |v| (8 significand bits)."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", BN_SITES)
def test_bn_kernels_match_plain_at_the_sites(cuda_device, shape, dtype):
    """The kernels (forward, then backward with dx) against the plain version
    on the card, LeakyReLU 0.2 as the models run it. The statistics differ
    only in the order of their fp32 sums: mean and var within 1e-5 of
    max(1, their largest). The plain backward takes the kernels' saved
    statistics, so both take the same branch of the activation at every
    element (with its own, the plain version's pre-activation moves by the
    statistics' last bits, and the few elements within that of 0 take the
    other branch: 0.8 of their cotangent, ~0.45 of a channel's sum in fp32);
    dweight and dbias within 1e-4 of max(1, their largest) (sums over up to
    2e7 rows). y and dx follow the statistics through the same elementwise
    arithmetic: bf16 y within one bf16 ulp of
    its pre-activation (of y on the positive side; 0.2 of one of y / 0.2,
    plus one of y, where the LeakyReLU rounds a second time) plus 1e-5 of
    max(1, max|y|) (near 0 the statistics' last bits move the pre-activation
    by more than an ulp of it), fp32 y within 1e-5 of max(1, max|y|); dx
    within one ulp (bf16) plus 1e-5 of max(1, max|dx|) (its coefficients are
    order-dependent sums)."""
    from sivae_torch.kernels.batchnorm import (batchnorm_train, batchnorm_train_backward,
                                               batchnorm_train_backward_plain,
                                               batchnorm_train_plain)

    x, w, b, g = _bn_operands(shape, dtype, cuda_device, 11)
    y, mean, var, rstd, k, n, xs = batchnorm_train(x, w, b, 1e-5, 0.2, dtype)
    dx, dw, db = batchnorm_train_backward(g, xs, w, b, mean, rstd, k, n, 0.2, True)
    yp, mp, vp, _, kp, npl, _ = batchnorm_train_plain(x, w, b, 1e-5, 0.2, dtype)
    dxp, dwp, dbp = batchnorm_train_backward_plain(g, x, w, b, mean, rstd, k, n, 0.2, True)
    torch.cuda.synchronize()
    assert n == npl and y.shape == x.shape and y.dtype == dtype and dx.dtype == dtype
    for got, want in ((mean, mp), (var, vp)):
        assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())
    assert torch.equal(k, kp)
    for got, want in ((dw, dwp), (db, dbp)):
        assert (got - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())
    yd, yw = y.float(), yp.float()
    dxd, dxw = dx.float(), dxp.float()
    if dtype == torch.bfloat16:
        floor = 1e-5 * max(1.0, yw.abs().max().item())
        tol = torch.where(yw > 0, _bf16_ulp(yw),
                          0.2 * _bf16_ulp(yw / 0.2) + _bf16_ulp(yw)) + floor
        assert bool(((yd - yw).abs() <= tol).all())
        tol = _bf16_ulp(dxw) + 1e-5 * max(1.0, dxw.abs().max().item())
        assert bool(((dxd - dxw).abs() <= tol).all())
    else:
        assert (yd - yw).abs().max().item() <= 1e-5 * max(1.0, yw.abs().max().item())
        assert (dxd - dxw).abs().max().item() <= 1e-5 * max(1.0, dxw.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("slope", [None, 0.0, 0.2])
@pytest.mark.parametrize("shape", BN_SMALL)
def test_bn_kernels_take_the_plain_arithmetic_bit_for_bit(cuda_device, shape, slope, dtype):
    """Given the same statistics (a remat replay's filled `stats`, which
    skips the statistics kernel) and the same gradient sums (passed where
    several ranks pass their all-reduced ones), y and dx are the plain
    version's on the CPU bit for bit: every elementwise step keeps its fp32
    operations, their order and their roundings. A constant channel reads
    raw_var 0 and k 1/2. Counters: one count a launch."""
    from sivae_torch.kernels.batchnorm import (batchnorm_train, batchnorm_train_backward,
                                               batchnorm_train_backward_plain,
                                               batchnorm_train_plain)

    x, w, b, g = _bn_operands(shape, dtype, cuda_device, 12, constant_channel=True)
    xc, wc, bc, gc = (t.cpu() for t in (x, w, b, g))
    stats = []
    first = batchnorm_train(x, w, b, 1e-5, slope, dtype, stats)
    assert len(stats) == 3 and float(first[4][1]) == 0.5 and float(stats[1][1]) == 0.0
    cpu_stats = [stats[0].cpu(), stats[1].cpu(), stats[2]]
    before = dict(build.launches)
    y, mean, var, rstd, k, n, xs = batchnorm_train(x, w, b, 1e-5, slope, dtype, list(stats))
    torch.cuda.synchronize()
    assert build.launches["bn_stats"] == before["bn_stats"]
    assert build.launches["bn_finalize"] == before["bn_finalize"] + 1
    assert build.launches["bn_apply"] == before["bn_apply"] + 1
    yp, mp, vp, rp, kp, npl, _ = batchnorm_train_plain(xc, wc, bc, 1e-5, slope, dtype,
                                                       list(cpu_stats))
    assert torch.equal(y.cpu(), yp) and torch.equal(first[0], y)
    for got, want in ((mean, mp), (var, vp), (rstd, rp), (k, kp)):
        assert torch.equal(got.cpu(), want)
    _, dwp, dbp = batchnorm_train_backward_plain(gc, xc, wc, bc, mp, rp, kp, npl, slope, False)
    given = torch.cat([dwp, dbp]).to(cuda_device)
    before = dict(build.launches)
    dx, dw, db = batchnorm_train_backward(g, xs, w, b, mean, rstd, k, n, slope, True,
                                          lambda t: given)
    torch.cuda.synchronize()
    for key in ("bn_bwd_reduce", "bn_bwd_finalize", "bn_bwd_apply"):
        assert build.launches[key] == before[key] + 1
    dxp, _, _ = batchnorm_train_backward_plain(gc, xc, wc, bc, mp, rp, kp, npl, slope, True,
                                               lambda t: given.cpu())
    assert torch.equal(dx.cpu(), dxp)
    for got, want in ((dw, dwp), (db, dbp)):
        assert (got.cpu() - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())
    before = dict(build.launches)
    assert batchnorm_train_backward(g, xs, w, b, mean, rstd, k, n, slope, False)[0] is None
    assert build.launches["bn_bwd_apply"] == before["bn_bwd_apply"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bn_kernels_are_deterministic_and_count_their_launches(cuda_device, dtype):
    """Two runs of the forward and backward give the same bits (fixed-order
    sums, no atomics); each launch counts once, and the site is counted by
    "C@M dtype"."""
    from sivae_torch.kernels.batchnorm import batchnorm_train, batchnorm_train_backward

    x, w, b, g = _bn_operands((8, 64, 40, 48, 40), dtype, cuda_device, 13)
    build.reset_launches()
    runs = []
    for _ in range(2):
        y, mean, var, rstd, k, n, xs = batchnorm_train(x, w, b, 1e-5, 0.2, dtype)
        runs.append((y, mean, var, rstd, k)
                    + batchnorm_train_backward(g, xs, w, b, mean, rstd, k, n, 0.2, True))
    torch.cuda.synchronize()
    for a, e in zip(*runs):
        assert torch.equal(a, e)
    assert {k: v for k, v in build.launches.items() if k.startswith("bn_")} == {
        "bn_stats": 2, "bn_finalize": 2, "bn_apply": 2, "bn_bwd_reduce": 2,
        "bn_bwd_finalize": 2, "bn_bwd_apply": 2}
    assert build.bn_sites == {f"64@{8 * 40 * 48 * 40} {str(dtype)[6:]}": 2}
    assert build.bn_layout_copies == 0


@pytest.mark.gpu
def test_bn_modules_on_the_card_match_the_cpu(cuda_device):
    """`BatchNorm` and `FeatureBatchNorm` in training mode on the card
    (kernels) against the same modules on the CPU (plain version), fp32:
    output, input and parameter gradients and running statistics within
    1e-5 of max(1, their largest) (the order of the fp32 sums). An input
    outside channels-last memory is copied into it once and counted; a
    float64 tensor on the card raises."""
    from sivae_torch.models.blocks import BatchNorm, FeatureBatchNorm

    gen = torch.Generator().manual_seed(14)
    cases = [(BatchNorm(24, act_slope=0.2), torch.randn((4, 24, 6, 7, 8), generator=gen)),
             (FeatureBatchNorm((8, 3, 4, 5), act_slope=0.0),
              torch.randn((6, 480), generator=gen))]
    for mod, x in cases:
        out = {}
        for dev in (cuda_device, torch.device("cpu")):
            m = __import__("copy").deepcopy(mod).to(dev).train()
            xi = x.to(dev).requires_grad_()
            build.reset_launches()
            y = m(xi)
            y.backward(torch.cos(y.detach()))
            out[dev.type] = (y.detach().cpu(), xi.grad.cpu(), m.weight.grad.cpu(),
                             m.bias.grad.cpu(), m.running_mean.cpu(), m.running_var.cpu(),
                             build.bn_layout_copies, build.launches["bn_apply"])
        got, want = out["cuda"], out["cpu"]
        for a, e in zip(got[:6], want[:6]):
            assert (a - e).abs().max().item() <= 1e-5 * max(1.0, e.abs().max().item())
        # the NCDHW-contiguous 5-D input of BatchNorm is copied once; the
        # features' (B, F, 1, 1, 1) view is already [M, C]
        assert got[6] == (0 if isinstance(mod, FeatureBatchNorm) else 1)
        assert got[7] == 1 and want[6:] == (0, 0)
    with pytest.raises(TypeError):
        BatchNorm(3).to(cuda_device).double().train()(
            torch.randn((2, 3, 2, 2, 2), dtype=torch.float64, device=cuda_device))
