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
from sivae_torch.kernels.conv3d import (WGMMA_SHAPES, conv3d_same, conv3d_same_body,
                                        conv3d_same_earlier_body, conv3d_same_narrow_plain,
                                        conv3d_same_narrow_tf32x3_plain, conv3d_same_plain,
                                        conv3d_same_tf32x3_plain, conv3d_same_wgmma_blocks,
                                        conv3d_same_wgmma_shape)
from sivae_torch.kernels.conv3d_fused import (conv3d_fused_stats, conv3d_fused_stats_body,
                                              conv3d_fused_stats_earlier_body,
                                              conv3d_fused_stats_plain,
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
# 128 channels). The narrow body marches 16-wide patches along d: every
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
    ((2, 5, 6, 7, 96), 64, "mma", torch.bfloat16),          # Ci = 32 * 3: the earlier body
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
    """The wgmma body in each block shape (the measuring entry): another shape
    regroups whole fp32 sums only, so the outputs are bit-identical to the
    dispatch's, which picks one of them; a 128-wide shape refuses Co = 64."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn((3, 5, 7, 9, 128), generator=gen, device=cuda_device).bfloat16()
    w = (0.1 * torch.randn((3, 3, 3, 128, 128), generator=gen, device=cuda_device)).bfloat16()
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
