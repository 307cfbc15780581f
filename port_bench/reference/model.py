"""Plain PyTorch reference of the two Soft-IntroVAE families the benchmark
runs: the spatial-latent ResNet VAE (reference models/models.py:8-145,
257-300) and the FC-latent VAE (reference models/mymodel.py:51-230).

It imports nothing of the program. Its parameters carry the reference
checkpoints' `state_dict` keys, so one state dict loads into both. Every
operation is a plain `torch` call in NCDHW float32: `F.conv3d` for each
convolution, a nearest upsample followed by a 3x3x3 conv (not a derived
transposed conv), `F.avg_pool3d`, and BatchNorm written out from its
definition: batch statistics over (N, D, H, W), the biased variance
`max(0, E[x^2] - mean^2)`, running statistics moved as `0.9 * old + 0.1 *
new`. A BatchNorm followed by its activation in the reference is applied
in that order here.

`Run` carries what one forward needs besides the parameters: training or
evaluation, the generator of the dropout masks, the multiplication
precision (`Precision`) and, under data parallelism, the all-reduce that
makes BatchNorm's statistics the global batch's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5
BN_KEEP = 0.9          # share of the old running statistic kept
FP8_MAX = 448.0        # largest float8_e4m3fn


def fake_fp8(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude maps to 448), straight-through for the gradient."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t.detach())


@dataclass
class Precision:
    """How the reference multiplies. "fp32": full float32 (TF32 off, set by
    the caller's `precision_flags`); "tf32": cuDNN and matmul in TF32;
    "fp8": the operands of every conv and Linear rounded to float8 e4m3
    (per-tensor scale), products in float32."""

    name: str = "fp32"

    def operands(self, *ts):
        if self.name == "fp8":
            return tuple(None if t is None else fake_fp8(t) for t in ts)
        return ts


class precision_flags:
    """Context: cuDNN's and matmul's TF32 switches for `prec`, put back on
    exit."""

    def __init__(self, prec: Precision):
        self.tf32 = prec.name == "tf32"

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = self.tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        return self

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved
        return False


@dataclass
class Run:
    """One forward's settings. `drop` draws a dropout mask's uniforms for an
    NCDHW shape (None: no dropout, as in evaluation); `reduce` sums BatchNorm's
    [sum x, sum x^2] over the data-parallel ranks (differentiably) and
    returns them with the global count factor."""

    train: bool
    prec: Precision
    drop: Optional[Callable[[tuple], torch.Tensor]] = None
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    ranks: int = 1


class Conv(nn.Module):
    def __init__(self, ci: int, co: int, k: int, bias: bool):
        super().__init__()
        self.k = k
        self.weight = nn.Parameter(torch.empty(co, ci, k, k, k))
        self.bias = nn.Parameter(torch.empty(co)) if bias else None

    def forward(self, x: torch.Tensor, run: Run) -> torch.Tensor:
        x, w, b = run.prec.operands(x, self.weight, self.bias)
        return F.conv3d(x, w, b, padding=self.k // 2)


class UpConv(Conv):
    """nearest upsample by 2, then the 3x3x3 conv (reference UpBlock's
    `block.3` and `block.4`)."""

    def forward(self, x: torch.Tensor, run: Run) -> torch.Tensor:
        return super().forward(F.interpolate(x, scale_factor=2, mode="nearest"), run)


class Lin(nn.Module):
    def __init__(self, fi: int, fo: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(fo, fi))
        self.bias = nn.Parameter(torch.empty(fo))

    def forward(self, x: torch.Tensor, run: Run) -> torch.Tensor:
        x, w, b = run.prec.operands(x, self.weight, self.bias)
        return F.linear(x, w, b)


class BN(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.empty(c))
        self.register_buffer("running_var", torch.empty(c))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor, run: Run) -> torch.Tensor:
        view = (1, -1, 1, 1, 1)
        if not run.train:
            mean, var = self.running_mean, self.running_var
        else:
            axes = (0, 2, 3, 4)
            n = x.numel() // x.shape[1]
            sums = torch.cat([x.sum(dim=axes), (x * x).sum(dim=axes)])
            if run.reduce is not None:
                sums = run.reduce(sums)
                n = n * run.ranks
            mean, ex2 = (sums / n).chunk(2)
            var = (ex2 - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.mul_(BN_KEEP).add_(mean.detach(), alpha=1 - BN_KEEP)
                self.running_var.mul_(BN_KEEP).add_(var.detach(), alpha=1 - BN_KEEP)
                self.num_batches_tracked += 1
        scale = torch.rsqrt(var + BN_EPS) * self.weight
        return (x - mean.view(view)) * scale.view(view) + self.bias.view(view)


def _mods(**kw) -> nn.ModuleDict:
    """A container whose children sit under the reference's indices."""
    return nn.ModuleDict(kw)


def dropout(x: torch.Tensor, rate: float, run: Run) -> torch.Tensor:
    if not run.train or rate == 0.0 or run.drop is None:
        return x
    keep = 1.0 - rate
    return torch.where(run.drop(tuple(x.shape)) < keep, x / keep, torch.zeros_like(x))


def act(x: torch.Tensor, name: str, slope: float) -> torch.Tensor:
    return F.leaky_relu(x, slope) if name == "leaky_relu" else F.relu(x)


class Residual(nn.Module):
    """Reference models/models.py:8-80: conv -> BN -> act -> pool or
    upsample -> conv -> BN, the input added back (through a 1x1 projection
    when the widths differ) and the activation applied at stride 1; at
    stride 2 the second BN is followed by the activation and nothing is
    added."""

    def __init__(self, ci: int, co: int, stride: int, up: bool):
        super().__init__()
        mid = ci if up else co
        second = UpConv if up and stride == 2 else Conv
        self.block = _mods(**{"0": Conv(ci, mid, 3, False), "1": BN(mid),
                              "4": second(mid, co, 3, False), "5": BN(co)})
        self.shortcut = Conv(ci, co, 1, True) if stride == 1 and ci != co else None
        self.stride, self.up = stride, up

    def forward(self, x, run: Run, a: Callable) -> torch.Tensor:
        b = self.block
        h = a(b["1"](b["0"](x, run), run))
        if self.stride == 2 and not self.up:
            h = F.avg_pool3d(h, 2)
        h = b["5"](b["4"](h, run), run)
        if self.stride == 2:
            return a(h)
        return a(h + (x if self.shortcut is None else self.shortcut(x, run)))


class SpatialVAE(nn.Module):
    """`SoftIntroVAE(in_ch, block_setting)` of reference z-1200main.py:158:
    encoder stem, residual stages and 1x1 mu / logvar heads to a one-channel
    latent map; the mirrored decoder."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        a = cfg["act"]
        self.slope, self.body, self.tail = a["negative_slope"], a["body_act"], a["decoder_tail_act"]
        self.drops = (a["stem_dropout"], a["dec_in_dropout"], a["dec_out_dropout"])
        self.clip = cfg.get("logvar_clip")
        setting = [tuple(line) for line in cfg["block_setting"]]
        c0 = cfg["in_ch"]
        enc: List[nn.Module] = [_mods(**{"0": Conv(1, c0, 3, True), "1": BN(c0)})]
        self.enc_strides, ch = [], c0
        for c, n, s in setting:
            for i in range(n):
                stride = s if i == 0 else 1
                enc.append(nn.ModuleList([Residual(ch, c, stride, up=False)]))
                ch = c
        self.encoder = nn.Module()
        self.encoder.blocks = nn.ModuleList(enc)
        self.encoder.mu = Conv(ch, 1, 1, True)
        self.encoder.var = Conv(ch, 1, 1, True)
        ch = setting[-1][0]
        dec: List[nn.Module] = [_mods(**{"0": Conv(1, ch, 1, True), "1": BN(ch)})]
        rev = setting[::-1]
        for i, (c, n, s) in enumerate(rev):
            nc = c0 if i == len(rev) - 1 else rev[i + 1][0]
            for j in range(n):
                last = j == n - 1
                out = nc if last else c
                dec.append(nn.ModuleList([Residual(ch, out, s if last else 1, up=True)]))
                ch = out
        dec.append(_mods(**{"0": Conv(ch, 1, 3, True)}))
        self.decoder = nn.Module()
        self.decoder.blocks = nn.ModuleList(dec)
        d, h, w = cfg["input_shape"]
        for _, _, s in setting:
            d, h, w = d // s, h // s, w // s
        self.latent_shape = (1, d, h, w)
        self.zero_init = ["encoder.var.weight"] if cfg.get("logvar_head_zero_init") else []

    def _a(self, x):
        return act(x, self.body, self.slope)

    def encode(self, x: torch.Tensor, run: Run):
        stem = self.encoder.blocks[0]
        h = dropout(self._a(stem["1"](stem["0"](x, run), run)), self.drops[0], run)
        for blk in self.encoder.blocks[1:]:
            h = blk[0](h, run, self._a)
        mu, logvar = self.encoder.mu(h, run), self.encoder.var(h, run)
        if self.clip is not None:
            logvar = logvar.clamp(*self.clip)
        return mu, logvar

    def decode(self, z: torch.Tensor, run: Run) -> torch.Tensor:
        h = z.reshape((z.shape[0],) + self.latent_shape)
        head = self.decoder.blocks[0]
        h = dropout(self._a(head["1"](head["0"](h, run), run)), self.drops[1], run)
        for blk in self.decoder.blocks[1:-1]:
            h = blk[0](h, run, self._a)
        h = self.decoder.blocks[-1]["0"](h, run)
        return dropout(act(h, self.tail, self.slope), self.drops[2], run)


class FCVAE(nn.Module):
    """`mymodel.SoftIntroVAE(f, s, t, fo, z)` of reference 600z_main.py:176:
    four pooled stages with two skip additions to a (fo, D/16, H/16, W/16)
    bottleneck, one Linear to (mu, logvar) over the (C, D, H, W)-ordered
    features; the decoder's Linear + ReLU, skip and upsampling stages and a
    conv + ReLU output."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        a = cfg["act"]
        self.slope, self.body = a["negative_slope"], a["body_act"]
        self.clip = cfg.get("logvar_clip")
        f, s, t, fo, z = (cfg[k] for k in ("first_ch", "second_ch", "third_ch", "forth_ch", "z_ch"))
        d, h, w = (v // 16 for v in cfg["input_shape"])
        self.bottleneck = (fo, d, h, w)
        self.z = z

        def unit2(ci, cm, co):
            return _mods(**{"0": Conv(ci, cm, 3, True), "1": BN(cm),
                            "3": Conv(cm, co, 3, True), "4": BN(co)})

        def cb(ci, co):
            return _mods(**{"0": Conv(ci, co, 3, True), "1": BN(co)})

        def up(ci, co):
            return _mods(**{"0": Conv(ci, ci, 3, True), "1": BN(ci),
                            "4": UpConv(ci, co, 3, True), "5": BN(co)})

        e = nn.Module()
        e.block1, e.block2, e.block3 = unit2(1, f, f), unit2(f, f, s), unit2(s, s, t)
        e.block4short, e.block5 = cb(t, t), cb(t, t)
        e.block6 = _mods(**{"0": Conv(t, t, 3, True), "1": BN(t),
                            "4": Conv(t, fo, 3, True), "5": BN(fo)})
        e.block7 = unit2(fo, fo, fo)
        e.fc = Lin(fo * d * h * w, 2 * z)
        self.encoder = e
        dd = nn.Module()
        dd.dfc = _mods(**{"0": Lin(z, fo * d * h * w)})
        dd.block1, dd.block2u, dd.block3 = unit2(fo, fo, fo), up(fo, t), unit2(t, t, t)
        dd.block4u, dd.block5u, dd.block6u = up(t, s), up(s, f), up(f, f)
        dd.last_block = _mods(**{"0": Conv(f, 1, 3, True)})
        self.decoder = dd
        self.latent_shape = (z,)
        self.zero_init = ["encoder.fc.weight:rows_second_half"] \
            if cfg.get("logvar_head_zero_init") else []

    def _a(self, x):
        return act(x, self.body, self.slope)

    def _cba(self, m, i, x, run, with_act=True):
        """conv `m[i]`, BN `m[i + 1]`, and the activation."""
        y = m[str(i + 1)](m[str(i)](x, run), run)
        return self._a(y) if with_act else y

    def _skip(self, m, x, run):
        """x + (conv-BN-act, conv-BN), then the activation."""
        return self._a(x + self._cba(m, 3, self._cba(m, 0, x, run), run, with_act=False))

    def _up(self, m, x, run):
        return self._cba(m, 4, self._cba(m, 0, x, run), run)

    def encode(self, x: torch.Tensor, run: Run):
        e = self.encoder
        h = x
        for blk in (e.block1, e.block2, e.block3):
            h = F.avg_pool3d(self._cba(blk, 3, self._cba(blk, 0, h, run), run), 2)
        h = self._cba(e.block4short, 0, h, run)
        h = self._a(h + self._cba(e.block5, 0, h, run))
        h = self._cba(e.block6, 0, h, run)
        h = self._cba(e.block6, 4, F.avg_pool3d(h, 2), run)
        h = self._skip(e.block7, h, run)
        mu, logvar = e.fc(h.reshape(h.shape[0], -1), run).chunk(2, dim=1)
        if self.clip is not None:
            logvar = logvar.clamp(*self.clip)
        return mu, logvar

    def decode(self, z: torch.Tensor, run: Run) -> torch.Tensor:
        d = self.decoder
        y = F.relu(d.dfc["0"](z.reshape(z.shape[0], -1), run)).reshape((-1,) + self.bottleneck)
        y = self._skip(d.block1, y, run)
        y = self._up(d.block2u, y, run)
        y = self._skip(d.block3, y, run)
        for blk in (d.block4u, d.block5u, d.block6u):
            y = self._up(blk, y, run)
        return F.relu(d.last_block["0"](y, run))


def make_reference(cfg: dict, device="cpu") -> nn.Module:
    """The reference model of configuration file `cfg` (its parameters and
    buffers uninitialised: `load_state_dict` fills them)."""
    cls = SpatialVAE if cfg["family"] == "spatial" else FCVAE
    with torch.device(device):
        return cls(cfg)


def leaf_kind(model: nn.Module, key: str) -> str:
    """What a state-dict entry is: "conv" or "linear" weight, "bias" of a
    conv or Linear, "bn_weight", "bn_bias", "running_mean", "running_var"
    or "count"."""
    owner, _, leaf = key.rpartition(".")
    mod = model.get_submodule(owner)
    if isinstance(mod, BN):
        return {"weight": "bn_weight", "bias": "bn_bias", "running_mean": "running_mean",
                "running_var": "running_var", "num_batches_tracked": "count"}[leaf]
    if leaf == "bias":
        return "bias"
    return "linear" if isinstance(mod, Lin) else "conv"


def fan_in(w_shape) -> int:
    return int(math.prod(w_shape[1:]))
