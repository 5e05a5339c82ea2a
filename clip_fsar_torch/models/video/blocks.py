"""Video-backbone building blocks (counterpart of
clip_fsar_tpu/models/video/blocks.py).

Layout: the JAX package computes on NDHWC video [B, T, H, W, C].  Here a
video activation is the NCDHW view [B, C, T, H, W] of that same memory
(``channels_last_3d``), so every conv runs on the NDHWC layout and a
BatchNorm's channels are dim 1.  ``to_ncdhw`` / ``to_ndhwc`` are free
permutes between the two views.

Module and parameter names are the JAX package's flax names (``conv1``,
``conv2.res_1.conv_branch.a_bn``, ...) with torch's ``weight`` for flax's
``kernel`` / ``scale`` (models/video/convert.py), so the reference's
parameter groups (train/optimizer.py) classify every parameter as the JAX
package does.  Block hyperparameters come from ``resolve_block_params``, the
JAX package's per [stage, block] resolution.

Flax infers a layer's input channels at its first call; torch needs them
when the layer is made, so every block here takes its input channels
(``cin``) from the caller, which knows them from the config.

Two behaviours of the JAX package that differ from the upstream framework
are kept: ``bn`` never trains (the classification model never passes
``train_bn``, so every BatchNorm normalizes with its running statistics) and
it ignores ``BN.EPS`` (eps 1e-5 always; ``BlockParams.bn_eps`` is read and
unused, as there).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from clip_fsar_torch.models.clip.model import Dense
from clip_fsar_torch.models.heads.common import dropout
from clip_fsar_torch.models.init import fc_init_, lecun_normal_, msra_fill_
from clip_fsar_torch.utils.registry import BRANCH_REGISTRY, HEAD_REGISTRY, STEM_REGISTRY


def to_ncdhw(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, W, C] -> the [B, C, T, H, W] view of the same memory."""
    return x.permute(0, 4, 1, 2, 3)


def to_ndhwc(x: torch.Tensor) -> torch.Tensor:
    """[B, C, T, H, W] -> [B, T, H, W, C]."""
    return x.permute(0, 2, 3, 4, 1)


@dataclasses.dataclass(frozen=True)
class BlockParams:
    """Resolved per-block conv hyperparameters."""

    stage_id: int
    block_id: int
    dim_in: int
    num_filters: int
    kernel_size: Tuple[int, int, int]
    stride: Tuple[int, int, int]
    downsampling: bool
    transformation: str  # simple_block | bottleneck
    expansion_ratio: Optional[int]
    bn_eps: float
    bn_mmt: float
    branch_cfg: Any  # cfg.VIDEO.BACKBONE.BRANCH
    num_frames: int


def resolve_block_params(cfg, stage_id: int, block_id: int) -> BlockParams:
    bb = cfg.VIDEO.BACKBONE
    if block_id == 0:
        dim_in = int(bb.NUM_FILTERS[stage_id - 1])
        downsampling = bool(bb.DOWNSAMPLING[stage_id])
        down_t = bool(bb.DOWNSAMPLING_TEMPORAL[stage_id])
    else:
        dim_in = int(bb.NUM_FILTERS[stage_id])
        downsampling = False
        down_t = False
    if downsampling:
        stride = (2, 2, 2) if down_t else (1, 2, 2)
    else:
        stride = (1, 1, 1)
    depth = bb.DEPTH
    if isinstance(depth, str):
        transformation = "bottleneck"
    else:
        transformation = "simple_block" if int(depth) <= 34 else "bottleneck"
    return BlockParams(
        stage_id=stage_id,
        block_id=block_id,
        dim_in=dim_in,
        num_filters=int(bb.NUM_FILTERS[stage_id]),
        kernel_size=tuple(bb.KERNEL_SIZE[stage_id]),
        stride=stride,
        downsampling=downsampling,
        transformation=transformation,
        expansion_ratio=int(bb.get("EXPANSION_RATIO", 2) or 2),
        bn_eps=float(cfg.BN.get("EPS", 1e-5)),
        bn_mmt=float(cfg.BN.get("MOMENTUM", 0.1)),
        branch_cfg=bb.get("BRANCH", None),
        num_frames=int(cfg.DATA.NUM_INPUT_FRAMES),
    )


def same_padding(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int]) -> torch.Tensor:
    """Pad [B, C, T, H, W] as flax's padding "SAME" does for this kernel and
    stride (the larger half after), for the embedding stems."""
    pads = []
    for n, k, s in zip(x.shape[2:], kernel, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    if not any(lo or hi for lo, hi in pads):
        return x
    return F.pad(x, [v for lo_hi in reversed(pads) for v in lo_hi])


class Conv3d(nn.Module):
    """3-D conv with explicit symmetric padding (k // 2 per axis unless given),
    computing in its input's dtype (flax ``nn.Conv(dtype=...)`` casts its
    float32 kernel the same way).  ``weight`` is torch's [out, in / groups,
    kt, kh, kw]; ``init`` names its initializer (``msra``: the reference's
    c2_msra_fill, ``lecun``: flax's default, ``zeros``)."""

    def __init__(self, cin: int, cout: int, kernel: Sequence[int], stride: Sequence[int] = (1, 1, 1), bias: bool = False,
                 groups: int = 1, padding: Optional[Sequence[int]] = None, init: str = "msra"):
        super().__init__()
        kernel = tuple(int(k) for k in kernel)
        self.stride = tuple(int(s) for s in stride)
        self.padding = tuple(k // 2 for k in kernel) if padding is None else tuple(padding)
        self.groups = groups
        self.init = init
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, *kernel))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(dtype=x.dtype, memory_format=torch.channels_last_3d)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv3d(x, w, b, self.stride, self.padding, 1, self.groups)

    @torch.no_grad()
    def init_own_parameters(self, g: torch.Generator) -> None:
        if self.init == "msra":
            msra_fill_(self.weight, g)
        elif self.init == "lecun":
            lecun_normal_(self.weight, g)
        else:
            self.weight.zero_()
        if self.bias is not None:
            self.bias.zero_()


def conv3d(cin: int, cout: int, kernel: Sequence[int], stride: Sequence[int] = (1, 1, 1), bias: bool = False, groups: int = 1) -> Conv3d:
    return Conv3d(cin, cout, kernel, stride, bias=bias, groups=groups)


class BatchNorm(nn.Module):
    """BatchNorm of a video activation [B, C, ...] on its running statistics,
    in float32, output in the input's dtype.  ``centered`` is flax's own
    ``nn.BatchNorm`` arithmetic, (x - mean) * (scale * rsqrt(var + eps)) +
    bias; otherwise the JAX package's BatchNorm, x * a + b with the folded
    a = scale * rsqrt(var + eps), b = bias - mean * a.  ``zero_init`` starts
    the scale at 0 (TAdaConv's pooled branch)."""

    def __init__(self, channels: int, eps: float = 1e-5, centered: bool = False, zero_init: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.eps, self.centered, self.zero_init = eps, centered, zero_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = self.weight * torch.rsqrt(self.running_var + self.eps)
        if self.centered:
            y = (x.float() - self.running_mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        else:
            y = x.float() * mul.view(shape) + (self.bias - self.running_mean * mul).view(shape)
        return y.to(x.dtype)

    @torch.no_grad()
    def init_own_parameters(self, g: torch.Generator) -> None:
        self.weight.fill_(0.0 if self.zero_init else 1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)


def bn(channels: int) -> BatchNorm:
    """The JAX package's ``bn``: running statistics, eps 1e-5 whatever BN.EPS says."""
    return BatchNorm(channels)


class Base3DBlock(nn.Module):
    """Residual block: shortcut (a 1x1x1 conv + bn where the channels or the
    stride change) + the registered branch, relu."""

    def __init__(self, cfg, p: BlockParams, cin: int):
        super().__init__()
        self.has_shortcut = p.dim_in != p.num_filters or p.downsampling
        if self.has_shortcut:
            self.short_cut = conv3d(cin, p.num_filters, (1, 1, 1), p.stride)
            self.short_cut_bn = bn(p.num_filters)
        self.conv_branch = BRANCH_REGISTRY.get(cfg.VIDEO.BACKBONE.BRANCH.NAME)(cfg, p, cin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        short_cut = self.short_cut_bn(self.short_cut(x)) if self.has_shortcut else x
        return F.relu(short_cut + self.conv_branch(x))


class Base3DResStage(nn.Module):
    """A stage of blocks ``res_1`` .. ``res_n`` and an optional trailing
    NonLocal (VIDEO.BACKBONE.NONLOCAL.STAGES holds stage_idx + 1)."""

    def __init__(self, cfg, num_blocks: int, stage_idx: int, cin: int):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            p = resolve_block_params(cfg, stage_idx, i)
            self.add_module(f"res_{i + 1}", Base3DBlock(cfg, p, cin))
            cin = p.num_filters
        nl = cfg.VIDEO.BACKBONE.get("NONLOCAL", None)
        self.has_nonlocal = bool(nl and nl.get("ENABLE", False) and (stage_idx + 1) in list(nl.get("STAGES", [])))
        if self.has_nonlocal:  # "nonlocal", the flax name, is a python keyword: reached by getattr
            self.add_module("nonlocal", BRANCH_REGISTRY.get("NonLocal")(cfg, resolve_block_params(cfg, stage_idx, num_blocks - 1), cin))
        self.out_channels = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_blocks):
            x = getattr(self, f"res_{i + 1}")(x)
        return getattr(self, "nonlocal")(x) if self.has_nonlocal else x


def _stem_stride(bb) -> Tuple[int, int, int]:
    if bb.DOWNSAMPLING[0]:
        return (2, 2, 2) if bool(bb.DOWNSAMPLING_TEMPORAL[0]) else (1, 2, 2)
    return (1, 1, 1)


def _input_channels(cfg) -> int:
    return int(cfg.DATA.get("NUM_INPUT_CHANNELS", 3))


# ---------------------------------------------------------------------------
# stems
# ---------------------------------------------------------------------------


@STEM_REGISTRY.register(name="Base2DStem")
class Base2DStem(nn.Module):
    """Per-frame 2D conv stem: a (1, kh, kw) conv, bn, relu."""

    def __init__(self, cfg):
        super().__init__()
        bb = cfg.VIDEO.BACKBONE
        k = bb.KERNEL_SIZE[0]
        self.out_channels = int(bb.NUM_FILTERS[0])
        stride = (1, 2, 2) if bb.DOWNSAMPLING[0] else (1, 1, 1)
        self.a = conv3d(_input_channels(cfg), self.out_channels, (1, k[1], k[2]), stride)
        self.a_bn = bn(self.out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.a_bn(self.a(x)))


@STEM_REGISTRY.register(name="Base3DStem")
class Base3DStem(nn.Module):
    """Full 3D conv stem."""

    def __init__(self, cfg):
        super().__init__()
        bb = cfg.VIDEO.BACKBONE
        self.out_channels = int(bb.NUM_FILTERS[0])
        self.a = conv3d(_input_channels(cfg), self.out_channels, tuple(bb.KERNEL_SIZE[0]), _stem_stride(bb))
        self.a_bn = bn(self.out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.a_bn(self.a(x)))


@STEM_REGISTRY.register(name="R2Plus1DStem")
class R2Plus1DStem(nn.Module):
    """(2+1)D factorized stem: spatial 1 x kh x kw then temporal kt x 1 x 1,
    the mid width matching the 3D conv's parameter count."""

    def __init__(self, cfg):
        super().__init__()
        bb = cfg.VIDEO.BACKBONE
        k = bb.KERNEL_SIZE[0]
        f = self.out_channels = int(bb.NUM_FILTERS[0])
        dim_in = int(bb.get("NUM_INPUT_CHANNELS", 3))
        stride = _stem_stride(bb)
        mid = int((k[0] * k[1] * k[2] * dim_in * f) / (k[1] * k[2] * dim_in + k[0] * f))
        self.a1 = conv3d(_input_channels(cfg), mid, (1, k[1], k[2]), (1, stride[1], stride[2]))
        self.a1_bn = bn(mid)
        self.a2 = conv3d(mid, f, (k[0], 1, 1), (stride[0], 1, 1))
        self.a2_bn = bn(f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.a1_bn(self.a1(x)))
        return F.relu(self.a2_bn(self.a2(x)))


@STEM_REGISTRY.register(name="DownSampleStem")
class DownSampleStem(nn.Module):
    """Base3DStem, then a (1, 3, 3) max-pool at stride (1, 2, 2) padded by -inf."""

    def __init__(self, cfg):
        super().__init__()
        self.stem = Base3DStem(cfg)
        self.out_channels = self.stem.out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool3d(self.stem(x), (1, 3, 3), (1, 2, 2), (0, 1, 1))


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------


class _Head(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        h = cfg.VIDEO.HEAD
        self.rate = float(h.get("DROPOUT_RATE", 0) or 0)
        self.activation = h.get("ACTIVATION", "softmax")

    @torch.no_grad()
    def init_own_parameters(self, g: torch.Generator) -> None:
        for m in self.children():
            if isinstance(m, Dense):
                fc_init_(m.weight, g)
                m.bias.zero_()


@HEAD_REGISTRY.register(name="BaseHead")
class BaseHead(_Head):
    """GAP -> dropout -> FC in float32 (+ the activation at eval)."""

    def __init__(self, cfg, dim_in: int):
        super().__init__(cfg)
        self.out = Dense(dim_in, int(cfg.VIDEO.HEAD.NUM_CLASSES))

    def forward(self, x: torch.Tensor, train: bool = True, generator: Optional[torch.Generator] = None):
        x = dropout(x.mean(dim=(2, 3, 4)), self.rate, generator if train else None)  # [B, C]
        logits = self.out(x.float())
        if not train:
            if self.activation == "softmax":
                return torch.softmax(logits, dim=-1), x
            if self.activation == "sigmoid":
                return torch.sigmoid(logits), x
        return logits, x


@HEAD_REGISTRY.register(name="BaseHeadx2")
class BaseHeadx2(_Head):
    """Two FC heads over shared features (EPIC verb + noun)."""

    def __init__(self, cfg, dim_in: int):
        super().__init__(cfg)
        n1, n2 = (int(n) for n in cfg.VIDEO.HEAD.NUM_CLASSES)
        self.out1 = Dense(dim_in, n1)
        self.out2 = Dense(dim_in, n2)

    def forward(self, x: torch.Tensor, train: bool = True, generator: Optional[torch.Generator] = None):
        x = dropout(x.mean(dim=(2, 3, 4)), self.rate, generator if train else None)
        a, b = self.out1(x.float()), self.out2(x.float())
        if not train and self.activation == "softmax":
            a, b = torch.softmax(a, -1), torch.softmax(b, -1)
        return (a, b), x
