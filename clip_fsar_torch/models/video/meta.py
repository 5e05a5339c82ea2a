"""Backbone meta-architectures (counterpart of
clip_fsar_tpu/models/video/meta.py): ResNet3D, Inception3D (S3D / S3D-G),
Identity and Slowfast, on NCDHW video activations.  Each backbone says what
it hands the head in ``out_channels`` (a list of two for SlowFast).

SimpleLocalizationConv is the localization task's backbone: grouped temporal
convs over window features [B, C, T].
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from clip_fsar_torch.models.video.blocks import Base3DResStage, bn, conv3d
from clip_fsar_torch.models.init import lecun_normal_
from clip_fsar_torch.models.video.branches import SelfGating
from clip_fsar_torch.utils.registry import BACKBONE_REGISTRY, BRANCH_REGISTRY, STEM_REGISTRY

_N_CONV_RESNET = {
    10: (1, 1, 1, 1),
    16: (2, 2, 2, 1),
    18: (2, 2, 2, 2),
    26: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


@BACKBONE_REGISTRY.register(name="ResNet3D")
class ResNet3D(nn.Module):
    """Stem ``conv1`` + four res-stages ``conv2`` .. ``conv5``."""

    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = STEM_REGISTRY.get(cfg.VIDEO.BACKBONE.STEM.NAME)(cfg)
        cin = self.conv1.out_channels
        self.num_stages = len(_N_CONV_RESNET[int(cfg.VIDEO.BACKBONE.DEPTH)])
        for stage, n in enumerate(_N_CONV_RESNET[int(cfg.VIDEO.BACKBONE.DEPTH)], start=1):
            block = Base3DResStage(cfg, n, stage, cin)
            self.add_module(f"conv{stage + 1}", block)
            cin = block.out_channels
        self.out_channels = cin

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        x = self.conv1(x)
        for stage in range(1, self.num_stages + 1):
            x = getattr(self, f"conv{stage + 1}")(x)
        return x


class InceptionBaseConv3D(nn.Module):
    """conv (k, k, k) + bn + relu."""

    def __init__(self, cin: int, out_planes: int, kernel_size: int, stride: int = 1):
        super().__init__()
        self.conv = conv3d(cin, out_planes, (kernel_size,) * 3, (stride,) * 3)
        self.bn = bn(out_planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class InceptionBlock3D(nn.Module):
    """Four-branch inception block, with self-gating of each branch under
    VIDEO.BACKBONE.BRANCH.GATING; out channels o[0] + o[2] + o[4] + o[5]."""

    def __init__(self, cfg, cin: int, out_planes: Sequence[int], dtype: torch.dtype):
        super().__init__()
        o = list(out_planes)
        branch = cfg.VIDEO.BACKBONE.get("BRANCH")
        self.gating = bool(branch.get("GATING", False)) if branch else False
        st = BRANCH_REGISTRY.get(cfg.VIDEO.BACKBONE.BRANCH.NAME)
        self.branch0 = InceptionBaseConv3D(cin, o[0], 1, 1)
        self.branch1_0 = InceptionBaseConv3D(cin, o[1], 1, 1)
        self.branch1_1 = st(cfg, o[1], o[2], 3, 1, 1)
        self.branch2_0 = InceptionBaseConv3D(cin, o[3], 1, 1)
        self.branch2_1 = st(cfg, o[3], o[4], 3, 1, 1)
        self.branch3 = InceptionBaseConv3D(cin, o[5], 1, 1)
        if self.gating:
            self.gating_b0 = SelfGating(o[0], dtype)
            self.gating_b1 = SelfGating(o[2], dtype)
            self.gating_b2 = SelfGating(o[4], dtype)
            self.gating_b3 = SelfGating(o[5], dtype)
        self.out_channels = o[0] + o[2] + o[4] + o[5]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b0 = self.branch0(x)
        b1 = self.branch1_1(self.branch1_0(x))
        b2 = self.branch2_1(self.branch2_0(x))
        b3 = self.branch3(F.max_pool3d(x, 3, 1, 1))
        if self.gating:
            b0, b1, b2, b3 = self.gating_b0(b0), self.gating_b1(b1), self.gating_b2(b2), self.gating_b3(b3)
        return torch.cat([b0, b1, b2, b3], dim=1)


_INCEPTION = (
    ("Mixed_3b", [64, 96, 128, 16, 32, 32]),
    ("Mixed_3c", [128, 128, 192, 32, 96, 64]),
    ("pool", ((3, 3, 3), (2, 2, 2), (1, 1, 1))),
    ("Mixed_4b", [192, 96, 208, 16, 48, 64]),
    ("Mixed_4c", [160, 112, 224, 24, 64, 64]),
    ("Mixed_4d", [128, 128, 256, 24, 64, 64]),
    ("Mixed_4e", [112, 144, 288, 32, 64, 64]),
    ("Mixed_4f", [256, 160, 320, 32, 128, 128]),
    ("pool", ((2, 2, 2), (2, 2, 2), (0, 0, 0))),
    ("Mixed_5b", [256, 160, 320, 32, 128, 128]),
    ("Mixed_5c", [384, 192, 384, 48, 128, 128]),
)


@BACKBONE_REGISTRY.register(name="Inception3D")
class Inception3D(nn.Module):
    """S3D / S3D-G: the STConv3d stem, max-pools padded by -inf, and the
    Mixed blocks."""

    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        st = BRANCH_REGISTRY.get(cfg.VIDEO.BACKBONE.BRANCH.NAME)
        self.Conv_1a = BRANCH_REGISTRY.get(cfg.VIDEO.BACKBONE.STEM.NAME)(cfg, int(cfg.DATA.NUM_INPUT_CHANNELS), 64, 7, 2, 3)
        self.Conv_2b = InceptionBaseConv3D(64, 64, 1, 1)
        self.Conv_2c = st(cfg, 64, 192, 3, 1, 1)
        cin = 192
        self.layout = []
        for name, spec in _INCEPTION:
            if name == "pool":
                self.layout.append(spec)
                continue
            block = InceptionBlock3D(cfg, cin, spec, dtype)
            self.add_module(name, block)
            self.layout.append(name)
            cin = block.out_channels
        self.out_channels = cin

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        pool = lambda y: F.max_pool3d(y, (1, 3, 3), (1, 2, 2), (0, 1, 1))  # noqa: E731
        x = pool(self.Conv_1a(x))
        x = pool(self.Conv_2c(self.Conv_2b(x)))
        for item in self.layout:
            x = F.max_pool3d(x, *item) if isinstance(item, tuple) else getattr(self, item)(x)
        return x


@BACKBONE_REGISTRY.register(name="SimpleLocalizationConv")
class SimpleLocalizationConv(nn.Module):
    """VIDEO.BACKBONE_LAYER grouped temporal convs (k = 3, padding 1,
    VIDEO.BACKBONE_GROUPS_NUM groups, VIDEO.DIM1D wide), each followed by a
    ReLU, over window features [B, C, T] (the localization task's backbone;
    float32, as in the JAX package)."""

    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(cfg.VIDEO.DIM1D)
        self.layers = int(cfg.VIDEO.BACKBONE_LAYER)
        groups = int(cfg.VIDEO.BACKBONE_GROUPS_NUM)
        cin = int(cfg.DATA.NUM_INPUT_CHANNELS)
        for i in range(self.layers):
            self.add_module(f"conv_{i}", nn.Conv1d(cin if i == 0 else hidden, hidden, 3, padding=1, groups=groups))
        self.out_channels = hidden if self.layers else cin

    def init_own_parameters(self, g: torch.Generator) -> None:
        """flax's defaults: lecun normal kernels, zero biases."""
        for i in range(self.layers):
            conv = getattr(self, f"conv_{i}")
            lecun_normal_(conv.weight, g)
            conv.bias.zero_()

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        for i in range(self.layers):
            x = F.relu(getattr(self, f"conv_{i}")(x))
        return x


@BACKBONE_REGISTRY.register(name="Identity")
class Identity(nn.Module):
    def __init__(self, cfg=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_channels = int(cfg.VIDEO.BACKBONE.get("NUM_OUT_FEATURES", 0) or 0) if cfg is not None else 0

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return x


class FuseFastToSlow(nn.Module):
    """Lateral fast -> slow fusion: a (k, 1, 1) conv at temporal stride alpha
    from the fast features, bn, relu, concatenated to the slow features."""

    def __init__(self, cin_fast: int, dim_in: int, ratio: int, kernel: int, alpha: int):
        super().__init__()
        self.conv_f2s = conv3d(cin_fast, dim_in * ratio, (kernel, 1, 1), (alpha, 1, 1))
        self.bn = bn(dim_in * ratio)
        self.out_channels = dim_in * ratio

    def forward(self, x_s: torch.Tensor, x_f: torch.Tensor):
        fuse = F.relu(self.bn(self.conv_f2s(x_f)))
        return torch.cat([x_s, fuse], dim=1), x_f


def pathway_cfg(cfg, idx: int):
    """The config of SlowFast pathway ``idx`` (0 slow, 1 fast): KERNEL_SIZE
    and TEMPORAL_CONV_BOTTLENECK take their [slow, fast] entry, the fast
    pathway has NUM_FILTERS / BETA."""
    p = cfg.deep_copy()
    bb = p.VIDEO.BACKBONE
    ks = bb.get("KERNEL_SIZE", None)
    if ks is not None and len(ks) == 2 and ks[0] and isinstance(ks[0][0], (list, tuple)):
        bb.KERNEL_SIZE = ks[idx]
    tcb = bb.get("TEMPORAL_CONV_BOTTLENECK", None)
    if tcb is not None and len(tcb) == 2 and isinstance(tcb[0], (list, tuple)):
        bb.TEMPORAL_CONV_BOTTLENECK = tcb[idx]
    if idx == 1:
        bb.ADD_FUSION_CHANNEL = False
        bb.NUM_FILTERS = [max(f // int(cfg.VIDEO.BACKBONE.SLOWFAST.BETA), 1) for f in bb.NUM_FILTERS]
    else:
        bb.ADD_FUSION_CHANNEL = True
    return p


@BACKBONE_REGISTRY.register(name="Slowfast")
class Slowfast(nn.Module):
    """Two-pathway SlowFast.  The input is a pair [slow, fast] or one tensor,
    whose slow pathway is then every alpha-th frame (x[:, :, ::alpha]);
    returns the pair of feature maps."""

    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        sf = cfg.VIDEO.BACKBONE.SLOWFAST
        self.alpha = int(sf.ALPHA)
        ratio = int(sf.get("CONV_CHANNEL_RATIO", 2))
        kernel = int(sf.get("KERNEL_SIZE", 5))
        slow_cfg, fast_cfg = pathway_cfg(cfg, 0), pathway_cfg(cfg, 1)
        stem = STEM_REGISTRY.get(cfg.VIDEO.BACKBONE.STEM.NAME)
        self.slow_stem, self.fast_stem = stem(slow_cfg), stem(fast_cfg)
        cs, cf = self.slow_stem.out_channels, self.fast_stem.out_channels
        self.num_stages = len(_N_CONV_RESNET[int(cfg.VIDEO.BACKBONE.DEPTH)])
        for stage, n in enumerate(_N_CONV_RESNET[int(cfg.VIDEO.BACKBONE.DEPTH)], start=1):
            fuse = FuseFastToSlow(cf, int(fast_cfg.VIDEO.BACKBONE.NUM_FILTERS[stage - 1]), ratio, kernel, self.alpha)
            self.add_module(f"fuse_{stage}", fuse)
            slow = Base3DResStage(slow_cfg, n, stage, cs + fuse.out_channels)
            fast = Base3DResStage(fast_cfg, n, stage, cf)
            self.add_module(f"slow_conv{stage + 1}", slow)
            self.add_module(f"fast_conv{stage + 1}", fast)
            cs, cf = slow.out_channels, fast.out_channels
        self.out_channels = [cs, cf]

    def forward(self, x, generator=None):
        if isinstance(x, (list, tuple)):
            x_slow, x_fast = x[0], x[1]
        else:
            x_slow, x_fast = x[:, :, :: self.alpha], x
        s, f = self.slow_stem(x_slow), self.fast_stem(x_fast)
        for stage in range(1, self.num_stages + 1):
            s, f = getattr(self, f"fuse_{stage}")(s, f)
            s = getattr(self, f"slow_conv{stage + 1}")(s)
            f = getattr(self, f"fast_conv{stage + 1}")(f)
        return [s, f]
