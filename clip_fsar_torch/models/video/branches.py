"""Registered conv branches (counterpart of
clip_fsar_tpu/models/video/branches.py).

Every branch takes an NCDHW video activation (channels_last_3d memory),
the resolved BlockParams and its input channels ``cin``.  As in the JAX
package:

  * TAdaConv2d's per-(clip, frame) calibration of the base weight's input
    channels is folded into the activations, x * alpha, before one [B*T]
    conv (the reference groups B*T 2D convs instead); RouteFuncMLP's last
    conv starts at zero, so a fresh model calibrates by exactly 1;
  * TAdaConv's pooled branch averages with the padded zeros counted
    (``count_include_pad``) and normalizes with flax's own ``nn.BatchNorm``
    (``b_avgpool_bn``, scale starting at 0);
  * channel-separated (CSN) convs are grouped convs;
  * NonLocal's attention softmax runs in float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from clip_fsar_torch.models.clip.model import Dense
from clip_fsar_torch.models.video.blocks import BatchNorm, BlockParams, Conv3d, bn, conv3d
from clip_fsar_torch.ops import pool3d
from clip_fsar_torch.utils.registry import BRANCH_REGISTRY


@BRANCH_REGISTRY.register(name="R2D3DBranch")
class R2D3DBranch(nn.Module):
    """2D/3D residual branch: two convs with the stage kernel (simple block)
    or 1x1x1, the stage kernel, 1x1x1 (bottleneck)."""

    def __init__(self, cfg, p: BlockParams, cin: int):
        super().__init__()
        self.simple = p.transformation == "simple_block"
        if self.simple:
            self.a = conv3d(cin, p.num_filters, p.kernel_size, p.stride)
            self.a_bn = bn(p.num_filters)
            self.b = conv3d(p.num_filters, p.num_filters, p.kernel_size)
            self.b_bn = bn(p.num_filters)
            return
        mid = p.num_filters // p.expansion_ratio
        self.a = conv3d(cin, mid, (1, 1, 1))
        self.a_bn = bn(mid)
        self.b = conv3d(mid, mid, p.kernel_size, p.stride)
        self.b_bn = bn(mid)
        self.c = conv3d(mid, p.num_filters, (1, 1, 1))
        self.c_bn = bn(p.num_filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.a_bn(self.a(x)))
        x = self.b_bn(self.b(x))
        if self.simple:
            return x
        return self.c_bn(self.c(F.relu(x)))


def _r2plus1d_mid(kt, kh, kw, cin, cout) -> int:
    return int((kt * kh * kw * cin * cout) / (kh * kw * cin + kt * cout))


def _factorized(parent: nn.Module, tag: str, cin: int, mid: int, cout: int, kernel: Sequence[int], stride: Sequence[int]) -> None:
    """Spatial (1, kh, kw) conv to ``mid`` channels + bn + relu, then temporal
    (kt, 1, 1) to ``cout``, registered as ``{tag}1``, ``{tag}1_bn``, ``{tag}2``
    of ``parent``, the JAX branch's names."""
    kt, kh, kw = kernel
    parent.add_module(f"{tag}1", conv3d(cin, mid, (1, kh, kw), (1, stride[1], stride[2])))
    parent.add_module(f"{tag}1_bn", bn(mid))
    parent.add_module(f"{tag}2", conv3d(mid, cout, (kt, 1, 1), (stride[0], 1, 1)))


def _run_factorized(parent: nn.Module, tag: str, x: torch.Tensor) -> torch.Tensor:
    x = F.relu(getattr(parent, f"{tag}1_bn")(getattr(parent, f"{tag}1")(x)))
    return getattr(parent, f"{tag}2")(x)


@BRANCH_REGISTRY.register(name="R2Plus1DBranch")
class R2Plus1DBranch(nn.Module):
    """(2+1)D factorized convs: the simple block picks each mid width by the
    (2+1)D parameter-matching formula (from the block's configured dim_in);
    the bottleneck keeps num_filters // expansion on both factorized convs."""

    def __init__(self, cfg, p: BlockParams, cin: int):
        super().__init__()
        kt, kh, kw = p.kernel_size
        nf = p.num_filters
        self.simple = p.transformation == "simple_block"
        if self.simple:
            _factorized(self, "a", cin, _r2plus1d_mid(kt, kh, kw, p.dim_in, nf), nf, p.kernel_size, p.stride)
            self.a2_bn = bn(nf)
            _factorized(self, "b", nf, _r2plus1d_mid(kt, kh, kw, nf, nf), nf, p.kernel_size, (1, 1, 1))
            self.b2_bn = bn(nf)
            return
        mid = nf // p.expansion_ratio
        self.a = conv3d(cin, mid, (1, 1, 1))
        self.a_bn = bn(mid)
        _factorized(self, "b", mid, mid, mid, p.kernel_size, p.stride)
        self.b2_bn = bn(mid)
        self.c = conv3d(mid, nf, (1, 1, 1))
        self.c_bn = bn(nf)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.simple:
            y = F.relu(self.a2_bn(_run_factorized(self, "a", x)))
            return self.b2_bn(_run_factorized(self, "b", y))
        y = F.relu(self.a_bn(self.a(x)))
        y = F.relu(self.b2_bn(_run_factorized(self, "b", y)))
        return self.c_bn(self.c(y))


class RouteFuncMLP(nn.Module):
    """Calibration weights: per-frame + global pooled features -> two
    temporal 1D convs -> + 1.  Output [B, C, T]."""

    def __init__(self, c_in: int, ratio: int, kernels: Sequence[int]):
        super().__init__()
        self.g = conv3d(c_in, c_in, (1, 1, 1), bias=True)
        self.a = conv3d(c_in, c_in // ratio, (kernels[0], 1, 1), bias=True)
        self.bn = bn(c_in // ratio)
        # zero-init final conv so the initial calibration is exactly 1
        self.b = Conv3d(c_in // ratio, c_in, (kernels[1], 1, 1), padding=(kernels[1] // 2, 0, 0), init="zeros")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.g(x.mean(dim=(2, 3, 4), keepdim=True))  # [B, C, 1, 1, 1] global
        f = x.mean(dim=(3, 4), keepdim=True)  # [B, C, T, 1, 1] per frame
        y = F.relu(self.bn(self.a(f + g)))
        return self.b(y)[:, :, :, 0, 0] + 1.0  # [B, C, T]


class TAdaConv2d(nn.Module):
    """Temporally-adaptive 2D conv: alpha [B, C, T] calibrates the base
    weight's input channels, folded into the activations before one
    (1, kh, kw) conv."""

    def __init__(self, cin: int, cout: int, kernel: Sequence[int], stride: Sequence[int] = (1, 1)):
        super().__init__()
        kh, kw = kernel
        self.conv = Conv3d(cin, cout, (1, kh, kw), (1,) + tuple(stride), padding=(0, kh // 2, kw // 2), init="lecun")

    def forward(self, x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
        return self.conv(x * alpha[:, :, :, None, None].to(x.dtype))


@BRANCH_REGISTRY.register(name="TAdaConvBlockAvgPool")
class TAdaConvBlockAvgPool(nn.Module):
    """TAda bottleneck with average-pool aggregation."""

    def __init__(self, cfg, p: BlockParams, cin: int):
        super().__init__()
        mid = p.num_filters // p.expansion_ratio
        br = p.branch_cfg
        self.pool_k = tuple(int(k) for k in br.get("POOL_K", [3, 1, 1]))
        self.a = conv3d(cin, mid, (1, 1, 1))
        self.a_bn = bn(mid)
        self.b_rf = RouteFuncMLP(mid, int(br.get("ROUTE_FUNC_R", 4)), tuple(br.get("ROUTE_FUNC_K", [3, 3])))
        self.b = TAdaConv2d(mid, mid, (p.kernel_size[1], p.kernel_size[2]), (p.stride[1], p.stride[2]))
        self.b_avgpool_bn = BatchNorm(mid, centered=True, zero_init=True)
        self.b_bn = bn(mid)
        self.c = conv3d(mid, p.num_filters, (1, 1, 1))
        self.c_bn = bn(p.num_filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.a_bn(self.a(x)))
        y = self.b(y, self.b_rf(y))
        # pooled in float32, which its BatchNorm computes in anyway (the JAX package pools in the compute dtype first)
        pooled = pool3d.avg_pool3d(y.float(), self.pool_k, (1, 1, 1), tuple(k // 2 for k in self.pool_k))
        y = F.relu(self.b_bn(y) + self.b_avgpool_bn(pooled).to(y.dtype))
        return self.c_bn(self.c(y))


@BRANCH_REGISTRY.register(name="CSNBranch")
class CSNBranch(nn.Module):
    """ir-CSN bottleneck: a depthwise conv with the stage kernel between 1x1x1 convs."""

    def __init__(self, cfg, p: BlockParams, cin: int):
        super().__init__()
        mid = p.num_filters // p.expansion_ratio
        self.a = conv3d(cin, mid, (1, 1, 1))
        self.a_bn = bn(mid)
        self.b = conv3d(mid, mid, p.kernel_size, p.stride, groups=mid)
        self.b_bn = bn(mid)
        self.c = conv3d(mid, p.num_filters, (1, 1, 1))
        self.c_bn = bn(p.num_filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.a_bn(self.a(x)))
        x = F.relu(self.b_bn(self.b(x)))
        return self.c_bn(self.c(x))


@BRANCH_REGISTRY.register(name="SlowfastBranch")
class SlowfastBranch(nn.Module):
    """SlowFast branch.  Bottleneck: ``a`` is (3, 1, 1) where the pathway's
    TEMPORAL_CONV_BOTTLENECK[stage] is set, else 1x1x1; ``b`` carries the
    stage kernel and the stride; ``c`` is 1x1x1.  Simple block: two convs
    with the stage kernel."""

    def __init__(self, cfg, p: BlockParams, cin: int):
        super().__init__()
        self.simple = p.transformation == "simple_block"
        if self.simple:
            self.a = conv3d(cin, p.num_filters, p.kernel_size, p.stride)
            self.a_bn = bn(p.num_filters)
            self.b = conv3d(p.num_filters, p.num_filters, p.kernel_size)
            self.b_bn = bn(p.num_filters)
            return
        mid = p.num_filters // p.expansion_ratio
        tconv = list(cfg.VIDEO.BACKBONE.get("TEMPORAL_CONV_BOTTLENECK", []) or [])
        temporal_a = bool(tconv[p.stage_id]) if p.stage_id < len(tconv) else False
        self.a = conv3d(cin, mid, (3, 1, 1) if temporal_a else (1, 1, 1))
        self.a_bn = bn(mid)
        self.b = conv3d(mid, mid, p.kernel_size, p.stride)
        self.b_bn = bn(mid)
        self.c = conv3d(mid, p.num_filters, (1, 1, 1))
        self.c_bn = bn(p.num_filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.a_bn(self.a(x)))
        x = self.b_bn(self.b(x))
        if self.simple:
            return x
        return self.c_bn(self.c(F.relu(x)))


@BRANCH_REGISTRY.register(name="NonLocal")
class NonLocal(nn.Module):
    """Non-local attention block over all T*H*W positions; its width is half
    the block's configured dim_in."""

    def __init__(self, cfg, p: BlockParams, cin: int):
        super().__init__()
        self.mid = mid = p.dim_in // 2
        self.qconv = conv3d(cin, mid, (1, 1, 1), bias=True)
        self.kconv = conv3d(cin, mid, (1, 1, 1), bias=True)
        self.vconv = conv3d(cin, mid, (1, 1, 1), bias=True)
        self.out_conv = conv3d(mid, p.num_filters, (1, 1, 1), bias=True)
        self.out_bn = bn(p.num_filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, t, h, w = x.shape
        tokens = lambda y: y.flatten(2).transpose(1, 2)  # noqa: E731  [B, C, T, H, W] -> [B, THW, C]
        q, k, v = tokens(self.qconv(x)), tokens(self.kconv(x)), tokens(self.vconv(x))
        attn = torch.softmax(torch.matmul(q, k.transpose(1, 2)).float() * (self.mid**-0.5), dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, self.mid, t, h, w)
        return x + self.out_bn(self.out_conv(out.contiguous(memory_format=torch.channels_last_3d)))


class SelfGating(nn.Module):
    """S3D-G feature gating: sigmoid(FC(GAP(x))) scales x per channel."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.fc = Dense(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.fc(x.mean(dim=(2, 3, 4)))
        return torch.sigmoid(w)[:, :, None, None, None] * x


@BRANCH_REGISTRY.register(name="STConv3d")
class STConv3d(nn.Module):
    """Separable spatial + temporal conv of S3D / S3D-G: (1, k, k) at the
    spatial stride, bn, relu, then (k, 1, 1) at the temporal stride, bn,
    relu."""

    def __init__(self, cfg, in_planes: int, out_planes: int, kernel_size: int, stride, padding: int = 0):
        super().__init__()
        k, s = kernel_size, stride
        t_stride = s[0] if isinstance(s, (tuple, list)) else s
        s_spatial = s[-1] if isinstance(s, (tuple, list)) else s
        self.conv1 = conv3d(in_planes, out_planes, (1, k, k), (1, s_spatial, s_spatial))
        self.bn1 = bn(out_planes)
        self.conv2 = conv3d(out_planes, out_planes, (k, 1, 1), (t_stride, 1, 1))
        self.bn2 = bn(out_planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))
