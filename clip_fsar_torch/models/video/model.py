"""BaseVideoModel = BACKBONE o HEAD (counterpart of
clip_fsar_tpu/models/video/model.py), the transformer and SlowFast heads,
and ``build_video_model``.

The model takes normalized float32 video [B, T, H, W, 3] (a pair of them
for SlowFast) and computes in ``dtype`` from its first conv on, as the JAX
model's convs cast their input; the classifier FCs run in float32.  It
returns (predictions, pooled features); the predictions are raw logits in
train mode and the HEAD.ACTIVATION (softmax / sigmoid) of them at eval.

``build_video_model`` fills every parameter from a torch.Generator seeded
with RANDOM_SEED (the JAX package's initializer family: msra for the convs,
normal(0.01) for the classifiers, truncated normal(0.02) for the class
tokens and position tables, flax's lecun normal elsewhere, the transformer
and SlowFast classifiers included) and moves the
model to its device with its conv kernels in channels_last_3d.

MoSINet (MODEL.NAME) runs the model over the pseudo-motion clips of
self-supervised pretraining, [B, S, T, H, W, 3] flattened to B*S clips,
with a MoSI head: GAP, dropout and one linear classifier per axis of the
speed labels (joint, x, y or both).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from clip_fsar_torch.models.clip.model import Dense
from clip_fsar_torch.models.heads.common import dropout
from clip_fsar_torch.models.init import lecun_normal_
from clip_fsar_torch.models.video import blocks as _blocks  # noqa: F401  (registers stems and heads)
from clip_fsar_torch.models.video import branches as _branches  # noqa: F401  (registers branches)
from clip_fsar_torch.models.video import meta as _meta  # noqa: F401  (registers backbones)
from clip_fsar_torch.models.video import transformer as _transformer  # noqa: F401  (registers transformer layers and stems)
from clip_fsar_torch.models.video.blocks import to_ncdhw
from clip_fsar_torch.models.video.transformer import LayerNorm
from clip_fsar_torch.utils.registry import BACKBONE_REGISTRY, HEAD_REGISTRY, MODEL_REGISTRY


@HEAD_REGISTRY.register(name="TransformerHead")
class TransformerHead(nn.Module):
    """Linear head over the cls feature, with an optional tanh pre-logits layer."""

    def __init__(self, cfg, dim_in: int):
        super().__init__()
        h = cfg.VIDEO.HEAD
        self.rate = float(h.get("DROPOUT_RATE", 0) or 0)
        self.softmax = h.get("ACTIVATION", "softmax") == "softmax"
        self.pre = bool(h.get("PRE_LOGITS", False))
        if self.pre:
            self.pre_logits = Dense(dim_in, dim_in)
        self.linear = Dense(dim_in, int(h.NUM_CLASSES))

    def forward(self, x: torch.Tensor, train: bool = True, generator: Optional[torch.Generator] = None):
        out = dropout(x, self.rate, generator if train else None)
        if self.pre:
            out = torch.tanh(self.pre_logits(out.float()))
        logits = self.linear(out.float())
        if not train and self.softmax:
            logits = torch.softmax(logits, dim=-1)
        return logits, x


@HEAD_REGISTRY.register(name="SlowFastHead")
class SlowFastHead(nn.Module):
    """GAP of both pathways (HEAD.MODE slowfast), of the slow or of the fast
    one, concatenated, then an FC."""

    def __init__(self, cfg, dim_in):
        super().__init__()
        h = cfg.VIDEO.HEAD
        self.mode = h.get("MODE", "slowfast")
        self.rate = float(h.get("DROPOUT_RATE", 0) or 0)
        self.softmax = h.get("ACTIVATION", "softmax") == "softmax"
        dims = {"slowfast": dim_in[0] + dim_in[1], "slowonly": dim_in[0]}.get(self.mode, dim_in[1])
        self.out = Dense(dims, int(h.NUM_CLASSES))

    def forward(self, x, train: bool = True, generator: Optional[torch.Generator] = None):
        gap = lambda y: y.mean(dim=(2, 3, 4))  # noqa: E731
        if self.mode == "slowfast":
            feats = torch.cat([gap(x[0]), gap(x[1])], dim=-1)
        elif self.mode == "slowonly":
            feats = gap(x[0])
        else:
            feats = gap(x[1])
        feats = dropout(feats, self.rate, generator if train else None)
        logits = self.out(feats.float())
        if not train and self.softmax:
            logits = torch.softmax(logits, dim=-1)
        return logits, feats


class _MoSIHeadBase(nn.Module):
    """GAP, dropout and one linear head ``out_<axis>`` per axis (reference
    module_zoo/heads/mosi_head.py).  The joint head has a class per speed
    of the speed set; a per-axis one NUM_CLASSES - 1, plus 1 unless
    PRETRAIN.ZERO_OUT.  Returns ({axis: logits}, pooled features); no
    activation at eval, as in the JAX package."""

    axes: tuple = ("move_joint",)

    def __init__(self, cfg, dim_in: int):
        super().__init__()
        h, p = cfg.VIDEO.HEAD, cfg.PRETRAIN
        if self.axes == ("move_joint",):
            from clip_fsar_torch.data.mosi import build_speed_set

            n = len(build_speed_set(int(h.NUM_CLASSES), bool(p.get("DECOUPLE", True)), str(p.get("DATA_MODE", "xy")),
                                    bool(p.get("ZERO_OUT", False))))
        else:
            n = int(h.NUM_CLASSES) - 1 + int(not bool(p.get("ZERO_OUT", False)))
        self.rate = float(h.get("DROPOUT_RATE", 0) or 0)
        for axis in self.axes:
            self.add_module(f"out_{axis}", Dense(dim_in, n))

    def forward(self, x: torch.Tensor, train: bool = True, generator: Optional[torch.Generator] = None):
        feats = x.mean(dim=(2, 3, 4)) if x.dim() == 5 else x
        feats = dropout(feats, self.rate, generator if train else None)
        return {axis: getattr(self, f"out_{axis}")(feats.float()) for axis in self.axes}, feats


@HEAD_REGISTRY.register(name="MoSIHeadJoint")
class MoSIHeadJoint(_MoSIHeadBase):
    axes = ("move_joint",)


@HEAD_REGISTRY.register(name="MoSIHeadOnlyX")
class MoSIHeadOnlyX(_MoSIHeadBase):
    axes = ("move_x",)


@HEAD_REGISTRY.register(name="MoSIHeadOnlyY")
class MoSIHeadOnlyY(_MoSIHeadBase):
    axes = ("move_y",)


@HEAD_REGISTRY.register(name="MoSIHeadXY")
class MoSIHeadXY(_MoSIHeadBase):
    axes = ("move_x", "move_y")


@MODEL_REGISTRY.register(name="BaseVideoModel")
class BaseVideoModel(nn.Module):
    """backbone o head over NDHWC video."""

    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone = BACKBONE_REGISTRY.get(cfg.VIDEO.BACKBONE.META_ARCH)(cfg, dtype)
        self.head = HEAD_REGISTRY.get(cfg.VIDEO.HEAD.NAME)(cfg, self.backbone.out_channels)

    def forward(self, x, train: bool = True, generator: Optional[torch.Generator] = None):
        """x: normalized float video [B, T, H, W, 3], or a [slow, fast] pair;
        ``generator`` drives every dropout of a train call (None: none)."""
        x = [to_ncdhw(v.to(self.dtype)) for v in x] if isinstance(x, (list, tuple)) else to_ncdhw(x.to(self.dtype))
        feats = self.backbone(x, generator if train else None)
        return self.head(feats, train=train, generator=generator)


@MODEL_REGISTRY.register(name="MoSINet")
class MoSINet(nn.Module):
    """BaseVideoModel ``net`` over pseudo-motion clips: x [B, S, T, H, W, 3]
    -> predictions over the B*S clips, a dict of per-axis logits (a single
    output becomes {"move_joint": it})."""

    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.net = BaseVideoModel(cfg, dtype)

    def forward(self, x, train: bool = True, generator: Optional[torch.Generator] = None):
        x = x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))
        res, logits = self.net(x, train=train, generator=generator)
        return (res if isinstance(res, dict) else {"move_joint": res}), logits


@torch.no_grad()
def init_video_weights(model: nn.Module, g: torch.Generator) -> None:
    """Fill every parameter from ``g``: Dense layers and LayerNorms by flax's
    defaults, then every module with an initializer of its own
    (``init_own_parameters``: convs, BatchNorms, heads, class tokens)."""
    for m in model.modules():
        if isinstance(m, Dense):
            lecun_normal_(m.weight, g)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for m in model.modules():
        if hasattr(m, "init_own_parameters"):
            m.init_own_parameters(g)


def build_video_model(cfg, dtype: torch.dtype = torch.float32, device=None, generator: Optional[torch.Generator] = None) -> nn.Module:
    """The model MODEL.NAME names in the model registry (MoSINet), else a
    BaseVideoModel, with fresh weights from ``generator`` (RANDOM_SEED by
    default), on ``device`` (the CPU when None; the entry points pass the
    card)."""
    name = cfg.MODEL.get("NAME", None) or "BaseVideoModel"
    model = (MODEL_REGISTRY.get(name) if name in MODEL_REGISTRY else BaseVideoModel)(cfg, dtype)
    g = generator if generator is not None else torch.Generator().manual_seed(int(cfg.get("RANDOM_SEED", 0)))
    init_video_weights(model, g)
    return model.to(device=device or "cpu", memory_format=torch.channels_last_3d)
