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

MoSINet and the MoSI heads belong to self-supervised pretraining, which is
not ported (ROADMAP Queue 1 #8): naming them raises.
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

PRETRAIN_NOT_PORTED = "self-supervised pretraining (MoSI) is not ported yet: ROADMAP Queue 1 #8"


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


def _pretrain_head(*_, **__):
    raise NotImplementedError(f"the MoSI heads: {PRETRAIN_NOT_PORTED}")


for _name in ("MoSIHeadJoint", "MoSIHeadOnlyX", "MoSIHeadOnlyY", "MoSIHeadXY"):
    HEAD_REGISTRY.register(_pretrain_head, name=_name)


@MODEL_REGISTRY.register(name="MoSINet")
def _mosi_net(*_, **__):
    raise NotImplementedError(f"MoSINet: {PRETRAIN_NOT_PORTED}")


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


def build_video_model(cfg, dtype: torch.dtype = torch.float32, device=None, generator: Optional[torch.Generator] = None) -> BaseVideoModel:
    """The classification model of ``cfg`` with fresh weights from
    ``generator`` (RANDOM_SEED by default), on ``device`` (the CPU when
    None; the entry points pass the card)."""
    name = cfg.MODEL.get("NAME", None) or "BaseVideoModel"
    if name in MODEL_REGISTRY and name != "BaseVideoModel":
        MODEL_REGISTRY.get(name)(cfg, dtype)
    model = BaseVideoModel(cfg, dtype)
    g = generator if generator is not None else torch.Generator().manual_seed(int(cfg.get("RANDOM_SEED", 0)))
    init_video_weights(model, g)
    return model.to(device=device or "cpu", memory_format=torch.channels_last_3d)
