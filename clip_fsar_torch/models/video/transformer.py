"""Video transformers (counterpart of
clip_fsar_tpu/models/video/transformer.py): BaseTransformerLayer,
TimesformerLayer (divided space-time attention), the joint Transformer
and the FactorizedTransformer (ViViT factorized encoder) backbones, and
the patch / tubelet embedding stems.

Tokens: [B, 1 + T*N, C] with the cls token first, frames major.  The
attention is the plain ``mha`` (float32 softmax), as the JAX package's video
transformers call its XLA ``mha``: no kernel of the port lies on this path.
Every dropout (attention probabilities, projections, feed-forward, stochastic
depth) draws from the ``generator`` of the call and is off without one.
Each sublayer runs in the model's compute dtype ``dtype``; the LayerNorms
compute in float32, and the final ones return float32, as flax's do.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from clip_fsar_torch.models.clip.model import Dense, shard_feed_forward
from clip_fsar_torch.models.heads.common import dropout
from clip_fsar_torch.models.heads.molo import resize_bilinear
from clip_fsar_torch.models.init import trunc_normal_
from clip_fsar_torch.models.video.blocks import Conv3d, same_padding
from clip_fsar_torch.ops.attention import merge_heads, mha, split_heads
from clip_fsar_torch.parallel.tensor import ModelShard
from clip_fsar_torch.utils.registry import BACKBONE_REGISTRY, BRANCH_REGISTRY, STEM_REGISTRY


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-6)``: float32 statistics (E[x^2] - E[x]^2),
    float32 output."""

    def __init__(self, width: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(width))
        self.bias = nn.Parameter(torch.empty(width))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf.square().mean(dim=-1, keepdim=True) - mu.square()).clamp_min(0.0)
        return (xf - mu) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class DropPath(nn.Module):
    """Stochastic depth: each sample's branch kept with probability 1 - rate
    and scaled by 1 / (1 - rate)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.rate == 0.0 or generator is None:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), generator=generator, device=x.device) < keep
        return x / keep * mask.to(x.dtype)


class VideoAttention(nn.Module):
    """qkv attention, whole-sequence or divided ("time": across frames per
    patch; "space": across patches per frame), then a projection."""

    def __init__(self, dim: int, num_heads: int, attn_dropout: float, ff_dropout: float, dtype: torch.dtype):
        super().__init__()
        self.heads, self.attn_dropout, self.ff_dropout = num_heads, attn_dropout, ff_dropout
        self.to_qkv = Dense(dim, dim * 3, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def shard_(self, shard: ModelShard) -> Optional[str]:
        """``to_qkv`` column-parallel per head out of each third, ``proj``
        row-parallel; the probabilities' dropout masks sliced over the heads."""
        if self.heads % shard.size:
            return f"{self.heads} heads"
        self.to_qkv.column_(shard, parts=3)
        self.proj.row_(shard)
        self.heads //= shard.size
        return None

    def _mha(self, q, k, v, generator):
        return mha(q, k, v, prob_dropout_rate=self.attn_dropout, generator=generator, prob_dropout_shard=self.proj.tp)

    def forward(self, x, generator=None, divide: Optional[str] = None, frames: int = 0, patches: int = 0):
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        if divide is None:
            h = self.heads
            out = merge_heads(self._mha(split_heads(q, h), split_heads(k, h), split_heads(v, h), generator))
        else:
            out = self._divided(q, k, v, divide, frames, patches, generator)
        return dropout(self.proj(out), self.ff_dropout, generator)

    def _divided(self, q, k, v, mode: str, t: int, n: int, generator):
        """The cls token attends over the whole sequence; every other token
        within its group, whose keys and values also hold the cls token's."""
        h = self.heads
        b = q.shape[0]
        d = q.shape[-1] // h
        qh, kh, vh = split_heads(q, h), split_heads(k, h), split_heads(v, h)  # [B, H, N, d]
        cls_out = self._mha(qh[:, :, :1], kh, vh, generator)  # [B, H, 1, d]
        if mode == "time":  # one group per patch, over the frames
            regroup = lambda y: y.reshape(b, h, t, n, d).permute(0, 3, 1, 2, 4).reshape(b * n, h, t, d)  # noqa: E731
            r = n
        else:  # one group per frame, over the patches
            regroup = lambda y: y.reshape(b, h, t, n, d).permute(0, 2, 1, 3, 4).reshape(b * t, h, n, d)  # noqa: E731
            r = t
        kg = torch.cat([kh[:, :, :1].repeat_interleave(r, dim=0), regroup(kh[:, :, 1:])], dim=2)
        vg = torch.cat([vh[:, :, :1].repeat_interleave(r, dim=0), regroup(vh[:, :, 1:])], dim=2)
        out = self._mha(regroup(qh[:, :, 1:]), kg, vg, generator)  # [B*r, H, seq, d]
        if mode == "time":
            out = out.reshape(b, n, h, t, d).permute(0, 2, 3, 1, 4).reshape(b, h, t * n, d)
        else:
            out = out.reshape(b, t, h, n, d).permute(0, 2, 1, 3, 4).reshape(b, h, t * n, d)
        return merge_heads(torch.cat([cls_out, out], dim=2))


class TransformerFeedForward(nn.Module):
    def __init__(self, dim: int, mult: int, ff_dropout: float, dtype: torch.dtype):
        super().__init__()
        self.rate = ff_dropout
        self.fc1 = Dense(dim, dim * mult, dtype=dtype)
        self.fc2 = Dense(dim * mult, dim, dtype=dtype)

    def shard_(self, shard: ModelShard) -> Optional[str]:
        return shard_feed_forward(self.fc1, self.fc2, shard)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        h = dropout(F.gelu(self.fc1(x), approximate="none"), self.rate, generator, self.fc1.tp)
        return dropout(self.fc2(h), self.rate, generator)


def _layer_dims(cfg):
    bb = cfg.VIDEO.BACKBONE
    return int(bb.NUM_FEATURES), int(bb.NUM_HEADS), float(bb.get("ATTN_DROPOUT", 0.1)), float(bb.get("FF_DROPOUT", 0.1))


@BRANCH_REGISTRY.register(name="BaseTransformerLayer")
class BaseTransformerLayer(nn.Module):
    """Pre-norm attention and feed-forward, each behind stochastic depth."""

    def __init__(self, cfg, drop_path_rate: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        dim, heads, ad, fd = _layer_dims(cfg)
        self.dtype = dtype
        self.norm = LayerNorm(dim)
        self.attn = VideoAttention(dim, heads, ad, fd, dtype)
        self.drop_path = DropPath(drop_path_rate)
        self.norm_ffn = LayerNorm(dim)
        self.ffn = TransformerFeedForward(dim, int(cfg.VIDEO.BACKBONE.get("MLP_MULT", 4)), fd, dtype)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        x = x + self.drop_path(self.attn(self.norm(x).to(self.dtype), generator), generator)
        return x + self.drop_path(self.ffn(self.norm_ffn(x).to(self.dtype), generator), generator)


@BRANCH_REGISTRY.register(name="TimesformerLayer")
class TimesformerLayer(nn.Module):
    """Divided space-time layer: temporal attention, spatial attention, feed-forward."""

    def __init__(self, cfg, drop_path_rate: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        dim, heads, ad, fd = _layer_dims(cfg)
        self.dtype = dtype
        self.t = int(cfg.DATA.NUM_INPUT_FRAMES)
        self.n = (int(cfg.DATA.TRAIN_CROP_SIZE) // int(cfg.VIDEO.BACKBONE.PATCH_SIZE)) ** 2
        self.norm_temporal = LayerNorm(dim)
        self.attn_temporal = VideoAttention(dim, heads, ad, fd, dtype)
        self.norm = LayerNorm(dim)
        self.attn = VideoAttention(dim, heads, ad, fd, dtype)
        self.norm_ffn = LayerNorm(dim)
        self.ffn = TransformerFeedForward(dim, 4, fd, dtype)
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        dp, dt = self.drop_path, self.dtype
        x = x + dp(self.attn_temporal(self.norm_temporal(x).to(dt), generator, "time", self.t, self.n), generator)
        x = x + dp(self.attn(self.norm(x).to(dt), generator, "space", self.t, self.n), generator)
        return x + dp(self.ffn(self.norm_ffn(x).to(dt), generator), generator)


class _EmbedStem(nn.Module):
    def __init__(self, cfg, tubelet: int):
        super().__init__()
        bb = cfg.VIDEO.BACKBONE
        p, self.features = int(bb.PATCH_SIZE), int(bb.NUM_FEATURES)
        self.kernel = (tubelet, p, p)
        self.conv1 = Conv3d(int(cfg.DATA.get("NUM_INPUT_CHANNELS", 3)), self.features, self.kernel, self.kernel, bias=True, padding=(0, 0, 0),
                            init="lecun")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(same_padding(x, self.kernel, self.kernel))  # flax padding "SAME"
        return x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1, self.features)  # [B, T*N, C], frame-major


@STEM_REGISTRY.register(name="PatchEmbedStem")
class PatchEmbedStem(_EmbedStem):
    """Per-frame patch embedding -> [B, T*N, C]."""

    def __init__(self, cfg):
        super().__init__(cfg, 1)


@STEM_REGISTRY.register(name="TubeletEmbeddingStem")
class TubeletEmbeddingStem(_EmbedStem):
    """3D tubelet embedding -> [B, T/ts*N, C]."""

    def __init__(self, cfg):
        super().__init__(cfg, int(cfg.VIDEO.BACKBONE.get("TUBELET_SIZE", 2)))


def _tokens(x: torch.Tensor, cls: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    x = torch.cat([cls.to(x.dtype).expand(x.shape[0], 1, -1), x], dim=1)
    return x + pos.to(x.dtype)


class _TransformerBackbone(nn.Module):
    def _layers(self, cfg, prefix: str, count: int, rates, dtype) -> None:
        branch = BRANCH_REGISTRY.get(cfg.VIDEO.BACKBONE.BRANCH.NAME)
        for i in range(count):
            self.add_module(f"{prefix}_{i}", branch(cfg, rates[i], dtype))

    def _run(self, prefix: str, count: int, x: torch.Tensor, generator) -> torch.Tensor:
        for i in range(count):
            x = getattr(self, f"{prefix}_{i}")(x, generator)
        return x

    @torch.no_grad()
    def init_own_parameters(self, g: torch.Generator) -> None:
        for p in self._parameters.values():
            trunc_normal_(p, g)


@BACKBONE_REGISTRY.register(name="Transformer")
class VideoTransformer(_TransformerBackbone):
    """TimeSformer-style transformer over all tokens; returns the cls feature [B, C]."""

    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        bb = cfg.VIDEO.BACKBONE
        f = self.out_channels = int(bb.NUM_FEATURES)
        self.depth = int(bb.DEPTH)
        drop_path = float(bb.get("DROP_PATH", 0.0) or 0.0)
        tubelet = int(bb.get("TUBELET_SIZE", 1) or 1)
        num_patches = int(cfg.DATA.NUM_INPUT_FRAMES) * (int(cfg.DATA.TRAIN_CROP_SIZE) // int(bb.PATCH_SIZE)) ** 2 // tubelet
        self.stem = STEM_REGISTRY.get(bb.STEM.NAME)(cfg)
        self.cls_token = nn.Parameter(torch.empty(1, 1, f))
        self.pos_embd = nn.Parameter(torch.empty(1, num_patches + 1, f))
        self._layers(cfg, "layers", self.depth, [drop_path * i / max(self.depth - 1, 1) for i in range(self.depth)], dtype)
        self.norm = LayerNorm(f)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        x = _tokens(self.stem(x), self.cls_token, self.pos_embd)
        return self.norm(self._run("layers", self.depth, x, generator))[:, 0]


@BACKBONE_REGISTRY.register(name="FactorizedTransformer")
class FactorizedTransformer(_TransformerBackbone):
    """ViViT factorized encoder: a spatial transformer per frame, then a
    temporal one over the frames' cls features; returns the output cls
    feature [B, C].  The position table is for the TRAIN_CROP_SIZE grid and
    resized bilinearly (jax.image.resize's arithmetic) for another grid."""

    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        bb = cfg.VIDEO.BACKBONE
        f = self.out_channels = int(bb.NUM_FEATURES)
        self.depth, self.depth_temp = int(bb.DEPTH), int(bb.get("DEPTH_TEMP", 4))
        drop_path = float(bb.get("DROP_PATH", 0.0) or 0.0)
        tubelet = int(bb.get("TUBELET_SIZE", 1) or 1)
        self.n_per_frame = (int(cfg.DATA.TRAIN_CROP_SIZE) // int(bb.PATCH_SIZE)) ** 2
        self.t_frames = int(cfg.DATA.NUM_INPUT_FRAMES) // tubelet
        self.stem = STEM_REGISTRY.get(bb.STEM.NAME)(cfg)
        self.cls_token = nn.Parameter(torch.empty(1, 1, f))
        self.pos_embd = nn.Parameter(torch.empty(1, self.n_per_frame + 1, f))
        total = self.depth + self.depth_temp
        rates = [drop_path * i / max(total - 1, 1) for i in range(total)]
        self._layers(cfg, "layers", self.depth, rates, dtype)
        self.norm = LayerNorm(f)
        self.cls_token_out = nn.Parameter(torch.empty(1, 1, f))
        self.temp_embd = nn.Parameter(torch.empty(1, self.t_frames + 1, f))
        self._layers(cfg, "layers_temporal", self.depth_temp, rates[self.depth:], dtype)
        self.norm_out = LayerNorm(f)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        x = self.stem(x)  # [B, T*N, C]
        b, f = x.shape[0], x.shape[-1]
        n_actual = x.shape[1] // self.t_frames
        x = x.reshape(b * self.t_frames, n_actual, f)
        pos = self.pos_embd
        if n_actual != self.n_per_frame:
            side_t, side_a = round(self.n_per_frame**0.5), round(n_actual**0.5)
            grid = pos[0, 1:].reshape(side_t, side_t, f).permute(2, 0, 1)
            grid = resize_bilinear(grid, (side_a, side_a)).permute(1, 2, 0).reshape(1, n_actual, f)
            pos = torch.cat([pos[:, :1], grid], dim=1)
        x = self._run("layers", self.depth, _tokens(x, self.cls_token, pos), generator)
        x = self.norm(x)[:, 0].reshape(b, self.t_frames, f)
        x = self._run("layers_temporal", self.depth_temp, _tokens(x, self.cls_token_out, self.temp_embd), generator)
        return self.norm_out(x)[:, 0]
