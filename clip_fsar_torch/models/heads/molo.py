"""MoLo head (CNN_BiMHM_MoLo; counterpart of clip_fsar_tpu/models/heads/molo.py,
reference models/base/few_shot.py:2390-2654): motion-augmented long-short
contrastive few-shot matching.

Streams, over the trunk's spatial feature map (a ResNet's last stage, or a
CLIP tower's token grid):

* appearance: the map's spatial mean per frame, a class token, a temporal
  transformer;
* motion: a 3x3x3 conv over (T, h, w) to D/8 channels, the frame difference
  of a 3x3-conv'd copy, a 1x1 up-projection, the spatial mean, a class token,
  a transformer of its own;
* a decoder (bilinear upsampling, 3x3 conv, BatchNorm, ReLU, three times,
  then a 1x1 conv to RGB) reconstructs the raw differences of consecutive
  normalized frames from the motion map (``loss_recons``).  It runs in the
  train branch only: in eval the JAX head decodes too, on the running
  statistics, and discards the result (its loss is 0 there), so skipping it
  changes no output;
* logits: frame-level Bi-MHM distances of both streams (appearance +
  LOGIT_BALANCE_COFF * motion) and the four global<->local contrastive logits,
  scaled by learnable temperatures under USE_CONTRASTIVE without TEMP_COFF.

The trunk runs once over all E*(S+Q)*T frames on its running statistics.
The decoder's BatchNorms run on batch statistics, per episode
(``groups=E``), in two calls, support first, then target, as the JAX
head's two ``_streams`` calls do; ``live_batch_norms`` names them for the
train step, which commits their running stats.
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clip_fsar_torch.data.types import Episode
from clip_fsar_torch.models.clip.model import BatchNorm, Conv2d, Dense
from clip_fsar_torch.models.heads.common import HyRSMPositionalEncoding, PreNormSelfAttention, class_mean, cos_sim, dropout
from clip_fsar_torch.models.heads.fsheads import ClassicHead
from clip_fsar_torch.models.resnet import TorchResNet
from clip_fsar_torch.utils import tracing
from clip_fsar_torch.utils.registry import HEAD_REGISTRY


class Conv3d(Conv2d):
    """'Same' 3-D convolution with a bias (flax ``nn.Conv`` with a 3-D
    kernel): weight (out, in, kt, kh, kw), input [B, C, T, H, W] (channels
    last in memory), padding k // 2 on every axis."""

    def __init__(self, cin: int, cout: int, k: int, dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, k, dtype=dtype, bias=True)
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, k, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(dtype=self.dtype, memory_format=torch.channels_last_3d)
        return F.conv3d(x, w, self.bias.to(self.dtype), 1, self.weight.shape[-1] // 2)


@functools.lru_cache(maxsize=None)
def _resize_matrix(n_in: int, n_out: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """[n_out, n_in] weights of a bilinear resize along one axis: the triangle
    kernel at half-pixel centres, widened by the factor where it shrinks
    (antialiased), each row normalized; jax.image's ``compute_weight_mat``
    in its float32 arithmetic.  Made once per size, dtype and device (every
    caller gets the same tensor: read it, never write to it)."""
    inv_scale = np.float32(n_in / n_out)
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps, w / np.where(total != 0, total, 1), 0)
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(w.T)).to(device=device, dtype=dtype)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` of an NCHW-shaped map: half-pixel
    centres, antialiased where it shrinks.  Written as jax.image computes it,
    one fixed weight matrix per axis applied by a matrix product, whose
    backward is a matrix product too: the backward of ``F.interpolate``'s
    bilinear mode adds into its input gradient with atomics on a card, in an
    order that changes from run to run."""
    out_h, out_w = int(size[0]), int(size[1])
    if out_h != x.shape[-2]:
        x = torch.matmul(_resize_matrix(x.shape[-2], out_h, x.dtype, x.device), x)
    if out_w != x.shape[-1]:
        x = torch.matmul(x, _resize_matrix(x.shape[-1], out_w, x.dtype, x.device).T)
    return x


class TransformerV2Block(nn.Module):
    """Transformer_v2 at depth 1 (reference few_shot.py:1001-1022): pre-norm
    self-attention, then a residual feed-forward with exact GELU."""

    def __init__(self, dim: int, heads: int = 8, dropout_atte: float = 0.2, mlp_dim: int = 2048, dropout_ffn: float = 0.05,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attn = PreNormSelfAttention(dim, heads=heads, dim_head=dim // heads, dropout=dropout_atte, dtype=dtype)
        self.ff_fc1 = Dense(dim, mlp_dim, dtype=dtype)
        self.ff_fc2 = Dense(mlp_dim, dim, dtype=dtype)
        self.rate = dropout_ffn

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        x = self.attn(x, generator)
        h = dropout(F.gelu(self.ff_fc1(x), approximate="none"), self.rate, generator)
        return x + dropout(self.ff_fc2(h), self.rate, generator)


class UpBlock(nn.Module):
    """Bilinear upsampling by ``scale``, 3x3 conv, BatchNorm on the batch
    statistics of each of ``groups`` episodes, ReLU (reference Up2 /
    DoubleConv2, few_shot.py:889-962)."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(cin, cout, 3, dtype=dtype)
        self.bn = BatchNorm(cout)

    def forward(self, x: torch.Tensor, scale: int, groups: int) -> torch.Tensor:
        x = resize_bilinear(x, (x.shape[-2] * scale, x.shape[-1] * scale))
        return F.relu(self.bn(self.conv(x), groups))


def bi_mhm_flat(tgt: torch.Tensor, sup: torch.Tensor, single_direct: bool = False) -> torch.Tensor:
    """Frame-level min-sum distance from flattened cos_sim (reference
    :2607-2621): tgt [E, Q, T, D], sup [E, W, T, D] -> [E, Q, W]; one
    direction (query frames to their nearest support frame) if
    ``single_direct``."""
    (e, q, t, d), w, ts = tgt.shape, sup.shape[1], sup.shape[2]
    dists = (1.0 - cos_sim(tgt.reshape(e, q * t, d), sup.reshape(e, w * ts, d))).reshape(e, q, t, w, ts).transpose(2, 3)
    one = dists.amin(dim=4).sum(dim=3)
    return one if single_direct else one + dists.amin(dim=3).sum(dim=3)


class MoLoHead(ClassicHead):
    FACTOR = 8

    def __init__(self, *args, num_class: int = 64, heads: int = 8, use_contrastive: bool = True, use_classification: bool = True,
                 use_local: bool = False, single_direct: bool = False, logit_balance_coff: float = 0.3, temp_coff: float = 0.0,
                 position_a: float = 10.0, position_b: float = 1.0, **kw):
        super().__init__(*args, tokens=True, **kw)
        d, dt = self.dim, self.dtype
        self.class_token = nn.Parameter(torch.empty(1, 1, d))
        self.class_token_motion = nn.Parameter(torch.empty(1, 1, d))
        self.temporal_atte_before = TransformerV2Block(d, heads=heads, dtype=dt)
        self.temporal_atte_before_motion = TransformerV2Block(d, heads=heads, dtype=dt)
        self.motion_reduce = Conv3d(d, d // self.FACTOR, 3, dtype=dt)
        self.motion_conv = Conv2d(d // self.FACTOR, d // self.FACTOR, 3, dtype=dt, bias=True)
        self.motion_up = Conv2d(d // self.FACTOR, d, 1, dtype=dt, bias=True)
        self.up1 = UpBlock(d // self.FACTOR, 128, dtype=dt)
        self.up2 = UpBlock(128, 32, dtype=dt)
        self.up3 = UpBlock(32, 16, dtype=dt)
        self.outc = Conv2d(16, 3, 1, dtype=dt, bias=True)
        if use_classification:
            self.classification_layer = Dense(d, num_class, dtype=dt)
        # the temperatures exist only under USE_CONTRASTIVE without TEMP_COFF (reference few_shot.py:2400-2409)
        if use_contrastive and not temp_coff:
            self.scale = nn.Parameter(torch.ones(1))
            self.scale_motion = nn.Parameter(torch.ones(1))
        self.pe = HyRSMPositionalEncoding(d, position_a, position_b)
        self.num_class, self.use_contrastive, self.use_classification, self.use_local = num_class, use_contrastive, use_classification, use_local
        self.single_direct, self.logit_balance_coff, self.temp_coff = single_direct, logit_balance_coff, temp_coff

    @torch.no_grad()
    def init_own_parameters(self, generator: torch.Generator) -> None:
        """The class tokens: flax ``normal(1.0)``, drawn from ``generator``."""
        self.class_token.normal_(0.0, 1.0, generator=generator)
        self.class_token_motion.normal_(0.0, 1.0, generator=generator)

    def live_batch_norms(self) -> list:
        return [self.up1.bn, self.up2.bn, self.up3.bn]

    def _spatial(self, images: torch.Tensor) -> torch.Tensor:
        """[E, N, T, H, W, 3] -> the trunk's map, NHWC [E*N*T, h, w, D], in
        one trunk call (a CLIP tower's token grid for CLIP backbones)."""
        flat = images.reshape((-1,) + images.shape[3:])
        with tracing.span("fsar.tower"):
            if isinstance(self.backbone, TorchResNet):
                return self.backbone(flat, pool=False)
            _, tokens = self.backbone(flat, return_tokens=True)
        g = int(tokens.shape[1] ** 0.5)
        return tokens.reshape(tokens.shape[0], g, g, tokens.shape[-1])

    def _decode(self, motion: torch.Tensor, size, groups: int) -> torch.Tensor:
        """The motion map [B, D/8, h, w] -> the reconstructed frame
        differences, NHWC [B, H, W, 3] float32, the BatchNorms on the batch
        statistics of each of ``groups`` episodes; the total upscale is the
        image resolution over the grid size."""
        ratio = size[0] // motion.shape[-2]
        rec = self.up3(self.up2(self.up1(motion, 2, groups), 4, groups), max(ratio // 8, 1), groups)
        rec = self.outc(rec)
        if rec.shape[-2] != size[0]:  # ratios that do not divide
            rec = resize_bilinear(rec, size)
        return rec.permute(0, 2, 3, 1).float()

    def _tokens(self, block: TransformerV2Block, feats: torch.Tensor, token: torch.Tensor, generator) -> torch.Tensor:
        """[E, N, L, D] per-frame features -> ReLU(transformer(pe([token; feats]))) [E, N, L+1, D]."""
        e, n = feats.shape[:2]
        x = self.pe(torch.cat([token.float().expand(e, n, 1, -1), feats], dim=2).flatten(0, 1), generator)
        return F.relu(block(x, generator)).reshape(e, n, x.shape[1], -1)

    def forward(self, ep: Episode, *unused, train: bool = False, generator=None) -> Dict[str, Any]:
        g = generator if train else None
        way, t, dim = self.way, self.num_frames, self.dim
        self.check(ep.support_images)
        e, s = ep.support_images.shape[:2]
        n = s + ep.target_images.shape[1]
        spatial = self._spatial(torch.cat([ep.support_images, ep.target_images], dim=1))  # [E*N*T, h, w, D]
        h, w = spatial.shape[1:3]

        # motion: a 3-D conv over (T, h, w), the difference of the next frame's 3x3-conv'd copy and this frame's reduction
        with tracing.span("fsar.molo.motion", clips=e * n):
            red = self.motion_reduce(spatial.reshape(e * n, t, h, w, dim).permute(0, 4, 1, 2, 3))  # [E*N, D/8, T, h, w]
            red = red.permute(0, 2, 1, 3, 4)  # [E*N, T, D/8, h, w]
            conv = self.motion_conv(red.reshape(e * n * t, -1, h, w)).reshape(red.shape)
            motion = (conv[:, 1:] - red[:, :-1]).reshape(e, n, t - 1, -1, h, w)

        if train:  # the decoder: the support call, then the target call, each episode on its own batch statistics
            size = ep.support_images.shape[3:5]
            with tracing.span("fsar.molo.decode", maps=e * n * (t - 1), pixels=e * n * (t - 1) * size[0] * size[1]):
                recs = [self._decode(motion[:, part].flatten(0, 2), size, e) for part in (slice(0, s), slice(s, n))]

        motion_feat = F.relu(self.motion_up(motion.flatten(0, 2))).mean(dim=(2, 3)).float().reshape(e, n, t - 1, dim)
        motion_feat = self._tokens(self.temporal_atte_before_motion, motion_feat, self.class_token_motion, g)  # [E, N, T, D]
        app = spatial.mean(dim=(1, 2)).float().reshape(e, n, t, dim)
        app = self._tokens(self.temporal_atte_before, app, self.class_token, g)  # [E, N, T+1, D]
        sup_app, tgt_app, sup_mot, tgt_mot = app[:, :s], app[:, s:], motion_feat[:, :s], motion_feat[:, s:]

        class_logits = None
        if self.use_classification:
            if self.use_local:
                class_logits = self.classification_layer(app).float().reshape(e, -1, self.num_class)
            else:
                class_logits = self.classification_layer(app.mean(dim=2) + motion_feat.mean(dim=2)).float()  # [E, S+Q, C]

        labels = ep.support_labels
        sup_app, sup_mot = class_mean(sup_app, labels, way), class_mean(sup_mot, labels, way)  # [E, WAY, L, D]
        if self.use_contrastive:
            scale = self.scale.float() if not self.temp_coff else self.temp_coff
            scale_m = self.scale_motion.float() if not self.temp_coff else self.temp_coff
        else:
            scale = scale_m = 1.0

        def token_logits(sup, tgt, sc):
            """(local support, local target, s2q logits, q2s logits), each logit [E, Q, WAY]."""
            sup_l, tgt_l = sup[:, :, 1:], tgt[:, :, 1:]
            s2q = (1.0 - cos_sim(sup_l, tgt[:, None, :, 0])).sum(dim=2) * sc  # [E, WAY, Q]
            q2s = (1.0 - cos_sim(tgt_l, sup[:, None, :, 0])).sum(dim=2) * sc  # [E, Q, WAY]
            return sup_l, tgt_l, -s2q.transpose(-1, -2), -q2s

        sup_l, tgt_l, logits_s2q, logits_q2s = token_logits(sup_app, tgt_app, scale)
        sup_lm, tgt_lm, logits_s2q_m, logits_q2s_m = token_logits(sup_mot, tgt_mot, scale_m)
        class_dists = bi_mhm_flat(tgt_l, sup_l, self.single_direct) + self.logit_balance_coff * bi_mhm_flat(tgt_lm, sup_lm, self.single_direct)

        if train:  # against the raw differences of consecutive normalized frames, per episode
            target = [(x[:, :, 1:] - x[:, :, :-1]).reshape(e, -1) for x in (ep.support_images, ep.target_images)]
            err = torch.cat([r.reshape(e, -1) for r in recs], dim=1) - torch.cat(target, dim=1).float()
            loss_recons = (err * err).mean(dim=1)
        else:
            loss_recons = torch.zeros(e, device=class_dists.device)
        return {
            "logits": -class_dists,
            "class_logits": class_logits,
            "logits_s2q": logits_s2q,
            "logits_q2s": logits_q2s,
            "logits_s2q_motion": logits_s2q_m,
            "logits_q2s_motion": logits_q2s_m,
            "loss_recons": loss_recons,
        }


@HEAD_REGISTRY.register(name="CNN_BiMHM_MoLo")
def build_molo(cfg, arch=None, dtype=torch.float32, **kw):
    t = cfg.TRAIN
    return MoLoHead(
        backbone_name=cfg.VIDEO.HEAD.BACKBONE_NAME, way=int(t.WAY), num_frames=int(cfg.DATA.NUM_INPUT_FRAMES), dtype=dtype, arch=arch,
        num_class=int(t.get("NUM_CLASS", 64) or 64), heads=int(t.get("HEAD", 8) or 8),
        use_contrastive=bool(t.get("USE_CONTRASTIVE", False)), use_classification=bool(t.get("USE_CLASSIFICATION", False)),
        use_local=bool(t.get("USE_LOCAL", False)), single_direct=bool(t.get("SINGLE_DIRECT", False)),
        logit_balance_coff=float(t.get("LOGIT_BALANCE_COFF", 0.3) or 0.3), temp_coff=float(t.get("TEMP_COFF", 0.0) or 0.0),
        position_a=float(t.get("POSITION_A", 10.0) or 10.0), position_b=float(t.get("POSITION_B", 1.0) or 1.0),
    )
