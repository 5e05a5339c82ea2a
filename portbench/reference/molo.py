"""The MoLo head in plain PyTorch (Wang et al., Motion-augmented Long-short Contrastive Learning for
Few-shot Action Recognition, CVPR 2023; the reference code's CNN_BiMHM_MoLo, few_shot.py:2390-2654),
one episode at a time, on a torchvision ResNet trunk (``tv_resnet``) that keeps its last map.

Per episode, each clip's T frames go through the trunk on its running statistics to the last map
[T, D, h, w].  Appearance: the map's spatial mean a frame, a class token in front, the positional
encoding (x * sqrt(D / A) + B * table, dropout 0.1) and a TransformerV2 block (pre-norm
self-attention of 8 heads without q/k/v bias, its output projection with dropout 0.2, then a
residual feed-forward with exact GELU and dropout 0.05 after each layer), then ReLU: [T + 1, D].
Motion: a 3x3x3 convolution over (T, h, w) to D/8 channels, the difference of the next frame's
3x3-conv'd copy and this frame's reduction [T - 1, D/8, h, w], a 1x1 up-projection to D, ReLU, the
spatial mean, its own class token, encoding and block: [T, D].  A decoder rebuilds the differences
of consecutive normalized frames from the motion map: three times a bilinear upsampling (x2, x4,
then the rest of the image's size over the map's), a 3x3 convolution without bias, BatchNorm on the
batch statistics of the call, ReLU (128, 32, 16 channels), then a 1x1 convolution to RGB; it runs
twice an episode, on its support clips' maps, then on its query clips', each call on its own
statistics.

The episode's outputs from the class-mean support tokens (one per class) and the query tokens:
Bi-MHM distances of the tokens after the class token, 1 - cos a frame pair, the sum over query
frames of the nearest support frame plus the sum over support frames of the nearest query frame,
appearance plus LOGIT_BALANCE_COFF (0.3) times motion, logits = -distance; the four global-local
logits, support frames to the query's class token and query frames to the class's, each a sum of
1 - cos times the stream's learnt temperature, negated; the class logits of each clip's mean
appearance token plus its mean motion token.  The loss is the train step's: cross-entropy of the
logits, USE_CLASSIFICATION_VALUE times that of the class logits against the clips' real classes,
USE_CONTRASTIVE_COFF times each contrastive cross-entropy, and RECONS_COFF * TRAIN.BATCH_SIZE
times the mean squared error of the rebuilt differences over the episode.

Where the JAX package departs from the reference code (PARITY.md), so does this: the upsampling is
bilinear at half-pixel centres (the reference code's nn.Upsample takes align_corners=True), the
decoder's BatchNorm runs on each episode's own statistics (the reference code's one episode a
card), and the reconstruction loss is added times BATCH_SIZE, undivided (JAX train/step.py).

Float32 throughout, TF32 off (``ops.no_tf32``); ``prec`` says where products and held activations
round, as in the other references.  The positional table keeps the reference code's quirk: the
cosine's exponent uses the odd index.  Dropout keep masks are given (the family draws them in the
head's order), or None for none.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import tv_resnet
from portbench.reference.head import _drop, cos_sim
from portbench.reference.ops import Precision, attention, batch_norm_groups, layer_norm

Weights = Dict[str, torch.Tensor]
TRUNK = "backbone."
PE_DROP, ATTN_DROP, FFN_DROP = 0.1, 0.2, 0.05
POSITION_A, POSITION_B = 10.0, 1.0
BALANCE = 0.3  # LOGIT_BALANCE_COFF
DECODER = ("up1", "up2", "up3")
STREAMS = (("motion", "temporal_atte_before_motion", "class_token_motion"), ("appearance", "temporal_atte_before", "class_token"))
CONTRASTIVE = ("logits_s2q", "logits_q2s", "logits_s2q_motion", "logits_q2s_motion")


def trunk_part(w: Weights) -> Weights:
    """The trunk's leaves under torchvision's names."""
    return {k[len(TRUNK):]: v for k, v in w.items() if k.startswith(TRUNK)}


def trunk_map(x: torch.Tensor, w: Weights, prec: Precision, recompute: bool = False) -> torch.Tensor:
    """Frames [B, H, W, 3] -> the trunk's last map [B, D, h, w] (``tv_resnet.resnet`` without its mean)."""
    block = tv_resnet._bottleneck if "layer1.0.conv3.weight" in w else tv_resnet._basic
    x = x.permute(0, 3, 1, 2)
    x = F.max_pool2d(F.relu(tv_resnet._bn(prec.conv2d(x, w["conv1.weight"], stride=2), w, "bn1.", prec)), 3, 2, 1)
    for stage, blocks in enumerate(tv_resnet.stage_blocks(w), start=1):
        for i in range(blocks):
            args = (x, w, f"layer{stage}.{i}.", 2 if (stage > 1 and i == 0) else 1, prec)
            x = checkpoint(block, *args, use_reentrant=False) if recompute and torch.is_grad_enabled() else block(*args)
    return x


def _conv(prec: Precision, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """'Same' 2-D or 3-D convolution at stride 1 with an optional bias."""
    conv = F.conv3d if w.dim() == 5 else F.conv2d
    return prec.q(conv(prec.q(x), prec.q(w), None if b is None else b.float(), 1, w.shape[-1] // 2))


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] bilinear weights at half-pixel centres: the triangle kernel about each output's
    centre in input coordinates, each row normalized over the inputs it reaches (at an edge, the
    nearest input takes the whole weight); widened by the factor where it shrinks."""
    scale = n_in / n_out
    width = max(scale, 1.0)
    centre = (np.arange(n_out) + 0.5) * scale - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(centre[:, None] - np.arange(n_in)[None, :]) / width)
    return w / w.sum(axis=1, keepdims=True)


def resize(prec: Precision, x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Bilinear resize of [B, C, H, W] to ``size`` along each axis that changes."""
    for axis, n in ((2, int(size[0])), (3, int(size[1]))):
        if x.shape[axis] != n:
            m = torch.tensor(resize_weights(x.shape[axis], n), dtype=torch.float32, device=x.device)
            x = prec.q(torch.movedim(torch.tensordot(prec.q(x), m, dims=([axis], [1])), -1, axis))
    return x


def positional_table(length: int, dim: int) -> torch.Tensor:
    """HyRSM's and MoLo's table: sin(pos / 10000^(2i / D)) at even i, cos(pos / 10000^(2(i + 1) / D)) at odd i + 1."""
    pos = np.arange(length, dtype=np.float64)[:, None]
    i = np.arange(0, dim, 2, dtype=np.float64)
    table = np.zeros((length, dim))
    table[:, 0::2] = np.sin(pos / 10000.0 ** (2 * i / dim))
    table[:, 1::2] = np.cos(pos / 10000.0 ** (2 * (i + 1) / dim))
    return torch.tensor(table, dtype=torch.float32)


def stream(feats: torch.Tensor, token: torch.Tensor, w: Weights, p: str, prec: Precision, heads: int,
           masks: Optional[List[torch.Tensor]]) -> torch.Tensor:
    """Per-frame features [N, L, D] -> ReLU(block(encode([token; feats]))) [N, L + 1, D]; ``masks`` the
    keep masks of the encoding, the attention's output, the first and the second feed-forward layer."""
    m = masks or [None] * 4
    n, _, d = feats.shape
    x = torch.cat([token.float().reshape(1, 1, d).expand(n, 1, d), feats], dim=1)
    x = _drop(x * float(np.sqrt(np.float32(d) / np.float32(POSITION_A))) + POSITION_B * positional_table(x.shape[1], d).to(x.device),
              m[0], PE_DROP)
    h = prec.q(layer_norm(x, w[p + "attn.norm.weight"], w[p + "attn.norm.bias"]))
    q, k, v = prec.linear(h, w[p + "attn.to_qkv.weight"]).chunk(3, dim=-1)
    att = prec.linear(attention(prec, q, k, v, heads), w[p + "attn.to_out.weight"], w[p + "attn.to_out.bias"])
    x = _drop(att, m[1], ATTN_DROP) + x
    f = _drop(prec.q(F.gelu(prec.linear(x, w[p + "ff_fc1.weight"], w[p + "ff_fc1.bias"]))), m[2], FFN_DROP)
    f = _drop(prec.linear(f, w[p + "ff_fc2.weight"], w[p + "ff_fc2.bias"]), m[3], FFN_DROP)
    return F.relu(x + f)


def motion_map(maps: torch.Tensor, w: Weights, prec: Precision) -> torch.Tensor:
    """The clips' trunk maps [N, T, D, h, w] -> the motion map [N, T - 1, D/8, h, w]."""
    red = _conv(prec, maps.transpose(1, 2), w["motion_reduce.weight"], w["motion_reduce.bias"]).transpose(1, 2)  # [N, T, D/8, h, w]
    conv = _conv(prec, red.flatten(0, 1), w["motion_conv.weight"], w["motion_conv.bias"]).reshape(red.shape)
    return conv[:, 1:] - red[:, :-1]


def decode(motion: torch.Tensor, w: Weights, prec: Precision, size: Sequence[int]) -> torch.Tensor:
    """Motion maps [B, D/8, h, w] of one call -> rebuilt differences [B, H, W, 3], each BatchNorm on the call's statistics."""
    x = motion
    ratio = int(size[0]) // motion.shape[-2]
    for name, scale in zip(DECODER, (2, 4, max(ratio // 8, 1))):
        x = resize(prec, x, (x.shape[-2] * scale, x.shape[-1] * scale))
        x = _conv(prec, x, w[name + ".conv.weight"], None)
        bn = name + ".bn."
        x = prec.q(F.relu(batch_norm_groups(x, w[bn + "weight"], w[bn + "bias"], 1, w[bn + "running_mean"], w[bn + "running_var"])))
    x = _conv(prec, x, w["outc.weight"], w["outc.bias"])
    if x.shape[-2] != int(size[0]):
        x = resize(prec, x, size)
    return x.permute(0, 2, 3, 1)


def class_mean(x: torch.Tensor, labels: torch.Tensor, way: int) -> torch.Tensor:
    """The mean of x [S, ...] over each class's clips, by label: [WAY, ...]."""
    onehot = F.one_hot(labels.long(), way).float()  # [S, WAY]
    return (onehot.t() @ x.flatten(1) / onehot.sum(dim=0)[:, None]).reshape((way,) + x.shape[1:])


def bi_mhm(tgt: torch.Tensor, sup: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Tokens tgt [Q, L, D], sup [WAY, L, D] -> [Q, WAY]: each query frame's nearest support frame, summed,
    plus each support frame's nearest query frame, summed."""
    (q, l, d), way = tgt.shape, sup.shape[0]
    dist = (1.0 - cos_sim(tgt.reshape(q * l, d), sup.reshape(way * l, d), prec)).reshape(q, l, way, l).transpose(1, 2)
    return dist.amin(dim=3).sum(dim=2) + dist.amin(dim=2).sum(dim=2)


def episode(w: Weights, clips_s: torch.Tensor, clips_q: torch.Tensor, support_labels: torch.Tensor, way: int, prec: Precision,
            heads: int, masks: Optional[Dict[str, List[torch.Tensor]]] = None, train: bool = False, recompute: bool = False) -> dict:
    """One episode from its normalized clips [S | Q, T, H, W, 3]: ``logits`` [Q, WAY], the four contrastive logits
    [Q, WAY], ``class_logits`` [S + Q, C] and, with ``train``, ``loss_recons`` (the decoder on)."""
    s, q, t = clips_s.shape[0], clips_q.shape[0], clips_s.shape[1]
    clips = torch.cat([clips_s, clips_q])
    n = s + q
    maps = trunk_map(clips.flatten(0, 1), trunk_part(w), prec, recompute)
    maps = maps.reshape((n, t) + maps.shape[1:])  # [N, T, D, h, w]
    motion = motion_map(maps, w, prec)  # [N, T - 1, D/8, h, w]
    out = {}
    if train:
        size = clips.shape[2:4]
        rebuilt = [decode(motion[part].flatten(0, 1), w, prec, size) for part in (slice(0, s), slice(s, n))]
        diffs = clips[:, 1:] - clips[:, :-1]
        err = torch.cat([r.reshape(-1) for r in rebuilt]) - diffs.reshape(-1)
        out["loss_recons"] = (err * err).mean()
    m = masks or {}
    up = prec.q(F.relu(_conv(prec, motion.flatten(0, 1), w["motion_up.weight"], w["motion_up.bias"])))
    feats = {"motion": up.mean(dim=(2, 3)).reshape(n, t - 1, -1), "appearance": maps.mean(dim=(3, 4))}
    tokens = {kind: stream(feats[kind], w[token], w, block + ".", prec, heads, m.get(kind)) for kind, block, token in STREAMS}
    app, mot = tokens["appearance"], tokens["motion"]
    out["class_logits"] = prec.linear(app.mean(dim=1) + mot.mean(dim=1), w["classification_layer.weight"], w["classification_layer.bias"])
    temperature = {"appearance": w["scale"].float(), "motion": w["scale_motion"].float()}
    dists = 0.0
    for kind, coff in (("appearance", 1.0), ("motion", BALANCE)):
        sup, tgt = class_mean(tokens[kind][:s], support_labels, way), tokens[kind][s:]
        sup_l, tgt_l = sup[:, 1:], tgt[:, 1:]
        s2q = (1.0 - cos_sim(sup_l, tgt[None, :, 0], prec)).sum(dim=1) * temperature[kind]  # [WAY, Q]
        q2s = (1.0 - cos_sim(tgt_l, sup[None, :, 0], prec)).sum(dim=1) * temperature[kind]  # [Q, WAY]
        tag = "" if kind == "appearance" else "_motion"
        out["logits_s2q" + tag], out["logits_q2s" + tag] = -s2q.t(), -q2s
        dists = dists + coff * bi_mhm(tgt_l, sup_l, prec)
    out["logits"] = -dists
    return out


def episode_loss(out: dict, labels_q: torch.Tensor, real: torch.Tensor, train_cfg: dict) -> torch.Tensor:
    """The train step's loss of one episode from ``episode``'s outputs; ``real`` the real classes of its S + Q clips."""
    loss = F.cross_entropy(out["logits"], labels_q.long())
    if train_cfg.get("USE_CLASSIFICATION", False):
        loss = loss + float(train_cfg.get("USE_CLASSIFICATION_VALUE", 1.0) or 1.0) * F.cross_entropy(out["class_logits"], real.long())
    if train_cfg.get("USE_CONTRASTIVE", False):
        coff = float(train_cfg.get("USE_CONTRASTIVE_COFF", 1.0) or 1.0)
        for key in CONTRASTIVE:
            loss = loss + coff * F.cross_entropy(out[key], labels_q.long())
    if train_cfg.get("USE_RECONS", False):
        loss = loss + float(train_cfg.get("RECONS_COFF", 0.0) or 0.0) * float(train_cfg.get("BATCH_SIZE", 1) or 1) * out["loss_recons"]
    return loss
