"""The CLIP-FSAR head in plain PyTorch (Wang et al., CLIP-guided prototype modulation for few-shot
action recognition, IJCV 2023; the reference code's CNN_OTAM_CLIPFSAR).

Per episode: frame features of S support and Q query clips from the tower; video-text class
logits (cosine of the clip's mean feature with every class's text feature, times a learnt
scale); the prototype-modulation transformer (one pre-norm layer, q/k/v without bias, 8 heads,
attention output and feed-forward with dropout) over the query frames, and over each support
clip's frames with its class's text feature appended as a token; class prototypes as the mean
of a class's modulated support clips; OTAM, the bidirectional soft-min alignment (lambda 0.5)
of the frame distance 1 - cos between a query and a prototype; logits = -distance.

Dropout keep masks are given: the harness draws them as the configuration's generator gives
them, so that the reference and the program drop the same units.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from portbench.reference.ops import Precision, attention, layer_norm

Weights = Dict[str, torch.Tensor]
LAMBDA = 0.5
ATTN_DROP, FFN_DROP = 0.2, 0.05
HEADS = 8


def cos_sim(x: torch.Tensor, y: torch.Tensor, prec: Precision, eps: float = 0.01) -> torch.Tensor:
    """x [..., N, D], y [..., M, D] -> [..., N, M]; epsilon added to the product of the norms (the reference code's)."""
    num = prec.matmul(x, y.transpose(-1, -2))
    return num / (x.norm(dim=-1)[..., :, None] * y.norm(dim=-1)[..., None, :] + eps)


def _drop(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    return x if keep is None else torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def modulate(x: torch.Tensor, w: Weights, prec: Precision, masks: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """The prototype-modulation transformer (``context2.``) on [B, N, D]; ``masks`` the keep masks
    of the attention output, the first and the second feed-forward layer, or None (no dropout)."""
    m = masks or [None, None, None]
    h = prec.q(layer_norm(x, w["context2.norm_0.weight"], w["context2.norm_0.bias"]))
    q, k, v = (prec.linear(h, w[f"context2.attn_0.to_{t}.weight"]) for t in "qkv")
    att = prec.linear(attention(prec, q, k, v, HEADS), w["context2.attn_0.to_out.weight"], w["context2.attn_0.to_out.bias"])
    x = _drop(att, m[0], ATTN_DROP) + x
    f = prec.q(F.gelu(prec.linear(x, w["context2.ff_0.fc1.weight"], w["context2.ff_0.fc1.bias"])))
    f = _drop(f, m[1], FFN_DROP)
    f = _drop(prec.linear(f, w["context2.ff_0.fc2.weight"], w["context2.ff_0.fc2.bias"]), m[2], FFN_DROP)
    return f + x


def _otam_one_way(d: torch.Tensor, lbda: float) -> torch.Tensor:
    """Cumulative soft-min alignment of d [..., Tq, Ts] with a zero column padded on each side."""
    d = F.pad(d, (1, 1))
    tq, w = d.shape[-2], d.shape[-1]
    softmin = lambda *v: -lbda * torch.logsumexp(-torch.stack(v) / lbda, dim=0)  # noqa: E731
    prev = [torch.zeros_like(d[..., 0, 0])]
    for m in range(1, w):
        prev.append(prev[-1] + d[..., 0, m])
    for row in range(1, tq):
        cur = [torch.zeros_like(prev[0])]
        cur.append(d[..., row, 1] + softmin(prev[0], prev[1], torch.zeros_like(prev[0])))
        for m in range(2, w - 1):
            cur.append(d[..., row, m] + softmin(prev[m - 1], cur[-1]))
        cur.append(d[..., row, w - 1] + softmin(prev[w - 2], prev[w - 1], cur[-1]))
        prev = cur
    return prev[-1]


def otam(d: torch.Tensor, lbda: float = LAMBDA) -> torch.Tensor:
    """Bidirectional OTAM distance of frame distances d [..., Tq, Ts], soft-min temperature ``lbda``."""
    return _otam_one_way(d, lbda) + _otam_one_way(d.transpose(-1, -2), lbda)


def head(support: torch.Tensor, target: torch.Tensor, support_labels: torch.Tensor, text: torch.Tensor, text_support: torch.Tensor,
         w: Weights, prec: Precision, way: int, masks: Optional[Dict[str, List[torch.Tensor]]] = None, with_class_logits: bool = False):
    """One episode: frame features support [S, T, D] and target [Q, T, D], episode-local
    support labels [S], the text bank [C, D] and the support clips' text features [S, D].
    Returns (logits [Q, way], class logits [S + Q, C] or None)."""
    masks = masks or {}
    t = support.shape[1]
    class_logits = None
    if with_class_logits:
        feats = torch.cat([support, target]).mean(dim=1)
        class_logits = cos_sim(feats, text.float(), prec) * w["scale"].float()
    target = modulate(target, w, prec, masks.get("target"))
    merged = torch.cat([support, text_support.float()[:, None, :]], dim=1)  # [S, T + 1, D]
    support = modulate(merged, w, prec, masks.get("support"))[:, :t]
    onehot = F.one_hot(support_labels.long(), way).float()  # [S, way]
    protos = (onehot.t() @ support.reshape(support.shape[0], -1)) / onehot.sum(dim=0)[:, None]
    protos = protos.reshape(way, t, -1)
    q = target.shape[0]
    dists = 1.0 - cos_sim(target.reshape(q * t, -1), protos.reshape(way * t, -1), prec)
    dists = dists.reshape(q, t, way, t).transpose(1, 2)  # [Q, way, Tq, Ts]
    return -otam(dists), class_logits
