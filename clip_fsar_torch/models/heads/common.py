"""Shared few-shot head machinery (counterpart of
clip_fsar_tpu/models/heads/common.py:28-125).

Functions take optional leading batch axes, so one call serves the E
episodes of a step (the JAX head is vmapped over E instead).

Dropout draws its masks from an explicit ``torch.Generator`` that the train
step passes down (``F.dropout`` takes none); with no generator it is off,
which is also how the eval branch runs.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from clip_fsar_torch.models.clip.model import Dense, LayerNorm
from clip_fsar_torch.ops.attention import merge_heads, mha, split_heads


def cos_sim(x: torch.Tensor, y: torch.Tensor, epsilon: float = 0.01) -> torch.Tensor:
    """Cosine similarity between last dims with epsilon added to the
    denominator *product* (reference quirk, few_shot.py:1115-1124)."""
    numerator = torch.matmul(x, y.transpose(-1, -2))
    xnorm = torch.linalg.norm(x, dim=-1, keepdim=True)
    ynorm = torch.linalg.norm(y, dim=-1, keepdim=True)
    return numerator / (torch.matmul(xnorm, ynorm.transpose(-1, -2)) + epsilon)


def class_mean(feats: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Mean of ``feats`` per class id, rows ordered by class id.

    labels: [..., N] ints in [0, num_classes); feats: [..., N, *rest] with
    the same leading axes.  Every class is assumed present (episodes have
    exactly WAY classes).  Returns [..., num_classes, *rest]."""
    lead = labels.shape[:-1]
    n = labels.shape[-1]
    onehot = (labels[..., None] == torch.arange(num_classes, device=labels.device)).to(feats.dtype)  # [..., N, C]
    flat = feats.reshape(*lead, n, -1)
    sums = torch.matmul(onehot.transpose(-1, -2), flat)  # [..., C, prod(rest)]
    means = sums / onehot.sum(dim=-2)[..., None]
    return means.reshape(*lead, num_classes, *feats.shape[labels.dim():])


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout as flax ``nn.Dropout``: keep each element with
    probability 1 - rate (a Bernoulli mask drawn from ``generator``) and
    scale the kept ones by 1/(1 - rate).  Identity when ``generator`` is
    None or the rate is 0."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(dim, hidden_dim, dtype=dtype)
        self.fc2 = Dense(hidden_dim, dim, dtype=dtype)
        self.rate = dropout

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = dropout(F.gelu(self.fc1(x), approximate="none"), self.rate, generator)  # torch nn.GELU default: exact erf
        return dropout(self.fc2(h), self.rate, generator)


class AttentionQKV(nn.Module):
    """Separate-source q/k/v attention (reference Attention_qkv,
    few_shot.py:1035-1073): biasless projections, output projection with
    dropout unless a single head spans the whole width."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = heads * dim_head
        self.to_q = Dense(dim, inner, bias=False, dtype=dtype)
        self.to_k = Dense(dim, inner, bias=False, dtype=dtype)
        self.to_v = Dense(dim, inner, bias=False, dtype=dtype)
        self.to_out = None if (heads == 1 and dim_head == dim) else Dense(inner, dim, dtype=dtype)
        self.heads = heads
        self.rate = dropout

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        qh, kh, vh = (split_heads(proj(t), self.heads) for proj, t in ((self.to_q, q), (self.to_k, k), (self.to_v, v)))
        out = merge_heads(mha(qh, kh, vh))
        return out if self.to_out is None else dropout(self.to_out(out), self.rate, generator)


class TransformerV1(nn.Module):
    """Prototype-modulation transformer (reference Transformer_v1,
    few_shot.py:979-999).

    Layer 0: x = attn(LN(q), LN(k), LN(v)) + q; x = ff(x) + x.  Deeper
    layers are plain pre-norm self-attention.  One LayerNorm is shared by
    q/k/v within a layer, computed in float32.  Dropout (``dropout_atte``
    after the attention's output projection, ``dropout_ffn`` inside the
    feed-forward) is on only when a generator is passed."""

    def __init__(
        self, dim: int, heads: int = 8, dim_head_k: int = 256, dropout_atte: float = 0.05, mlp_dim: int = 2048,
        dropout_ffn: float = 0.05, depth: int = 1, dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.depth = depth
        for layer in range(depth):
            self.add_module(f"norm_{layer}", LayerNorm(dim))
            self.add_module(f"attn_{layer}", AttentionQKV(dim, heads=heads, dim_head=dim_head_k, dropout=dropout_atte, dtype=dtype))
            self.add_module(f"ff_{layer}", FeedForward(dim, mlp_dim, dropout=dropout_ffn, dtype=dtype))

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = q
        for layer in range(self.depth):
            ln = getattr(self, f"norm_{layer}")
            qq, kk, vv = (x, x, x) if layer > 0 else (q, k, v)
            x = getattr(self, f"attn_{layer}")(ln(qq), ln(kk), ln(vv), generator) + qq
            x = getattr(self, f"ff_{layer}")(x, generator) + x
        return x
