"""Shared few-shot head machinery (counterpart of
clip_fsar_tpu/models/heads/common.py:28-213).

Functions take optional leading batch axes, so one call serves the E
episodes of a step (the JAX head is vmapped over E instead).

Dropout draws its masks from an explicit ``torch.Generator`` that the train
step passes down (``F.dropout`` takes none); with no generator it is off,
which is also how the eval branch runs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
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


def class_sorted_order(labels: torch.Tensor) -> torch.Tensor:
    """Stable argsort by episode-local label over the last axis: the
    class-blocked support order the reference builds with unique +
    index_select (every class has the same shot count)."""
    return torch.argsort(labels, dim=-1, stable=True)


def hyrsm_positional_table(max_len: int, d_model: int) -> torch.Tensor:
    """HyRSM's PositionalEncoder table (reference few_shot.py:1658-1674):
    pe[pos, i] = sin(pos / 10000^(2i/d)), pe[pos, i+1] = cos(pos /
    10000^(2(i+1)/d)) for even i -- the exponent uses the raw even index (a
    reference quirk, kept).  Applied as ``x * sqrt(d/A) + B * pe``."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pos = np.arange(max_len)[:, None].astype(np.float64)
    even = np.arange(0, d_model, 2).astype(np.float64)
    pe[:, 0::2] = np.sin(pos / np.power(10000.0, 2 * even / d_model))
    pe[:, 1::2] = np.cos(pos / np.power(10000.0, 2 * (even + 1) / d_model))
    return torch.from_numpy(pe)


def trx_positional_table(max_len: int, d_model: int, pe_scale_factor: float = 0.1) -> torch.Tensor:
    """TRX's PositionalEncoding table (reference few_shot.py:1204-1223): the
    standard transformer sinusoid scaled by ``pe_scale_factor``, added."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pos = np.arange(max_len)[:, None].astype(np.float64)
    div = np.exp(np.arange(0, d_model, 2).astype(np.float64) * -(np.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(pos * div) * pe_scale_factor
    pe[:, 1::2] = np.cos(pos * div) * pe_scale_factor
    return torch.from_numpy(pe)


class HyRSMPositionalEncoding(nn.Module):
    """x [B, T, D] -> x * sqrt(D / A) + B * table[:T], then dropout 0.1
    (HyRSM's and MoLo's encoder, few_shot.py:1658-1685).  The scale is the
    JAX module's float32 sqrt, exactly (A = 0 gives inf there too)."""

    def __init__(self, dim: int, position_a: float = 10.0, position_b: float = 1.0):
        super().__init__()
        self.register_buffer("table", hyrsm_positional_table(20, dim), persistent=False)
        with np.errstate(divide="ignore"):
            self.scale = float(np.sqrt(np.float32(dim) / np.float32(position_a)))
        self.position_b = position_b

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return dropout(x * self.scale + self.position_b * self.table[: x.shape[-2]], 0.1, generator)


class ResidualMHA(nn.Module):
    """Post-norm residual MHA (reference MultiHeadAttention,
    few_shot.py:1594-1640): biasless q/k/v projections, scaled dot-product
    attention with a fixed 0.1 dropout on the probabilities, the output
    projection and its dropout, then a float32 LayerNorm of (output + q),
    returned in the output's dtype.  Inputs [B, N, d_model]."""

    def __init__(self, n_head: int, d_model: int, d_k: int, d_v: int, dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.w_qs = Dense(d_model, n_head * d_k, bias=False, dtype=dtype)
        self.w_ks = Dense(d_model, n_head * d_k, bias=False, dtype=dtype)
        self.w_vs = Dense(d_model, n_head * d_v, bias=False, dtype=dtype)
        self.fc = Dense(n_head * d_v, d_model, dtype=dtype)
        self.layer_norm = LayerNorm(d_model)
        self.n_head, self.d_k, self.rate = n_head, d_k, dropout

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        residual = q
        qh, kh, vh = (split_heads(proj(t), self.n_head) for proj, t in ((self.w_qs, q), (self.w_ks, k), (self.w_vs, v)))
        logits = torch.matmul(qh, kh.transpose(-1, -2)).float() / (self.d_k**0.5)
        probs = dropout(torch.softmax(logits, dim=-1).to(qh.dtype), 0.1, generator)
        out = dropout(self.fc(merge_heads(torch.matmul(probs, vh))), self.rate, generator)
        return self.layer_norm((out + residual).float()).to(out.dtype)


class PreNormSelfAttention(nn.Module):
    """x + Attention(LN(x)) (reference PreNormattention + Attention,
    few_shot.py:1024-1033, 1086-1113): one biasless packed q|k|v projection,
    plain float32-softmax attention, and the output projection with dropout
    unless a single head spans the whole width.  Input [B, N, dim]."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = heads * dim_head
        self.norm = LayerNorm(dim)
        self.to_qkv = Dense(dim, inner * 3, bias=False, dtype=dtype)
        self.to_out = None if (heads == 1 and dim_head == dim) else Dense(inner, dim, dtype=dtype)
        self.heads, self.rate = heads, dropout

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        q, k, v = (split_heads(t, self.heads) for t in self.to_qkv(self.norm(x)).chunk(3, dim=-1))
        out = merge_heads(mha(q, k, v))
        if self.to_out is not None:
            out = dropout(self.to_out(out), self.rate, generator)
        return out + x
