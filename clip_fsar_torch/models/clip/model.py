"""CLIP image/text towers in torch (counterpart of
clip_fsar_tpu/models/clip/model.py:107-405, 587-618).

Module and parameter names follow OpenAI's CLIP state dict
(``visual.conv1.weight``, ``transformer.resblocks.N.attn.in_proj_weight``,
...), so an OpenAI ``.pt`` loads by name; the JAX variables map onto them in
``convert.py``.  Layouts at the public functions follow the JAX package:
NHWC images, packed [B, N, 3*H*Dh] QKV.

Precision: parameters stay float32 and are cast to the compute dtype at
use; LayerNorm statistics are float32 (fast variance E[x^2] - E[x]^2,
clamped at 0) with the output in the input dtype.

Attention backends: ``fused`` sends non-causal, unmasked self-attention to
``clip_mha`` (the CUDA kernel on a card); everything else, and every other
backend, goes through ``split_heads`` -> ``mha`` -> ``merge_heads``
(``plain`` = fp32 softmax, ``plain:bf16`` = softmax in the compute dtype,
``pallas`` = ``flash_mha``, the CUDA kernels on a card, which read the
head-split views of the packed projection and write the layout
``merge_heads`` reads, so neither side copies).

Eval only for now: no remat, no scan over depth.  ModifiedResNet (RN50)
is not ported yet (ROADMAP Queue 1, RN50 tower).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from clip_fsar_torch.models.clip.arch import CLIPArch
from clip_fsar_torch.ops.attention import merge_heads, mha, split_heads
from clip_fsar_torch.ops.fused_attention import clip_mha


def _empty(*shape) -> nn.Parameter:
    """float32 parameter left uninitialized: the builder fills every
    parameter from an explicit torch.Generator (models/builder.py)."""
    return nn.Parameter(torch.empty(*shape, dtype=torch.float32))


class Dense(nn.Module):
    """Linear layer with float32 params cast to the compute dtype at use
    (flax ``nn.Dense(dtype=..., param_dtype=float32)``).  ``weight`` is
    torch's (out, in)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = _empty(out_features, in_features)
        self.bias = _empty(out_features) if bias else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), None if self.bias is None else self.bias.to(dt))


class LayerNorm(nn.Module):
    """LayerNorm with float32 statistics whatever the activation dtype;
    output in the input dtype (JAX model.py:107-139)."""

    def __init__(self, width: int, eps: float = 1e-5):
        super().__init__()
        self.weight = _empty(width)
        self.bias = _empty(width)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf.square().mean(dim=-1, keepdim=True) - mu.square()).clamp_min(0.0)
        return ((xf - mu) * torch.rsqrt(var + self.eps) * self.weight + self.bias).to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class PatchEmbed(nn.Module):
    """Non-overlapping patch embedding as ONE matmul over (kh, kw, c)
    patches (JAX _PatchEmbed, model.py:162-194).  ``weight`` keeps the
    OpenAI conv layout (width, c, p, p)."""

    def __init__(self, width: int, patch: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = _empty(width, 3, patch, patch)
        self.patch = patch
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        p = self.patch
        gh, gw = hh // p, ww // p
        patches = x.to(self.dtype).reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * c)
        kernel = self.weight.to(self.dtype).permute(2, 3, 1, 0).reshape(p * p * c, -1)  # (kh, kw, c) x width
        return patches @ kernel


class MultiheadAttention(nn.Module):
    """Self-attention with one packed [D, 3D] in-projection (JAX
    model.py:197-259; OpenAI names in_proj_weight / in_proj_bias / out_proj)."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype = torch.float32, attention_backend: str = "plain"):
        super().__init__()
        self.in_proj_weight = _empty(3 * dim, dim)
        self.in_proj_bias = _empty(3 * dim)
        self.out_proj = Dense(dim, dim, dtype=dtype)
        self.heads = heads
        self.dtype = dtype
        self.attention_backend = attention_backend

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        dt = self.dtype
        qkv = F.linear(x.to(dt), self.in_proj_weight.to(dt), self.in_proj_bias.to(dt))  # [B, N, 3D] (q | k | v)
        if self.attention_backend == "fused" and not causal:
            return self.out_proj(clip_mha(qkv, self.heads))
        q, k, v = (split_heads(t, self.heads) for t in qkv.chunk(3, dim=-1))
        return self.out_proj(merge_heads(mha(q, k, v, backend=self.attention_backend, causal=causal)))


class _MLP(nn.Module):
    def __init__(self, width: int, dtype: torch.dtype):
        super().__init__()
        self.c_fc = Dense(width, width * 4, dtype=dtype)
        self.c_proj = Dense(width * 4, width, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, d_model: int, n_head: int, causal: bool = False, dtype: torch.dtype = torch.float32, attention_backend: str = "plain"):
        super().__init__()
        self.ln_1 = LayerNorm(d_model)
        self.attn = MultiheadAttention(d_model, n_head, dtype=dtype, attention_backend=attention_backend)
        self.ln_2 = LayerNorm(d_model)
        self.mlp = _MLP(d_model, dtype)
        self.causal = causal

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), causal=self.causal)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, causal: bool = False, dtype: torch.dtype = torch.float32, attention_backend: str = "plain"):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, causal=causal, dtype=dtype, attention_backend=attention_backend) for _ in range(layers)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x)
        return x


class VisionTransformer(nn.Module):
    """CLIP ViT: NHWC images [B, H, W, 3] -> [B, output_dim]."""

    def __init__(
        self, input_resolution: int, patch_size: int, width: int, layers: int, heads: int, output_dim: int,
        dtype: torch.dtype = torch.float32, attention_backend: str = "plain",
    ):
        super().__init__()
        self.conv1 = PatchEmbed(width, patch_size, dtype=dtype)
        self.class_embedding = _empty(width)
        self.positional_embedding = _empty((input_resolution // patch_size) ** 2 + 1, width)
        self.ln_pre = LayerNorm(width)
        self.transformer = Transformer(width, layers, heads, dtype=dtype, attention_backend=attention_backend)
        self.ln_post = LayerNorm(width)
        self.proj = _empty(width, output_dim)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = self.conv1(x)  # [B, g*g, width]
        cls = self.class_embedding.to(dt).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        x = self.transformer(self.ln_pre(x))
        return self.ln_post(x[:, 0, :]) @ self.proj.to(dt)


class TextTransformer(nn.Module):
    """Causal text encoder with EOT-token pooling: tokens [B, context] ->
    [B, embed_dim]."""

    def __init__(self, arch: CLIPArch, dtype: torch.dtype = torch.float32, attention_backend: str = "plain"):
        super().__init__()
        a = arch
        self.token_embedding = nn.Embedding(a.vocab_size, a.transformer_width, _weight=torch.empty(a.vocab_size, a.transformer_width))
        self.positional_embedding = _empty(a.context_length, a.transformer_width)
        self.transformer = Transformer(
            a.transformer_width, a.transformer_layers, a.transformer_heads, causal=True, dtype=dtype, attention_backend=attention_backend
        )
        self.ln_final = LayerNorm(a.transformer_width)
        self.text_projection = _empty(a.transformer_width, a.embed_dim)
        self.dtype = dtype

    def forward(self, text: torch.Tensor) -> torch.Tensor:
        x = self.token_embedding(text).to(self.dtype)
        x = self.transformer(x + self.positional_embedding.to(x.dtype))
        x = self.ln_final(x)
        eot = text.argmax(dim=-1)  # EOT has the largest token id in each row
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled @ self.text_projection.to(x.dtype)


def build_vision_tower(arch: CLIPArch, dtype: torch.dtype = torch.float32, attention_backend: str = "plain") -> VisionTransformer:
    """The CLIP vision tower of ``arch``; ViT only for now."""
    if not arch.is_vit:
        raise NotImplementedError("ModifiedResNet (RN CLIP towers) is not ported yet: ROADMAP Queue 1, RN50 tower")
    return VisionTransformer(
        arch.image_resolution, arch.vision_patch_size, arch.vision_width, arch.vision_layers, arch.vision_heads,
        arch.embed_dim, dtype=dtype, attention_backend=attention_backend,
    )
