"""CLIP image/text towers in torch (counterpart of
clip_fsar_tpu/models/clip/model.py:107-618).

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

Remat (``Transformer(remat=True)``, the vision tower only, as in the JAX
package): each block runs under a non-reentrant checkpoint while autograd
records, and its backward recomputes it; ``remat_policy`` ``nothing``
recomputes everything, ``dots`` keeps the outputs of the 2-D products
(``aten.mm`` / ``aten.addmm``: the Dense layers and the packed in-projection)
as ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` does, and
recomputes the rest, the batched products of the attention included.  The
kernels' autograd Functions are recomputed too: their forward launches again.
There is no scan over depth: eager torch runs the blocks as a loop either way.

The RN towers (``ModifiedResNet``: RN50, RN101, RN50x4/x16/x64) keep
OpenAI's names too (``visual.layer1.0.bn1.weight``, ``...downsample.0/1``,
``visual.attnpool.q_proj``).  Their activations are NCHW-shaped views of
channels_last memory, so the NHWC input costs no copy and every conv runs
on the NHWC layout.  ``BatchNorm`` follows the JAX module, not
``torch.nn.BatchNorm2d``: float32 statistics with the fast variance,
eps 1e-5, the affine as one float32 ``x * a + b``, and a running update
with flax's momentum 0.9 on the biased batch variance.  Its mode is decided
per call (``groups``), never by ``nn.Module.training``.  The attention
pool always runs the plain float32-softmax ``mha``: its one query never
reaches ``clip_mha`` or ``flash_mha``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts, noop_context_fn

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


# the 2-D products whose outputs the ``dots`` policy keeps: an allow-list, so that no buffer a kernel
# wrapper allocates (torch.empty, then written through ctypes) is ever cached and handed back
_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _keep_products(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _PRODUCTS else CheckpointPolicy.PREFER_RECOMPUTE


def rematerialized(fn, *args, context_fn=noop_context_fn):
    """``fn(*args)`` under a non-reentrant checkpoint while autograd records,
    plainly otherwise.  The recompute draws nothing at random, so no RNG state
    is stashed (that would cost a copy per call)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, context_fn=context_fn)


class Transformer(nn.Module):
    def __init__(
        self, width: int, layers: int, heads: int, causal: bool = False, dtype: torch.dtype = torch.float32, attention_backend: str = "plain",
        remat: bool = False, remat_policy: str = "nothing",
    ):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, causal=causal, dtype=dtype, attention_backend=attention_backend) for _ in range(layers)
        )
        self.remat = remat
        # any other value is "nothing", as in the JAX package (model.py:303-307)
        self.context_fn = functools.partial(create_selective_checkpoint_contexts, _keep_products) if remat_policy == "dots" else noop_context_fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.resblocks:
            x = rematerialized(block, x, context_fn=self.context_fn) if self.remat else block(x)
        return x


class VisionTransformer(nn.Module):
    """CLIP ViT: NHWC images [B, H, W, 3] -> [B, output_dim]."""

    def __init__(
        self, input_resolution: int, patch_size: int, width: int, layers: int, heads: int, output_dim: int,
        dtype: torch.dtype = torch.float32, attention_backend: str = "plain", remat: bool = False, remat_policy: str = "nothing",
    ):
        super().__init__()
        self.conv1 = PatchEmbed(width, patch_size, dtype=dtype)
        self.class_embedding = _empty(width)
        self.positional_embedding = _empty((input_resolution // patch_size) ** 2 + 1, width)
        self.ln_pre = LayerNorm(width)
        self.transformer = Transformer(width, layers, heads, dtype=dtype, attention_backend=attention_backend, remat=remat, remat_policy=remat_policy)
        self.ln_post = LayerNorm(width)
        self.proj = _empty(width, output_dim)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, return_tokens: bool = False):
        """With ``return_tokens``: (class token [B, out], patch tokens
        [B, g*g, out]), every token through ln_post and the projection (JAX
        model.py:398-400)."""
        dt = self.dtype
        x = self.conv1(x)  # [B, g*g, width]
        cls = self.class_embedding.to(dt).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        x = self.transformer(self.ln_pre(x))
        if return_tokens:
            tokens = self.ln_post(x) @ self.proj.to(dt)
            return tokens[:, 0, :], tokens[:, 1:, :]
        return self.ln_post(x[:, 0, :]) @ self.proj.to(dt)


class Conv2d(nn.Module):
    """'Same' convolution with a float32 weight cast to the compute dtype at
    use (flax ``nn.Conv``; bias-free unless ``bias``).  ``weight`` is torch's
    (out, in, kh, kw); it is handed to the conv as channels_last, as the
    activations are."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, dtype: torch.dtype = torch.float32, bias: bool = False):
        super().__init__()
        self.weight = _empty(cout, cin, k, k)
        self.bias = _empty(cout) if bias else None
        self.stride = stride
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(dtype=self.dtype, memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, w, b, self.stride, self.weight.shape[-1] // 2)


class _BatchNormFn(torch.autograd.Function):
    """y = x * a + b per (group, channel) in float32, a = g * rsqrt(var + eps),
    b = beta - mean * a, on x [G, M, C].  With ``batch`` the statistics are
    each group's own (mean and fast variance E[x^2] - E[x]^2 clamped at 0,
    both part of the gradient), else the given running ones.  Returns y in
    x's dtype and the statistics used, [G, C] each.

    The backward is the chain rule of that same expression, step by step as
    autodiff takes it in the JAX package, but it keeps only x in its own
    dtype and per-channel vectors, never a float32 copy of the activation."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, batch: bool, eps: float):
        xf = x.float()
        g = x.shape[0]
        if batch:
            mean = xf.mean(dim=1)
            raw = xf.square().mean(dim=1) - mean.square()
            var = raw.clamp_min(0.0)
            live = (raw > 0).float()  # the clamp passes no gradient to the variance
        else:
            mean, var, live = running_mean.expand(g, -1), running_var.expand(g, -1), None
        rstd = torch.rsqrt(var + eps)
        a = weight * rstd
        b = bias - mean * a
        y = (xf * a[:, None] + b[:, None]).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, var + eps, rstd, live)
        ctx.batch = batch
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, var_eps, rstd, live = ctx.saved_tensors
        xf, dyf = x.float(), dy.float()
        a = weight * rstd
        d_b = dyf.sum(dim=1)  # y = x * a + b
        d_a = (dyf * xf).sum(dim=1) - d_b * mean  # b = beta - mean * a
        dx = dyf * a[:, None]
        if ctx.batch:
            d_var = d_a * weight * (-0.5) * rstd / var_eps * live  # a = g * rsqrt(var + eps), var = max(E[x^2] - mean^2, 0)
            d_mean = -d_b * a - 2.0 * mean * d_var
            dx = dx + (d_mean[:, None] + 2.0 * d_var[:, None] * xf) / x.shape[1]
        return dx.to(x.dtype), (d_a * rstd).sum(dim=0), d_b.sum(dim=0), None, None, None, None


class BatchNorm(nn.Module):
    """BatchNorm of the RN towers (JAX model.py:407-465) on NCHW-shaped
    channels_last activations.

    ``forward(x, groups=None)``: None normalizes with the running stats;
    ``groups=G`` splits the batch into G equal runs of frames (episodes) and
    normalizes each with its own batch statistics.  A batch-stat call also
    advances ``step_stats`` [G, 2, C], each group's running (mean, var) as
    flax's mutable ``batch_stats`` would hold them after this call: from the
    running buffers on the step's first call, from the previous call's
    result after it (so a target call sees what its support call updated).
    The train step averages and commits them (``commit``); nothing else
    writes the buffers.  eps and momentum are the JAX module's, whatever
    BN.EPS / BN.MOMENTUM say (the JAX package does not read them either)."""

    EPS, MOMENTUM = 1e-5, 0.9  # flax's momentum: torch's 0.1

    def __init__(self, channels: int):
        super().__init__()
        self.weight = _empty(channels)
        self.bias = _empty(channels)
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.step_stats: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor, groups: Optional[int] = None) -> torch.Tensor:
        b, c, h, w = x.shape
        xv = x.permute(0, 2, 3, 1).reshape(groups or 1, -1, c)  # a view of channels_last memory
        y, mean, var = _BatchNormFn.apply(xv, self.weight, self.bias, self.running_mean, self.running_var, groups is not None, self.EPS)
        if groups is not None:
            prev = torch.stack([self.running_mean, self.running_var]) if self.step_stats is None else self.step_stats
            self.step_stats = self.MOMENTUM * prev + (1.0 - self.MOMENTUM) * torch.stack([mean, var], dim=1)
        return y.reshape(b, h, w, c).permute(0, 3, 1, 2)

    @torch.no_grad()
    def commit(self, ok: torch.Tensor) -> None:
        """Running (mean, var) <- ``step_stats`` [2, C] (the train step's
        mean over its episodes) where ``ok``, a 0-dim bool on the device;
        else left as they are.  Nothing is read back."""
        new, self.step_stats = self.step_stats, None
        self.running_mean.copy_(torch.where(ok, new[0], self.running_mean))
        self.running_var.copy_(torch.where(ok, new[1], self.running_var))


class _Downsample(nn.Module):
    """The bottleneck's shortcut: avgpool (stride > 1), 1x1 conv, BatchNorm,
    under OpenAI's names ``downsample.0`` (conv) and ``downsample.1`` (BN)."""

    def __init__(self, cin: int, cout: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.add_module("0", Conv2d(cin, cout, 1, dtype=dtype))
        self.add_module("1", BatchNorm(cout))
        self.stride = stride

    def forward(self, x: torch.Tensor, groups: Optional[int] = None) -> torch.Tensor:
        if self.stride > 1:
            x = F.avg_pool2d(x, self.stride)
        return getattr(self, "1")(getattr(self, "0")(x), groups)


class Bottleneck(nn.Module):
    """CLIP anti-aliased bottleneck (JAX model.py:468-501): every conv at
    stride 1, an avgpool after conv2 when stride > 1."""

    EXPANSION = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        out = planes * self.EXPANSION
        self.conv1, self.bn1 = Conv2d(inplanes, planes, 1, dtype=dtype), BatchNorm(planes)
        self.conv2, self.bn2 = Conv2d(planes, planes, 3, dtype=dtype), BatchNorm(planes)
        self.conv3, self.bn3 = Conv2d(planes, out, 1, dtype=dtype), BatchNorm(out)
        self.downsample = _Downsample(inplanes, out, stride, dtype) if stride > 1 or inplanes != out else None
        self.stride = stride

    def forward(self, x: torch.Tensor, groups: Optional[int] = None) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), groups))
        out = F.relu(self.bn2(self.conv2(out), groups))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = self.bn3(self.conv3(out), groups)
        identity = x if self.downsample is None else self.downsample(x, groups)
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """QKV attention pooling (JAX model.py:504-534): the mean token plus the
    positional table; the query is the mean token alone."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int, output_dim: int, dtype: torch.dtype = torch.float32, tokens: bool = False):
        super().__init__()
        self.positional_embedding = _empty(spacial_dim**2 + 1, embed_dim)
        self.q_proj, self.k_proj, self.v_proj = (Dense(embed_dim, embed_dim, dtype=dtype) for _ in range(3))
        self.c_proj = Dense(embed_dim, output_dim, dtype=dtype)
        if tokens:  # the JAX module creates it at the first return_tokens call
            self.c_proj_tokens = Dense(embed_dim, output_dim, dtype=dtype)
        self.num_heads = num_heads

    def forward(self, x: torch.Tensor, return_tokens: bool = False):
        """[B, C, H, W] -> pooled [B, out]; with ``return_tokens`` also the
        spatial tokens [B, H*W, out], the ``c_proj_tokens`` projection of
        their values (JAX model.py:527-534, the reference's spatial "v2")."""
        b, c, h, w = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1) + self.positional_embedding.to(x.dtype)  # [B, HW+1, C]
        values = self.v_proj(x)
        q, k, v = (split_heads(t, self.num_heads) for t in (self.q_proj(x[:, :1]), self.k_proj(x), values))
        pooled = self.c_proj(merge_heads(mha(q, k, v)))[:, 0]  # plain float32 softmax whatever the config's attention path
        return (pooled, self.c_proj_tokens(values[:, 1:])) if return_tokens else pooled


class ModifiedResNet(nn.Module):
    """CLIP ResNet (JAX model.py:537-579): NHWC images [B, H, W, 3] ->
    [B, output_dim].  A 3-conv stem and an avgpool, four bottleneck stages,
    attention pooling.  ``bn_groups`` is every BatchNorm's ``groups``."""

    def __init__(
        self, layers, output_dim: int, heads: int, input_resolution: int = 224, width: int = 64, dtype: torch.dtype = torch.float32,
        tokens: bool = False,
    ):
        super().__init__()
        half = width // 2
        self.conv1, self.bn1 = Conv2d(3, half, 3, stride=2, dtype=dtype), BatchNorm(half)
        self.conv2, self.bn2 = Conv2d(half, half, 3, dtype=dtype), BatchNorm(half)
        self.conv3, self.bn3 = Conv2d(half, width, 3, dtype=dtype), BatchNorm(width)
        inplanes = width
        for stage, (blocks, planes, stride) in enumerate(zip(layers, (width, width * 2, width * 4, width * 8), (1, 2, 2, 2)), start=1):
            stack = []
            for i in range(blocks):
                stack.append(Bottleneck(inplanes, planes, stride if i == 0 else 1, dtype=dtype))
                inplanes = planes * Bottleneck.EXPANSION
            self.add_module(f"layer{stage}", nn.ModuleList(stack))
        self.attnpool = AttentionPool2d(input_resolution // 32, width * 32, heads, output_dim, dtype=dtype, tokens=tokens)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, bn_groups: Optional[int] = None, return_tokens: bool = False):
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW shape over the NHWC memory: channels_last, no copy
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2), (self.conv3, self.bn3)):
            x = F.relu(bn(conv(x), bn_groups))
        x = F.avg_pool2d(x, 2)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in stage:
                x = block(x, bn_groups)
        return self.attnpool(x, return_tokens)


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


def build_vision_tower(
    arch: CLIPArch, dtype: torch.dtype = torch.float32, attention_backend: str = "plain", remat: bool = False, remat_policy: str = "nothing",
    tokens: bool = False,
) -> nn.Module:
    """The CLIP vision tower of ``arch``: a VisionTransformer, or for the RN
    archs a ModifiedResNet, which ignores ``attention_backend`` and the remat
    options as the JAX one does (model.py:652-661, clipfsar.py:91-114).
    ``tokens`` gives an RN tower's attention pool the ``c_proj_tokens``
    projection that ``return_tokens`` needs (MoLo's token grid)."""
    if not arch.is_vit:
        return ModifiedResNet(
            arch.vision_layers, arch.embed_dim, arch.vision_heads, arch.image_resolution, arch.vision_width, dtype=dtype, tokens=tokens
        )
    return VisionTransformer(
        arch.image_resolution, arch.vision_patch_size, arch.vision_width, arch.vision_layers, arch.vision_heads,
        arch.embed_dim, dtype=dtype, attention_backend=attention_backend, remat=remat, remat_policy=remat_policy,
    )
