"""Multi-head attention core in plain torch (counterpart of
clip_fsar_tpu/ops/attention.py:21-118).

``mha`` works on head-split tensors.  Logits and softmax are float32 by
default; ``backend="plain:bf16"`` keeps them in the input dtype, the
counterpart of the JAX ``xla:bf16`` backend (``TPU.SOFTMAX_DTYPE
bfloat16``); ``backend="pallas"`` hands the call to ``flash_mha``
(``ops/flash_attention.py``, ``TPU.PALLAS_ATTENTION``).  The
whole-sequence kernel path lives in ``ops/fused_attention.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

from clip_fsar_torch.parallel.tensor import ModelShard, rand


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    backend: str = "plain",
    causal: bool = False,
    prob_dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    prob_dropout_shard: Optional[ModelShard] = None,
) -> torch.Tensor:
    """Scaled dot-product attention: q [B, H, Nq, Dh], k/v [B, H, Nk, Dh]
    -> [B, H, Nq, Dh] in q's dtype.  ``mask`` is additive, broadcastable to
    [B, H, Nq, Nk] (-inf where disallowed); ``causal`` masks keys after the
    query.  With a ``generator`` and ``prob_dropout_rate`` > 0 the softmaxed
    probabilities are dropped out (a Bernoulli keep mask, kept ones scaled
    by 1 / keep), as the JAX ``mha`` does with a dropout key; that call
    always takes the plain path.  ``prob_dropout_shard`` (a
    ``parallel.tensor.ModelShard``): the heads are the rank's slice of the
    model's, and the mask that slice of the draw over all of them."""
    dropping = prob_dropout_rate > 0.0 and generator is not None
    if backend == "pallas" and not dropping:
        from clip_fsar_torch.ops.flash_attention import flash_mha

        return flash_mha(q, k, v, mask=mask, causal=causal)
    dtype = q.dtype
    smax_dtype = dtype if backend == "plain:bf16" else torch.float32
    scale = q.shape[-1] ** -0.5
    # products of the input values accumulated in the softmax dtype, as
    # jnp.einsum(preferred_element_type=smax_dtype) does
    logits = torch.matmul(q.to(smax_dtype), k.to(smax_dtype).transpose(-1, -2)) * scale
    if causal and mask is None:
        mask = causal_mask(q.shape[-2], device=q.device)
    if mask is not None:
        logits = logits + mask.to(smax_dtype)
    probs = torch.softmax(logits, dim=-1)
    if dropping:
        keep = 1.0 - prob_dropout_rate
        probs = probs * (rand(probs.shape, generator, probs.device, prob_dropout_shard, dim=1) < keep).to(probs.dtype) / keep
    return torch.matmul(probs.to(dtype), v)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, N, D] -> [B, H, N, D/H]"""
    b, n, d = x.shape
    return x.reshape(b, n, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, N, Dh] -> [B, N, H*Dh]"""
    b, h, n, dh = x.shape
    return x.transpose(1, 2).reshape(b, n, h * dh)


def causal_mask(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Additive causal mask [n, n]: 0 on/below the diagonal, -inf above."""
    return torch.triu(torch.full((n, n), float("-inf"), dtype=dtype, device=device), diagonal=1)
