"""CLIP's vision towers in plain PyTorch, from a state dict under OpenAI's names.

``vit`` is CLIP's VisionTransformer (Radford et al. 2021): patches, class token, positions,
ln_pre, pre-norm residual blocks with QuickGELU MLPs, ln_post on the class token, the
projection.  ``resnet`` is CLIP's ModifiedResNet: a 3-conv stem and an average pool, four
stages of anti-aliased bottlenecks (an average pool where the stride is 2), attention pooling
whose one query is the mean token.  Images are NHWC float32, already normalized.  ``w`` maps
names (``conv1.weight``, ``transformer.resblocks.0.attn.in_proj_weight``, ``layer1.0.bn1.weight``,
...) to tensors.  Float32 throughout; ``prec`` says where products round.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.ops import Precision, attention, batch_norm_groups, layer_norm

Weights = Dict[str, torch.Tensor]


def _vit_block(x: torch.Tensor, w: Weights, p: str, heads: int, prec: Precision) -> torch.Tensor:
    h = prec.q(layer_norm(x, w[p + "ln_1.weight"], w[p + "ln_1.bias"]))
    q, k, v = prec.linear(h, w[p + "attn.in_proj_weight"], w[p + "attn.in_proj_bias"]).chunk(3, dim=-1)
    x = x + prec.linear(attention(prec, q, k, v, heads), w[p + "attn.out_proj.weight"], w[p + "attn.out_proj.bias"])
    h = prec.linear(layer_norm(x, w[p + "ln_2.weight"], w[p + "ln_2.bias"]), w[p + "mlp.c_fc.weight"], w[p + "mlp.c_fc.bias"])
    h = prec.q(h * torch.sigmoid(1.702 * h))
    return prec.q(x + prec.linear(h, w[p + "mlp.c_proj.weight"], w[p + "mlp.c_proj.bias"]))


def vit(x: torch.Tensor, w: Weights, prec: Precision, heads: int, recompute: bool = False) -> torch.Tensor:
    """[B, H, W, 3] -> [B, output_dim].  ``recompute``: each block under a checkpoint, so the
    reference's backward at the timed sizes fits beside the bank."""
    conv = w["conv1.weight"]  # [width, 3, p, p]: non-overlapping patches
    x = F.conv2d(prec.q(x.permute(0, 3, 1, 2)), prec.q(conv), None, conv.shape[-1])
    x = x.flatten(2).transpose(1, 2)  # [B, g*g, width]
    cls = w["class_embedding"].float().expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + w["positional_embedding"].float()
    x = prec.q(layer_norm(x, w["ln_pre.weight"], w["ln_pre.bias"]))
    layers = len({k.split(".")[2] for k in w if k.startswith("transformer.resblocks.")})
    for i in range(layers):
        p = f"transformer.resblocks.{i}."
        if recompute and torch.is_grad_enabled():
            x = checkpoint(_vit_block, x, w, p, heads, prec, use_reentrant=False)
        else:
            x = _vit_block(x, w, p, heads, prec)
    return prec.matmul(layer_norm(x[:, 0], w["ln_post.weight"], w["ln_post.bias"]), w["proj"])


def _bn(x: torch.Tensor, w: Weights, p: str, groups: Optional[int], prec: Precision) -> torch.Tensor:
    return prec.q(batch_norm_groups(x, w[p + "weight"], w[p + "bias"], groups, w[p + "running_mean"], w[p + "running_var"]))


def _bottleneck(x: torch.Tensor, w: Weights, p: str, stride: int, groups: Optional[int], prec: Precision) -> torch.Tensor:
    out = F.relu(_bn(prec.conv2d(x, w[p + "conv1.weight"]), w, p + "bn1.", groups, prec))
    out = F.relu(_bn(prec.conv2d(out, w[p + "conv2.weight"]), w, p + "bn2.", groups, prec))
    if stride > 1:
        out = F.avg_pool2d(out, stride)
    out = _bn(prec.conv2d(out, w[p + "conv3.weight"]), w, p + "bn3.", groups, prec)
    if p + "downsample.0.weight" in w:
        idn = F.avg_pool2d(x, stride) if stride > 1 else x
        idn = _bn(prec.conv2d(idn, w[p + "downsample.0.weight"]), w, p + "downsample.1.", groups, prec)
    else:
        idn = x
    return prec.q(F.relu(out + idn))


def resnet(x: torch.Tensor, w: Weights, prec: Precision, heads: int, groups: Optional[int] = None, recompute: bool = False) -> torch.Tensor:
    """[B, H, W, 3] -> [B, output_dim]; ``groups`` as ``batch_norm_groups``; ``recompute`` as ``vit``'s,
    each bottleneck under a checkpoint."""
    x = x.permute(0, 3, 1, 2)
    x = F.relu(_bn(prec.conv2d(x, w["conv1.weight"], stride=2), w, "bn1.", groups, prec))
    x = F.relu(_bn(prec.conv2d(x, w["conv2.weight"]), w, "bn2.", groups, prec))
    x = F.relu(_bn(prec.conv2d(x, w["conv3.weight"]), w, "bn3.", groups, prec))
    x = F.avg_pool2d(x, 2)
    for stage in range(1, 5):
        blocks = len({k.split(".")[1] for k in w if k.startswith(f"layer{stage}.")})
        for i in range(blocks):
            args = (x, w, f"layer{stage}.{i}.", 2 if (stage > 1 and i == 0) else 1, groups, prec)
            x = checkpoint(_bottleneck, *args, use_reentrant=False) if recompute and torch.is_grad_enabled() else _bottleneck(*args)
    x = x.flatten(2).transpose(1, 2)  # [B, HW, C]
    x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1) + w["attnpool.positional_embedding"].float()
    q = prec.linear(x[:, :1], w["attnpool.q_proj.weight"], w["attnpool.q_proj.bias"])
    k = prec.linear(x, w["attnpool.k_proj.weight"], w["attnpool.k_proj.bias"])
    v = prec.linear(x, w["attnpool.v_proj.weight"], w["attnpool.v_proj.bias"])
    return prec.linear(attention(prec, q, k, v, heads), w["attnpool.c_proj.weight"], w["attnpool.c_proj.bias"])[:, 0]


def tower(x: torch.Tensor, w: Weights, prec: Precision, heads: int, groups: Optional[int] = None, recompute: bool = False) -> torch.Tensor:
    """The tower that ``w`` holds, with ``heads`` attention heads (the ViT's blocks, the
    ResNet's pool): a ViT when it has ``class_embedding``, else the ResNet."""
    if "class_embedding" in w:
        return vit(x, w, prec, heads, recompute)
    return resnet(x, w, prec, heads, groups, recompute)
