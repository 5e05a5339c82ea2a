"""torchvision's ResNet trunk in plain PyTorch, from a state dict under torchvision's names
(``conv1.weight``, ``bn1.running_mean``, ``layer1.0.conv1.weight``, ``layer2.0.downsample.0.weight``
...), without its final ``fc``: the frame features of the classic few-shot heads and MoLo.

resnet18 / 34 stack basic blocks (two 3x3 convs, the stride on the first), resnet50 v1.5
bottlenecks (1x1, 3x3, 1x1 convs, the stride on the 3x3); a block whose stride or width changes
takes a projection shortcut (1x1 conv at the block's stride, BatchNorm).  The stem is a 7x7 conv
of stride 2, BatchNorm, ReLU and a 3x3 max pool of stride 2; stages 2-4 halve the map in their
first block.  Images are NHWC float32, already normalized; the trunk returns the global average
of the last map [B, D].  BatchNorm runs on the running statistics, as the program's ``TorchResNet``
does.  Float32 throughout; ``prec`` says where products and held activations round.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.ops import Precision, batch_norm_groups

Weights = Dict[str, torch.Tensor]


def _bn(x: torch.Tensor, w: Weights, p: str, prec: Precision) -> torch.Tensor:
    return prec.q(batch_norm_groups(x, w[p + "weight"], w[p + "bias"], None, w[p + "running_mean"], w[p + "running_var"]))


def _shortcut(x: torch.Tensor, w: Weights, p: str, stride: int, prec: Precision) -> torch.Tensor:
    if p + "downsample.0.weight" not in w:
        return x
    return _bn(prec.conv2d(x, w[p + "downsample.0.weight"], stride), w, p + "downsample.1.", prec)


def _basic(x: torch.Tensor, w: Weights, p: str, stride: int, prec: Precision) -> torch.Tensor:
    out = F.relu(_bn(prec.conv2d(x, w[p + "conv1.weight"], stride), w, p + "bn1.", prec))
    out = _bn(prec.conv2d(out, w[p + "conv2.weight"]), w, p + "bn2.", prec)
    return prec.q(F.relu(out + _shortcut(x, w, p, stride, prec)))


def _bottleneck(x: torch.Tensor, w: Weights, p: str, stride: int, prec: Precision) -> torch.Tensor:
    out = F.relu(_bn(prec.conv2d(x, w[p + "conv1.weight"]), w, p + "bn1.", prec))
    out = F.relu(_bn(prec.conv2d(out, w[p + "conv2.weight"], stride), w, p + "bn2.", prec))
    out = _bn(prec.conv2d(out, w[p + "conv3.weight"]), w, p + "bn3.", prec)
    return prec.q(F.relu(out + _shortcut(x, w, p, stride, prec)))


def resnet(x: torch.Tensor, w: Weights, prec: Precision, recompute: bool = False) -> torch.Tensor:
    """[B, H, W, 3] -> [B, D]; bottlenecks where ``w`` holds a
    ``conv3``; ``recompute``: each block under a checkpoint, so a backward at the timed sizes fits."""
    block = _bottleneck if "layer1.0.conv3.weight" in w else _basic
    x = x.permute(0, 3, 1, 2)
    x = F.max_pool2d(F.relu(_bn(prec.conv2d(x, w["conv1.weight"], stride=2), w, "bn1.", prec)), 3, 2, 1)
    for stage, blocks in enumerate(stage_blocks(w), start=1):
        for i in range(blocks):
            args = (x, w, f"layer{stage}.{i}.", 2 if (stage > 1 and i == 0) else 1, prec)
            x = checkpoint(block, *args, use_reentrant=False) if recompute and torch.is_grad_enabled() else block(*args)
    return x.mean(dim=(2, 3))


def stage_blocks(w: Weights) -> list:
    """Blocks in each of the four stages of the trunk that ``w`` holds."""
    return [len({k.split(".")[1] for k in w if k.startswith(f"layer{stage}.")}) for stage in range(1, 5)]
