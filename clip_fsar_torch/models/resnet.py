"""Torchvision-style 2D ResNet trunk of the classic few-shot heads
(counterpart of clip_fsar_tpu/models/resnet.py:21-148).

The non-CLIP heads take ImageNet ResNet-18/34/50 frame features (reference
CNN_FSHead, few_shot.py:1140-1176: torchvision's model without its final FC,
global-average-pooled to [B, D]).  Module and parameter names are
torchvision's (``conv1``, ``bn1``, ``layer1.0.conv1``, ``layer1.0.downsample.0``
/ ``.1``), so a torchvision state dict loads by name (``load_torchvision_resnet``).

NHWC images in; the activations are NCHW-shaped views of channels_last
memory, as in the RN CLIP towers, so every conv runs on the NHWC layout.
BatchNorm is the port's (``clip_fsar_torch/models/clip/model.py``) on its
running statistics: the JAX heads build this trunk with ``train=False``
(fsheads.py:42-46), so its statistics stay frozen while its weights train.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from clip_fsar_torch.models.clip.model import BatchNorm, Conv2d


class _Shortcut(nn.Module):
    """The block's projection shortcut under torchvision's names:
    ``downsample.0`` (1x1 conv at the block's stride), ``downsample.1`` (BN)."""

    def __init__(self, cin: int, cout: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.add_module("0", Conv2d(cin, cout, 1, stride=stride, dtype=dtype))
        self.add_module("1", BatchNorm(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, "1")(getattr(self, "0")(x))


class BasicBlock(nn.Module):
    EXPANSION = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1, self.bn1 = Conv2d(inplanes, planes, 3, stride=stride, dtype=dtype), BatchNorm(planes)
        self.conv2, self.bn2 = Conv2d(planes, planes, 3, dtype=dtype), BatchNorm(planes)
        self.downsample = _Shortcut(inplanes, planes, stride, dtype) if stride != 1 or inplanes != planes else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class TorchBottleneck(nn.Module):
    """torchvision v1.5 bottleneck: the stride on the 3x3 conv."""

    EXPANSION = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        out = planes * self.EXPANSION
        self.conv1, self.bn1 = Conv2d(inplanes, planes, 1, dtype=dtype), BatchNorm(planes)
        self.conv2, self.bn2 = Conv2d(planes, planes, 3, stride=stride, dtype=dtype), BatchNorm(planes)
        self.conv3, self.bn3 = Conv2d(planes, out, 1, dtype=dtype), BatchNorm(out)
        self.downsample = _Shortcut(inplanes, out, stride, dtype) if stride != 1 or inplanes != out else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


RESNET_SPECS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2), 512),
    "resnet34": (BasicBlock, (3, 4, 6, 3), 512),
    "resnet50": (TorchBottleneck, (3, 4, 6, 3), 2048),
}


class TorchResNet(nn.Module):
    """ResNet trunk: NHWC images [B, H, W, 3] -> pooled features [B, D] in
    the compute dtype, or with ``pool=False`` the last stage's map
    [B, h, w, D] (an NHWC view, as the JAX module returns it)."""

    def __init__(self, depth: str = "resnet50", dtype: torch.dtype = torch.float32):
        super().__init__()
        block, layers, self.feature_dim = RESNET_SPECS[depth]
        self.conv1, self.bn1 = Conv2d(3, 64, 7, stride=2, dtype=dtype), BatchNorm(64)
        inplanes = 64
        for stage, (blocks, planes, stride) in enumerate(zip(layers, (64, 128, 256, 512), (1, 2, 2, 2)), start=1):
            stack = []
            for i in range(blocks):
                stack.append(block(inplanes, planes, stride if i == 0 else 1, dtype=dtype))
                inplanes = planes * block.EXPANSION
            self.add_module(f"layer{stage}", nn.ModuleList(stack))
        self.dtype = dtype

    def forward(self, x: torch.Tensor, pool: bool = True) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW shape over the NHWC memory: channels_last, no copy
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for blk in stage:
                x = blk(x)
        return x.mean(dim=(2, 3)) if pool else x.permute(0, 2, 3, 1)


def load_torchvision_resnet(module: TorchResNet, sd: Mapping[str, torch.Tensor]) -> None:
    """A torchvision ResNet state dict into ``module`` (strict): the final
    ``fc`` and BatchNorm2d's ``num_batches_tracked`` counters are dropped, as
    the JAX converter drops them (resnet.py:112-148)."""
    keep: Dict[str, torch.Tensor] = {
        k: torch.as_tensor(v).float() for k, v in sd.items() if not k.startswith("fc.") and not k.endswith(".num_batches_tracked")
    }
    module.load_state_dict(keep)
