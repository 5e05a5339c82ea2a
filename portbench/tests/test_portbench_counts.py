"""The operation counts of portbench/counts/ against sums by hand and against torch's own count
of the reference towers' products, at the published ViT-B/16 and RN50 widths."""

from __future__ import annotations

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops, harness
from portbench.reference.ops import Precision
from portbench.reference import tv_resnet
from portbench.reference.towers import resnet, vit


def _cfg(name):
    return json.load(open(os.path.join(harness.ROOT, "configs", name + ".json")))["config"]


def test_vit_b16_by_hand():
    tokens, w = 197, 768
    per_layer = 2 * tokens * w * 12 * w + 2 * 2 * tokens * tokens * w
    total = 2 * 196 * 768 * w + 12 * per_layer + 2 * w * 512
    assert flops.vit_forward(768, 12, 12, 16, 224, 512)["total"] == total
    counts = harness.load_module("counts", "clipfsar_vitb16")
    # a train step: 4 episodes of 5 + 25 clips of 8 frames, three times the forward less the patch product's input gradient
    head = 4 * flops.clipfsar_head(512, 5, 5, 25, 8, 31)
    assert counts.model_flops(_cfg("clipfsar_vitb16"), "train", 4) == pytest.approx(3 * (960 * total + head) - 2 * 960 * (2 * 196 * 768 * w))
    assert counts.model_flops(_cfg("clipfsar_vitb16"), "test", 4) == pytest.approx(320 * total + 4 * flops.clipfsar_head(512, 5, 5, 5, 8, 31))
    launches = counts.attention_work(_cfg("clipfsar_vitb16"), "train", 4)
    assert len(launches) == 48  # 12 layers x 2 chunks, forward and backward
    assert launches[0] == (float((3 + 1) * 480 * 197 * 768 * 2 + 480 * 12 * 197 * 4), float(2 * 2 * 480 * 12 * 197 * 197 * 64))


def _weights_like(shapes):
    return {k: torch.zeros(s, device="meta") for k, s in shapes.items()}


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("name", ["clipfsar_vitb16", "clipfsar_rn50"])
def test_tower_counts_match_torch_flop_counter(name):
    """torch's FlopCounterMode over the reference tower (meta tensors: nothing computed)."""
    from portbench import drive

    cfg = _cfg(name)
    arch = json.load(open(os.path.join(harness.ROOT, "configs", name + ".json")))["arch"]
    shapes = drive.head_shapes(cfg, "cpu", harness.load_module("families", "clipfsar"))
    w = {k[len("backbone."):]: torch.zeros(s, device="meta") for k, s in shapes.items() if k.startswith("backbone.")}
    x = torch.zeros(1, 224, 224, 3, device="meta")
    if arch["tower"] == "ViT":
        got = _counted(lambda: vit(x, w, Precision(), arch["heads"]))
        want = flops.vit_forward(768, 12, 12, 16, 224, 512)["total"]
    else:
        got = _counted(lambda: resnet(x, w, Precision(), arch["heads"]))
        want = flops.resnet_forward((3, 4, 6, 3), 64, 224, 1024, 32)["total"]
    assert got == pytest.approx(want, rel=1e-6)


TV_RESNETS = {"resnet18": ((2, 2, 2, 2), False, 512), "resnet34": ((3, 4, 6, 3), False, 512), "resnet50": ((3, 4, 6, 3), True, 2048)}


def tv_resnet_shapes(layers, bottleneck: bool) -> dict:
    """Shapes of a torchvision ResNet's state dict (without ``fc``)."""
    shapes = {"conv1.weight": (64, 3, 7, 7)}
    inplanes, expansion = 64, 4 if bottleneck else 1
    for stage, (blocks, planes) in enumerate(zip(layers, (64, 128, 256, 512)), start=1):
        for i in range(blocks):
            p = f"layer{stage}.{i}."
            convs = [(planes, inplanes, 1), (planes, planes, 3), (planes * 4, planes, 1)] if bottleneck else \
                [(planes, inplanes, 3), (planes, planes, 3)]
            for j, (o, c, k) in enumerate(convs, start=1):
                shapes[f"{p}conv{j}.weight"] = (o, c, k, k)
            if (stage > 1 and i == 0) or inplanes != planes * expansion:
                shapes[p + "downsample.0.weight"] = (planes * expansion, inplanes, 1, 1)
            inplanes = planes * expansion
    for name in [k for k in shapes if k.endswith(".weight")]:
        bn = name.replace("conv", "bn").replace("downsample.0", "downsample.1").rsplit(".", 1)[0]
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{bn}.{leaf}"] = (shapes[name][0],)
    return shapes


@pytest.mark.parametrize("name", sorted(TV_RESNETS))
@pytest.mark.parametrize("resolution", [224, 36])
def test_tv_resnet_counts_match_torch_flop_counter(name, resolution):
    layers, bottleneck, dim = TV_RESNETS[name]
    w = {k: torch.zeros(s, device="meta") for k, s in tv_resnet_shapes(layers, bottleneck).items()}
    x = torch.zeros(1, resolution, resolution, 3, device="meta")
    assert _counted(lambda: tv_resnet.resnet(x, w, Precision())) == pytest.approx(
        flops.tv_resnet_forward(layers, bottleneck, resolution)["total"], rel=1e-6)
