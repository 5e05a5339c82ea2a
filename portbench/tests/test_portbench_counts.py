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
    shapes = drive.head_shapes(cfg, "cpu")
    w = {k[len("backbone."):]: torch.zeros(s, device="meta") for k, s in shapes.items() if k.startswith("backbone.")}
    x = torch.zeros(1, 224, 224, 3, device="meta")
    if arch["tower"] == "ViT":
        got = _counted(lambda: vit(x, w, Precision(), arch["heads"]))
        want = flops.vit_forward(768, 12, 12, 16, 224, 512)["total"]
    else:
        got = _counted(lambda: resnet(x, w, Precision(), arch["heads"]))
        want = flops.resnet_forward((3, 4, 6, 3), 64, 224, 1024, 32)["total"]
    assert got == pytest.approx(want, rel=1e-6)
