"""Operations of the clipfsar_rn50 cells: CLIP RN50 ((3, 4, 6, 3) bottlenecks, width 64, 224 px,
attention pool of 32 heads, output 1024) under the CLIP-FSAR head.  Of the port's kernels the tower
runs the BatchNorm's; no attention kernel."""

from __future__ import annotations

from portbench import flops

LAYERS, WIDTH, RES, OUT, HEADS = (3, 4, 6, 3), 64, 224, 1024, 32


def model_flops(cfg: dict, kind: str, episodes: int) -> float:
    """Model FLOPs of one step."""
    return flops.step_flops(cfg, kind, episodes, flops.resnet_forward(LAYERS, WIDTH, RES, OUT, HEADS), OUT)


def attention_work(cfg: dict, kind: str, episodes: int) -> list:
    """No attention kernel: the RN tower's pool runs plain attention (its BatchNorm kernels are read by time alone)."""
    return []
