"""Feature-map visualization (counterpart of
clip_fsar_tpu/utils/visualization.py, the reference's base_blocks.py:23-63).

Under VISUALIZATION.ENABLE and VISUALIZATION.FEATURE_MAPS.ENABLE the test
captures every residual block's output (``FeatureMaps``: forward hooks on
the Base3DBlock modules, where the JAX package sows them with flax's
``capture_intermediates``), and ``save_feature_maps`` writes each sample's
channel-normalized tile under
``BASE_OUTPUT_DIR/NAME/im_{id}/{layer}_feature.jpg``, the layer named by its
module path with "_" (``backbone_conv2_res_1``), as there.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
from torch import nn

# module classes whose outputs the reference's BaseModule hook captures (the conv backbones' residual blocks)
_CAPTURE_CLASSES = ("Base3DBlock",)


def visualization_enabled(cfg) -> bool:
    viz = cfg.get("VISUALIZATION", None)
    if not viz or not viz.get("ENABLE", False):
        return False
    fm = viz.get("FEATURE_MAPS", None)
    return bool(fm and fm.get("ENABLE", False))


class FeatureMaps:
    """Forward hooks on ``model``'s residual blocks while the context is
    open: ``maps`` holds each block's output of the last call, on its
    device, [B, C, T, H, W], by layer name."""

    def __init__(self, model: nn.Module):
        self.model = model
        self.maps: Dict[str, torch.Tensor] = {}
        self._handles = []

    def __enter__(self) -> "FeatureMaps":
        for name, m in self.model.named_modules():
            if type(m).__name__ in _CAPTURE_CLASSES:
                self._handles.append(m.register_forward_hook(lambda _m, _i, out, layer=name.replace(".", "_"): self.maps.__setitem__(layer, out.detach())))
        return self

    def __exit__(self, *exc) -> None:
        for h in self._handles:
            h.remove()
        self._handles.clear()

    def take(self) -> Dict[str, np.ndarray]:
        """The captured maps as float32 numpy [B, T, H, W, C] (waits for the
        card), and the capture emptied for the next call."""
        out = {name: t.float().permute(0, 2, 3, 4, 1).cpu().numpy() for name, t in self.maps.items()}
        self.maps.clear()
        return out


def tile_feature_map(feat: np.ndarray) -> np.ndarray:
    """One sample's [T, H, W, C] feature map -> the channel-normalized
    [C*H, T*W] grayscale tile (min / max over the channel axis; rows
    channels x height, columns time x width)."""
    t, h, w, c = feat.shape
    feat = feat.astype(np.float32)
    xmin = feat.min(axis=-1, keepdims=True)
    xmax = feat.max(axis=-1, keepdims=True)
    x = (feat - xmin) / np.maximum(xmax - xmin, 1e-8)
    return x.transpose(3, 1, 0, 2).reshape(c * h, t * w)


def save_feature_maps(maps: Dict[str, np.ndarray], cfg, start_id: int = 0, valid=None) -> int:
    """Write each sample's tile of every captured layer ([B, T, H, W, C]
    each), skipping the rows ``valid`` [B] marks as padding, so image ids
    count real samples.  Returns the samples written (the caller advances
    ``start_id`` by it)."""
    base = str(cfg.VISUALIZATION.FEATURE_MAPS.get("BASE_OUTPUT_DIR", "") or cfg.get("OUTPUT_DIR", "."))
    name = str(cfg.VISUALIZATION.get("NAME", "") or "default")
    written = 0
    for layer, feat in maps.items():
        if feat.ndim != 5:
            continue
        rows = range(feat.shape[0]) if valid is None else [i for i in range(feat.shape[0]) if i < len(valid) and valid[i]]
        written = len(rows)
        for out_i, i in enumerate(rows):
            sample_dir = os.path.join(base, name, f"im_{start_id + out_i}")
            os.makedirs(sample_dir, exist_ok=True)
            tile = (tile_feature_map(feat[i]) * 255.0).round().astype(np.uint8)
            _write_gray(os.path.join(sample_dir, f"{layer}_feature.jpg"), tile)
    return written


def _write_gray(path: str, img: np.ndarray) -> None:
    try:
        import cv2

        cv2.imwrite(path, img)
    except Exception:  # headless / no-jpeg builds: keep the tile as .npy
        np.save(path + ".npy", img)
