"""Episodic train and eval transforms on the host and normalization on the
device (counterpart of clip_fsar_tpu/data/transforms.py:184-220).

The resize/crop arithmetic is the JAX package's own numpy fixed-point
replica (``_np_resize_crop_flip``), pixel-identical to its native C++
kernel: the JAX transforms reach that kernel through a module that probes
jax, so the port calls the numpy version directly.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from clip_fsar_tpu.data.transforms import _np_resize_crop_flip, _stretch_dims


def fewshot_train_transform(frames: np.ndarray, cfg, rng: np.random.Generator, is_query: bool) -> np.ndarray:
    """Episodic train transform (reference ssv2_few_shot.py:528-613): flip
    (query clips with p = 0.5 always, support clips only under
    AUGMENTATION.RANDOM_FLIP), then the fixed-size stretch to
    TRAIN_JITTER_SCALES and a random TRAIN_CROP_SIZE crop, drawing from
    ``rng`` in the JAX package's order."""
    nh, nw = _stretch_dims(cfg.DATA.TRAIN_JITTER_SCALES)
    size = int(cfg.DATA.TRAIN_CROP_SIZE)
    if is_query:
        flip = bool(rng.random() < 0.5)
    else:
        aug = cfg.AUGMENTATION if "AUGMENTATION" in cfg else {}
        flip = bool(aug.get("RANDOM_FLIP", False)) and bool(rng.random() < 0.5)
    # int(random.uniform(0, max)) of the reference lands in [0, max-1]
    y = int(rng.integers(0, max(nh - size, 1)))
    x = int(rng.integers(0, max(nw - size, 1)))
    return _np_resize_crop_flip(frames, nh, nw, y, x, size, flip)


def fewshot_test_transform(frames: np.ndarray, cfg) -> np.ndarray:
    """Episodic eval transform: fixed-size stretch to TEST_SCALE + center crop."""
    nh, nw = _stretch_dims(cfg.DATA.TEST_SCALE)
    size = int(cfg.DATA.TEST_CROP_SIZE)
    return _np_resize_crop_flip(frames, nh, nw, (nh - size) // 2, (nw - size) // 2, size, flip=False)


def standardize(x: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """Device-side: float [..., 3] in [0, 1] -> (x - mean) / std."""
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean_t) / std_t


def normalize_images(images: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """Device-side: uint8/float [..., 3] -> normalized float32."""
    return standardize(images.float() / 255.0, mean, std)
