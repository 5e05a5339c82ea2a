"""Episodic train and eval transforms on the host and normalization on the
device (counterpart of clip_fsar_tpu/data/transforms.py:75-113, 148-220).

The fused resize + crop + flip runs the native C++ pass
(``clip_fsar_torch/native/frameops``) where it builds, and the numpy
fixed-point replica ``_np_resize_crop_flip`` otherwise; their pixels are
identical.  ``RESIZE_CALLS`` counts which of the two the loaders took.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from clip_fsar_torch.native import frameops

# clips resized by each implementation since import (a run shows which one its loaders used)
RESIZE_CALLS = {"native": 0, "numpy": 0}


def _fixed_point_taps(src: int, dst: int, begin: int, count: int):
    """Bilinear taps with 8-bit fixed-point weights — the exact math of
    the native kernel (clip_fsar_torch/native/frameops.cpp)."""
    s = (np.arange(begin, begin + count, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    s = np.maximum(s, 0.0)
    lo = np.minimum(s.astype(np.int64), src - 1)
    hi = np.minimum(lo + 1, src - 1)
    w = np.floor((s - lo) * 256.0 + 0.5).astype(np.int64)
    return lo, hi, w


def _np_resize_crop_flip(
    frames: np.ndarray, nh: int, nw: int, y: int, x: int, size: int, flip: bool, size_w: int = 0
) -> np.ndarray:
    """Pure-numpy replica of the native fixed-point kernel — pixel-
    identical output, used when the C++ toolchain is unavailable so data
    pipelines stay deterministic across environments."""
    t, h, w, _ = frames.shape
    ylo, yhi, wy = _fixed_point_taps(h, nh, y, size)
    xlo, xhi, wx = _fixed_point_taps(w, nw, x, size_w or size)
    f = frames.astype(np.int64)
    # horizontal pass (value * 256)
    row = f[:, :, xlo] * (256 - wx)[None, None, :, None] + f[:, :, xhi] * wx[None, None, :, None]
    # vertical blend (value * 256 * 256) with the kernel's rounding
    v = row[:, ylo] * (256 - wy)[None, :, None, None] + row[:, yhi] * wy[None, :, None, None]
    out = ((v + (1 << 15)) >> 16).astype(np.uint8)
    return np.ascontiguousarray(out[:, :, ::-1]) if flip else out


def _fused_resize_crop(frames: np.ndarray, nh: int, nw: int, y: int, x: int, size: int, flip: bool) -> np.ndarray:
    """Resize to (nh, nw), crop [size, size] at (y, x), flip the crop —
    one native C++ pass when available (only cropped pixels computed),
    numpy fixed-point replica otherwise (pixel-identical to the native
    kernel)."""
    if frameops.available():
        RESIZE_CALLS["native"] += 1
        return frameops.resize_crop_flip(frames, nh, nw, y, x, size, size, flip)
    RESIZE_CALLS["numpy"] += 1
    return _np_resize_crop_flip(frames, nh, nw, y, x, size, flip)


def _stretch_dims(cfg_scale) -> Tuple[int, int]:
    """KineticsResizedCropFewshot sizing (reference transformations.py
    :676-731): the clip is stretched to the FIXED size (scale[0],
    scale[1]) — height = scale[0], width = scale[1] (aspect-destroying
    with the shipped [256, 256] configs) — NOT a short-side resize."""
    if isinstance(cfg_scale, (list, tuple)):
        h = int(cfg_scale[0])
        w = int(cfg_scale[1]) if len(cfg_scale) > 1 else h
    else:
        h = w = int(cfg_scale)
    return h, w


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
    return _fused_resize_crop(frames, nh, nw, y, x, size, flip)


def fewshot_train_stretch(frames: np.ndarray, cfg) -> np.ndarray:
    """The fixed-size stretch of ``fewshot_train_transform`` without its crop
    and flip: uint8 [T, H, W, 3] -> [T, nh, nw, 3] at TRAIN_JITTER_SCALES
    (JAX transforms.py:161-181).  The fixed-point taps are computed in
    destination coordinates, so rows [y, y + size) and columns [x, x + size)
    of this frame are bit for bit the fused resize + crop at (y, x): the
    train frame bank stores this and crops on the device
    (data/frame_bank.py)."""
    nh, nw = _stretch_dims(cfg.DATA.TRAIN_JITTER_SCALES)
    if frameops.available():
        RESIZE_CALLS["native"] += 1
        return frameops.resize_crop_flip(frames, nh, nw, 0, 0, nh, nw, False)
    RESIZE_CALLS["numpy"] += 1
    return _np_resize_crop_flip(frames, nh, nw, 0, 0, nh, False, size_w=nw)


def fewshot_test_transform(frames: np.ndarray, cfg) -> np.ndarray:
    """Episodic eval transform: fixed-size stretch to TEST_SCALE + center crop."""
    nh, nw = _stretch_dims(cfg.DATA.TEST_SCALE)
    size = int(cfg.DATA.TEST_CROP_SIZE)
    return _fused_resize_crop(frames, nh, nw, (nh - size) // 2, (nw - size) // 2, size, flip=False)


@functools.lru_cache(maxsize=None)
def device_constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``values`` as a tensor on ``device``, made once and kept (every caller
    gets the same tensor: read it, never write to it): a tensor built from
    python numbers reaches a card by a copy from pageable memory, which waits
    for everything the card has queued."""
    return torch.tensor(values, dtype=dtype, device=device)


def standardize(x: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """Device-side: float [..., 3] in [0, 1] -> (x - mean) / std."""
    mean_t = device_constant(tuple(float(v) for v in mean), torch.float32, x.device)
    std_t = device_constant(tuple(float(v) for v in std), torch.float32, x.device)
    return (x - mean_t) / std_t


def normalize_images(images: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """Device-side: uint8/float [..., 3] -> normalized float32."""
    return standardize(images.float() / 255.0, mean, std)
