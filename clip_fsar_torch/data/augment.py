"""Device-side train augmentation of the episodic stacks (counterpart of
clip_fsar_tpu/data/augment.py:39-103, 274-439).

``fewshot_train_augment`` is the tail of the reference's episodic train
stacks: ColorJitter (brightness, contrast, saturation, hue through
RGB <-> HSV, random grayscale) then mean/std normalization.  Query clips are
jittered unconditionally, support clips only under
``AUGMENTATION.COLOR_AUG``.  As in the JAX package, one op order is drawn per
call for the whole batch and one factor per clip (``CONSISTENT``) or per
frame.

Drawing and applying are split: ``draw_jitter`` takes every random number
from a ``torch.Generator`` on the device, ``color_jitter_batch`` applies
given draws, so a test can hand the port the JAX package's own draws.
``AUGMENTATION.RANDOM_ERASING`` is not ported yet (off in base.yaml and in
the shipped few-shot configs) and raises.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from clip_fsar_torch.data.transforms import device_constant, normalize_images, standardize

_LUMA = (0.299, 0.587, 0.114)  # ITU-R 601-2


@dataclasses.dataclass(frozen=True)
class JitterConfig:
    """Strengths of the jitter ops (``AUGMENTATION`` keys, base.yaml values)."""

    brightness: float = 0.0
    contrast: float = 0.0
    saturation: float = 0.0
    hue: float = 0.0
    grayscale: float = 0.0
    consistent: bool = True
    shuffle: bool = True

    @classmethod
    def from_cfg(cls, cfg) -> "JitterConfig":
        aug = cfg.AUGMENTATION if "AUGMENTATION" in cfg else {}
        return cls(
            brightness=float(aug.get("BRIGHTNESS", 0.0) or 0.0),
            contrast=float(aug.get("CONTRAST", 0.0) or 0.0),
            saturation=float(aug.get("SATURATION", 0.0) or 0.0),
            hue=float(aug.get("HUE", 0.0) or 0.0),
            grayscale=float(aug.get("GRAYSCALE", 0.0) or 0.0),
            consistent=bool(aug.get("CONSISTENT", True)),
            shuffle=bool(aug.get("SHUFFLE", True)),
        )

    def active(self) -> List[str]:
        """The jitter ops that run, in their canonical order."""
        strengths = (("brightness", self.brightness), ("contrast", self.contrast), ("saturation", self.saturation), ("hue", self.hue))
        return [name for name, v in strengths if v > 0]


@dataclasses.dataclass
class JitterDraws:
    """One call's random numbers, in the JAX package's shapes: factors
    [N, 1, 1, 1, 1] (one per clip) or [N, T, 1, 1, 1] (per frame), hue
    without the last axis; ``order`` indexes the permutations of the active
    ops; ``gray`` [N, 1, 1, 1, 1] bool."""

    brightness: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor
    order: int
    gray: torch.Tensor


def check_supported(cfg) -> None:
    """Raise for augmentation the port does not have yet."""
    aug = cfg.AUGMENTATION if "AUGMENTATION" in cfg else {}
    erasing = aug.get("RANDOM_ERASING", {})
    if hasattr(erasing, "get") and bool(erasing.get("ENABLE", False)):
        raise NotImplementedError("AUGMENTATION.RANDOM_ERASING is not ported yet: ROADMAP Queue 1, train slice leftovers (random erasing)")


def draw_jitter(generator: torch.Generator, host: np.random.Generator, n: int, t: int, jc: JitterConfig, device=None) -> JitterDraws:
    """Every random number of one ``color_jitter_batch`` call: uniform
    factors in [max(0, 1-v), 1+v] (hue in [-v, v]) and the grayscale flags
    from ``generator`` (on ``device``), the op-order index from ``host``.
    The order index picks python code, so it is drawn on the host: reading
    it back from the device would make every train step wait for the one
    before.  Both generators advance with every call."""
    shape = (n, 1, 1, 1, 1) if jc.consistent else (n, t, 1, 1, 1)

    def unif(lo: float, hi: float, size) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(size, generator=generator, device=device)

    b_f = unif(max(0.0, 1.0 - jc.brightness), 1.0 + jc.brightness, shape)
    c_f = unif(max(0.0, 1.0 - jc.contrast), 1.0 + jc.contrast, shape)
    s_f = unif(max(0.0, 1.0 - jc.saturation), 1.0 + jc.saturation, shape)
    h_f = unif(-jc.hue, jc.hue, shape[:-1])
    num_orders = math.factorial(len(jc.active()))  # permutations of the active ops
    order = int(host.integers(num_orders))
    gray = torch.rand((n, 1, 1, 1, 1), generator=generator, device=device) < jc.grayscale
    return JitterDraws(b_f, c_f, s_f, h_f, order, gray)


def host_generator(generator: torch.Generator) -> np.random.Generator:
    """The host generator that goes with ``generator``: seeded from its
    seed, which the host knows without asking the device."""
    return np.random.default_rng(generator.initial_seed())


def _blend(a: torch.Tensor, b: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
    return torch.clamp(ratio * a + (1.0 - ratio) * b, 0.0, 1.0)


def _grayscale_cf(img: torch.Tensor) -> torch.Tensor:
    """Luma of channel-first [..., 3, H, W], broadcast back to 3 channels."""
    w = device_constant(tuple(_LUMA), img.dtype, img.device)[:, None, None]
    return (img * w).sum(dim=-3, keepdim=True).expand(img.shape)


def _adjust_hue_cf(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Hue shift of channel-first [..., 3, H, W] through HSV (the JAX
    package's ``_adjust_hue_cf``, reference transformations.py)."""
    r, g, b = img[..., 0, :, :], img[..., 1, :, :], img[..., 2, :, :]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    eqc = maxc == minc
    cr = maxc - minc
    ones = torch.ones_like(maxc)
    s = cr / torch.where(eqc, ones, maxc)
    div = torch.where(eqc, ones, cr)
    rc, gc, bc = (maxc - r) / div, (maxc - g) / div, (maxc - b) / div
    h = (
        (maxc == r) * (bc - gc)
        + ((maxc == g) & (maxc != r)) * (2.0 + rc - bc)
        + ((maxc != g) & (maxc != r)) * (4.0 + gc - rc)
    )
    h = torch.remainder(h / 6.0 + 1.0 + factor, 1.0)

    v = maxc
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    i = i.to(torch.int32) % 6
    p = torch.clamp(v * (1.0 - s), 0.0, 1.0)
    q = torch.clamp(v * (1.0 - s * f), 0.0, 1.0)
    t = torch.clamp(v * (1.0 - s * (1.0 - f)), 0.0, 1.0)

    def pick(*choices):
        out = choices[5]
        for k in (4, 3, 2, 1, 0):
            out = torch.where(i == k, choices[k], out)
        return out

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p), pick(p, p, t, v, v, q)], dim=-3)


def color_jitter_batch(clips: torch.Tensor, draws: JitterDraws, jc: JitterConfig) -> torch.Tensor:
    """Apply one call's draws to clips [N, T, H, W, 3] float in [0, 1]: the
    active ops in the drawn order (or canonical order without SHUFFLE),
    then grayscale where drawn."""
    x = clips.movedim(-1, 2)  # channel-first [N, T, 3, H, W], as the JAX package computes
    ops = {
        "brightness": lambda v: _blend(v, torch.zeros_like(v), draws.brightness),
        "contrast": lambda v: _blend(v, _grayscale_cf(v).mean(dim=(-3, -2, -1), keepdim=True), draws.contrast),
        "saturation": lambda v: _blend(v, _grayscale_cf(v), draws.saturation),
        "hue": lambda v: _adjust_hue_cf(v, draws.hue),
    }
    active = jc.active()
    order = range(len(active))
    if jc.shuffle and len(active) > 1:
        order = list(itertools.permutations(range(len(active))))[draws.order]
    for i in order:
        x = ops[active[i]](x)
    if jc.grayscale > 0:
        x = torch.where(draws.gray, _grayscale_cf(x), x)
    return x.movedim(2, -1)


def fewshot_train_augment(
    clips: torch.Tensor, cfg, mean: Sequence[float], std: Sequence[float], is_query: bool, generator: Optional[torch.Generator],
    host: Optional[np.random.Generator] = None,
) -> torch.Tensor:
    """uint8 clips [N, T, H, W, 3] -> normalized float32: ColorJitter on
    query clips always and on support clips under AUGMENTATION.COLOR_AUG,
    with draws from ``generator`` and, for the op order, from the host
    generator ``host``: a caller that jitters more than once with one
    ``generator`` makes ``host`` with ``host_generator`` and passes it to
    every call (without one, each call seeds its own from ``generator``'s
    seed and so draws the same order).  A None generator only normalizes."""
    check_supported(cfg)
    aug = cfg.AUGMENTATION if "AUGMENTATION" in cfg else {}
    if generator is None or not (is_query or bool(aug.get("COLOR_AUG", False))):
        return normalize_images(clips, mean, std)
    jc = JitterConfig.from_cfg(cfg)
    draws = draw_jitter(generator, host if host is not None else host_generator(generator), clips.shape[0], clips.shape[1], jc, device=clips.device)
    return standardize(color_jitter_batch(clips.float() / 255.0, draws, jc), mean, std)
