"""Device-side train augmentation of the episodic stacks (counterpart of
clip_fsar_tpu/data/augment.py:39-103, 168-232, 274-439).

``fewshot_train_augment`` is the tail of the reference's episodic train
stacks: ColorJitter (brightness, contrast, saturation, hue through
RGB <-> HSV, random grayscale), mean/std normalization, then RandomErasing.
Query clips are jittered unconditionally, support clips only under
``AUGMENTATION.COLOR_AUG``.  As in the JAX package, one op order is drawn per
call for the whole batch and one factor per clip (``CONSISTENT``) or per
frame.  ``AUGMENTATION.RANDOM_ERASING.ENABLE`` erases in both stacks, and
``AUGMENTATION.NO_RANDOM_ERASE`` keeps the support clips clean: per clip,
with probability PROB, COUNT rectangles of the same place in every frame
(timm's geometry: of 10 attempts at an area in AREA_RANGE of the frame
shared among the rectangles and an aspect within [MIN_ASPECT,
1/MIN_ASPECT], the first that fits), filled with 0 (``const``), one N(0, 1)
colour per rectangle (``rand``) or N(0, 1) per pixel (``pixel``), in
normalized space; with NUM_SPLITS > 1 the first 1/NUM_SPLITS of the clips
stay clean.

Drawing and applying are split: ``draw_jitter`` and ``draw_erasing`` take
every random number from a ``torch.Generator`` on the device,
``color_jitter_batch`` and ``random_erasing_batch`` apply given draws, so a
test can hand the port the JAX package's own draws.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import List, Optional, Sequence, Tuple

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


@dataclasses.dataclass(frozen=True)
class ErasingConfig:
    """``AUGMENTATION.RANDOM_ERASING`` (base.yaml values; the JAX package's
    fallbacks for a key set to a false value)."""

    probability: float = 0.25
    area_range: Tuple[float, float] = (0.02, 0.33)
    min_aspect: float = 0.3
    mode: str = "const"
    count: Tuple[int, int] = (1, 1)
    num_splits: int = 0

    @classmethod
    def from_cfg(cls, cfg) -> Optional["ErasingConfig"]:
        """None unless RANDOM_ERASING.ENABLE."""
        aug = cfg.AUGMENTATION if "AUGMENTATION" in cfg else {}
        re = aug.get("RANDOM_ERASING", {})
        if not (hasattr(re, "get") and bool(re.get("ENABLE", False))):
            return None
        mode = str(re.get("MODE", "const") or "const")
        if mode not in ("const", "rand", "pixel"):
            raise ValueError(f"AUGMENTATION.RANDOM_ERASING.MODE {mode!r}: const, rand or pixel")
        lo, hi = (float(v) for v in re.get("AREA_RANGE", (0.02, 0.33)))
        min_count, max_count = (int(v) for v in re.get("COUNT", (1, 1)))
        return cls(
            probability=float(re.get("PROB", 0.25) or 0.25),
            area_range=(lo, hi),
            min_aspect=float(re.get("MIN_ASPECT", 0.3) or 0.3),
            mode=mode,
            count=(min_count, max_count),
            num_splits=int(re.get("NUM_SPLITS", 0) or 0),
        )


@dataclasses.dataclass
class ErasingDraws:
    """One call's random numbers for N clips and up to K = COUNT[1]
    rectangles each: ``on`` [N] bool; per rectangle ``top``, ``left``,
    ``height``, ``width`` [N, K] (int64) and ``use`` [N, K] bool (the
    rectangle is one of the clip's drawn count and one of its 10 attempts
    fit); ``fill`` None (const), [N, K, C] (rand) or [N, K, T, H, W, C]
    (pixel), float32."""

    on: torch.Tensor
    top: torch.Tensor
    left: torch.Tensor
    height: torch.Tensor
    width: torch.Tensor
    use: torch.Tensor
    fill: Optional[torch.Tensor]


ERASE_ATTEMPTS = 10


def erase_box_sizes(area: torch.Tensor, log_ratio: torch.Tensor, count: torch.Tensor, img_h: int, img_w: int) -> tuple:
    """timm's rectangle geometry from the attempts' draws: ``area`` [..., 10]
    (fractions of the frame, uniform in AREA_RANGE) shared among the clip's
    ``count`` [...] rectangles, ``log_ratio`` [..., 10] (uniform in
    [log MIN_ASPECT, -log MIN_ASPECT]).  Returns (height, width, fits), the
    sizes of the first attempt that fits inside the frame (of the first
    attempt where none does, as the JAX package picks) and whether one did,
    in the JAX package's float32 arithmetic (augment.py:202-209)."""
    target = area * float(img_h * img_w) / count.clamp_min(1)[..., None].float()
    ratio = torch.exp(log_ratio)
    hh = torch.round(torch.sqrt(target * ratio)).long()
    ww = torch.round(torch.sqrt(target / ratio)).long()
    valid = (ww < img_w) & (hh < img_h)
    pick = valid.long().argmax(dim=-1, keepdim=True)  # the first attempt that fits (0 if none does)
    return hh.gather(-1, pick)[..., 0], ww.gather(-1, pick)[..., 0], valid.any(dim=-1)


def draw_erasing(generator: torch.Generator, shape: Sequence[int], ec: ErasingConfig, device=None) -> ErasingDraws:
    """Every random number of one ``random_erasing_batch`` call on clips of
    ``shape`` [N, T, H, W, C], from ``generator`` (on ``device``); nothing
    is read back to the host."""
    n, t, img_h, img_w, c = shape
    min_count, max_count = ec.count
    log_lo, log_hi = math.log(ec.min_aspect), math.log(1.0 / ec.min_aspect)

    def unif(lo: float, hi: float, size) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(size, generator=generator, device=device)

    def place(room: torch.Tensor) -> torch.Tensor:  # uniform over [0, room), room >= 1, as the JAX package's randint
        return (torch.rand(room.shape, generator=generator, device=device) * room).long().minimum(room - 1)

    on = torch.rand(n, generator=generator, device=device) < ec.probability
    if min_count == max_count:
        count = torch.full((n,), min_count, dtype=torch.long, device=device)
    else:
        count = torch.randint(min_count, max_count + 1, (n,), generator=generator, device=device)
    blocks = (n, max_count)
    height, width, fits = erase_box_sizes(
        unif(*ec.area_range, blocks + (ERASE_ATTEMPTS,)), unif(log_lo, log_hi, blocks + (ERASE_ATTEMPTS,)), count[:, None], img_h, img_w
    )
    top, left = place((img_h - height).clamp_min(1)), place((img_w - width).clamp_min(1))
    use = fits & (torch.arange(max_count, device=device) < count[:, None])
    fill = None
    if ec.mode == "rand":
        fill = torch.randn(blocks + (c,), generator=generator, device=device)
    elif ec.mode == "pixel":
        fill = torch.randn(blocks + (t, img_h, img_w, c), generator=generator, device=device)
    return ErasingDraws(on, top, left, height, width, use, fill)


def random_erasing_batch(x: torch.Tensor, draws: ErasingDraws, ec: ErasingConfig) -> torch.Tensor:
    """Apply one call's draws to normalized clips [N, T, H, W, C]: each
    drawn rectangle, in every frame, takes its fill (a later rectangle over
    an earlier one where they overlap), on the clips drawn ``on``; with
    NUM_SPLITS > 1 the first N // NUM_SPLITS clips are left as they are.
    Selections only: the output holds input and fill values bit for bit."""
    n, t, img_h, img_w, c = x.shape
    rows = torch.arange(img_h, device=x.device)[None, None, :, None]
    cols = torch.arange(img_w, device=x.device)[None, None, None, :]
    d = draws
    top, left, height, width = (v[..., None, None] for v in (d.top, d.left, d.height, d.width))
    masks = (rows >= top) & (rows < top + height) & (cols >= left) & (cols < left + width) & d.use[..., None, None]  # [N, K, H, W]
    fill = torch.zeros_like(x)
    for blk in range(masks.shape[1]):
        m = masks[:, blk, None, :, :, None]  # [N, 1, H, W, 1]
        if ec.mode == "rand":
            fill = torch.where(m, d.fill[:, blk, None, None, None, :], fill)
        elif ec.mode == "pixel":
            fill = torch.where(m, d.fill[:, blk], fill)
    erased = torch.where(masks.any(dim=1)[:, None, :, :, None] & d.on[:, None, None, None, None], fill, x)
    if ec.num_splits > 1:
        clean = n // ec.num_splits
        erased = torch.cat([x[:clean], erased[clean:]])
    return erased


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
    seed and so draws the same order).  Then RandomErasing under its ENABLE,
    on support clips unless AUGMENTATION.NO_RANDOM_ERASE, with draws from
    ``generator`` after the jitter's.  A None generator only normalizes."""
    aug = cfg.AUGMENTATION if "AUGMENTATION" in cfg else {}
    if generator is None:
        return normalize_images(clips, mean, std)
    if is_query or bool(aug.get("COLOR_AUG", False)):
        jc = JitterConfig.from_cfg(cfg)
        draws = draw_jitter(generator, host if host is not None else host_generator(generator), clips.shape[0], clips.shape[1], jc, device=clips.device)
        x = standardize(color_jitter_batch(clips.float() / 255.0, draws, jc), mean, std)
    else:
        x = normalize_images(clips, mean, std)
    ec = ErasingConfig.from_cfg(cfg)
    if ec is None or (not is_query and bool(aug.get("NO_RANDOM_ERASE", False))):
        return x
    return random_erasing_batch(x, draw_erasing(generator, x.shape, ec, device=x.device), ec)
