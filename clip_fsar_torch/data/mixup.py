"""Mixup / CutMix / label smoothing (counterpart of
clip_fsar_tpu/data/mixup.py, timm's semantics as the reference's
datasets/utils/mixup.py), applied on the device inside the train step.

As in ``data/augment.py``, drawing and applying are split: ``draw_mixup``
takes every random number of one call from a numpy generator on the host (so
the step reads nothing back from the card to decide a branch), and
``mixup_batch`` applies given draws, so a test can hand the port the JAX
package's own draws.  Draws are per element of the global batch in every
mode: ``batch`` repeats one draw, ``pair`` mirrors the first half's, and
element i always mixes with element B - 1 - i (the flipped batch).  The
CutMix lambda is corrected to the box's area (the reference's correct_lam),
and CUTMIX.MINMAX draws the box size from that range of the image ratio
instead of from lambda (with CutMix's alpha forced to 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def smooth_one_hot(labels: torch.Tensor, num_classes: int, smoothing: float = 0.0) -> torch.Tensor:
    """Float32 one-hot targets [..., C] with ``smoothing`` spread evenly."""
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    onehot = (labels.long()[..., None] == torch.arange(num_classes, device=labels.device)).float()
    return onehot * (on - off) + off


@dataclasses.dataclass(frozen=True)
class MixupConfig:
    """The AUGMENTATION.MIXUP / CUTMIX keys as the JAX train step reads them."""

    mixup_alpha: float = 0.8
    cutmix_alpha: float = 0.0
    prob: float = 1.0
    switch_prob: float = 0.5
    mode: str = "batch"
    cutmix_minmax: Optional[Tuple[float, float]] = None

    @classmethod
    def from_cfg(cls, cfg) -> Optional["MixupConfig"]:
        """None unless MIXUP.ENABLE or CUTMIX.ENABLE."""
        aug = cfg.AUGMENTATION
        if not (bool(aug.MIXUP.get("ENABLE", False)) or bool(aug.CUTMIX.get("ENABLE", False))):
            return None
        minmax = aug.CUTMIX.get("MINMAX", None) if aug.CUTMIX.get("ENABLE", False) else None
        return cls(
            mixup_alpha=float(aug.MIXUP.get("ALPHA", 0.8) or 0.0),
            cutmix_alpha=1.0 if minmax else float(aug.CUTMIX.get("ALPHA", 0.0) or 0.0),
            prob=float(aug.MIXUP.get("PROB", 1.0)),
            switch_prob=float(aug.MIXUP.get("SWITCH_PROB", 0.5)),
            mode=str(aug.MIXUP.get("MODE", "batch")),
            cutmix_minmax=tuple(float(v) for v in minmax) if minmax else None,
        )


@dataclasses.dataclass
class MixupDraws:
    """One call's draws, per element of the global batch [B]: whether it is
    mixed at all (``applied``), by CutMix (``cutmix``), its lambda, and its
    box rows [y1, y2) and columns [x1, x2) (consulted where CutMix applies)."""

    applied: np.ndarray
    cutmix: np.ndarray
    lam: np.ndarray
    y1: np.ndarray
    y2: np.ndarray
    x1: np.ndarray
    x2: np.ndarray

    def take(self, lo: int, hi: int) -> "MixupDraws":
        """The draws of elements [lo, hi) (a rank's rows)."""
        return MixupDraws(*(getattr(self, f.name)[lo:hi] for f in dataclasses.fields(self)))


def _box(rng: np.random.Generator, h: int, w: int, lam: np.ndarray):
    """A box of area about (1 - lam) * h * w centred uniformly, clipped to the image."""
    ratio = np.sqrt(1.0 - lam)
    cut_h, cut_w = (h * ratio).astype(np.int32), (w * ratio).astype(np.int32)
    cy, cx = rng.integers(0, h, lam.shape), rng.integers(0, w, lam.shape)
    return (np.clip(cy - cut_h // 2, 0, h), np.clip(cy + cut_h // 2, 0, h), np.clip(cx - cut_w // 2, 0, w), np.clip(cx + cut_w // 2, 0, w))


def _box_minmax(rng: np.random.Generator, h: int, w: int, minmax, n: int):
    """timm's cutmix_minmax box: sides uniform in [min, max] of the image,
    placed uniformly among the positions that keep it inside."""
    lo_h, hi_h = int(h * minmax[0]), int(h * minmax[1])
    lo_w, hi_w = int(w * minmax[0]), int(w * minmax[1])
    cut_h = rng.integers(lo_h, max(hi_h, lo_h + 1), n)
    cut_w = rng.integers(lo_w, max(hi_w, lo_w + 1), n)
    y1 = np.floor(rng.random(n) * (h - cut_h)).astype(np.int64)
    x1 = np.floor(rng.random(n) * (w - cut_w)).astype(np.int64)
    return y1, y1 + cut_h, x1, x1 + cut_w


def draw_mixup(rng: np.random.Generator, b: int, h: int, w: int, mc: MixupConfig) -> MixupDraws:
    """Every random number of one ``mixup_batch`` call on a global batch of
    ``b`` videos of [h, w] pixels, from ``rng``."""
    n = 1 if mc.mode == "batch" else (b // 2 if mc.mode == "pair" else b)
    if mc.mode == "pair" and b % 2:
        raise ValueError("pair-mode mixup needs an even batch (reference mirrors half-batch params)")
    has_mix, has_cut = mc.mixup_alpha > 0.0, mc.cutmix_alpha > 0.0
    applied = (rng.random(n) < mc.prob) & (has_mix or has_cut)
    cutmix = (rng.random(n) < mc.switch_prob) if (has_mix and has_cut) else np.full(n, has_cut)
    beta = lambda a: rng.beta(max(a, 1e-8), max(a, 1e-8), n)  # noqa: E731
    lam = np.where(applied, np.where(cutmix, beta(mc.cutmix_alpha), beta(mc.mixup_alpha)), 1.0)
    box = _box_minmax(rng, h, w, mc.cutmix_minmax, n) if mc.cutmix_minmax is not None else _box(rng, h, w, lam)
    if mc.mode == "batch" and mc.cutmix_minmax is not None:
        applied = applied | cutmix  # the JAX batch mode pastes a MINMAX box whatever MIXUP.PROB drew (mixup.py:125-162)

    def full(x):  # [n] draws -> [b] per element
        x = np.asarray(x)
        if mc.mode == "batch":
            return np.repeat(x, b)
        return np.concatenate([x, x[::-1]]) if mc.mode == "pair" else x

    return MixupDraws(full(applied), full(cutmix), full(lam.astype(np.float32)), *(full(v) for v in box))


def _on(x: np.ndarray, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(x))  # a writable copy
    if dtype is not None:
        t = t.to(dtype)
    if torch.device(device).type == "cuda":  # from pinned memory: the copy does not wait for the card
        return t.pin_memory().to(device, non_blocking=True)
    return t


def mixup_batch(
    videos: torch.Tensor, partner: torch.Tensor, labels: torch.Tensor, partner_labels: torch.Tensor, num_classes: int,
    draws: MixupDraws, smoothing: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mix float videos [b, T, H, W, C] with ``partner`` (the videos of the
    mirrored elements: ``videos.flip(0)`` in one process) under ``draws`` (these
    b elements'), and their smoothed one-hot targets likewise.  Returns
    (videos, float32 targets [b, C])."""
    b, _, h, w, _ = videos.shape
    dev = videos.device
    applied, cutmix = _on(draws.applied, dev), _on(draws.cutmix, dev)
    lam = _on(draws.lam, dev, torch.float32)
    y1, y2, x1, x2 = (_on(v, dev, torch.int64) for v in (draws.y1, draws.y2, draws.x1, draws.x2))
    area = ((y2 - y1) * (x2 - x1)).float()
    lam_cut = 1.0 - area / float(h * w)
    take_cut = cutmix & applied
    ex = lambda v: v.reshape(b, 1, 1, 1, 1)  # noqa: E731
    yy = torch.arange(h, device=dev).reshape(1, 1, h, 1, 1)
    xx = torch.arange(w, device=dev).reshape(1, 1, 1, w, 1)
    inside = (yy >= ex(y1)) & (yy < ex(y2)) & (xx >= ex(x1)) & (xx < ex(x2))
    mixed_mix = ex(lam).to(videos.dtype) * videos + ex(1.0 - lam).to(videos.dtype) * partner
    mixed = torch.where(ex(take_cut), torch.where(inside, partner, videos), torch.where(ex(applied), mixed_mix, videos))
    lam_eff = torch.where(take_cut, lam_cut, lam)[:, None]
    targets = lam_eff * smooth_one_hot(labels, num_classes, smoothing) + (1.0 - lam_eff) * smooth_one_hot(partner_labels, num_classes, smoothing)
    return mixed, targets
