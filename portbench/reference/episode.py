"""An episode's clips from a frame bank, and the episodic train transform, in plain PyTorch.

Test clips are bank rows [N, T] of a bank of centre-cropped frames.  Train clips are rows plus a
crop (y, x) and a flip flag [N, T + 3] of a bank of frames stretched to the jitter scale: each
frame is cropped at (y, x) to the crop size and mirrored left to right where the flag is set.
Query clips of a train episode then go through ColorJitter (the reference code's episodic
stack): brightness, contrast, saturation and hue in a drawn order, factors drawn per clip,
then grayscale with a drawn probability.  Every clip is normalized by the CLIP mean and std.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import torch

LUMA = (0.299, 0.587, 0.114)


def eval_clips(bank: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """uint8 clips [N, T, H, W, 3] of bank rows [N, T]."""
    return bank[rows.long()]


def train_clips(bank: torch.Tensor, idx: torch.Tensor, num_frames: int, crop: int) -> torch.Tensor:
    """uint8 clips [N, T, crop, crop, 3] of idx [N, T + 3] (rows, crop y, crop x, flip)."""
    out = []
    nh, nw = bank.shape[1], bank.shape[2]
    for clip in idx.long().tolist():
        rows, (y, x, flip) = clip[:num_frames], clip[num_frames:]
        y, x = min(max(y, 0), nh - crop), min(max(x, 0), nw - crop)
        frames = bank[torch.tensor(rows, device=bank.device), y:y + crop, x:x + crop]
        out.append(frames.flip(2) if flip else frames)
    return torch.stack(out)


def normalize(x: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """float [..., 3] in [0, 1] -> (x - mean) / std."""
    return (x - torch.tensor(mean, device=x.device)) / torch.tensor(std, device=x.device)


def eval_episode_clips(bank: torch.Tensor, support: torch.Tensor, target: torch.Tensor, mean: Sequence[float],
                       std: Sequence[float]) -> torch.Tensor:
    """Normalized float clips [S + Q, T, H, W, 3] of an episode's support then target bank rows."""
    clips = torch.cat([eval_clips(bank, support), eval_clips(bank, target)])
    return normalize(clips.float() / 255.0, mean, std)


def _gray(img: torch.Tensor) -> torch.Tensor:
    """Luma of [..., H, W, 3], broadcast to 3 channels."""
    return (img * torch.tensor(LUMA, device=img.device)).sum(dim=-1, keepdim=True).expand(img.shape)


def _blend(a: torch.Tensor, b: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
    return (ratio * a + (1.0 - ratio) * b).clamp(0.0, 1.0)


def _hue(img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Rotate the hue of [..., H, W, 3] in [0, 1] by ``shift`` turns (RGB -> HSV -> RGB)."""
    r, g, b = img.unbind(-1)
    maxc, minc = img.max(dim=-1).values, img.min(dim=-1).values
    v, delta = maxc, maxc - minc
    s = torch.where(maxc > 0, delta / torch.where(maxc > 0, maxc, torch.ones_like(maxc)), torch.zeros_like(maxc))
    safe = torch.where(delta > 0, delta, torch.ones_like(delta))
    h = torch.where(maxc == r, (g - b) / safe, torch.where(maxc == g, 2.0 + (b - r) / safe, 4.0 + (r - g) / safe))
    h = torch.where(delta > 0, h, torch.zeros_like(h))
    h = torch.remainder(h / 6.0 + shift, 1.0)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    i = i.long() % 6
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    table = torch.stack([torch.stack(c, dim=-1) for c in ((v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q))])
    return torch.gather(table, 0, i[None, ..., None].expand((1,) + i.shape + (3,)))[0].clamp(0.0, 1.0)


def color_jitter(x: torch.Tensor, brightness: torch.Tensor, contrast: torch.Tensor, saturation: torch.Tensor, hue: torch.Tensor,
                 order: int, gray: torch.Tensor) -> torch.Tensor:
    """x [N, T, H, W, 3] in [0, 1]; per clip factors [N] (hue a shift in turns) and grayscale
    flags [N]; ``order`` indexes the permutations of (brightness, contrast, saturation, hue)."""
    per = lambda f: f.reshape(-1, 1, 1, 1, 1).float()  # noqa: E731
    ops = [
        lambda v: _blend(v, torch.zeros_like(v), per(brightness)),
        lambda v: _blend(v, _gray(v).mean(dim=(-3, -2, -1), keepdim=True), per(contrast)),
        lambda v: _blend(v, _gray(v), per(saturation)),
        lambda v: _hue(v, hue.reshape(-1, 1, 1, 1).float()),
    ]
    for i in list(itertools.permutations(range(4)))[order]:
        x = ops[i](x)
    return torch.where(gray.reshape(-1, 1, 1, 1, 1), _gray(x), x)
