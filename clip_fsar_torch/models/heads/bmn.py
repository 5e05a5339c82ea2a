"""BMN head for temporal action localization (counterpart of
clip_fsar_tpu/models/heads/bmn.py:25-127, the reference's
module_zoo/heads/bmn_head.py:20-224).

Predicts start/end boundary probabilities and a (duration x time)
boundary-matching confidence map from window features [B, C, T], with the
optional regression map (VIDEO.HEAD.USE_BMN_REGRESSION) and verb/noun
classification maps (a [verbs, nouns] VIDEO.HEAD.NUM_CLASSES, EPIC).

The boundary-matching layer, the features [B, C, T] times the sample mask
[T, N*D*T] through the (N, 1, 1) Conv3d ``x_3d_p`` and a ReLU, is one op,
``ops.boundary_matching``: the Conv3d's weight first (a matrix product),
then a gather over the mask's nonzeros (a CUDA kernel on the card, with a
gathered backward), so neither the [B, C, N, D, T] activation nor a
convolution backward is formed.  ``x_3d_p`` keeps its parameters and
names.  The mask (``boundary_matching_mask``, the JAX package's numbers)
is built once per (T, D, N, per-bin, ratio) on the host and kept only as
the op's lists of its nonzeros, outside the state dict, as the JAX
package keeps it outside ``params``; ``mask_matrix`` gives it dense.
Everything runs in float32, as in the JAX package.
The localization runners build the head directly (train/localization.py),
as the JAX ones do, so it is not looked up in the head registry.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clip_fsar_torch.data.tal_features import duration_scale
from clip_fsar_torch.models.init import lecun_normal_
from clip_fsar_torch.ops.boundary_matching import boundary_matching, boundary_matching_lists



def interp1d_bin_mask(seg_xmin, seg_xmax, tscale, num_sample, num_sample_perbin) -> np.ndarray:
    """Sampling weights of one proposal over the T grid [T, num_sample]
    (the JAX package's loop, reference bmn_head.py:195-224)."""
    plen = float(seg_xmax - seg_xmin)
    plen_sample = plen / (num_sample * num_sample_perbin - 1.0)
    total = [seg_xmin + plen_sample * i for i in range(num_sample * num_sample_perbin)]
    cols = []
    for idx in range(num_sample):
        vec = np.zeros(tscale)
        for s in total[idx * num_sample_perbin : (idx + 1) * num_sample_perbin]:
            up = math.ceil(s)
            frac, down = math.modf(s)
            if 0 <= int(down) <= tscale - 1:
                vec[int(down)] += 1 - frac
            if 0 <= int(up) <= tscale - 1:
                vec[int(up)] += frac
        cols.append(vec / num_sample_perbin)
    return np.stack(cols, axis=1)


def boundary_matching_mask(tscale: int, dscale: int, num_sample: int, num_sample_perbin: int, boundary_ratio: float) -> np.ndarray:
    """The [T, num_sample, D, T_start] float32 sample mask (reference
    get_interp1d_mask): ``interp1d_bin_mask`` of every valid (start,
    duration) cell, zeros where start + duration >= T.  Vectorized over the
    starts and the bins of one duration with the loop's float64 arithmetic
    and its order of additions (each bin's down then up weight, sample by
    sample), so the values are the JAX package's bit for bit."""
    if dscale <= 0:
        raise ValueError(f"duration scale {dscale}: at least one duration is needed")
    out = np.zeros((tscale, num_sample, dscale, tscale), np.float32)
    n_total = num_sample * num_sample_perbin
    steps = np.arange(n_total)
    for duration in range(dscale):
        starts = np.arange(tscale - duration)  # start + duration < T
        if not len(starts):
            continue
        center = float(duration) + 1
        seg_xmin = starts - center * boundary_ratio
        seg_xmax = (starts + duration) + center * boundary_ratio
        plen_sample = (seg_xmax - seg_xmin) / (n_total - 1.0)
        samples = (seg_xmin[:, None] + plen_sample[:, None] * steps[None, :]).reshape(len(starts), num_sample, num_sample_perbin)
        acc = np.zeros((len(starts), num_sample, tscale))
        rows, bins = np.meshgrid(np.arange(len(starts)), np.arange(num_sample), indexing="ij")
        for j in range(num_sample_perbin):
            s = samples[:, :, j]
            frac, down = np.modf(s)
            for pos, weight in ((down.astype(np.int64), 1 - frac), (np.ceil(s).astype(np.int64), frac)):
                ok = (pos >= 0) & (pos <= tscale - 1)
                acc[rows[ok], bins[ok], pos[ok]] += weight[ok]
        out[:, :, duration, : len(starts)] = (acc / num_sample_perbin).transpose(2, 1, 0)
    return out


@functools.lru_cache(maxsize=2)
def mask_matrix(tscale: int, dscale: int, num_sample: int, num_sample_perbin: int, boundary_ratio: float) -> torch.Tensor:
    """``boundary_matching_mask`` as a [T, N*D*T] host tensor, built once per
    key (1.02 GB at the preset's T = D = 200, N = 32): the dense operand of
    the JAX package's product, for the tests; the model uses its lists."""
    return torch.from_numpy(boundary_matching_mask(tscale, dscale, num_sample, num_sample_perbin, boundary_ratio).reshape(tscale, -1))


def _conv_stack(cin: int, width: int, cout: int) -> nn.ModuleList:
    """conv1 (1x1) -> conv2 (3x3) -> conv3 (3x3) -> conv4 (1x1), the 2D map branches."""
    return nn.ModuleList([nn.Conv2d(cin, width, 1), nn.Conv2d(width, width, 3, padding=1), nn.Conv2d(width, width, 3, padding=1),
                          nn.Conv2d(width, cout, 1)])


class BaseBMN(nn.Module):
    """x [B, C, T] -> {"start", "end" [B, T]; "confidence_map" [B, 2, D, T]
    (regression, classification confidence); "reg_map" [B, 2, D, T],
    "verb_map" / "noun_map" [B, classes, D, T] or None}.  Parameter names
    are the flax ones (models/video/convert.py maps the JAX weights)."""

    def __init__(self, cfg, dim_in: int):
        super().__init__()
        h = cfg.VIDEO.HEAD
        self.tscale = int(cfg.DATA.TEMPORAL_SCALE)
        self.dscale = duration_scale(cfg)
        self.num_sample = int(h.NUM_SAMPLE)
        self.key = (self.tscale, self.dscale, self.num_sample, int(h.NUM_SAMPLE_PERBIN), float(h.BOUNDARY_RATIO))
        d1, d2, d3 = int(cfg.VIDEO.DIM1D), int(cfg.VIDEO.DIM2D), int(cfg.VIDEO.DIM3D)
        self.x_1d_s_conv1 = nn.Conv1d(dim_in, d1, 3, padding=1, groups=4)
        self.x_1d_s_conv2 = nn.Conv1d(d1, 1, 1)
        self.x_1d_e_conv1 = nn.Conv1d(dim_in, d1, 3, padding=1, groups=4)
        self.x_1d_e_conv2 = nn.Conv1d(d1, 1, 1)
        self.x_1d_p_conv = nn.Conv1d(dim_in, d1, 3, padding=1)
        self.x_3d_p = nn.Conv3d(d1, d3, (self.num_sample, 1, 1), stride=(self.num_sample, 1, 1))
        self.branches = {"p": 2}
        if bool(h.get("USE_BMN_REGRESSION", False)):
            self.branches["r"] = 2
        ncls = h.get("NUM_CLASSES", None)
        if isinstance(ncls, (list, tuple)):
            self.branches.update(verb=int(ncls[0]), noun=int(ncls[1]))
        for tag, n in self.branches.items():
            for i, conv in enumerate(_conv_stack(d3, d2, n), start=1):
                self.add_module(f"x_2d_{tag}_conv{i}", conv)

    def init_own_parameters(self, g: torch.Generator) -> None:
        """flax's defaults: lecun normal kernels, zero biases."""
        for m in self.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d)):
                lecun_normal_(m.weight, g)
                m.bias.zero_()

    def _map(self, tag: str, bm: torch.Tensor) -> torch.Tensor:
        h = bm
        for i in range(1, 4):
            h = F.relu(getattr(self, f"x_2d_{tag}_conv{i}")(h))
        return getattr(self, f"x_2d_{tag}_conv4")(h)

    def forward(self, x: torch.Tensor) -> Dict[str, Optional[torch.Tensor]]:
        start = torch.sigmoid(self.x_1d_s_conv2(F.relu(self.x_1d_s_conv1(x))))[:, 0]
        end = torch.sigmoid(self.x_1d_e_conv2(F.relu(self.x_1d_e_conv1(x))))[:, 0]
        mid = F.relu(self.x_1d_p_conv(x))  # [B, C, T]
        weight = self.x_3d_p.weight.view(self.x_3d_p.out_channels, mid.shape[1], self.num_sample)
        bm = boundary_matching(mid, weight, self.x_3d_p.bias, boundary_matching_lists(*self.key))  # [B, C3, D, T]
        out = {"confidence_map": torch.sigmoid(self._map("p", bm)), "start": start, "end": end, "reg_map": None, "verb_map": None, "noun_map": None}
        for tag in self.branches:
            if tag != "p":
                out["reg_map" if tag == "r" else f"{tag}_map"] = self._map(tag, bm)
        return out
