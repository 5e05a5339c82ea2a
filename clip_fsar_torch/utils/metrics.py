"""Accuracy metrics (counterpart of clip_fsar_tpu/utils/metrics.py, the
reference's utils/metrics.py), on torch tensors on any device."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _top(preds: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores per row, ties to the lower index (a stable descending sort)."""
    return torch.argsort(-preds, dim=-1, stable=True)[:, :k]


def topk_correct(preds: torch.Tensor, labels: torch.Tensor, ks: Sequence[int]) -> list:
    """Correct predictions among the top k, for each k (float32 0-dim
    tensors).  preds: [N, C] scores; labels: [N] int."""
    hits = _top(preds, max(ks)) == labels[:, None].long()
    return [hits[:, :k].sum().float() for k in ks]


def topk_accuracies(preds: torch.Tensor, labels: torch.Tensor, ks: Sequence[int]) -> list:
    n = preds.shape[0]
    return [c * 100.0 / n for c in topk_correct(preds, labels, ks)]


def topk_errors(preds: torch.Tensor, labels: torch.Tensor, ks: Sequence[int]) -> list:
    return [100.0 - a for a in topk_accuracies(preds, labels, ks)]


def joint_topk_correct(
    preds_a: torch.Tensor, preds_b: torch.Tensor, labels_a: torch.Tensor, labels_b: torch.Tensor, ks: Sequence[int]
) -> Tuple[list, list, list]:
    """Joint verb x noun top-k (the EPIC protocol): the top k of the
    flattened softmax(a) x softmax(b) against the pair index a * Nb + b,
    beside each factor's own top k.  Returns (joint, a, b) correct counts
    aligned with ``ks``."""
    max_k = max(ks)
    hit_a = _top(preds_a, max_k) == labels_a[:, None].long()
    hit_b = _top(preds_b, max_k) == labels_b[:, None].long()
    nb = preds_b.shape[-1]
    joint = (torch.softmax(preds_a, -1)[:, :, None] * torch.softmax(preds_b, -1)[:, None, :]).reshape(preds_a.shape[0], -1)
    hit_j = _top(joint, max_k) == (labels_a.long() * nb + labels_b.long())[:, None]
    count = lambda hit, k: hit[:, :k].any(dim=1).sum().float()  # noqa: E731
    return [count(hit_j, k) for k in ks], [count(hit_a, k) for k in ks], [count(hit_b, k) for k in ks]
