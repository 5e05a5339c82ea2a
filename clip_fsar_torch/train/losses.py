"""Loss composition (counterpart of clip_fsar_tpu/train/losses.py:25-68, the
reference's models/utils/losses.py calculate_loss:51-118).

``calculate_loss`` sums the '+'-composed terms of PRETRAIN.LOSS (the SSL
losses, train/ssl_losses.py) or of LOCALIZATION.LOSS (the BMN losses,
train/localization_losses.py), each times its LOSS_WEIGHTS entry, and
otherwise takes the supervised cross-entropy: ``soft_target_cross_entropy``
against soft targets (mixup) or label-smoothed one-hot ones, the one loss
the classification train step uses too (train/classification.py).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from clip_fsar_torch.data.mixup import smooth_one_hot
from clip_fsar_torch.train import localization_losses as _ll  # noqa: F401  (registers the localization losses)
from clip_fsar_torch.train import ssl_losses as _sl  # noqa: F401  (registers the SSL losses)
from clip_fsar_torch.utils.registry import LOCALIZATION_LOSSES, SSL_LOSSES


def soft_target_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean over rows of -sum(targets * log_softmax(logits)) in float32 (reference SoftTargetCrossEntropy)."""
    return -(targets * F.log_softmax(logits.float(), dim=-1)).sum(dim=-1).mean()


def _compose(names: str, weights, term, parts: Dict[str, torch.Tensor]):
    loss = 0.0
    for w, name in zip(list(weights), str(names).split("+")):
        cur, _ = term("Loss_" + name)
        for k, v in cur.items():
            parts[k] = v
            if "debug" not in k:
                loss = loss + w * v
    return loss


def calculate_loss(cfg, preds, logits, labels: Dict[str, Any], cur_epoch: float = 0.0, draws=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, its named parts).  ``labels`` holds "self-supervised" (a dict
    of per-axis targets) under PRETRAIN.ENABLE, "supervised" (the BMN label
    maps) under LOCALIZATION.ENABLE, else "supervised" class ids (a dict of
    them for several heads) or "supervised_mixup" soft targets.  ``draws``
    are ``Loss_PemReg``'s uniform fields (localization_losses.pem_reg_draws)."""
    parts: Dict[str, torch.Tensor] = {}
    if "PRETRAIN" in cfg and cfg.PRETRAIN.get("ENABLE", False):
        term = lambda name: SSL_LOSSES.get(name)(cfg, preds, logits, labels["self-supervised"], cur_epoch)  # noqa: E731
        return _compose(cfg.PRETRAIN.LOSS, cfg.PRETRAIN.LOSS_WEIGHTS, term, parts), parts
    if "LOCALIZATION" in cfg and cfg.LOCALIZATION.get("ENABLE", False):
        term = lambda name: LOCALIZATION_LOSSES.get(name)(cfg, preds, logits, labels, cur_epoch, draws=draws)  # noqa: E731
        return _compose(cfg.LOCALIZATION.LOSS, cfg.LOCALIZATION.LOSS_WEIGHTS, term, parts), parts
    smoothing = float(cfg.AUGMENTATION.get("LABEL_SMOOTHING", 0.0) or 0.0) if "AUGMENTATION" in cfg else 0.0

    def supervised(p: torch.Tensor, target: torch.Tensor, smoothing: float) -> torch.Tensor:
        if target.dim() > 1:  # soft targets
            return soft_target_cross_entropy(p, target)
        return soft_target_cross_entropy(p, smooth_one_hot(target, p.shape[-1], smoothing))

    target = labels.get("supervised_mixup", labels["supervised"])
    if isinstance(target, dict):
        loss = 0.0
        for k, v in target.items():
            parts["loss_" + k] = supervised(preds[k], v, 0.0)  # per head: no smoothing, as in the JAX package
            loss = loss + parts["loss_" + k]
        return loss, parts
    return supervised(preds, target, smoothing), parts
