"""Self-supervised losses (counterpart of clip_fsar_tpu/train/ssl_losses.py:20-39,
the reference's models/utils/losses.py:120-196: the MoSI family),
registered in SSL_LOSSES for ``calculate_loss``'s '+'-composition.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from clip_fsar_torch.utils.registry import SSL_LOSSES


def _ce(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(preds.float(), labels.reshape(preds.shape[0]).long())


@SSL_LOSSES.register(name="Loss_MoSIX")
def loss_mosi_x(cfg, preds, logits, labels, cur_epoch: float = 0) -> Tuple[Dict, None]:
    # the reference (losses.py:143) reads labels["move_joint"] for the per-axis
    # loss too, which fails under LABEL_MODE separate; as in the JAX package the
    # per-axis labels are used where they exist, the joint ones otherwise
    return {"loss_move_x": _ce(preds["move_x"], labels.get("move_x", labels.get("move_joint")))}, None


@SSL_LOSSES.register(name="Loss_MoSIY")
def loss_mosi_y(cfg, preds, logits, labels, cur_epoch: float = 0) -> Tuple[Dict, None]:
    return {"loss_move_y": _ce(preds["move_y"], labels.get("move_y", labels.get("move_joint")))}, None


@SSL_LOSSES.register(name="Loss_MoSIJoint")
def loss_mosi_joint(cfg, preds, logits, labels, cur_epoch: float = 0) -> Tuple[Dict, None]:
    return {"loss_joint": _ce(preds["move_joint"], labels["move_joint"])}, None
