"""Temporal-action-localization losses (counterpart of
clip_fsar_tpu/train/localization_losses.py:20-103, the reference's
models/utils/localization_losses.py: the BMN loss family).

Each returns (dict of named 0-dim tensors, None), as the JAX package's do,
so ``calculate_loss`` (train/losses.py) sums the terms that
LOCALIZATION.LOSS names.  ``Loss_PemReg`` sub-samples the medium- and
low-IoU cells with two uniform fields: they are inputs (``draws``, from
``pem_reg_draws``) so that a test can hand the port the JAX package's own.
Nothing here reads a value back from the device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from clip_fsar_torch.utils.registry import LOCALIZATION_LOSSES

_EPS = 1e-6


def pem_reg_draws(shape, generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """``Loss_PemReg``'s two uniform [0, 1) fields of the iou map's ``shape``
    [B, D, T] (medium-IoU cells, low-IoU cells), from ``generator``."""
    return (torch.rand(tuple(shape), generator=generator, device=generator.device),
            torch.rand(tuple(shape), generator=generator, device=generator.device))


def _balanced_bce(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Positive/negative-balanced binary CE over sigmoid scores (reference Loss_Tem.bi_loss)."""
    pred = pred.reshape(-1)
    pmask = (gt.reshape(-1) > 0.5).float()
    num_entries = float(pred.shape[0])
    ratio = num_entries / pmask.sum().clamp(min=1.0)
    coef_0 = 0.5 * ratio / (ratio - 1.0).clamp(min=_EPS)
    coef_1 = 0.5 * ratio
    loss_pos = coef_1 * torch.log(pred + _EPS) * pmask
    loss_neg = coef_0 * torch.log(1.0 - pred + _EPS) * (1.0 - pmask)
    return -torch.mean(loss_pos + loss_neg)


@LOCALIZATION_LOSSES.register(name="Loss_Tem")
def loss_tem(cfg, preds, logits, labels, cur_epoch: float = 0, draws=None) -> Tuple[Dict, None]:
    sup = labels["supervised"]
    return {"tem": _balanced_bce(preds["start"], sup["start_map"]) + _balanced_bce(preds["end"], sup["end_map"])}, None


@LOCALIZATION_LOSSES.register(name="Loss_PemReg")
def loss_pem_reg(cfg, preds, logits, labels, cur_epoch: float = 0, draws: Optional[tuple] = None) -> Tuple[Dict, None]:
    """Balanced MSE on the regression confidence channel, with the
    reference's random sub-sampling of medium- and low-IoU cells (``draws``;
    without them, drawn from a generator seeded with ``cur_epoch``, as the
    JAX package falls back to PRNGKey(cur_epoch))."""
    pred = preds["confidence_map"][:, 0]
    sup = labels["supervised"]
    gt = sup["iou_map"] * sup["mask"]
    pos_t = float(cfg.LOCALIZATION.POS_REG_THRES)
    neg_t = float(cfg.LOCALIZATION.NEG_REG_THRES)
    u_h = (gt > pos_t).float()
    u_m = ((gt <= pos_t) & (gt > neg_t)).float()
    u_l = ((gt <= neg_t) & (gt > 0.0)).float() * sup["mask"]
    r_m = u_h.sum() / u_m.sum().clamp(min=1.0)
    r_l = u_h.sum() / u_l.sum().clamp(min=1.0)
    if draws is None:
        draws = pem_reg_draws(gt.shape, torch.Generator(device=gt.device).manual_seed(int(cur_epoch)))
    u_sm = (u_m * draws[0] > (1.0 - r_m)).float()
    u_sl = (u_l * draws[1] > (1.0 - r_l)).float()
    weights = u_h + u_sm + u_sl
    mse = torch.mean((pred * weights - gt * weights) ** 2)
    return {"pem_reg": 0.5 * mse * weights.numel() / weights.sum().clamp(min=1.0)}, None


@LOCALIZATION_LOSSES.register(name="Loss_PemCls")
def loss_pem_cls(cfg, preds, logits, labels, cur_epoch: float = 0, draws=None) -> Tuple[Dict, None]:
    pred = preds["confidence_map"][:, 1]
    sup = labels["supervised"]
    gt = sup["iou_map"] * sup["mask"]
    thres = float(cfg.LOCALIZATION.POS_CLS_THRES)
    pmask = (gt > thres).float()
    nmask = (gt <= thres).float() * sup["mask"]
    num_pos = pmask.sum().clamp(min=1.0)
    num_entries = num_pos + nmask.sum()
    ratio = num_entries / num_pos
    coef_0 = 0.5 * ratio / (ratio - 1.0).clamp(min=_EPS)
    coef_1 = 0.5 * ratio
    loss = -(coef_1 * torch.log(pred + _EPS) * pmask + coef_0 * torch.log(1.0 - pred + _EPS) * nmask).sum() / num_entries
    return {"pem_cls": loss}, None


@LOCALIZATION_LOSSES.register(name="Loss_BmnActionCls")
def loss_bmn_action_cls(cfg, preds, logits, labels, cur_epoch: float = 0, draws=None) -> Tuple[Dict, None]:
    """Verb/noun cross-entropy over the proposals of IoU >= 0.75, as a
    weighted mean (the JAX package's static-shape form of the reference's
    boolean select)."""
    sup = labels["supervised"]
    b = sup["label_map"].shape[0]
    gt_label = sup["label_map"].reshape(b, 2, -1)
    select = ((sup["iou_map"] * sup["mask"]).reshape(-1) >= 0.75).float()
    denom = select.sum().clamp(min=1.0)
    out = {}
    for i, tag in enumerate(("verb", "noun")):
        pred = preds[f"{tag}_map"]
        pred = pred.reshape(b, pred.shape[1], -1).transpose(1, 2).reshape(-1, pred.shape[1])  # [B*D*T, C]
        ce = F.cross_entropy(pred.float(), gt_label[:, i, :].reshape(-1).long(), reduction="none")
        out[f"{tag}_loss"] = (ce * select).sum() / denom
    return out, None
