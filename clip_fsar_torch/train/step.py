"""Train and eval steps over a batch of episodes (counterpart of
clip_fsar_tpu/train/step.py:40-220).

Episodes arrive as uint8 [E, ...] tensors on the device; augmentation and
normalization run there in float32, then one head call covers all E
episodes (one tower call over E*(S+Q)*T frames, as the JAX vmap compiles to).

Train loss, as the reference's few-shot loop (train_net_few_shot.py:108-152):
CE(episode logits, target labels) + USE_CLASSIFICATION_VALUE *
CE(video-text class logits, real support | real target labels), each a mean
over the episode, then a mean over the E episodes.  ``TPU.EPISODE_CHUNKS``
runs the E episodes as c sequential micro-batches whose gradients are summed
and divided by c, so only E/c episodes' activations are alive at once.  A
non-finite loss leaves the parameters, the optimizer moments and the
accumulation window untouched (the NaN guard, :161-180).  As there, the
guard is decided on the device and the metrics stay there: a step reads
nothing back to the host, so the caller can launch the next step (and copy
its batch) while the card still works on this one, and fetches metrics only
where it logs.

RN towers with live BatchNorm (BN.FREEZE off) also update the running
statistics, as the JAX step's mutable ``batch_stats`` do (:63-78,104-112,
140-160,178-180): each episode starts from the step's running stats r0,
its support call and then its target call each move them by flax's
momentum (0.81 r0 + 0.09 m_support + 0.1 m_target), every chunk starts
from r0 again, and the new stats are the mean over the E episodes.  They
are written at the step's end where the loss is finite, on every micro-step
of the accumulation window, on the device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from clip_fsar_torch.data import augment
from clip_fsar_torch.data.transforms import normalize_images
from clip_fsar_torch.data.types import Episode
from clip_fsar_torch.models.clip.model import BatchNorm
from clip_fsar_torch.train.state import TrainState

# loss terms of heads that are not ported yet
_UNPORTED_LOSSES = {
    "USE_LOCAL": "the HyRSM local loss",
    "TEMPORAL_LOSS_WEIGHT": "the temporal regularizer",
    "USE_CONTRASTIVE": "the MoLo contrastive terms",
    "USE_RECONS": "the MoLo reconstruction loss",
}


def _check_train_cfg(cfg) -> None:
    """Raise for the loss terms of heads the port does not have yet."""
    for key, what in _UNPORTED_LOSSES.items():
        if cfg.TRAIN.get(key, False):
            raise NotImplementedError(f"TRAIN.{key} ({what}) belongs to a head that is not ported yet: ROADMAP Queue 1, breadth")


def _live_batch_norms(head) -> list:
    """The BatchNorms whose running stats a train step updates: an RN tower's, unless BN.FREEZE."""
    return [m for m in head.modules() if isinstance(m, BatchNorm)] if head.train_backbone_bn else []


def make_loss_fn(head, cfg, text_train: torch.Tensor, text_test: torch.Tensor) -> Callable:
    """loss_fn(batch, generator) -> (loss, metrics) for a normalized batch of
    episodes: the mean over episodes of the per-episode loss, and the
    per-step means of ``loss``, ``ce`` and ``top1`` as 0-dim tensors."""
    use_cls = bool(cfg.TRAIN.get("USE_CLASSIFICATION", False))
    cls_value = float(cfg.TRAIN.get("USE_CLASSIFICATION_VALUE", 1.0) or 1.0)
    cls_only = bool(cfg.TRAIN.get("USE_CLASSIFICATION_ONLY", False))

    def loss_fn(batch: Episode, generator: Optional[torch.Generator]):
        out = head(batch, text_train, text_test, train=True, generator=generator)
        logits = out["logits"]  # [E, Q, WAY]
        labels = batch.target_labels.long()
        ep_ce = F.cross_entropy(logits.flatten(0, 1), labels.flatten(), reduction="none").reshape(labels.shape).mean(dim=-1)
        loss = ep_ce
        if use_cls:
            real = torch.cat([batch.real_support_labels, batch.real_target_labels], dim=1).long()  # [E, S+Q]
            cls_logits = out["class_logits"]
            cls_ce = F.cross_entropy(cls_logits.flatten(0, 1), real.flatten(), reduction="none").reshape(real.shape).mean(dim=-1)
            loss = cls_value * cls_ce if cls_only else ep_ce + cls_value * cls_ce
        top1 = (logits.argmax(dim=-1) == labels).float().mean(dim=-1)
        return loss.mean(), {"loss": loss.mean().detach(), "ce": ep_ce.mean().detach(), "top1": top1.mean().detach()}

    return loss_fn


def make_grad_fn(head, cfg, text_train: torch.Tensor, text_test: torch.Tensor) -> Callable:
    """grad_fn(batch, generator) -> metrics (0-dim tensors on the batch's
    device, nothing is read back): augment and
    normalize the uint8 batch, then forward and backward over the
    TPU.EPISODE_CHUNKS micro-batches, leaving the gradient of the mean loss
    over the E episodes in the parameters' ``.grad``.  ``generator`` (a
    torch.Generator on the batch's device) drives the jitter draws and
    dropout; None turns both off (normalization only).  With live
    BatchNorm, each BatchNorm's ``step_stats`` is left holding the step's
    new running (mean, var) [2, C] for ``BatchNorm.commit``."""
    _check_train_cfg(cfg)
    live_bn = _live_batch_norms(head)
    mean = tuple(float(x) for x in cfg.DATA.MEAN)
    std = tuple(float(x) for x in cfg.DATA.STD)
    ep_chunks = int(cfg.TPU.get("EPISODE_CHUNKS", 1)) if "TPU" in cfg else 1
    loss_fn = make_loss_fn(head, cfg, text_train, text_test)

    def aug(images: torch.Tensor, is_query: bool, generator: Optional[torch.Generator], host) -> torch.Tensor:
        e, n = images.shape[:2]
        out = augment.fewshot_train_augment(images.flatten(0, 1), cfg, mean, std, is_query, generator, host)
        return out.reshape((e, n) + out.shape[1:])

    def grad_fn(batch: Episode, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        host = None if generator is None else augment.host_generator(generator)  # the step's host draws (the jitter's op orders)
        batch = batch.replace(
            support_images=aug(batch.support_images, False, generator, host),
            target_images=aug(batch.target_images, True, generator, host),
        )
        e = batch.support_images.shape[0]
        c = ep_chunks if (ep_chunks > 1 and e % ep_chunks == 0) else 1
        head.zero_grad(set_to_none=True)
        chunk_metrics, stats = [], None
        for i in range(c):
            chunk = batch.map(lambda x, i=i: x[i * (e // c) : (i + 1) * (e // c)])
            for bn in live_bn:
                bn.step_stats = None  # every chunk's episodes start from the step's running stats
            loss, metrics = loss_fn(chunk, generator)
            loss.backward()  # sums the chunks' gradients into .grad
            chunk_metrics.append(metrics)
            if live_bn:  # the mean over the chunk's episodes, summed over the chunks
                means = [bn.step_stats.mean(dim=0) for bn in live_bn]
                stats = means if stats is None else torch._foreach_add(stats, means)
        if c > 1:
            for p in head.parameters():
                if p.grad is not None:
                    p.grad.div_(c)
        for bn, s in zip(live_bn, stats or []):
            bn.step_stats = s / c
        return {k: torch.stack([m[k] for m in chunk_metrics]).mean() for k in chunk_metrics[0]}

    return grad_fn


def make_train_step(head, cfg, text_train: torch.Tensor, text_test: torch.Tensor) -> Callable:
    """train_step(state, batch, lr, generator) -> metrics (0-dim tensors on
    the device: ``loss``, ``ce``, ``top1``, ``updated`` (bool) and
    ``nan_skipped`` (0. or 1.)), updating ``state`` in place:
    ``make_grad_fn``'s gradient, then the optimizer (one micro-step of its
    accumulation window, which changes nothing when the loss is not finite:
    the optimizer decides that on the device), the step counter, and the EMA
    (on every step, from whatever the parameters then are; it covers the
    parameters only, the running stats are kept as trained).  With live
    BatchNorm the running stats take the step's new values where the loss
    is finite.  No value is read back to the host."""
    grad_fn = make_grad_fn(head, cfg, text_train, text_test)
    live_bn = _live_batch_norms(head)
    ema_decay = float(cfg.MODEL.EMA.DECAY) if ("MODEL" in cfg and cfg.MODEL.EMA.get("ENABLE", False)) else None

    def train_step(state: TrainState, batch: Episode, lr: float, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        metrics = grad_fn(batch, generator)
        ok = torch.isfinite(metrics["loss"])
        metrics["updated"] = state.optimizer.step(lr, ok)
        for bn in live_bn:
            bn.commit(ok)
        head.zero_grad(set_to_none=True)
        state.step += 1
        if ema_decay is not None:
            state.update_ema(ema_decay)
        metrics["nan_skipped"] = (~ok).float()
        return metrics

    return train_step


def make_eval_step(head, cfg, text_train: torch.Tensor, text_test: torch.Tensor) -> Callable[[Episode], Dict[str, torch.Tensor]]:
    mean = tuple(float(x) for x in cfg.DATA.MEAN)
    std = tuple(float(x) for x in cfg.DATA.STD)

    @torch.no_grad()
    def eval_step(batch: Episode) -> Dict[str, torch.Tensor]:
        """Per-episode metrics, each with a leading [E] axis: top-1 / top-5
        correct counts, query count, mean CE, and per-query real labels and
        correctness (for the per-class report), plus the logits."""
        batch = batch.replace(
            support_images=normalize_images(batch.support_images, mean, std),
            target_images=normalize_images(batch.target_images, mean, std),
        )
        logits = head(batch, text_train, text_test, train=False)["logits"]  # [E, Q, WAY]
        labels = batch.target_labels.long()
        order = torch.argsort(-logits, dim=-1, stable=True)
        hit1 = order[..., 0] == labels
        kmax = min(5, logits.shape[-1])
        top5 = (order[..., :kmax] == labels[..., None]).any(dim=-1).sum(dim=-1)
        ce = F.cross_entropy(logits.flatten(0, 1), labels.flatten(), reduction="none").reshape(labels.shape).mean(dim=-1)
        e, q = labels.shape
        return {
            "top1_correct": hit1.sum(dim=-1),
            "top5_correct": top5,
            "count": torch.full((e,), q, dtype=torch.int32, device=labels.device),
            "loss": ce,
            "real_labels": batch.real_target_labels,
            "correct": hit1.float(),
            "logits": logits,
        }

    return eval_step
