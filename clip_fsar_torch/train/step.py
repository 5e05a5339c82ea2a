"""Train and eval steps over a batch of episodes (counterpart of
clip_fsar_tpu/train/step.py:40-220).

Episodes arrive as uint8 [E, ...] tensors on the device; augmentation and
normalization run there in float32, then one head call covers all E
episodes (one tower call over E*(S+Q)*T frames, as the JAX vmap compiles to).

Train loss, as the reference's few-shot loop (train_net_few_shot.py:108-152):
CE(episode logits, target labels) + USE_CLASSIFICATION_VALUE *
CE(class logits, real support | real target labels; repeated per frame
under USE_LOCAL) + TEMPORAL_LOSS_WEIGHT * the HyRSM++ temporal regularizer
+ USE_CONTRASTIVE_COFF * CE of each of MoLo's four contrastive logits +
RECONS_COFF * BATCH_SIZE * MoLo's reconstruction loss (USE_RECONS; the
reference adds it undivided by BATCH_SIZE, JAX step.py:49-55), each a mean
over the episode, then a mean over the E episodes.  ``TPU.EPISODE_CHUNKS``
runs the E episodes as c sequential micro-batches whose gradients are summed
and divided by c, so only E/c episodes' activations are alive at once.  A
non-finite loss leaves the parameters, the optimizer moments and the
accumulation window untouched (the NaN guard, :161-180).  As there, the
guard is decided on the device and the metrics stay there: a step reads
nothing back to the host, so the caller can launch the next step (and copy
its batch) while the card still works on this one, and fetches metrics only
where it logs.

The BatchNorms a head runs on batch statistics in its train branch (its
``live_batch_norms``: an RN CLIP tower's unless BN.FREEZE, MoLo's decoder's)
also update their running statistics, as the JAX step's mutable
``batch_stats`` do (:63-78,104-112, 140-160,178-180): each episode starts
from the step's running stats r0, its support call and then its target call
each move them by flax's momentum (0.81 r0 + 0.09 m_support + 0.1
m_target), every chunk starts from r0 again, and the new stats are the mean
over the E episodes.  They are written at the step's end where the loss is
finite, on every micro-step of the accumulation window, on the device.  A
BatchNorm on its running statistics (a frozen trunk's) is never listed.

Under a process group (parallel/mesh.py) the batch is the rank's slice of
the step's global E episodes, and the step is the global one, as the JAX
step over a sharded batch is: the augmentation is drawn for the global E and
sliced at the rank's offset, and after the episode-chunk loop the gradient,
the metrics and the new running statistics are all-reduced to their means
over the ranks, once a step.  The per-episode batch statistics stay local,
as in the JAX package and the reference (no SyncBN).  The NaN guard reads
the reduced loss, so one rank's non-finite loss skips the update on every
rank.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from clip_fsar_torch import runtime
from clip_fsar_torch.data import augment
from clip_fsar_torch.data.frame_bank import assemble_train_clips, gather_eval_clips
from clip_fsar_torch.data.transforms import normalize_images
from clip_fsar_torch.data.types import Episode
from clip_fsar_torch.parallel import mesh
from clip_fsar_torch.train.state import TrainState
from clip_fsar_torch.utils import tracing

_CONTRASTIVE = ("logits_s2q", "logits_q2s", "logits_s2q_motion", "logits_q2s_motion")


def _episode_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of logits [E, N, C] (float32) against labels [E, N], the mean per episode [E]."""
    return F.cross_entropy(logits.float().flatten(0, 1), labels.long().flatten(), reduction="none").reshape(labels.shape).mean(dim=-1)


def make_loss_fn(head, cfg, text_train: torch.Tensor, text_test: torch.Tensor) -> Callable:
    """loss_fn(batch, generator) -> (loss, metrics) for a normalized batch of
    episodes: the mean over episodes of the per-episode loss, and the
    per-step means of ``loss``, ``ce`` and ``top1`` as 0-dim tensors."""
    t = cfg.TRAIN
    use_cls = bool(t.get("USE_CLASSIFICATION", False))
    cls_value = float(t.get("USE_CLASSIFICATION_VALUE", 1.0) or 1.0)
    cls_only = bool(t.get("USE_CLASSIFICATION_ONLY", False))
    use_local = bool(t.get("USE_LOCAL", False))
    temporal_weight = float(t.get("TEMPORAL_LOSS_WEIGHT", 0.0) or 0.0)
    use_contrastive = bool(t.get("USE_CONTRASTIVE", False))
    contrastive_coff = float(t.get("USE_CONTRASTIVE_COFF", 1.0) or 1.0)
    recons_coff = float(t.get("RECONS_COFF", 0.0) or 0.0) * float(t.get("BATCH_SIZE", 1) or 1) if t.get("USE_RECONS", False) else 0.0
    num_frames = int(cfg.DATA.NUM_INPUT_FRAMES)

    def loss_fn(batch: Episode, generator: Optional[torch.Generator]):
        out = head(batch, text_train, text_test, train=True, generator=generator)
        logits = out["logits"]  # [E, Q, WAY]
        labels = batch.target_labels.long()
        ep_ce = _episode_ce(logits, labels)
        loss = ep_ce
        if use_cls:
            real = torch.cat([batch.real_support_labels, batch.real_target_labels], dim=1)  # [E, S+Q]
            if use_local:  # per-frame class logits (train_net_few_shot.py:113-117): each label once per frame
                real = real.repeat_interleave(num_frames, dim=1)
            cls_ce = _episode_ce(out["class_logits"], real)
            loss = cls_value * cls_ce if cls_only else ep_ce + cls_value * cls_ce
        if temporal_weight and out.get("loss_temporal_regular") is not None:
            loss = loss + temporal_weight * out["loss_temporal_regular"]
        if use_contrastive:  # MoLo's global <-> local terms (train_net_few_shot.py:120-131)
            for key in _CONTRASTIVE:
                if out.get(key) is not None:
                    loss = loss + contrastive_coff * _episode_ce(out[key], labels)
        if recons_coff and out.get("loss_recons") is not None:
            loss = loss + recons_coff * out["loss_recons"]
        top1 = (logits.argmax(dim=-1) == labels).float().mean(dim=-1)
        return loss.mean(), {"loss": loss.mean().detach(), "ce": ep_ce.mean().detach(), "top1": top1.mean().detach()}

    return loss_fn


def make_grad_fn(head, cfg, text_train: torch.Tensor, text_test: torch.Tensor, bank: Optional[torch.Tensor] = None) -> Callable:
    """grad_fn(batch, generator) -> metrics (0-dim tensors on the batch's
    device, nothing is read back): forward and backward over the
    TPU.EPISODE_CHUNKS micro-batches, each augmented and normalized from its
    uint8 clips just before its forward, leaving the gradient of the mean
    loss over the E episodes in the parameters' ``.grad`` (under a process
    group, over the global E: see the module docstring).  The random draws
    of the augmentation are taken for all E episodes first (support clips,
    then target clips), so they do not depend on the chunking or the ranks.
    ``generator`` (a torch.Generator on the batch's device) drives the jitter
    draws and dropout; None turns both off (normalization only).  With live
    BatchNorm, each BatchNorm's ``step_stats`` is left holding the step's
    new running (mean, var) [2, C] for ``BatchNorm.commit``.

    With ``bank`` (the train frame bank, uint8 [V*F, nh, nw, 3] on the
    device) the batch's images are int32 [E, N, T + 3] bank rows and crops
    (data/frame_bank.py), and each chunk's clips are assembled from the bank
    inside the chunk loop: only one chunk's uint8 pixels are alive at a
    time."""
    live_bn = head.live_batch_norms()
    mean = tuple(float(x) for x in cfg.DATA.MEAN)
    std = tuple(float(x) for x in cfg.DATA.STD)
    ep_chunks = int(cfg.TPU.get("EPISODE_CHUNKS", 1)) if "TPU" in cfg else 1
    num_frames, crop = int(cfg.DATA.NUM_INPUT_FRAMES), int(cfg.DATA.TRAIN_CROP_SIZE)
    loss_fn = make_loss_fn(head, cfg, text_train, text_test)

    def clips(images: torch.Tensor) -> torch.Tensor:
        """A field of the batch as uint8 clips [E, N, T, H, W, 3]."""
        return images if bank is None else assemble_train_clips(bank, images, num_frames, crop)

    def clip_shape(images: torch.Tensor, e: int) -> tuple:
        """The flattened clips' shape [E*N, T, H, W, 3] of a batch field of ``e`` episodes."""
        n = images.shape[1]
        return (e * n,) + (tuple(images.shape[2:]) if bank is None else (num_frames, crop, crop, 3))

    def aug(images: torch.Tensor, draws: Optional[augment.AugmentDraws], first: int, total: int) -> torch.Tensor:
        e, n = images.shape[:2]
        chunk_draws = None if draws is None else draws.take(first, first + e * n)
        out = augment.apply_train_augment(images.flatten(0, 1), chunk_draws, cfg, mean, std, first, total)
        return out.reshape((e, n) + out.shape[1:])

    @runtime.deterministic_convolutions()  # the backward runs inside: the same bits on every run
    def grad_fn(batch: Episode, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        e, s, q = batch.support_images.shape[0], batch.support_images.shape[1], batch.target_images.shape[1]
        # under a process group the batch is this data rank's slice [first, first + e) of the global e_all episodes
        e_all, first = e * mesh.data_size(), e * mesh.data_rank()
        draws = (None, None)
        if generator is not None:
            with tracing.span("fsar.augment"):
                host = augment.host_generator(generator)  # the step's host draws (the jitter's op orders)
                device = batch.support_images.device
                draws = tuple(augment.draw_train_augment(cfg, clip_shape(images, e_all), is_query, generator, host, device=device)
                              for images, is_query in ((batch.support_images, False), (batch.target_images, True)))
        c = ep_chunks if (ep_chunks > 1 and e % ep_chunks == 0) else 1
        head.zero_grad(set_to_none=True)
        chunk_metrics, stats = [], None
        for i in range(c):
            lo, hi = i * (e // c), (i + 1) * (e // c)
            with tracing.span("fsar.augment"):
                chunk = batch.map(lambda x: x[lo:hi])
                chunk = chunk.replace(
                    support_images=aug(clips(chunk.support_images), draws[0], (first + lo) * s, e_all * s),
                    target_images=aug(clips(chunk.target_images), draws[1], (first + lo) * q, e_all * q),
                )
            for bn in live_bn:
                bn.step_stats = None  # every chunk's episodes start from the step's running stats
            with tracing.span("fsar.forward"):
                loss, metrics = loss_fn(chunk, generator)
            with tracing.span("fsar.backward"):
                loss.backward()  # sums the chunks' gradients into .grad
            chunk_metrics.append(metrics)
            if live_bn:  # the mean over the chunk's episodes, summed over the chunks
                means = [bn.step_stats.mean(dim=0) for bn in live_bn]
                stats = means if stats is None else torch._foreach_add(stats, means)
        if c > 1:
            with tracing.span("fsar.backward"):
                for p in head.parameters():
                    if p.grad is not None:
                        p.grad.div_(c)
        stats = [st / c for st in stats or []]
        names = list(chunk_metrics[0])
        values = torch.stack([torch.stack([m[k] for m in chunk_metrics]).mean() for k in names])
        if mesh.distributed():  # the means over the global E: once a step, after the chunks' local sums
            mesh.all_reduce_grads(head.parameters())
            mesh.all_reduce_mean([values] + stats)
        for bn, st in zip(live_bn, stats):
            bn.step_stats = st
        return dict(zip(names, values.unbind()))

    return grad_fn


def make_train_step(head, cfg, text_train: torch.Tensor, text_test: torch.Tensor, bank: Optional[torch.Tensor] = None) -> Callable:
    """train_step(state, batch, lr, generator) -> metrics (0-dim tensors on
    the device: ``loss``, ``ce``, ``top1``, ``updated`` (bool) and
    ``nan_skipped`` (0. or 1.)), updating ``state`` in place:
    ``make_grad_fn``'s gradient, then the optimizer (one micro-step of its
    accumulation window, which changes nothing when the loss is not finite:
    the optimizer decides that on the device), the step counter, and the EMA
    (on every step, from whatever the parameters then are; it covers the
    parameters only, the running stats are kept as trained).  With live
    BatchNorm the running stats take the step's new values where the loss
    is finite.  No value is read back to the host.  With ``bank`` the batch
    holds train frame bank rows and crops (``make_grad_fn``)."""
    grad_fn = make_grad_fn(head, cfg, text_train, text_test, bank)
    live_bn = head.live_batch_norms()
    ema_decay = float(cfg.MODEL.EMA.DECAY) if ("MODEL" in cfg and cfg.MODEL.EMA.get("ENABLE", False)) else None

    def train_step(state: TrainState, batch: Episode, lr: float, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        with tracing.span("fsar.step", step=state.step):
            metrics = grad_fn(batch, generator)
            with tracing.span("fsar.optimizer"):
                ok = torch.isfinite(metrics["loss"])
                metrics["updated"] = state.optimizer.step(lr, ok)
                for bn in live_bn:
                    bn.commit(ok)
                head.zero_grad(set_to_none=True)
                if ema_decay is not None:
                    state.update_ema(ema_decay)
            state.step += 1
            metrics["nan_skipped"] = (~ok).float()
            return metrics

    return train_step


def make_eval_step(
    head, cfg, text_train: torch.Tensor, text_test: torch.Tensor, bank: Optional[torch.Tensor] = None,
) -> Callable[[Episode], Dict[str, torch.Tensor]]:
    """eval_step(batch) -> per-episode metrics.  With ``bank`` (the eval frame
    bank, uint8 [V*F, crop, crop, 3] on the device) the batch's images are
    int32 [E, N, T] bank rows, gathered on the device (data/frame_bank.py)."""
    mean = tuple(float(x) for x in cfg.DATA.MEAN)
    std = tuple(float(x) for x in cfg.DATA.STD)
    calls = itertools.count()  # the eval step index: the step of the caller's loader

    @torch.no_grad()
    def eval_step(batch: Episode) -> Dict[str, torch.Tensor]:
        """Per-episode metrics, each with a leading [E] axis: top-1 / top-5
        correct counts, query count, mean CE, and per-query real labels and
        correctness (for the per-class report), plus the logits."""
        with tracing.span("fsar.step", step=next(calls)):
            with tracing.span("fsar.augment"):
                clips = (lambda rows: rows) if bank is None else (lambda rows: gather_eval_clips(bank, rows))
                batch = batch.replace(
                    support_images=normalize_images(clips(batch.support_images), mean, std),
                    target_images=normalize_images(clips(batch.target_images), mean, std),
                )
            with tracing.span("fsar.forward"):
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
