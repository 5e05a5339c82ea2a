"""The classification task: epoch-driven training and the multi-view test
(counterpart of clip_fsar_tpu/train/classification.py:33-476, the
reference's runs/train.py and runs/test.py).

The train step works as the JAX one does: uint8 clips [B, T, H, W, 3] on
the device, colour jitter and random erasing there (``apply_train_augment``,
under AUGMENTATION.COLOR_AUG and RANDOM_ERASING.ENABLE), mixup / cutmix
(data/mixup.py) or label smoothing, softmax cross-entropy (for EPIC's two
heads the sum of both), a NaN guard that leaves parameters and optimizer
moments untouched for a non-finite loss, and the EMA of the parameters.  It
reads nothing back from the card: the mixup draws and the jitter's op order
come from a host generator seeded from the step's generator, and the
metrics stay on the device until the loop logs.

The loop follows the JAX one: the lr of each step at its fractional epoch,
TRAIN.NUM_FOLDS shuffles per loader pass, validation and checkpoints on the
reference's cadence (utils/misc.py), auto-resume from OUTPUT_DIR (at
TRAIN.RESUME_EPOCH, as there) or TRAIN.CHECKPOINT_FILE_PATH with its
surgery (train/pretrain.py).  The test keeps one step in flight while the
meter takes the last one's scores.

Under PRETRAIN.ENABLE (TASK_TYPE pretrain) the same trainer pretrains
MoSI (JAX classification.py:61-100, 228-322): the loader's pseudo-motion
clips [B, S, F, H, W, 3] are jittered and erased with the draws of
[B, S*F, H, W, 3] (one draw per sample, or per frame without
AUGMENTATION.CONSISTENT, as the JAX step flattens them), the loss is
``calculate_loss``'s '+'-composition of PRETRAIN.LOSS over the per-axis
labels, and the validation is the SSL one (``_eval_epoch_ssl``: the mean
cross-entropy and accuracy per axis over the test split, padding masked).

Under a process group (parallel/mesh.py) TRAIN.BATCH_SIZE and
TEST.BATCH_SIZE are global: each data rank loads and runs its rows of every
global batch, the random draws (jitter, erasing, mixup) are taken for the
global batch and sliced, mixup's partners (element B - 1 - i) are gathered
from the other data ranks, the gradient and the metrics are all-reduced to
their means over the data ranks once a step, and eval outputs (and the
feature maps) are gathered in global row order before the meter sees them.
Dropout draws its masks per data rank (as in the few-shot path, ROADMAP
"Not faults").  Under TPU.MESH.MODEL > 1 the video transformers' matmuls
are tensor-parallel (parallel/tensor.py), after the weights are loaded.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from clip_fsar_torch.data import augment
from clip_fsar_torch.data.classification import build_classification_loader
from clip_fsar_torch.data.mixup import MixupConfig, draw_mixup, mixup_batch, smooth_one_hot
from clip_fsar_torch.data.transforms import normalize_images
from clip_fsar_torch.models.video.model import build_video_model
from clip_fsar_torch.parallel import mesh, tensor
from clip_fsar_torch.train.checkpoint import Checkpointer, auto_resume
from clip_fsar_torch.train.losses import calculate_loss, soft_target_cross_entropy
from clip_fsar_torch.train.optimizer import Optimizer, get_lr_at_epoch
from clip_fsar_torch.train.pretrain import load_test_variables, load_train_checkpoint_file
from clip_fsar_torch.train.state import TrainState
from clip_fsar_torch.utils.logging import get_logger, log_json_stats, setup_logging
from clip_fsar_torch.utils.meters import EpicKitchenMeter, ScalarMeter, TestMeter
from clip_fsar_torch.utils.misc import is_checkpoint_epoch, is_eval_epoch, log_model_info
from clip_fsar_torch.utils.visualization import FeatureMaps, save_feature_maps, visualization_enabled

logger = get_logger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg) -> torch.dtype:
    return _DTYPES[str(cfg.TPU.get("COMPUTE_DTYPE", "bfloat16")) if "TPU" in cfg else "float32"]


def _dual_head(cfg) -> bool:
    return isinstance(cfg.VIDEO.HEAD.get("NUM_CLASSES", 0), (list, tuple))


def _pretrain(cfg) -> bool:
    return "PRETRAIN" in cfg and bool(cfg.PRETRAIN.get("ENABLE", False))


def _rows(global_batch: int, data: mesh.Mesh) -> tuple:
    """This data rank's rows [lo, hi) of a global batch (an equal share each)."""
    if global_batch % data.data:
        raise ValueError(f"the global batch of {global_batch} clips must be divisible by the {data.data} data ranks (each takes an equal share)")
    return mesh.local_episode_range(global_batch, data)


def _to_device(x, device: torch.device):
    """A host array (or a dict of them: SSL labels) on ``device``."""
    if isinstance(x, dict):
        return {k: _to_device(v, device) for k, v in x.items()}
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":  # from pinned memory, so the copy waits for nothing the card has queued
        return t.pin_memory().to(device, non_blocking=True)
    return t


def step_generator(cfg, epoch: int, it: int, device) -> torch.Generator:
    """The generator of the train step at (epoch, iteration): seeded from
    RANDOM_SEED + 2 and the step, so a resumed run draws as an uninterrupted one."""
    seed = np.random.SeedSequence((int(cfg.get("RANDOM_SEED", 0)) + 2, epoch, it)).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def draw_step(cfg, shape, generator: torch.Generator) -> tuple:
    """The random draws of one train step on a global batch of ``shape``
    [B, T, H, W, 3]: (the jitter's and erasing's ``AugmentDraws`` or None,
    the ``MixupDraws`` or None)."""
    aug = cfg.AUGMENTATION
    host = augment.host_generator(generator)
    jitter = erasing = None
    if bool(aug.get("COLOR_AUG", False)):
        jitter = augment.draw_jitter(generator, host, int(shape[0]), int(shape[1]), augment.JitterConfig.from_cfg(cfg), device=generator.device)
    ec = augment.ErasingConfig.from_cfg(cfg)
    if ec is not None:
        erasing = augment.draw_erasing(generator, tuple(int(v) for v in shape), ec, device=generator.device)
    draws = augment.AugmentDraws(jitter, erasing, int(shape[0])) if (jitter is not None or erasing is not None) else None
    mc = MixupConfig.from_cfg(cfg)
    mix = None if (mc is None or _dual_head(cfg)) else draw_mixup(host, int(shape[0]), int(shape[2]), int(shape[3]), mc)
    return draws, mix


def _partner(x: torch.Tensor) -> torch.Tensor:
    """The rows that this rank's rows mix with, element B - 1 - i of the global batch."""
    if not mesh.distributed():
        return x.flip(0)
    b, d = x.shape[0], mesh.data_rank()
    full = mesh.all_gather_rows(x).flip(0)
    return full[d * b : (d + 1) * b]


def make_classification_train_step(model, cfg):
    """train_step(state, videos, labels, lr, generator, draws=None) ->
    metrics (0-dim tensors on the device: loss, top1, updated, nan_skipped),
    updating ``state`` in place.  ``videos`` uint8 [b, T, H, W, 3] and
    ``labels`` [b] ([b, 2] for EPIC) are this rank's rows on the device;
    under PRETRAIN.ENABLE ``videos`` [b, S, F, H, W, 3] and ``labels``
    {axis: [b, S]}.  ``draws`` (from ``draw_step``, for the global batch of
    [B, T, H, W, 3], or [B, S*F, H, W, 3] under pretraining) replace the
    step's own; ``generator`` drives them and dropout (None: neither)."""
    mean = tuple(float(x) for x in cfg.DATA.MEAN)
    std = tuple(float(x) for x in cfg.DATA.STD)
    nc = cfg.VIDEO.HEAD.NUM_CLASSES
    dual = _dual_head(cfg)
    smoothing = float(cfg.AUGMENTATION.get("LABEL_SMOOTHING", 0.0) or 0.0)
    ema_decay = float(cfg.MODEL.EMA.DECAY) if cfg.MODEL.EMA.get("ENABLE", False) else None

    pretrain = _pretrain(cfg)

    def train_step(state: TrainState, videos: torch.Tensor, labels, lr: float, generator: Optional[torch.Generator], draws=None):
        b = videos.shape[0]
        world, first = mesh.data_size(), b * mesh.data_rank()
        clips = videos.reshape((b, -1) + tuple(videos.shape[-3:])) if pretrain else videos  # [b, S*F, H, W, 3] under pretraining
        if draws is None and generator is not None:
            draws = draw_step(cfg, (b * world,) + tuple(clips.shape[1:]), generator)
        aug_draws, mix = draws if draws is not None else (None, None)
        if aug_draws is not None:
            x = augment.apply_train_augment(clips, aug_draws.take(first, first + b), cfg, mean, std, first, b * world)
        else:
            x = normalize_images(clips, mean, std)
        if pretrain:
            preds, logits = model(x.reshape(videos.shape), train=True, generator=generator)
            loss, _ = calculate_loss(cfg, preds, logits, {"self-supervised": labels})
            shared = [k for k in preds if k in labels]
            top1 = ((preds[shared[0]].argmax(-1) == labels[shared[0]].reshape(-1)).float().mean() if shared
                    else torch.zeros((), device=loss.device))
            return _update(state, loss, top1, lr)
        labels = labels.long()
        if dual:
            (pv, pn), _ = model(x, train=True, generator=generator)
            loss = (soft_target_cross_entropy(pv, smooth_one_hot(labels[:, 0], int(nc[0]), smoothing))
                    + soft_target_cross_entropy(pn, smooth_one_hot(labels[:, 1], int(nc[1]), smoothing)))
            top1 = ((pv.argmax(-1) == labels[:, 0]) & (pn.argmax(-1) == labels[:, 1])).float().mean()
        else:
            if mix is not None:
                x, targets = mixup_batch(x, _partner(x), labels, _partner(labels), int(nc), mix.take(first, first + b), smoothing)
            else:
                targets = smooth_one_hot(labels, int(nc), smoothing)
            logits, _ = model(x, train=True, generator=generator)
            loss = soft_target_cross_entropy(logits, targets)
            top1 = (logits.argmax(-1) == labels).float().mean()
        return _update(state, loss, top1, lr)

    def _update(state: TrainState, loss: torch.Tensor, top1: torch.Tensor, lr: float):
        model.zero_grad(set_to_none=True)
        loss.backward()
        values = torch.stack([loss.detach(), top1])
        if mesh.distributed():  # the means over the global batch, once a step
            mesh.all_reduce_grads(model.parameters())
            mesh.all_reduce_mean([values])
        ok = torch.isfinite(values[0])
        updated = state.optimizer.step(lr, ok)
        model.zero_grad(set_to_none=True)
        state.step += 1
        if ema_decay is not None:
            state.update_ema(ema_decay)
        return {"loss": values[0], "top1": values[1], "updated": updated, "nan_skipped": (~ok).float()}

    return train_step


def make_classification_eval_step(model, cfg):
    """eval_step(videos uint8 [b, T, H, W, 3] on the device) -> predictions
    (HEAD.ACTIVATION applied; a (verb, noun) pair for EPIC)."""
    mean = tuple(float(x) for x in cfg.DATA.MEAN)
    std = tuple(float(x) for x in cfg.DATA.STD)

    @torch.no_grad()
    def eval_step(videos: torch.Tensor):
        return model(normalize_images(videos, mean, std), train=False)[0]

    return eval_step


def _setup(cfg, device):
    """The mesh (TPU.MESH refused as the JAX package refuses it, before any model) and the fresh model."""
    setup_logging(cfg.get("OUTPUT_DIR", None))
    mesh.maybe_init_distributed(cfg, mesh.backend_for(device))
    data = mesh.build_mesh(cfg, device)
    model = build_video_model(cfg, dtype=compute_dtype(cfg), device=data.device)
    return data, model


def _gather(x) -> np.ndarray:
    """Rows of every rank in global order, on the host (waits for the card)."""
    return mesh.all_gather_rows(x).cpu().numpy()


def _eval_epoch(cfg, model, data: mesh.Mesh) -> Dict[str, float]:
    """Validation top-1 over the test split (padding rows masked)."""
    dual = _dual_head(cfg)
    correct = total = 0

    def on_batch(out, labels, clip_ids, _maps):
        nonlocal correct, total
        valid = clip_ids >= 0
        if dual:
            correct += int(((out[0].argmax(-1)[valid] == labels[valid, 0]) & (out[1].argmax(-1)[valid] == labels[valid, 1])).sum())
        else:
            correct += int((out.argmax(-1)[valid] == labels[valid]).sum())
        total += int(valid.sum())

    _test_loop(cfg, model, data, _test_loader(cfg, data), on_batch)
    stats = {"top1_acc": correct / max(total, 1) * 100.0}
    log_json_stats({"_type": "val_epoch", **stats, "samples": total}, logger)
    return stats


def _ssl_batch_stats(preds: Dict[str, np.ndarray], labels: Dict[str, np.ndarray], valid: np.ndarray) -> tuple:
    """One validation batch's (mean SSL cross-entropy over the axes, {axis:
    accuracy}, clips counted): per-clip cross-entropies and hits weighted
    by the clip's sample being real (the JAX make_ssl_eval_step's sums)."""
    s = next(iter(labels.values())).shape[1]
    w = np.repeat(valid.astype(np.float32), s)
    denom = max(float(w.sum()), 1.0)
    losses, accs = {}, {}
    for k, p in preds.items():
        lab = labels.get(k, labels.get("move_joint"))
        if lab is None:
            continue
        lab = lab.reshape(-1).astype(np.int64)
        p = p.astype(np.float64)
        top = p.max(-1)
        ce = np.log(np.exp(p - top[:, None]).sum(-1)) + top - p[np.arange(len(lab)), lab]
        losses[k] = float((ce * w).sum()) / denom
        accs[k] = float(((p.argmax(-1) == lab) * w).sum()) / denom
    return sum(losses.values()) / max(len(losses), 1), accs, float(w.sum())


def _eval_epoch_ssl(cfg, model, data: mesh.Mesh) -> Dict[str, float]:
    """The pretraining validation over the test split (the reference's eval
    epoch with the SSL losses): the mean cross-entropy over the axes and the
    accuracy of each axis, over the real clips (padding rows masked)."""
    loss_sum = w_sum = 0.0
    acc_sum: Dict[str, float] = {}

    def on_batch(out, labels, clip_ids, _maps):
        nonlocal loss_sum, w_sum
        loss, accs, w = _ssl_batch_stats(out, labels, clip_ids >= 0)
        loss_sum += loss * w
        w_sum += w
        for k, v in accs.items():
            acc_sum[k] = acc_sum.get(k, 0.0) + v * w

    _test_loop(cfg, model, data, _test_loader(cfg, data), on_batch)
    stats = {"loss": loss_sum / max(w_sum, 1.0), **{f"acc_{k}": round(v / max(w_sum, 1.0) * 100.0, 2) for k, v in acc_sum.items()}}
    log_json_stats({"_type": "val_epoch_ssl", **stats, "clips": int(w_sum)}, logger)
    return stats


def train(cfg, device=None) -> Dict[str, Any]:
    """Classification training, or MoSI pretraining under PRETRAIN.ENABLE.
    Returns the JAX package's ``best_top1`` and the per-step losses, the
    optimizer updates made, the start weights (``init_weights``: "fresh",
    "resumed" or TRAIN.CHECKPOINT_FILE_PATH), the steps run, the wall
    seconds of the step loop with the clips it trained per second
    (validations and checkpoints excluded; under pretraining a clip is a
    video's S pseudo-motion clips) and the last SSL validation's stats
    (``ssl_val``, pretraining only).  Runs on the card unless ``device``
    names the CPU."""
    data, model = _setup(cfg, device)
    device = data.device
    state = TrainState.create(cfg, model, Optimizer(cfg, model, name_prefix=""))
    if cfg.get("LOG_MODEL_INFO", False):
        log_model_info(model, label=f"{cfg.MODEL.get('NAME', None) or 'BaseVideoModel'}/{cfg.VIDEO.BACKBONE.META_ARCH}", device=device)
    ckpt = Checkpointer(cfg.OUTPUT_DIR)
    start_epoch, init_weights = 0, "fresh"
    if auto_resume(cfg, ckpt, state) is not None:
        start_epoch, init_weights = int(cfg.TRAIN.get("RESUME_EPOCH", 0)), "resumed"
    elif load_train_checkpoint_file(cfg, model):
        init_weights = str(cfg.TRAIN.CHECKPOINT_FILE_PATH)
        if state.ema is not None:
            state.ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    mesh.broadcast_module(model)
    state.shard_(data.model_shard)
    train_step = make_classification_train_step(model, cfg)
    batch = int(cfg.TRAIN.BATCH_SIZE)
    loader = build_classification_loader(cfg, "train", row_range=_rows(batch, data))
    max_epoch = int(cfg.SOLVER.MAX_EPOCH)
    num_folds = int(cfg.TRAIN.get("NUM_FOLDS", 1))
    log_period = int(cfg.get("LOG_PERIOD", 10))
    loss_meter = ScalarMeter(log_period)
    best_top1, losses, updates, pending = 0.0, [], 0, []
    train_seconds, ssl_val = 0.0, None

    def fetch() -> float:
        """The pending steps' metrics in one read; returns the last top1."""
        nonlocal updates
        rows = torch.stack([torch.stack([m["loss"], m["top1"], m["updated"].float()]) for m in pending]).tolist()
        pending.clear()
        for loss, _, updated in rows:
            losses.append(loss)
            updates += int(updated)
        return rows[-1][1]

    for cur_epoch in range(start_epoch, max_epoch, num_folds):
        loader.set_epoch(cur_epoch)
        data_size = max(len(loader), 1)
        t0 = time.perf_counter()
        for it, (videos, labels, _) in enumerate(loader):
            lr = get_lr_at_epoch(cfg, cur_epoch + num_folds * it / data_size)
            pending.append(train_step(state, _to_device(videos, device), _to_device(labels, device), lr, step_generator(cfg, cur_epoch, it, device)))
            if (it + 1) % log_period == 0:
                top1 = fetch()
                loss_meter.add_value(losses[-1])
                log_json_stats({"_type": "train_iter", "epoch": cur_epoch + 1, "iter": f"{it + 1}/{data_size}",
                                "loss": round(loss_meter.get_win_median(), 5), "top1": round(top1 * 100, 2), "lr": lr}, logger)
        if pending:
            fetch()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        train_seconds += time.perf_counter() - t0
        covered = range(cur_epoch, min(cur_epoch + num_folds, max_epoch))
        if any(is_eval_epoch(cfg, e) for e in covered):
            if _pretrain(cfg):
                ssl_val = _eval_epoch_ssl(cfg, model, data)
            else:
                best_top1 = max(best_top1, _eval_epoch(cfg, model, data)["top1_acc"])
        if any(is_checkpoint_epoch(cfg, e) for e in covered):
            ckpt.save(cur_epoch + num_folds, state)
    ckpt.save(max_epoch, state)
    steps = len(losses)
    return {"best_top1": best_top1, "losses": losses, "updates": updates, "init_weights": init_weights, "steps": steps,
            "seconds": train_seconds, "clips_per_s": steps * batch / max(train_seconds, 1e-9), "ssl_val": ssl_val}


def _test_loader(cfg, data: mesh.Mesh):
    return build_classification_loader(cfg, "test", row_range=_rows(int(cfg.TEST.get("BATCH_SIZE", cfg.TRAIN.BATCH_SIZE)), data))


def _test_loop(cfg, model, data: mesh.Mesh, loader, on_batch, features: bool = False) -> Dict[str, float]:
    """Run ``loader``'s clips through ``model``, one step in flight while
    ``on_batch(out, labels, clip_ids, maps)`` takes the one before (global
    rows on the host; ``maps`` the residual blocks' feature maps with
    ``features``, else empty, gathered in global row order as the outputs
    are); returns the loop's clips and seconds."""
    eval_step = make_classification_eval_step(model, cfg)
    fm = FeatureMaps(model) if features else None
    pending, clips = None, 0
    t0 = time.perf_counter()

    def drain(out, labels, clip_ids, maps):
        if isinstance(out, dict):  # MoSI's per-axis predictions, with per-axis labels
            host, labels = {k: _gather(o) for k, o in out.items()}, {k: _gather(v) for k, v in labels.items()}
        else:
            host, labels = (tuple(_gather(o) for o in out) if isinstance(out, tuple) else _gather(out)), _gather(labels)
        on_batch(host, labels, _gather(clip_ids), {k: _gather(v.float().permute(0, 2, 3, 4, 1).contiguous()) for k, v in maps.items()})

    with fm or contextlib.nullcontext():
        for videos, labels, clip_ids in loader:
            out = eval_step(_to_device(videos, data.device))
            maps = {} if fm is None else dict(fm.maps)  # this step's; the next step's hooks write new tensors
            clips += videos.shape[0] * data.data
            if pending is not None:
                drain(*pending)
            pending = (out, _to_device(labels, data.device), _to_device(clip_ids, data.device), maps)
        if pending is not None:
            drain(*pending)
    seconds = time.perf_counter() - t0
    return {"clips": clips, "seconds": seconds, "clips_per_s": clips / max(seconds, 1e-9)}


def _test_model(cfg, device):
    data, model = _setup(cfg, device)
    weights = load_test_variables(cfg, Checkpointer(cfg.OUTPUT_DIR), model)
    mesh.broadcast_module(model)
    tensor.shard_module(model, data.model_shard)
    return data, model, weights


def test(cfg, device=None) -> Dict[str, Any]:
    """The multi-view test: every clip's scores summed (or maxed,
    DATA.ENSEMBLE_METHOD) per video, then top-1 / top-5 (EPIC: verb, noun,
    joint and action).  Returns the meter's stats with the weights tested,
    the clips a video the meter saw (``clips_per_video``, the least over the
    videos) and the loop's clips per second."""
    data, model, weights = _test_model(cfg, device)
    loader = _test_loader(cfg, data)
    num_videos, num_clips = len(loader.ds.samples), loader.ds._num_clips
    method = str(cfg.DATA.get("ENSEMBLE_METHOD", "sum"))
    dual = _dual_head(cfg)
    meter = (EpicKitchenMeter(num_videos, num_clips, cfg.VIDEO.HEAD.NUM_CLASSES, method) if dual
             else TestMeter(num_videos, num_clips, int(cfg.VIDEO.HEAD.NUM_CLASSES), method))
    viz_id = 0

    def on_batch(out, labels, clip_ids, maps):
        nonlocal viz_id
        valid = clip_ids >= 0
        if maps and mesh.rank() == 0:  # the maps of every rank, in global row order
            viz_id += save_feature_maps(maps, cfg, start_id=viz_id, valid=valid)
        if dual:
            meter.update_stats(out[0][valid], out[1][valid], labels[valid, 0], labels[valid, 1], clip_ids[valid])
        else:
            meter.update_stats(out[valid], labels[valid], clip_ids[valid])

    loop = _test_loop(cfg, model, data, loader, on_batch, features=visualization_enabled(cfg))
    stats = meter.finalize_metrics()
    return {**stats, "weights": weights, "clips_per_video": int(meter.clip_count.min()), "clips": loop["clips"],
            "seconds": loop["seconds"], "clips_per_s": loop["clips_per_s"], "meter": meter}


def submission_test(cfg, device=None) -> Dict[str, Any]:
    """The EPIC test-set submission: the multi-view EPIC test, then the
    per-video ensembled verb and noun scores as ``OUTPUT_DIR/submission.json``
    (written by rank 0)."""
    data, model, weights = _test_model(cfg, device)
    loader = _test_loader(cfg, data)
    num_videos, num_clips = len(loader.ds.samples), loader.ds._num_clips
    meter = EpicKitchenMeter(num_videos, num_clips, cfg.VIDEO.HEAD.NUM_CLASSES, str(cfg.DATA.get("ENSEMBLE_METHOD", "sum")))

    def on_batch(out, labels, clip_ids, maps):
        valid = clip_ids >= 0
        meter.update_stats(out[0][valid], out[1][valid], labels[valid, 0], labels[valid, 1], clip_ids[valid])

    _test_loop(cfg, model, data, loader, on_batch)
    preds = meter.get_video_preds()
    results = {
        "version": "0.2",
        "challenge": "action_recognition",
        "results": {
            str(loader.ds.samples[v][0]): {
                "verb": {str(c): float(s) for c, s in enumerate(preds["verb_class"][v])},
                "noun": {str(c): float(s) for c, s in enumerate(preds["noun_class"][v])},
            }
            for v in range(num_videos)
        },
    }
    out_path = os.path.join(cfg.OUTPUT_DIR, "submission.json")
    if mesh.rank() == 0:
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(results, f)
        logger.info("wrote EPIC submission JSON: %s", out_path)
    mesh.barrier()
    return {**meter.finalize_metrics(), "weights": weights, "submission": out_path}
