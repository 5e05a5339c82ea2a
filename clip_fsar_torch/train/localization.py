"""The localization task: BMN training and the sliding-window EPIC test
(counterpart of clip_fsar_tpu/train/localization.py:31-284, the reference's
runs/train.py with the LOCALIZATION losses, runs/test_epic_localization.py
and runs/submission_test.py).

``BMNModel`` is SimpleLocalizationConv then BaseBMN over window features
[B, T, C], built whatever MODEL.NAME says, as the JAX runners build theirs.
``train_localization`` runs SOLVER.MAX_EPOCH epochs of shuffled windows, the
lr of each step at its fractional epoch, the losses of LOCALIZATION.LOSS
(``Loss_PemReg``'s draws from a generator per step), and saves one
checkpoint at the end.  ``test_epic_localization`` tests the newest
OUTPUT_DIR checkpoint: the windows' proposals on the video timeline,
score, soft-NMS on duration-normalized segments and the top-k verb/noun
fan-out, then mAP of the action, verb and noun streams at tIoU 0.1-0.5.
``submission_test`` writes the same detections in the EPIC JSON schema.
The proposals and the mAP are host numpy (utils/tal.py); the test keeps one
batch in flight on the device while the host parses the one before.

Two deliberate divergences from the JAX package (ROADMAP): DATA.DURATION_SCALE
<= 0 reads as TEMPORAL_SCALE (data/tal_features.py), and ``submission_test``
loads the newest checkpoint where the JAX one writes the predictions of
freshly initialized weights.  Everything runs in float32.  The runners run
as one process: a process group of more than one rank raises before any
work.  The train step runs under cuDNN's deterministic algorithms and BMN's
boundary-matching layer has a gathered backward (ops/boundary_matching.py),
so a training repeats bit for bit on a card.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from clip_fsar_torch import runtime
from clip_fsar_torch.data.tal_features import TalFeatureDataset
from clip_fsar_torch.models.heads.bmn import BaseBMN
from clip_fsar_torch.models.video.meta import SimpleLocalizationConv
from clip_fsar_torch.parallel import mesh
from clip_fsar_torch.train.checkpoint import Checkpointer
from clip_fsar_torch.train.classification import _to_device, step_generator
from clip_fsar_torch.train.localization_losses import pem_reg_draws
from clip_fsar_torch.train.losses import calculate_loss
from clip_fsar_torch.train.optimizer import Optimizer, get_lr_at_epoch
from clip_fsar_torch.train.state import TrainState
from clip_fsar_torch.utils.logging import get_logger, log_json_stats, setup_logging
from clip_fsar_torch.utils.tal import detection_map, fuse_verb_noun_maps, parse_bmn_proposals, soft_nms

logger = get_logger(__name__)

TIOUS = (0.1, 0.2, 0.3, 0.4, 0.5)


class BMNModel(nn.Module):
    """SimpleLocalizationConv backbone + BaseBMN head over [B, T, C] features."""

    def __init__(self, cfg):
        super().__init__()
        self.backbone = SimpleLocalizationConv(cfg)
        self.head = BaseBMN(cfg, self.backbone.out_channels)

    def forward(self, x: torch.Tensor) -> Dict[str, Optional[torch.Tensor]]:
        return self.head(self.backbone(x.float().transpose(1, 2)))


def build_bmn_model(cfg, device=None, generator: Optional[torch.Generator] = None) -> BMNModel:
    """A BMNModel with fresh weights from ``generator`` (RANDOM_SEED by
    default; flax's defaults: lecun normal kernels, zero biases) on
    ``device`` (the CPU when None)."""
    model = BMNModel(cfg)
    g = generator if generator is not None else torch.Generator().manual_seed(int(cfg.get("RANDOM_SEED", 0)))
    with torch.no_grad():
        model.backbone.init_own_parameters(g)
        model.head.init_own_parameters(g)
    return model.to(device or "cpu")


def _one_process(cfg, what: str) -> None:
    """Before any work: refuse a process group of more than one rank.  TPU.MESH
    is not read, as the JAX package's localization runners do not read it."""
    if mesh.world_size() > 1 or int(os.environ.get("WORLD_SIZE", "1") or 1) > 1:
        raise NotImplementedError(f"{what} under a process group of more than one rank: the localization runners run as one process, as the "
                                  "JAX package's do")


def _batches(ds: TalFeatureDataset, batch_size: int, shuffle: bool, seed: int):
    """(features [b, T, C], label maps {name: [b, ...]}, metas [(video, window start)]) per batch."""
    order = np.random.default_rng(seed).permutation(len(ds)) if shuffle else np.arange(len(ds))
    for i in range(0, len(order), batch_size):
        feats, maps, metas = [], collections.defaultdict(list), []
        for j in order[i : i + batch_size]:
            f, m, meta = ds.get_item(int(j))
            feats.append(f)
            for k, v in m.items():
                maps[k].append(v)
            metas.append(meta)
        yield np.stack(feats), {k: np.stack(v) for k, v in maps.items()}, metas


def make_localization_train_step(model: BMNModel, cfg):
    """train_step(state, feats [b, T, C], maps {name: [b, ...]} on the device,
    lr, draws=None or generator) -> (loss, parts) as 0-dim device tensors,
    updating ``state`` in place.  ``draws`` (``Loss_PemReg``'s fields) are
    drawn from ``generator`` when not given.  Reads nothing back.  The step
    runs under ``runtime.deterministic_convolutions()``, and the boundary-matching
    layer's backward is a gather (``ops.boundary_matching``): two runs from one
    start give the same bits on a card."""

    @runtime.deterministic_convolutions()  # the backward runs inside: the same bits on every run
    def train_step(state: TrainState, feats: torch.Tensor, maps: Dict[str, torch.Tensor], lr: float,
                   generator: Optional[torch.Generator] = None, draws=None):
        preds = model(feats)
        if draws is None and generator is not None:
            draws = pem_reg_draws(maps["iou_map"].shape, generator)
        loss, parts = calculate_loss(cfg, preds, None, {"supervised": maps}, draws=draws)
        model.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step(lr)
        model.zero_grad(set_to_none=True)
        state.step += 1
        return loss.detach(), {k: v.detach() for k, v in parts.items()}

    return train_step


def train_localization(cfg, device=None) -> Dict[str, Any]:
    """BMN training (see the module docstring).  Returns the JAX package's
    ``final_loss`` with the per-step losses, the steps, the seconds of the
    step loop and its windows per second, and the checkpoint written."""
    setup_logging(cfg.get("OUTPUT_DIR", None))
    _one_process(cfg, "train_localization")
    cfg.LOCALIZATION.ENABLE = True
    device = runtime.device(device)
    model = build_bmn_model(cfg, device)
    state = TrainState.create(cfg, model, Optimizer(cfg, model, name_prefix=""))
    train_step = make_localization_train_step(model, cfg)
    ds = TalFeatureDataset(cfg, "train")
    bs = int(cfg.TRAIN.BATCH_SIZE)
    max_epoch = int(cfg.SOLVER.MAX_EPOCH)
    losses: List[float] = []
    seconds, windows = 0.0, 0
    for epoch in range(max_epoch):
        n = max(-(-len(ds) // bs), 1)
        pending = []
        t0 = time.perf_counter()
        for it, (feats, maps, _) in enumerate(_batches(ds, bs, True, epoch)):
            lr = get_lr_at_epoch(cfg, epoch + it / n)
            pending.append(train_step(state, _to_device(feats, device), _to_device(maps, device), lr, step_generator(cfg, epoch, it, device)))
            windows += len(feats)
        rows = torch.stack([torch.stack([loss, *parts.values()]) for loss, parts in pending]).tolist()  # the epoch's one read
        seconds += time.perf_counter() - t0
        losses += [r[0] for r in rows]
        log_json_stats({"_type": "tal_train_epoch", "epoch": epoch + 1, "loss": round(rows[-1][0], 5),
                        **{k: round(v, 4) for k, v in zip(pending[-1][1], rows[-1][1:])}}, logger)
    path = Checkpointer(cfg.OUTPUT_DIR).save(max_epoch, state)
    return {"final_loss": losses[-1], "losses": losses, "steps": len(losses), "seconds": seconds,
            "windows_per_s": windows / max(seconds, 1e-9), "checkpoint": path}


def _test_model(cfg, device) -> tuple:
    """(model with the newest OUTPUT_DIR checkpoint, else fresh weights; which one it holds)."""
    model = build_bmn_model(cfg, device)
    ckpt = Checkpointer(cfg.OUTPUT_DIR)
    step = ckpt.latest_step()
    if step is None:
        logger.info("no checkpoint under %s: testing freshly built weights", cfg.OUTPUT_DIR)
        return model.eval(), "fresh"
    model.load_state_dict(ckpt.load(step)["head"])
    logger.info("testing with checkpoint at step %d", step)
    return model.eval(), ckpt.path(step)


def _host(preds: Dict[str, Optional[torch.Tensor]]) -> Dict[str, Optional[np.ndarray]]:
    return {k: None if v is None else v.cpu().numpy() for k, v in preds.items()}


def _proposals(cfg, model: BMNModel, ds: TalFeatureDataset, device: torch.device) -> tuple:
    """Every window's proposals on its video's timeline, one batch in
    flight on the device while the host parses the one before; returns
    (proposals by video, windows, seconds)."""
    proposals: Dict[str, List] = collections.defaultdict(list)
    pending, windows = None, 0

    def drain(preds, metas):
        for video, plist in _window_proposals(cfg, _host(preds), metas, ds).items():
            proposals[video].extend(plist)

    t0 = time.perf_counter()
    with torch.no_grad():
        for feats, _maps, metas in _batches(ds, int(cfg.TEST.BATCH_SIZE), False, 0):
            preds = model(_to_device(feats, device))
            windows += len(feats)
            if pending is not None:
                drain(*pending)
            pending = (preds, metas)
        if pending is not None:
            drain(*pending)
    return proposals, windows, time.perf_counter() - t0


def _window_proposals(cfg, preds, metas, ds) -> Dict[str, List]:
    """Parse per-window proposals and place them on the video timeline
    (reference fuse_epic_sliding_windows + parse_epic_bmn_proposals).  With
    verb/noun maps each proposal also carries its fused top-k actions
    (reference tal_tools.py:125,139-167): ``verb_noun`` [k, 2] (verb_id,
    noun_id) and ``vn_score`` [k, 3] (verb, noun, fused score).  As in the
    JAX package the regression map is not read here."""
    per_video: Dict[str, List] = collections.defaultdict(list)
    tscale = int(cfg.DATA.TEMPORAL_SCALE)
    start, end, conf = preds["start"], preds["end"], preds["confidence_map"]
    has_cls = preds.get("verb_map") is not None
    for bi, (video, w_start) in enumerate(metas):
        duration = float(ds.annotations[video]["duration"])
        props = []
        for p in parse_bmn_proposals(start[bi], end[bi], conf[bi]):
            t0 = w_start + p["xmin"] * tscale
            t1 = w_start + p["xmax"] * tscale
            if t1 <= duration + 1e-6:
                props.append((p, dict(p, xmin=t0, xmax=t1, label=0)))
        if has_cls and props:
            # the (duration, start) cell each proposal was read from, all of the window's fused at once
            d_idx = np.array([max(min(int((p["xmax"] - p["xmin"]) * tscale) - 1, conf[bi].shape[1] - 1), 0) for p, _ in props])
            s_idx = np.array([min(int(p["xmin"] * tscale), tscale - 1) for p, _ in props])
            vn, vn_score = fuse_verb_noun_maps(preds["verb_map"][bi][:, d_idx, s_idx].T, preds["noun_map"][bi][:, d_idx, s_idx].T)
            for k, (_, out) in enumerate(props):
                out["verb_noun"], out["vn_score"] = vn[k], vn_score[k]
                out["label"] = int(vn[k, 0, 0])
        per_video[video].extend(out for _, out in props)
    return per_video


def _post_process(cfg, proposals: Dict[str, List], ds) -> Dict[str, List[Dict]]:
    """Score, soft-NMS and top-k action expansion per video (reference
    epic_video_post_process, tal_tools.py:298-372).  Returns video ->
    [{"segment": [t0, t1], "score", "verb", "noun"}]."""
    loc = cfg.LOCALIZATION
    pp = loc.get("POST_PROCESS", loc)  # the legacy flat keys as the fallback
    nms_alpha = float(pp.get("SOFT_NMS_ALPHA", 0.4))
    t1, t2 = float(pp.get("SOFT_NMS_LOW_THRES", 0.0)), float(pp.get("SOFT_NMS_HIGH_THRES", 0.0))
    iou_power = float(pp.get("IOU_POWER", 2.0))
    select_score = float(pp.get("SELECT_SCORE", 0.0))
    score_type = str(pp.get("SCORE_TYPE", "cr"))
    clr_power = float(pp.get("CLR_POWER", 1.2))
    reg_power = float(pp.get("REG_POWER", 1.2))
    action_power = float(pp.get("ACTION_SCORE_POWER", 1.0))
    use_topk = int(pp.get("USE_TOPK", 5))

    predictions: Dict[str, List[Dict]] = {}
    for video, plist in proposals.items():
        duration = max(float(ds.annotations[video]["duration"]), 1e-6)
        # the ranking score recomputed from its factors (tal_tools.py:332-343); 'cr' is the shipped default
        for p in plist:
            if score_type == "cr":
                p["score"] = p.get("clr_score", p["score"]) ** clr_power * p.get("reg_score", 1.0) ** reg_power
            elif score_type == "se":
                p["score"] = p.get("xmin_score", p["score"]) ** 2
            elif score_type == "secr":
                p["score"] = p.get("clr_score", 1.0) * p.get("reg_score", 1.0) * p.get("xmin_score", p["score"]) ** 2
        plist = [p for p in plist if p["score"] > select_score]
        # soft-NMS on duration-normalized segments: its width-dependent
        # threshold t1 + (t2 - t1) * width assumes widths in [0, 1] (tal_tools.py:346-370)
        norm = [dict(p, xmin=p["xmin"] / duration, xmax=p["xmax"] / duration) for p in plist]
        kept = soft_nms(norm, nms_alpha, t1, t2, int(pp.get("PROP_NUM", 100)), iou_power) if len(norm) > 1 else norm
        dets = []
        for p in kept:
            seg = [max(0.0, p["xmin"]) * duration, min(1.0, p["xmax"]) * duration]
            if "verb_noun" in p:
                # each kept proposal fans out into its top-k fused actions, scored
                # score * fused^ACTION_SCORE_POWER (tal_tools.py:359-371)
                vn, vs = p["verb_noun"], p["vn_score"]
                for k in range(min(use_topk, len(vn))):
                    dets.append({"segment": seg, "score": float(p["score"] * vs[k, 2] ** action_power),
                                 "verb": int(vn[k, 0]), "noun": int(vn[k, 1])})
            else:
                dets.append({"segment": seg, "score": float(p["score"]), "verb": int(p.get("label", 0)), "noun": 0})
        predictions[video] = dets
    return predictions


def evaluate_detections(predictions: Dict[str, List[Dict]], ds) -> Dict[str, float]:
    """mAP of the action (exact (verb, noun) pair), verb and noun streams at
    each tIoU of ``TIOUS`` and their average, as the reference's
    Epicdetection evaluates them (eval_epic_detection.py:231-242)."""
    gt = {"action": {}, "verb": {}, "noun": {}}
    for v, info in ds.annotations.items():
        anns = [(a["segment"][0], a["segment"][1], int(a.get("verb", 0)), int(a.get("noun", 0))) for a in info["annotations"]]
        gt["action"][v] = [(s, e, (vb, nn_)) for s, e, vb, nn_ in anns]
        gt["verb"][v] = [(s, e, vb) for s, e, vb, _ in anns]
        gt["noun"][v] = [(s, e, nn_) for s, e, _, nn_ in anns]
    pred = {"action": {}, "verb": {}, "noun": {}}
    for v, dets in predictions.items():
        pred["action"][v] = [(d["segment"][0], d["segment"][1], d["score"], (d["verb"], d["noun"])) for d in dets]
        pred["verb"][v] = [(d["segment"][0], d["segment"][1], d["score"], d["verb"]) for d in dets]
        pred["noun"][v] = [(d["segment"][0], d["segment"][1], d["score"], d["noun"]) for d in dets]
    stats: Dict[str, float] = {}
    for stream in ("action", "verb", "noun"):
        for k, val in detection_map(gt[stream], pred[stream], tiou_thresholds=TIOUS).items():
            stats[f"{stream}/{k}"] = val
    return stats


def test_epic_localization(cfg, device=None) -> Dict[str, Any]:
    """The sliding-window test of the newest OUTPUT_DIR checkpoint on
    TEST.TEST_SET.  Returns the mAP stats (the JAX package's dict) with the
    weights tested, the windows and the windows per second of the loop."""
    setup_logging(cfg.get("OUTPUT_DIR", None))
    _one_process(cfg, "test_epic_localization")
    device = runtime.device(device)
    model, weights = _test_model(cfg, device)
    ds = TalFeatureDataset(cfg, cfg.TEST.get("TEST_SET", "val"))
    proposals, windows, seconds = _proposals(cfg, model, ds, device)
    stats = evaluate_detections(_post_process(cfg, proposals, ds), ds)
    log_json_stats({"_type": "tal_eval", **{k: round(v, 4) for k, v in stats.items()}}, logger)
    return {**stats, "weights": weights, "windows": windows, "seconds": seconds, "windows_per_s": windows / max(seconds, 1e-9)}


def submission_test(cfg, device=None) -> Dict[str, Any]:
    """The EPIC submission JSON (reference runs/submission_test.py) of the
    newest OUTPUT_DIR checkpoint on TEST.TEST_SET, at
    OUTPUT_DIR/SUBMISSION.SAVE_RESULTS_PATH; returns its path and the
    weights used."""
    setup_logging(cfg.get("OUTPUT_DIR", None))
    _one_process(cfg, "submission_test")
    device = runtime.device(device)
    test_set = str(cfg.TEST.get("TEST_SET", "test"))
    stats_path = os.path.join(cfg.OUTPUT_DIR, cfg.SUBMISSION.get("SAVE_RESULTS_PATH", "test.json"))
    model, weights = _test_model(cfg, device)
    ds = TalFeatureDataset(cfg, test_set)
    proposals, _, _ = _proposals(cfg, model, ds, device)
    # the EPIC challenge schema (reference tal_tools.py:229-238 and the per-detection keys at :362-371):
    # 'label' is the key on val splits, 'action' on the held-out test split (:315)
    action_key = "label" if "val" in test_set else "action"
    results = {v: [{"score": d["score"], action_key: f"{d['verb']},{d['noun']}", "verb": d["verb"], "noun": d["noun"], "segment": d["segment"]}
                   for d in dets]
               for v, dets in _post_process(cfg, proposals, ds).items()}
    os.makedirs(os.path.dirname(stats_path) or ".", exist_ok=True)
    with open(stats_path, "w") as f:
        json.dump({"version": "0.2", "challenge": "action_detection", "sls_pt": 2, "sls_tl": 3, "sls_td": 3, "results": results}, f, indent=4)
    logger.info("submission written to %s", stats_path)
    return {"path": stats_path, "weights": weights}
