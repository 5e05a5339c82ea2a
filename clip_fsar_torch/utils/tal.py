"""Temporal-action-localization post-processing (counterpart of
clip_fsar_tpu/utils/tal.py:16-229, the reference's utils/tal_tools.py,
utils/bboxes_1d.py and utils/eval_tal/*).

Host numpy with the JAX package's arithmetic, so that both give the same
numbers: proposal parsing from BMN maps (local-peak and half-max start/end
candidates, confidence products), Gaussian soft-NMS, segment IoU, the
verb/noun fusion of EPIC proposals, and the interpolated-AP detection
evaluator (EPIC protocol).  The verb/noun fusion of a window's proposals
(``fuse_verb_noun_maps``) and soft-NMS's overlap tests run on arrays rather
than one proposal at a time, which at the EPIC preset's 200 x 200 cells and
97 x 300 classes is the difference between minutes and seconds of host time
per test; each number is computed by the same operations as there.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_POW = np.frompyfunc(math.pow, 2, 1)


def iou_with_anchors(anchors_min: np.ndarray, anchors_max: np.ndarray, box_min: float, box_max: float) -> np.ndarray:
    """Temporal IoU of many anchors with one segment
    (reference bboxes_1d.py)."""
    inter_min = np.maximum(anchors_min, box_min)
    inter_max = np.minimum(anchors_max, box_max)
    inter = np.maximum(inter_max - inter_min, 0.0)
    union = (anchors_max - anchors_min) + (box_max - box_min) - inter
    return inter / np.maximum(union, 1e-9)


def segment_iou(target: np.ndarray, candidates: np.ndarray) -> np.ndarray:
    """IoU of one [2] target with [N, 2] candidates
    (reference eval_epic_detection.py:349-374)."""
    tt1 = np.maximum(target[0], candidates[:, 0])
    tt2 = np.minimum(target[1], candidates[:, 1])
    inter = np.maximum(tt2 - tt1, 0.0)
    union = (candidates[:, 1] - candidates[:, 0]) + (target[1] - target[0]) - inter
    return inter / np.maximum(union, 1e-9)


def boundary_candidates(scores: np.ndarray, first_or_last: int) -> np.ndarray:
    """Start/end candidate mask: local maxima or > half the global max
    (reference tal_tools.py:94-110).  first_or_last: 0 -> force index 0
    on (starts), -1 -> force last index (ends)."""
    t = len(scores)
    bins = np.zeros(t)
    bins[first_or_last] = 1
    mx = scores.max()
    for i in range(1, t - 1):
        if scores[i] > scores[i + 1] and scores[i] > scores[i - 1]:
            bins[i] = 1
        elif scores[i] > 0.5 * mx:
            bins[i] = 1
    return bins


def parse_bmn_proposals(
    start_scores: np.ndarray,  # [T]
    end_scores: np.ndarray,  # [T]
    confidence_map: np.ndarray,  # [2, D, T] (reg, cls)
    reg_map: Optional[np.ndarray] = None,
    reg_weights: Tuple[float, float] = (1.0, 1.0),
) -> List[Dict[str, float]]:
    """Enumerate (start, duration) cells whose endpoints are candidates
    (reference parse_epic_bmn_proposals, tal_tools.py:67-140).  Scores are
    start * end * cls_conf * reg_conf."""
    reg_conf, clr_conf = confidence_map[0], confidence_map[1]
    dscale, tscale = clr_conf.shape
    start_bins = boundary_candidates(start_scores, 0)
    end_bins = boundary_candidates(end_scores, -1)
    props = []
    for d in range(dscale):
        for s in range(tscale):
            e = s + d + 1
            if e >= tscale or start_bins[s] != 1 or end_bins[e] != 1:
                continue
            xmin, xmax = s / tscale, e / tscale
            if reg_map is not None:
                dx = reg_map[0, d, s] * reg_weights[0]
                dw = reg_map[1, d, s] * reg_weights[1]
                center = (xmax + xmin) / 2.0 + dx * (xmax - xmin)
                width = (xmax - xmin) * np.exp(dw)
                xmin, xmax = max(center - width / 2.0, 0.0), min(center + width / 2.0, 1.0)
            score = float(start_scores[s] * end_scores[e] * clr_conf[d, s] * reg_conf[d, s])
            props.append({"xmin": xmin, "xmax": xmax, "score": score,
                          "xmin_score": float(start_scores[s]), "xmax_score": float(end_scores[e]),
                          "clr_score": float(clr_conf[d, s]), "reg_score": float(reg_conf[d, s])})
    return props


def fuse_verb_noun_map(
    verb_scores: np.ndarray,  # [num_verbs]
    noun_scores: np.ndarray,  # [num_nouns]
    verb_topk: int = 10,
    noun_topk: int = 30,
    topk: int = 20,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fuse per-proposal verb/noun distributions into a ranked action list
    (reference fuse_verb_noun_map, tal_tools.py:139-167).

    Takes the top `verb_topk` verbs x top `noun_topk` nouns, scores every
    pair by the product of the two scores, and returns the `topk` best:
      index [topk, 2] int — (verb_id, noun_id) per action candidate;
      score [topk, 3] — (verb_score, noun_score, fused_score).
    """
    index, score = fuse_verb_noun_maps(np.asarray(verb_scores)[None], np.asarray(noun_scores)[None], verb_topk, noun_topk, topk)
    return index[0], score[0]


def fuse_verb_noun_maps(
    verb_scores: np.ndarray,  # [P, num_verbs]
    noun_scores: np.ndarray,  # [P, num_nouns]
    verb_topk: int = 10,
    noun_topk: int = 30,
    topk: int = 20,
) -> Tuple[np.ndarray, np.ndarray]:
    """``fuse_verb_noun_map`` of P proposals at once: index [P, topk, 2],
    score [P, topk, 3], each row what the one-proposal call gives (stable
    sorts row by row, the same float64 products)."""
    # the ranks from the scores as given (a float32 map ranks as its float64 copy), the products in float64
    verb_index = np.argsort(-np.asarray(verb_scores), axis=1, kind="stable")[:, :verb_topk]
    noun_index = np.argsort(-np.asarray(noun_scores), axis=1, kind="stable")[:, :noun_topk]
    verb_scores = np.asarray(verb_scores, np.float64)
    noun_scores = np.asarray(noun_scores, np.float64)
    rows = np.arange(verb_scores.shape[0])[:, None]
    # [P, noun_topk, verb_topk] so that flat // n_verbs is the noun row, matching
    # the reference's pesdo_noun_index = idx // verb_topk decode
    fuse = (noun_scores[rows, noun_index][:, :, None] * verb_scores[rows, verb_index][:, None, :]).reshape(len(rows), -1)
    flat = np.argsort(-fuse, axis=1, kind="stable")[:, :topk]
    n_verbs = verb_index.shape[1]
    real_noun = np.take_along_axis(noun_index, flat // n_verbs, axis=1)
    real_verb = np.take_along_axis(verb_index, flat % n_verbs, axis=1)
    index = np.stack([real_verb, real_noun], axis=2)
    score = np.stack([verb_scores[rows, real_verb], noun_scores[rows, real_noun], np.take_along_axis(fuse, flat, axis=1)], axis=2)
    return index, score


def soft_nms(proposals: List[Dict[str, float]], alpha: float, t1: float, t2: float, prop_num: int, iou_power: float = 2.0) -> List[Dict[str, float]]:
    """Gaussian soft-NMS with width-dependent threshold
    (reference tal_tools.py:249-296).  The overlaps and the threshold test
    run on arrays; each decay is the scalar expression the JAX package
    applies, so the kept scores are its bit for bit."""
    if not proposals:
        return []
    order = sorted(range(len(proposals)), key=lambda i: -proposals[i]["score"])
    tstart = np.asarray([proposals[i]["xmin"] for i in order], np.float64)
    tend = np.asarray([proposals[i]["xmax"] for i in order], np.float64)
    tscore = np.asarray([proposals[i]["score"] for i in order], np.float64)
    items = [proposals[i] for i in order]

    out: List[Dict[str, float]] = []
    while len(tscore) > 1 and len(out) < prop_num:
        mi = int(np.argmax(tscore))
        ious = iou_with_anchors(tstart, tend, tstart[mi], tend[mi])
        width = tend[mi] - tstart[mi]
        hit = ious > t1 + (t2 - t1) * width
        hit[mi] = False
        idx = np.flatnonzero(hit)
        if len(idx):  # the power through math.pow: C pow, as a float64 scalar's ** takes it (the ufunc's may round otherwise)
            tscore[idx] *= np.exp(-_POW(ious[idx], iou_power).astype(np.float64) / alpha)
        keep = dict(items[mi])
        keep["score"] = float(tscore[mi])
        out.append(keep)
        tstart, tend, tscore = np.delete(tstart, mi), np.delete(tend, mi), np.delete(tscore, mi)
        items.pop(mi)
    return out


def detection_map(
    ground_truth: Dict[str, List[Tuple[float, float, int]]],
    predictions: Dict[str, List[Tuple[float, float, float, int]]],
    tiou_thresholds: Sequence[float] = (0.1, 0.2, 0.3, 0.4, 0.5),
    num_classes: Optional[int] = None,
) -> Dict[str, float]:
    """Interpolated-AP detection evaluation (EPIC protocol, reference
    eval_epic_detection.py:17-255).

    ground_truth: video -> [(t_start, t_end, label)]
    predictions: video -> [(t_start, t_end, score, label)]
    Returns mAP per tIoU plus the average.
    """
    labels = set()
    for v in ground_truth.values():
        labels.update(g[2] for g in v)
    if num_classes is not None:
        # evaluate every class id in range, whether or not it appears in
        # the ground truth (absent classes contribute AP 0 like the
        # reference's fixed class list)
        labels = set(range(num_classes))
    labels = sorted(labels)

    aps = np.zeros((len(tiou_thresholds), len(labels)))
    for li, label in enumerate(labels):
        gt_by_video = {v: np.asarray([[g[0], g[1]] for g in gs if g[2] == label]) for v, gs in ground_truth.items()}
        npos = sum(len(g) for g in gt_by_video.values())
        if npos == 0:
            aps[:, li] = np.nan
            continue
        preds = []
        for v, ps in predictions.items():
            for p in ps:
                if p[3] == label:
                    preds.append((v, p[0], p[1], p[2]))
        if not preds:
            continue
        preds.sort(key=lambda x: -x[3])
        tp = np.zeros((len(tiou_thresholds), len(preds)))
        fp = np.zeros((len(tiou_thresholds), len(preds)))
        taken = {v: np.zeros((len(tiou_thresholds), len(g))) for v, g in gt_by_video.items()}
        for pi, (v, ts, te, _) in enumerate(preds):
            gts = gt_by_video.get(v, np.zeros((0, 2)))
            if len(gts) == 0:
                fp[:, pi] = 1
                continue
            ious = segment_iou(np.asarray([ts, te]), gts)
            order = np.argsort(-ious)
            for ti, thr in enumerate(tiou_thresholds):
                matched = False
                for gi in order:
                    if ious[gi] < thr:
                        break
                    if not taken[v][ti, gi]:
                        taken[v][ti, gi] = 1
                        tp[ti, pi] = 1
                        matched = True
                        break
                if not matched:
                    fp[ti, pi] = 1
        ctp = np.cumsum(tp, axis=1)
        cfp = np.cumsum(fp, axis=1)
        recall = ctp / npos
        precision = ctp / np.maximum(ctp + cfp, 1e-9)
        for ti in range(len(tiou_thresholds)):
            aps[ti, li] = _interpolated_ap(precision[ti], recall[ti])

    result = {}
    with np.errstate(invalid="ignore"):
        per_tiou = np.nanmean(aps, axis=1)
    for thr, v in zip(tiou_thresholds, per_tiou):
        result[f"mAP@{thr}"] = float(0.0 if np.isnan(v) else v)
    result["mAP_avg"] = float(np.nanmean(per_tiou)) if len(per_tiou) else 0.0
    return result


def _interpolated_ap(precision: np.ndarray, recall: np.ndarray) -> float:
    """101-point-free interpolated AP (standard envelope form)."""
    mprec = np.concatenate([[0.0], precision, [0.0]])
    mrec = np.concatenate([[0.0], recall, [1.0]])
    for i in range(len(mprec) - 2, -1, -1):
        mprec[i] = max(mprec[i], mprec[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mprec[idx]))
