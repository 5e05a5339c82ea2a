"""Training/validation/test meters (counterpart of
clip_fsar_tpu/utils/meters.py, the reference's utils/meters.py).  Numpy on
the host, as there, so the port's meters give the JAX package's numbers.

* ``ScalarMeter`` — sliding-window median/average of a scalar.
* ``TestMeter``  — multi-view ensemble by video id
  (NUM_ENSEMBLE_VIEWS x NUM_SPATIAL_CROPS protocol, meters.py:24-176).
* ``EpicKitchenMeter`` — the same with EPIC's verb and noun heads.
"""

from __future__ import annotations

from collections import deque
from typing import Dict

import numpy as np

from clip_fsar_torch.utils.logging import get_logger, log_json_stats

logger = get_logger(__name__)


class ScalarMeter:
    def __init__(self, window_size: int = 10):
        self._deque = deque(maxlen=window_size)
        self._total = 0.0
        self._count = 0

    def reset(self) -> None:
        self._deque.clear()
        self._total = 0.0
        self._count = 0

    def add_value(self, value: float) -> None:
        self._deque.append(float(value))
        self._total += float(value)
        self._count += 1

    def get_win_median(self) -> float:
        return float(np.median(self._deque)) if self._deque else 0.0

    def get_win_avg(self) -> float:
        return float(np.mean(self._deque)) if self._deque else 0.0

    def get_global_avg(self) -> float:
        return self._total / self._count if self._count else 0.0


class TestMeter:
    """Multi-view test: accumulate per-clip scores into per-video scores.

    Each video contributes ``num_clips`` views; views are summed (or maxed)
    per video id, then top-1/top-5 are computed once all views arrived.
    """

    def __init__(self, num_videos: int, num_clips: int, num_cls: int, ensemble_method: str = "sum"):
        assert ensemble_method in ("sum", "max")
        self.num_clips = num_clips
        self.ensemble_method = ensemble_method
        self.video_preds = np.zeros((num_videos, num_cls), dtype=np.float64)
        self.video_labels = -np.ones((num_videos,), dtype=np.int64)
        self.clip_count = np.zeros((num_videos,), dtype=np.int64)

    def reset(self) -> None:
        self.video_preds[:] = 0.0
        self.video_labels[:] = -1
        self.clip_count[:] = 0

    def update_stats(self, preds: np.ndarray, labels: np.ndarray, clip_ids: np.ndarray) -> None:
        preds = np.asarray(preds)
        labels = np.asarray(labels)
        clip_ids = np.asarray(clip_ids)
        for i in range(preds.shape[0]):
            vid = int(clip_ids[i]) // self.num_clips
            if self.video_labels[vid] >= 0 and self.video_labels[vid] != int(labels[i]):
                raise ValueError(f"Inconsistent labels for video {vid}")
            self.video_labels[vid] = int(labels[i])
            if self.ensemble_method == "sum":
                self.video_preds[vid] += preds[i]
            else:
                self.video_preds[vid] = np.maximum(self.video_preds[vid], preds[i])
            self.clip_count[vid] += 1

    def finalize_metrics(self, ks=(1, 5)) -> Dict[str, float]:
        if not np.all(self.clip_count == self.num_clips):
            missing = int(np.sum(self.clip_count != self.num_clips))
            logger.warning("%d videos have missing clips", missing)
        order = np.argsort(-self.video_preds, axis=1)
        stats: Dict[str, float] = {"_type": "test_final"}
        for k in ks:
            hit = (order[:, :k] == self.video_labels[:, None]).any(axis=1)
            stats[f"top{k}_acc"] = float(hit.mean() * 100.0)
        log_json_stats(stats, logger)
        return stats


class EpicKitchenMeter:
    """Multi-view ensemble for the EPIC verb+noun protocol (reference
    utils/meters.py:178-468): per-video verb scores, noun scores, and the
    verb x noun outer-product "action" scores are each ensembled over the
    clips views, then joint top-k is computed — a joint hit requires both
    the verb and the noun to be in their respective top-k (reference
    metrics.joint_topks_correct:12-96).

    Numpy accumulators on the host; the per-view verb x noun outer
    product is summed (or maxed) into a [C_v, C_n] table per video, exact
    with respect to the reference.
    """

    def __init__(self, num_videos: int, num_clips: int, num_cls, ensemble_method: str = "sum"):
        assert ensemble_method in ("sum", "max")
        self.num_clips = num_clips
        self.ensemble_method = ensemble_method
        cv, cn = int(num_cls[0]), int(num_cls[1])
        self.cv, self.cn = cv, cn
        self.verb_preds = np.zeros((num_videos, cv), dtype=np.float64)
        self.noun_preds = np.zeros((num_videos, cn), dtype=np.float64)
        self.action_preds = np.zeros((num_videos, cv, cn), dtype=np.float64)
        self.verb_labels = -np.ones((num_videos,), dtype=np.int64)
        self.noun_labels = -np.ones((num_videos,), dtype=np.int64)
        self.clip_count = np.zeros((num_videos,), dtype=np.int64)
        self.video_names: Dict[int, str] = {}

    def reset(self) -> None:
        self.verb_preds[:] = 0.0
        self.noun_preds[:] = 0.0
        self.action_preds[:] = 0.0
        self.verb_labels[:] = -1
        self.noun_labels[:] = -1
        self.clip_count[:] = 0

    def update_stats(self, preds_verb, preds_noun, labels_verb, labels_noun, clip_ids, names=()) -> None:
        preds_verb, preds_noun = np.asarray(preds_verb), np.asarray(preds_noun)
        labels_verb, labels_noun = np.asarray(labels_verb), np.asarray(labels_noun)
        clip_ids = np.asarray(clip_ids)
        for i in range(preds_verb.shape[0]):
            vid = int(clip_ids[i]) // self.num_clips
            if self.verb_labels[vid] >= 0:
                assert self.verb_labels[vid] == int(labels_verb[i]) and self.noun_labels[vid] == int(labels_noun[i])
            self.verb_labels[vid] = int(labels_verb[i])
            self.noun_labels[vid] = int(labels_noun[i])
            if len(names) > 0:
                self.video_names[vid] = names[i]
            outer = np.outer(preds_verb[i], preds_noun[i])
            if self.ensemble_method == "sum":
                self.verb_preds[vid] += preds_verb[i]
                self.noun_preds[vid] += preds_noun[i]
                self.action_preds[vid] += outer
            else:
                self.verb_preds[vid] = np.maximum(self.verb_preds[vid], preds_verb[i])
                self.noun_preds[vid] = np.maximum(self.noun_preds[vid], preds_noun[i])
                self.action_preds[vid] = np.maximum(self.action_preds[vid], outer)
            self.clip_count[vid] += 1

    @staticmethod
    def _topk_hit(preds: np.ndarray, labels: np.ndarray, k: int) -> np.ndarray:
        order = np.argsort(-preds, axis=1)[:, :k]
        return (order == labels[:, None]).any(axis=1)

    @staticmethod
    def _maybe_softmax(x: np.ndarray) -> np.ndarray:
        # the reference softmaxes video-level scores before forming the
        # joint product unless they already sum to 1
        # (metrics.joint_topks_correct, utils/metrics.py:54-59)
        if np.isclose(x[0].sum(), 1.0):
            return x
        e = np.exp(x - x.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    def finalize_metrics(self, ks=(1, 5)) -> Dict[str, float]:
        if not np.all(self.clip_count == self.num_clips):
            logger.warning("%d videos have missing clips", int(np.sum(self.clip_count != self.num_clips)))
        stats: Dict[str, float] = {"_type": "test_final"}
        flat_action = self.action_preds.reshape(self.action_preds.shape[0], -1)
        action_labels = self.verb_labels * self.cn + self.noun_labels
        # "joint": product of the softmaxed ENSEMBLED verb/noun scores —
        # ensemble-then-fuse, vs "action" which fuses per view then
        # ensembles (reference joint_topks_correct, utils/metrics.py:12-96)
        joint = (self._maybe_softmax(self.verb_preds)[:, :, None]
                 * self._maybe_softmax(self.noun_preds)[:, None, :]).reshape(len(self.verb_preds), -1)
        for k in ks:
            hv = self._topk_hit(self.verb_preds, self.verb_labels, k)
            hn = self._topk_hit(self.noun_preds, self.noun_labels, k)
            stats[f"top_{k}_acc_verb"] = float(hv.mean() * 100.0)
            stats[f"top_{k}_acc_noun"] = float(hn.mean() * 100.0)
            stats[f"top_{k}_acc_joint"] = float(self._topk_hit(joint, action_labels, k).mean() * 100.0)
            # action: top-k over the ensembled verb x noun outer product
            stats[f"top_{k}_acc_action"] = float(self._topk_hit(flat_action, action_labels, k).mean() * 100.0)
        log_json_stats(stats, logger)
        return stats

    def get_video_preds(self) -> Dict[str, np.ndarray]:
        """Ensembled per-video scores for submission JSON generation."""
        return {
            "verb_class": self.verb_preds,
            "noun_class": self.noun_preds,
            "action_class_ind_pred": self.action_preds.reshape(self.action_preds.shape[0], -1),
        }
