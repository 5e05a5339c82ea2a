"""TAL feature dataset (counterpart of clip_fsar_tpu/data/tal_features.py:36-184,
the reference's datasets/base/epickitchen100_feature.py): pre-extracted
sliding-window features and BMN label maps, host numpy, the JAX package's
arithmetic line for line.

Storage: one ``.npy`` feature array [T_total, C] per video under
DATA.DATA_ROOT_DIR, plus an annotation JSON
``{video: {"duration": sec, "annotations": [{"segment": [s, e],
"verb": i, "noun": j}]}}`` at DATA.ANNO_DIR/<split>_annotations.json.
A synthetic mode (DATA.DECODER == "synthetic") makes deterministic
features and annotations for tests and the card's smoke run.

Label maps per window (BMN supervision):
  * start_map/end_map [T]: per-anchor max IoA against 3/T-wide boxes
    around the ground-truth boundaries;
  * iou_map [D, T]: max temporal IoU of each (duration, start) anchor
    with the GT segments;
  * mask [D, T]: valid anchors (start+duration < T);
  * label_map [2, D, T]: verb/noun id of the best-matching GT.

DATA.DURATION_SCALE <= 0 reads as DATA.TEMPORAL_SCALE (``duration_scale``).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Tuple

import numpy as np

from clip_fsar_torch.utils.logging import get_logger
from clip_fsar_torch.utils.registry import DATASET_REGISTRY

logger = get_logger(__name__)


def _bmn_geometry(tscale: int, dscale: int):
    """Exact reference anchor geometry (_init_temporal_tools,
    epickitchen100_feature.py:106-130): proposal (d, t) spans
    [t/T, t/T + (d+1)/T] (unclamped; valid when end <= 1); boundary
    anchors have width 2/T centered at cell edges."""
    gap = 1.0 / tscale
    t_idx = np.arange(tscale, dtype=np.float64)
    d_idx = np.arange(1, dscale + 1, dtype=np.float64)
    pmin = np.tile(t_idx * gap, (dscale, 1))  # [D, T]
    pmax = pmin + d_idx[:, None] * gap
    anchor_xmin = (np.arange(tscale) - 0.5) * gap
    anchor_xmax = (np.arange(1, tscale + 1) + 0.5) * gap
    mask = (pmax <= 1.0).astype(np.float32)
    return pmin, pmax, anchor_xmin, anchor_xmax, mask


def duration_scale(cfg) -> int:
    """DATA.DURATION_SCALE, where a value <= 0 (the shipped preset's -1) means
    DATA.TEMPORAL_SCALE: the JAX package reads -1 as a duration scale of -1
    and cannot build its mask (ROADMAP, deliberate divergences)."""
    d = int(cfg.DATA.get("DURATION_SCALE", 0) or 0)
    return d if d > 0 else int(cfg.DATA.TEMPORAL_SCALE)


def _ioa(amin, amax, bmin, bmax):
    inter = np.maximum(np.minimum(amax, bmax) - np.maximum(amin, bmin), 0.0)
    return inter / np.maximum(amax - amin, 1e-9)


def window_label_maps(tscale: int, dscale: int, segments: np.ndarray, labels: np.ndarray) -> Dict[str, np.ndarray]:
    """BMN training labels for one window — exact reference arithmetic
    (_get_bmn_train_label, epickitchen100_feature.py:460-558):

      * segments [N, 2] window-normalized and clamped to [0, 1];
      * iou_map: per-cell max IoU against all ground truths;
      * label_map [2, D, T]: verb/noun of the per-cell argmax ground truth;
      * start/end maps: per-anchor max IoA against 3/T-wide boundary boxes.
    """
    pmin, pmax, anchor_xmin, anchor_xmax, mask = _bmn_geometry(tscale, dscale)
    segments = np.clip(np.asarray(segments, np.float64).reshape(-1, 2), 0.0, 1.0)
    labels = np.asarray(labels).reshape(-1, 2)

    if segments.shape[0] == 0:
        return {
            "start_map": np.zeros(tscale, np.float32),
            "end_map": np.zeros(tscale, np.float32),
            "iou_map": np.zeros((dscale, tscale), np.float32),
            "mask": mask,
            "label_map": np.zeros((2, dscale, tscale), np.int32),
        }

    ious = []
    for s, e in segments:
        inter = np.maximum(np.minimum(pmax, e) - np.maximum(pmin, s), 0.0)
        union = (pmax - pmin) + (e - s) - inter
        ious.append(inter / np.maximum(union, 1e-9))
    ious = np.stack(ious)  # [N, D, T]
    best = np.argmax(ious, axis=0)  # [D, T]
    iou_map = np.max(ious, axis=0).astype(np.float32)
    label_map = labels[best.reshape(-1)].T.reshape(2, dscale, tscale).astype(np.int32)

    small = 3.0 / tscale
    starts = np.stack([segments[:, 0] - small / 2, segments[:, 0] + small / 2], axis=1)
    ends = np.stack([segments[:, 1] - small / 2, segments[:, 1] + small / 2], axis=1)
    start_map = np.array(
        [np.max(_ioa(anchor_xmin[j], anchor_xmax[j], starts[:, 0], starts[:, 1])) for j in range(tscale)],
        np.float32,
    )
    end_map = np.array(
        [np.max(_ioa(anchor_xmin[j], anchor_xmax[j], ends[:, 0], ends[:, 1])) for j in range(tscale)],
        np.float32,
    )
    return {"start_map": start_map, "end_map": end_map, "iou_map": iou_map, "mask": mask, "label_map": label_map}


@DATASET_REGISTRY.register(name="Talfeature")
class TalFeatureDataset:
    def __init__(self, cfg, split: str):
        self.cfg = cfg
        self.split = split
        self.tscale = int(cfg.DATA.TEMPORAL_SCALE)
        self.dscale = duration_scale(cfg)
        self.feat_dim = int(cfg.DATA.NUM_INPUT_CHANNELS)
        self.stride = int(cfg.DATA.get("WINDOW_STRIDE", 0) or 0) or self.tscale // 2
        self.synthetic = cfg.DATA.get("DECODER", "auto") == "synthetic"
        self._load_annotations()
        self._build_windows()

    # -- annotations ---------------------------------------------------------
    def _load_annotations(self) -> None:
        if self.synthetic:
            self.annotations = self._synthetic_annotations()
            return
        path = os.path.join(self.cfg.DATA.ANNO_DIR, f"{self.split}_annotations.json")
        with open(path) as f:
            self.annotations = json.load(f)

    def _synthetic_annotations(self, num_videos: int = 8) -> Dict:
        out = {}
        for i in range(num_videos):
            name = f"{self.split}_vid{i:03d}"
            seed = int.from_bytes(hashlib.md5(name.encode()).digest()[:4], "little")
            rng = np.random.RandomState(seed)
            frames = int(self.tscale * rng.uniform(1.0, 2.5))
            n_seg = rng.randint(1, 4)
            annos = []
            for _ in range(n_seg):
                s = rng.uniform(0, 0.8) * frames
                e = min(s + rng.uniform(0.05, 0.3) * frames, frames)
                annos.append({"segment": [float(s), float(e)], "verb": int(rng.randint(3)), "noun": int(rng.randint(4))})
            out[name] = {"duration": float(frames), "annotations": annos}
        return out

    def features_for(self, video: str) -> np.ndarray:
        frames = int(self.annotations[video]["duration"])
        if self.synthetic:
            seed = int.from_bytes(hashlib.md5(video.encode()).digest()[:4], "little")
            rng = np.random.RandomState(seed)
            feats = rng.randn(frames, self.feat_dim).astype(np.float32) * 0.1
            for a in self.annotations[video]["annotations"]:
                s, e = int(a["segment"][0]), int(a["segment"][1])
                feats[s:e, : self.feat_dim // 2] += 1.0  # plant signal inside segments
            return feats
        return np.load(os.path.join(self.cfg.DATA.DATA_ROOT_DIR, video + ".npy")).astype(np.float32)

    # -- windows -------------------------------------------------------------
    def _build_windows(self) -> None:
        self.windows: List[Tuple[str, int]] = []
        for video, info in sorted(self.annotations.items()):
            frames = int(info["duration"])
            start = 0
            while True:
                self.windows.append((video, start))
                if start + self.tscale >= frames:
                    break
                start += self.stride
        logger.info("Talfeature[%s]: %d videos, %d windows", self.split, len(self.annotations), len(self.windows))

    def __len__(self) -> int:
        return len(self.windows)

    def get_item(self, index: int):
        video, w_start = self.windows[index]
        feats = self.features_for(video)
        frames = feats.shape[0]
        window = np.zeros((self.tscale, self.feat_dim), np.float32)
        chunk = feats[w_start : w_start + self.tscale]
        window[: len(chunk)] = chunk

        segs, labs = [], []
        for a in self.annotations[video]["annotations"]:
            s = (a["segment"][0] - w_start) / self.tscale
            e = (a["segment"][1] - w_start) / self.tscale
            segs.append([s, e])
            labs.append([a.get("verb", 0), a.get("noun", 0)])
        maps = window_label_maps(self.tscale, self.dscale, np.asarray(segs, np.float32).reshape(-1, 2), np.asarray(labs, np.int32).reshape(-1, 2))
        return window, maps, (video, w_start)
