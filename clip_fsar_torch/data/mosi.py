"""MoSI pseudo-motion generator (counterpart of clip_fsar_tpu/data/mosi.py:20-111,
the reference's sslgenerators/mosi/mosi_generator.py: "Self-supervised
Motion Learning from Static Images").

Host numpy, the JAX package's draws in its order: from one decoded frame,
one pseudo-motion clip per speed of the speed set, a crop window sliding
along a line whose direction and length encode the (speed_x, speed_y)
class; an optional static mask pastes a frozen region over the moving
clip.  From the same ``np.random.Generator`` it gives the JAX package's
clips and labels byte for byte.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from clip_fsar_torch.utils.registry import SSL_GENERATOR_REGISTRY


def build_speed_set(num_speeds: int, decouple: bool, data_mode: str, zero_out: bool) -> List[Tuple[int, int]]:
    """(reference mosi_generator.py:65-130)"""
    speed_range = [int(v) for v in (np.linspace(0, num_speeds - 1, num_speeds) - num_speeds // 2)]
    all_speeds, zero_included = [], False
    for x in speed_range:
        for y in speed_range:
            if x == 0 and y == 0:
                if zero_included:
                    continue
                zero_included = True
            if decouple and x * y != 0:
                continue
            all_speeds.append((x, y))
    speed_set: List[Tuple[int, int]] = []
    if decouple:
        if "x" in data_mode:
            speed_set += [s for s in all_speeds if s[0] != 0]
        if "y" in data_mode:
            speed_set += [s for s in all_speeds if s[1] != 0]
        if not zero_out:
            speed_set.append((0, 0))
    else:
        if "x" in data_mode and "y" in data_mode:
            speed_set = all_speeds
        else:
            raise NotImplementedError(f"data mode {data_mode!r} unsupported without DECOUPLE")
    return speed_set


@SSL_GENERATOR_REGISTRY.register(name="MoSIGenerator")
class MoSIGenerator:
    def __init__(self, cfg, split: str):
        self.cfg = cfg
        self.split = split
        crop = cfg.DATA.TRAIN_CROP_SIZE
        self.crop_size = int(crop[0] if isinstance(crop, (list, tuple)) else crop)
        self.num_speeds = int(cfg.VIDEO.HEAD.NUM_CLASSES)
        self.num_frames = int(cfg.PRETRAIN.NUM_FRAMES)
        self.distance_jitter = tuple(cfg.PRETRAIN.get("DISTANCE_JITTER", [1.0, 1.0]))
        self.label_mode = cfg.PRETRAIN.get("LABEL_MODE", "joint")
        self.zero_out = bool(cfg.PRETRAIN.get("ZERO_OUT", False))
        self.static_mask_enable = bool(cfg.PRETRAIN.get("STATIC_MASK", False))
        self.mask_size_ratio = tuple(cfg.PRETRAIN.get("MASK_SIZE_RATIO", [0.3, 0.5]))
        self.speed_set = build_speed_set(
            self.num_speeds, bool(cfg.PRETRAIN.get("DECOUPLE", True)), str(cfg.PRETRAIN.get("DATA_MODE", "xy")), self.zero_out
        )
        self.labels = self._labels()

    def _labels(self) -> Dict[str, np.ndarray]:
        if self.label_mode == "separate":
            speed_min = -(self.num_speeds // 2)
            lx = [s[0] - speed_min - int(s[0] > 0) * int(self.zero_out) for s in self.speed_set]
            ly = [s[1] - speed_min - int(s[1] > 0) * int(self.zero_out) for s in self.speed_set]
            return {"move_x": np.asarray(lx, np.int32), "move_y": np.asarray(ly, np.int32)}
        return {"move_joint": np.arange(len(self.speed_set), dtype=np.int32)}

    def _crop_params(self, speed_factor: float, total: int, rng: np.random.Generator) -> Tuple[int, float]:
        if abs(speed_factor) < 1 and speed_factor != 0:
            dj = rng.uniform(*self.distance_jitter) if self.split == "train" else 1.0
        else:
            dj = rng.uniform(self.distance_jitter[0], 1.0) if self.split == "train" else 1.0
        distance = (total - self.crop_size) * speed_factor * dj
        start_min = max(0, -distance)
        start_max = min(total - self.crop_size, (total - self.crop_size) - distance)
        if self.split == "train":
            start = int(rng.integers(int(start_min), int(start_max) + 1))
        else:
            start = int((total - self.crop_size - distance) // 2)
        return start, start + distance

    def __call__(self, frames: np.ndarray, rng: np.random.Generator) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """frames: decoded video uint8 [T, H, W, 3] -> clips uint8
        [num_speeds_set, num_frames, crop, crop, 3] + labels."""
        t_total, h, w, c = frames.shape
        frame = frames[int(rng.integers(0, t_total))]
        out = np.empty((len(self.speed_set), self.num_frames, self.crop_size, self.crop_size, c), frames.dtype)
        half = self.num_speeds // 2
        for i, (sx, sy) in enumerate(self.speed_set):
            x0, x1 = self._crop_params(sx / half, w, rng)
            y0, y1 = self._crop_params(sy / half, h, rng)
            xs = np.clip(np.linspace(x0, x1, self.num_frames).astype(np.int64), 0, w - self.crop_size)
            ys = np.clip(np.linspace(y0, y1, self.num_frames).astype(np.int64), 0, h - self.crop_size)
            for t in range(self.num_frames):
                out[i, t] = frame[ys[t] : ys[t] + self.crop_size, xs[t] : xs[t] + self.crop_size]
            if self.static_mask_enable:
                mh = int(self.crop_size * rng.uniform(*self.mask_size_ratio))
                mw = int(self.crop_size * rng.uniform(*self.mask_size_ratio))
                my = int(rng.integers(0, self.crop_size - mh + 1))
                mx = int(rng.integers(0, self.crop_size - mw + 1))
                patch = out[i, 0, my : my + mh, mx : mx + mw].copy()
                out[i, :, my : my + mh, mx : mx + mw] = patch[None]
        return out, self.labels
