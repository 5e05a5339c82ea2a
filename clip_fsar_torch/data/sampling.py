"""Frame-index samplers (host side, numpy RNG; copy of clip_fsar_tpu/data/sampling.py:18-110).

Behavioral parity with the reference samplers
(datasets/base/base_dataset.py:493-595):

  * ``uniform_segment_indices`` — the SAMPLING_RATE>40 path the CLIP-FSAR
    configs actually use (:500-509): split the video into ``num_frames``
    equal segments, draw one random frame per segment;
  * ``interval_indices`` — FPS-normalized sliding window (:493-530);
  * ``segment_indices`` — TSN-style segment sampling (:571-595).
"""

from __future__ import annotations

import numpy as np


def uniform_segment_indices(vid_length: int, num_frames: int, rng: np.random.Generator) -> np.ndarray:
    if vid_length <= 0:
        raise ValueError("empty video")
    if vid_length < num_frames:
        # short video: repeat-pad by clamping the linspace
        return np.minimum(np.arange(num_frames), vid_length - 1)
    interval = vid_length // num_frames
    starts = np.arange(num_frames) * interval
    offsets = rng.integers(0, interval, size=num_frames)
    return starts + offsets


def interval_indices(
    vid_length: int,
    vid_fps: float,
    clip_idx: int,
    num_clips: int,
    num_frames: int,
    interval: int,
    target_fps: float = 30.0,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """clip_idx == -1 -> random temporal window (train); otherwise the
    clip_idx-th of num_clips evenly spaced windows (multi-view test).
    The window ends ``interval`` before its nominal end — exact reference
    arithmetic (base_dataset.py:524-529: end = start + clip_length -
    interval; linspace; clamp; truncate)."""
    if num_frames == 1:
        # the reference draws a uniformly random frame in train AND test
        # alike (base_dataset.py:495: random.randint regardless of split);
        # the center frame is only a fallback when no rng is available
        if rng is None:
            return np.array([vid_length // 2])
        return np.array([int(rng.integers(0, vid_length))])

    clip_length = num_frames * interval * vid_fps / target_fps
    if clip_length > vid_length:
        clip_length = vid_length // num_frames * num_frames

    max_idx = max(vid_length - clip_length + 1, 0)
    if clip_idx == -1:
        start = float(rng.uniform(0, max_idx)) if rng is not None else max_idx / 2
    elif num_clips == 1:
        start = max_idx / 2
    else:
        start = max_idx * clip_idx / num_clips
    end = start + clip_length - interval
    index = np.linspace(start, end, num_frames)
    return np.clip(index, 0, vid_length - 1).astype(np.int64)


def segment_indices(vid_length: int, clip_idx: int, num_clips: int, num_frames: int, rng: np.random.Generator | None = None) -> np.ndarray:
    """TSN segment sampling (exact reference arithmetic,
    base_dataset.py:571-595): segment edges = linspace(0, L, T+1);
    train draws uniform reals per segment, test takes the midpoint
    (num_clips == 1) or edge + width * (clip_idx+1)/num_clips; then
    round-half-to-even + clamp."""
    edges = np.linspace(0.0, float(vid_length), num_frames + 1)
    index = np.zeros(num_frames, dtype=np.float64)
    for i in range(num_frames):
        if clip_idx == -1 and rng is not None:
            index[i] = rng.uniform(edges[i], edges[i + 1])
        elif num_clips == 1:
            index[i] = (edges[i] + edges[i + 1]) / 2.0
        else:
            index[i] = edges[i] + (edges[i + 1] - edges[i]) * (clip_idx + 1) / num_clips
    return np.round(np.clip(index, 0, vid_length - 1)).astype(np.int64)


def sample_indices_for_cfg(cfg, split: str, vid_length: int, vid_fps: float, rng: np.random.Generator, clip_idx: int = -1, num_clips: int = 1) -> np.ndarray:
    """Dispatch matching the reference's decode-time logic: the uniform
    random-per-segment mode triggers when the effective sampling rate
    exceeds 40 (base_dataset.py:500-509)."""
    num_frames = int(cfg.DATA.NUM_INPUT_FRAMES)
    rate_key = "SAMPLING_RATE_TRAIN" if (split == "train" and hasattr(cfg.DATA, "SAMPLING_RATE_TRAIN")) else None
    if rate_key is None and hasattr(cfg.DATA, "SAMPLING_RATE_TEST") and cfg.DATA.SAMPLING_RATE_TEST > 40:
        return uniform_segment_indices(vid_length, num_frames, rng)
    if rate_key is None and cfg.DATA.SAMPLING_RATE > 40:
        return uniform_segment_indices(vid_length, num_frames, rng)
    interval = int(cfg.DATA.get(rate_key) if rate_key else cfg.DATA.SAMPLING_RATE)
    return interval_indices(
        vid_length,
        vid_fps,
        clip_idx,
        num_clips,
        num_frames,
        interval,
        target_fps=float(cfg.DATA.get("TARGET_FPS", 30)),
        # rng gates TRAIN randomness inside interval_indices; the single-
        # frame branch is random in every split (reference :495), so pass
        # it through there too
        rng=rng if (split == "train" or num_frames == 1) else None,
    )
