"""Card-resident frame banks (counterpart of clip_fsar_tpu/data/frame_bank.py).

The 10,000-episode test protocol (reference runs/test_net_few_shot.py:57,
NUM_TEST_TASKS) redraws episodes from the same small split thousands of
times.  The pixel path decodes, resizes and copies every clip of every
episode; with ``TPU.EVAL_FRAME_BANK`` the split's frames are decoded and
transformed once, onto a uniform grid of F frames per video, into one uint8
tensor on the card, ``[V*F, crop, crop, 3]`` (HMDB51's test split, 1292
videos at F = 64 and 224 px: 12.45 GB).  The host then samples episodes
exactly as the pixel path does (the same RNG draws) but ships int32 bank
rows [T] per clip instead of pixels, and the eval step gathers them on the
card (``gather_eval_clips``).

``TPU.TRAIN_FRAME_BANK`` does the same for training.  The episodic train
transform stretches every clip to the fixed TRAIN_JITTER_SCALES size and
then takes a random crop and flip (reference transformations.py:676-731),
so the train bank stores the full stretch ([V*F, nh, nw, 3]; HMDB51's train
split at F = 8 and 256 px: 6.73 GB) and the host ships [T] rows plus the
clip's (y, x, flip), drawn at the same positions of the same RNG stream as
the pixel path draws them.  The train step crops and flips on the card
(``assemble_train_clips``), one chunk of episodes at a time.

Numerics: with ``DATA.DECODER cached_opencv`` and the bank grid equal to
the decoder's cache grid (``FRAME_CACHE_FRAMES``), the pixel path already
snaps sampled frame indices to that grid, the test transform draws nothing,
and cropping the stored stretch at (y, x) equals the host's fused resize +
crop bit for bit (transforms.fewshot_train_stretch); the bank's episodes,
logits, metrics and losses are then those of the pixel path, bit for bit
(tests/test_torch_frame_bank.py).  Any other decoder, or another grid,
quantizes frame indices that the pixel path would not: the build warns.

The bank is allocated on the run's device at once, so a bank that does not
fit fails there with torch's out-of-memory error; the build warns first when
the bank alone is more than half of the card.  The host fills it in slices
of videos, so it never holds the whole bank.  Gathers and crops are torch
indexing: the JAX package's bank has no Pallas kernel either
(frame_bank.py:285-291, 376-389).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from clip_fsar_torch.data.datasets import DATASET_REGISTRY
from clip_fsar_torch.data.decode import CachedVideoDecoder
from clip_fsar_torch.data.episodes import EpisodeSampler
from clip_fsar_torch.data.sampling import sample_indices_for_cfg
from clip_fsar_torch.data.transforms import _stretch_dims, fewshot_test_transform, fewshot_train_stretch
from clip_fsar_torch.utils.logging import get_logger

logger = get_logger(__name__)

SLICE_VIDEOS = 32  # videos decoded, transformed and copied to the device together


@dataclasses.dataclass
class FrameBankTable:
    """Host-side metadata mapping split videos to bank rows."""

    orig_idx: np.ndarray  # [V, F] int64 source frame index of each bank row (padded rows repeat the last valid value)
    nframes: np.ndarray  # [V] int32 valid rows per video
    length: np.ndarray  # [V] int64 original video length (frame sampling uses the true length, as the pixel path does)
    fps: np.ndarray  # [V] float64
    row_of_path: Dict[str, int]
    frames_per_video: int


@dataclasses.dataclass
class FrameBank:
    """A bank on its device: ``pixels`` uint8 [V*F, H, W, 3], the host table,
    and the seconds the build spent decoding and transforming on the host and
    copying to the device."""

    pixels: torch.Tensor
    table: FrameBankTable
    build_seconds: float
    upload_seconds: float

    @property
    def nbytes(self) -> int:
        return self.pixels.numel() * self.pixels.element_size()


def _bank_frames(cfg, key: str) -> int:
    """TPU.<key> frames per video; 0 or absent means DATA.FRAME_CACHE_FRAMES."""
    tpu = cfg.TPU if "TPU" in cfg else {}
    return int(tpu.get(key, 0) or cfg.DATA.get("FRAME_CACHE_FRAMES", 64))


def build_eval_frame_bank(cfg, split: str, device) -> FrameBank:
    """Decode and test-transform every video of ``split`` onto the bank grid
    (TPU.EVAL_FRAME_BANK_FRAMES per video) into a [V*F, crop, crop, 3] uint8
    tensor on ``device``."""
    crop = int(cfg.DATA.TEST_CROP_SIZE)
    return _build_bank(cfg, split, _bank_frames(cfg, "EVAL_FRAME_BANK_FRAMES"), (crop, crop),
                       lambda frames: fewshot_test_transform(frames, cfg), "EVAL_FRAME_BANK", device)


def build_train_frame_bank(cfg, device, split: str = "train") -> FrameBank:
    """Decode and stretch every video of the train split to TRAIN_JITTER_SCALES
    (no crop, no flip: those are drawn per clip and applied on the device),
    TPU.TRAIN_FRAME_BANK_FRAMES per video, into [V*F, nh, nw, 3] on ``device``."""
    return _build_bank(cfg, split, _bank_frames(cfg, "TRAIN_FRAME_BANK_FRAMES"), _stretch_dims(cfg.DATA.TRAIN_JITTER_SCALES),
                       lambda frames: fewshot_train_stretch(frames, cfg), "TRAIN_FRAME_BANK", device)


def _split_paths(dataset) -> list:
    """The split's distinct video paths, class by class, in the order the bank stores them."""
    fs_split, paths, seen = dataset.fs_split, [], set()
    for class_id in fs_split.unique_classes():
        for idx in range(fs_split.num_videos_for_class(int(class_id))):
            path = dataset.path_map(fs_split.get(int(class_id), idx)[0])
            if path not in seen:
                seen.add(path)
                paths.append(path)
    return paths


def _build_bank(cfg, split: str, bank_frames: int, out_hw, transform: Callable, label: str, device) -> FrameBank:
    if bool(cfg.DATA.get("EXACT_SAMPLING", False)):
        # the contract of decode.py::build_decoder: a protocol-exact accuracy run never reads grid-snapped frames
        raise ValueError(
            f"TPU.{label}=true with DATA.EXACT_SAMPLING=true: the bank snaps sampled frame indices to its uniform grid, "
            "which the reference protocol's decode path never does (reference datasets/base/base_dataset.py:493-530). "
            "Disable the bank for accuracy runs, or drop EXACT_SAMPLING for throughput runs."
        )
    name = cfg.TRAIN.DATASET if split == "train" else cfg.TEST.get("DATASET", cfg.TRAIN.DATASET)
    dataset = DATASET_REGISTRY.get(name)(cfg, split)
    decoder = dataset.decoder
    if not isinstance(decoder, CachedVideoDecoder):
        logger.warning(
            "%s with DATA.DECODER=%s: the bank snaps sampled frame indices to a %d-frame uniform grid that this decoder's "
            "pixel path does NOT use, so metrics are not bit-identical to the pixel path. Use DATA.DECODER cached_opencv "
            "with FRAME_CACHE_FRAMES == bank frames for the identical configuration.",
            label, cfg.DATA.get("DECODER", "?"), bank_frames,
        )
    elif bank_frames != decoder.max_frames:
        logger.warning(
            "%s grid (%d frames) != decoder cache grid (%d frames): bank-mode results will differ from the pixel path's. "
            "Set the bank frames == DATA.FRAME_CACHE_FRAMES for bit-identity.", label, bank_frames, decoder.max_frames,
        )

    paths = _split_paths(dataset)
    v, (out_h, out_w) = len(paths), (int(out_hw[0]), int(out_hw[1]))
    device = torch.device(device)
    nbytes = v * bank_frames * out_h * out_w * 3
    if device.type == "cuda":
        total = torch.cuda.mem_get_info(device)[1]
        if nbytes > 0.5 * total:
            logger.warning(
                "frame bank is %.2f GB, more than half of the card's memory (%.2f GB); the train and eval steps need "
                "several GB of working memory beside it. If the run runs out of memory, reduce "
                "TPU.TRAIN_FRAME_BANK_FRAMES / TPU.EVAL_FRAME_BANK_FRAMES.", nbytes / 1e9, total / 1e9,
            )
    # allocated whole: a bank that does not fit fails here, before the build's host work
    bank = torch.empty((v * bank_frames, out_h, out_w, 3), dtype=torch.uint8, device=device)
    orig_idx = np.zeros((v, bank_frames), np.int64)
    nframes = np.zeros(v, np.int32)
    length = np.zeros(v, np.int64)
    fps = np.zeros(v, np.float64)

    def load(path: str):
        n = int(decoder.length(path))
        f = float(decoder.fps(path)) if hasattr(decoder, "fps") else float(cfg.DATA.get("FPS", 30))
        keep = np.unique(np.linspace(0, n - 1, min(bank_frames, max(n, 1))).round().astype(np.int64))
        return transform(decoder.read(path, keep)), keep, n, f

    build_seconds = upload_seconds = 0.0
    workers = max(int(cfg.DATA_LOADER.get("NUM_WORKERS", 4)), 1)
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        for lo in range(0, v, SLICE_VIDEOS):
            t0 = time.perf_counter()
            loaded = list(pool.map(load, paths[lo : lo + SLICE_VIDEOS]))
            host = np.empty((len(loaded) * bank_frames, out_h, out_w, 3), np.uint8)
            for j, (frames, keep, n, f) in enumerate(loaded):
                row, k = lo + j, len(keep)
                host[j * bank_frames : j * bank_frames + k] = frames
                host[j * bank_frames + k : (j + 1) * bank_frames] = frames[-1]  # a short video repeats its last grid frame
                orig_idx[row, :k], orig_idx[row, k:] = keep, keep[-1]
                nframes[row], length[row], fps[row] = k, n, f
            t1 = time.perf_counter()
            bank[lo * bank_frames : lo * bank_frames + len(host)].copy_(torch.from_numpy(host))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            build_seconds += t1 - t0
            upload_seconds += time.perf_counter() - t1
            if (lo // SLICE_VIDEOS + 1) % 8 == 0:
                logger.info("frame bank: %d/%d videos", min(lo + SLICE_VIDEOS, v), v)

    logger.info("frame bank built (%s): %d videos x %d grid frames x %dx%dpx = %.2f GB uint8 in %.1f s of host work",
                label, v, bank_frames, out_h, out_w, nbytes / 1e9, build_seconds)
    logger.info("frame bank on %s: %.2f GB in %.1f s", device, nbytes / 1e9, upload_seconds)
    table = FrameBankTable(orig_idx=orig_idx, nframes=nframes, length=length, fps=fps,
                           row_of_path={p: i for i, p in enumerate(paths)}, frames_per_video=bank_frames)
    return FrameBank(pixels=bank, table=table, build_seconds=build_seconds, upload_seconds=upload_seconds)


def _snap_rows(table: FrameBankTable, row: int, indices) -> np.ndarray:
    """Snap requested source-frame indices to the video's bank grid rows (the
    nearest-grid arithmetic of decode.py::CachedVideoDecoder.read), returning
    global int32 bank row ids."""
    orig = table.orig_idx[row, : table.nframes[row]]
    req = np.asarray(indices, np.int64)
    pos = np.clip(np.searchsorted(orig, req), 0, len(orig) - 1)
    left = np.clip(pos - 1, 0, len(orig) - 1)
    take = np.where(np.abs(orig[left] - req) <= np.abs(orig[pos] - req), left, pos)
    return (row * table.frames_per_video + take).astype(np.int32)


class IndexEpisodeSampler(EpisodeSampler):
    """EpisodeSampler that emits bank rows instead of pixels: int32 [T] global
    rows per clip.  It draws from the RNG exactly as the pixel sampler does
    (one ``sample_indices_for_cfg`` draw per clip; the test transform draws
    nothing), so (seed, step, slot) selects the same classes, videos and
    frames."""

    def __init__(self, base: EpisodeSampler, table: FrameBankTable):
        self.__dict__.update(base.__dict__)
        self._table = table

    def _load_clip(self, class_id: int, idx: int, is_query: bool = False) -> np.ndarray:
        t = self._table
        row = t.row_of_path[self.path_map(self.split.get(class_id, idx)[0])]
        indices = sample_indices_for_cfg(self.cfg, self.mode, int(t.length[row]), float(t.fps[row]), self.rng)
        return _snap_rows(t, row, indices)


class TrainIndexEpisodeSampler(EpisodeSampler):
    """Train-mode bank sampler: int32 [T + 3] per clip, T global bank rows and
    then (crop_y, crop_x, flip).  Per clip it draws what the pixel sampler
    draws, in its order and with its gating (``sample_indices_for_cfg``, then
    transforms.fewshot_train_transform's flip, skipped for support clips
    unless AUGMENTATION.RANDOM_FLIP, then y, then x), so (seed, step, slot)
    selects the same classes, videos, frames and crops."""

    def __init__(self, base: EpisodeSampler, table: FrameBankTable):
        self.__dict__.update(base.__dict__)
        self._table = table
        self._nh, self._nw = _stretch_dims(self.cfg.DATA.TRAIN_JITTER_SCALES)
        self._size = int(self.cfg.DATA.TRAIN_CROP_SIZE)
        aug = self.cfg.AUGMENTATION if "AUGMENTATION" in self.cfg else {}
        self._support_flip = bool(aug.get("RANDOM_FLIP", False))

    def _load_clip(self, class_id: int, idx: int, is_query: bool = False) -> np.ndarray:
        t = self._table
        row = t.row_of_path[self.path_map(self.split.get(class_id, idx)[0])]
        indices = sample_indices_for_cfg(self.cfg, self.mode, int(t.length[row]), float(t.fps[row]), self.rng)
        rows = _snap_rows(t, row, indices)
        if is_query:
            flip = bool(self.rng.random() < 0.5)
        else:
            flip = self._support_flip and bool(self.rng.random() < 0.5)
        y = int(self.rng.integers(0, max(self._nh - self._size, 1)))
        x = int(self.rng.integers(0, max(self._nw - self._size, 1)))
        return np.concatenate([rows, np.asarray([y, x, int(flip)], np.int32)])


def gather_eval_clips(bank: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Bank rows [..., T] (int32) -> uint8 clips [..., T, H, W, 3]: one
    ``index_select`` on the flattened rows."""
    return bank.index_select(0, rows.reshape(-1)).reshape(rows.shape + bank.shape[1:])


def assemble_train_clips(bank: torch.Tensor, idx: torch.Tensor, num_frames: int, crop: int) -> torch.Tensor:
    """Train clips from the stretched bank (JAX make_bank_train_assemble,
    frame_bank.py:366-391): idx [..., T + 3] int32 (rows | crop_y | crop_x |
    flip) -> uint8 [..., T, crop, crop, 3], each clip's frames cropped at its
    (y, x) and mirrored where its flip is set.  One batched gather reads only
    the cropped pixels: a flipped clip reads its columns right to left.
    Offsets are clamped to the frame as ``dynamic_slice`` clamps them."""
    lead = idx.shape[:-1]
    flat = idx.reshape(-1, idx.shape[-1]).long()
    rows = flat[:, :num_frames]  # [C, T]
    nh, nw = bank.shape[1], bank.shape[2]
    y = flat[:, num_frames].clamp(0, nh - crop)
    x = flat[:, num_frames + 1].clamp(0, nw - crop)
    step = torch.arange(crop, device=idx.device)
    cols = torch.where(flat[:, num_frames + 2, None] != 0, x[:, None] + (crop - 1) - step, x[:, None] + step)  # [C, crop]
    out = bank[rows[:, :, None, None], (y[:, None] + step)[:, None, :, None], cols[:, None, None, :]]  # [C, T, crop, crop, 3]
    return out.reshape(lead + out.shape[1:])
