"""Episodic sampler + prefetching loader (counterpart of
clip_fsar_tpu/data/episodes.py:30-271).

Same protocol and the same numpy RNG streams as the JAX sampler in both
modes: episode ``slot`` of step k is drawn from
``default_rng((seed, k, slot))``, so both packages produce byte-identical
episodes for one seed.  Train mode takes SHOT and QUERY_PER_CLASS clips per
class through the train transform (random crop, flip); test mode takes
SHOT_TEST and QUERY_PER_CLASS_TEST through the center crop.  A thread pool
keeps [E, ...] uint8 batches ready in step order.
"""

from __future__ import annotations

import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from clip_fsar_torch.data.sampling import sample_indices_for_cfg
from clip_fsar_torch.data.splits import FewShotSplit
from clip_fsar_torch.data.transforms import fewshot_test_transform, fewshot_train_transform
from clip_fsar_torch.data.types import Episode, stack_episodes
from clip_fsar_torch.utils import tracing
from clip_fsar_torch.utils.logging import get_logger

logger = get_logger(__name__)


class EpisodeSampler:
    """Samples N-way K-shot episodes from a split (``mode`` "train" or "test")."""

    def __init__(self, cfg, split: FewShotSplit, decoder, mode: str = "test", seed: int = 0, path_map=None):
        self.cfg = cfg
        self.split = split
        self.decoder = decoder
        self.mode = mode
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.path_map = path_map or (lambda p: p)

        t = cfg.TRAIN
        # the reference always episodes TRAIN.WAY classes at test too
        self.way = int(t.WAY)
        if mode == "train":
            self.shot = int(t.SHOT)
            self.queries = int(t.QUERY_PER_CLASS)
        else:
            self.shot = int(t.get("SHOT_TEST", t.SHOT))
            self.queries = int(t.get("QUERY_PER_CLASS_TEST", 1))
        self.classes = np.asarray(split.unique_classes())

    def _load_clip(self, class_id: int, idx: int, is_query: bool) -> np.ndarray:
        """Decode + frame-sample + spatial transform one clip -> uint8 [T, crop, crop, 3].
        Train clips get the reference's support and query stacks (query
        clips always flip, support clips only under AUGMENTATION.RANDOM_FLIP)."""
        path = self.path_map(self.split.get(class_id, idx)[0])
        length = self.decoder.length(path)
        fps = self.decoder.fps(path) if hasattr(self.decoder, "fps") else float(self.cfg.DATA.get("FPS", 30))
        frames = self.decoder.read(path, sample_indices_for_cfg(self.cfg, self.mode, length, fps, self.rng))
        if self.mode == "train":
            return fewshot_train_transform(frames, self.cfg, self.rng, is_query=is_query)
        return fewshot_test_transform(frames, self.cfg)

    def reseed_for_slot(self, step: int, slot: int) -> None:
        """Episode ``slot`` of step k depends only on (seed, k, slot)."""
        self.rng = np.random.default_rng((self.seed, step, slot))

    def sample_episode(self) -> Episode:
        retries = 5
        for attempt in range(retries):
            try:
                return self._sample_episode_once()
            except Exception:  # decode failures resample, as the reference does
                if attempt == retries - 1:
                    raise
                logger.warning("episode assembly failed (attempt %d), resampling", attempt + 1, exc_info=True)

    def _sample_episode_once(self) -> Episode:
        rng = self.rng
        batch_classes = rng.choice(self.classes, size=self.way, replace=False)
        support, target = [], []  # (clip, local label, class id)
        for local_label, class_id in enumerate(batch_classes):
            class_id = int(class_id)
            n_total = self.split.num_videos_for_class(class_id)
            need = self.shot + self.queries
            # tiny classes: sample with replacement rather than fail
            idxs = rng.choice(n_total, size=need, replace=n_total < need)
            for j, idx in enumerate(idxs):
                clip = self._load_clip(class_id, int(idx), is_query=j >= self.shot)
                (support if j < self.shot else target).append((clip, local_label, class_id))
        perm_s = rng.permutation(len(support))
        perm_t = rng.permutation(len(target))
        sup_imgs, sup_lab, sup_real = zip(*support)
        tgt_imgs, tgt_lab, tgt_real = zip(*target)
        return Episode(
            support_images=np.stack(sup_imgs)[perm_s],
            support_labels=np.asarray(sup_lab, np.int32)[perm_s],
            real_support_labels=np.asarray(sup_real, np.int32)[perm_s],
            target_images=np.stack(tgt_imgs)[perm_t],
            target_labels=np.asarray(tgt_lab, np.int32)[perm_t],
            real_target_labels=np.asarray(tgt_real, np.int32)[perm_t],
            batch_class_list=np.asarray(batch_classes, np.int32),
        )


class EpisodeLoader:
    """Background-threaded, seed-deterministic producer of [E, ...] batches
    in step order.  Workers claim step indices from a shared counter and
    produce out of order; a reorder buffer delivers in order, so the
    stream is the same for any worker count.  Errors in a worker are
    re-raised by the iterator.  Steps are the global indices
    [start_step, start_step + num_steps): a resumed run continues the
    (seed, step) episode stream instead of replaying it.  With
    ``episode_range`` (lo, hi) each batch holds slots [lo, hi) of the step's
    ``episodes_per_step``: the same episodes a loader of the whole batch puts
    at those rows (each slot is seeded by (seed, step, slot)), so the ranks of
    a data-parallel run sample only their own slots; (0, 0) gives [0, ...]
    batches."""

    def __init__(
        self, sampler_factory, episodes_per_step: int, num_steps: int, num_workers: int = 4, prefetch: int = 2, start_step: int = 0,
        episode_range: Optional[Tuple[int, int]] = None,
    ):
        self.episodes_per_step = episodes_per_step
        self.episode_range = (0, episodes_per_step) if episode_range is None else (int(episode_range[0]), int(episode_range[1]))
        self._start_step = int(start_step)
        self._empty: Optional[Episode] = None
        self.num_steps = int(start_step) + int(num_steps)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._samplers = [sampler_factory(i) for i in range(max(num_workers, 1))]
        self._window = max(prefetch, 1) + len(self._samplers)  # reorder-buffer bound
        self._buffer: dict = {}
        self._cond = threading.Condition()
        self._next_claim = int(start_step)
        self._next_emit = int(start_step)
        self._threads = [threading.Thread(target=self._worker, args=(s,), daemon=True) for s in self._samplers]
        for th in self._threads:
            th.start()

    def _empty_batch(self, sampler: EpisodeSampler) -> Episode:
        """A [0, ...] batch with the trailing shapes and dtypes of a step's,
        cut from one episode sampled once (slot 0 of the first step)."""
        if self._empty is None:
            sampler.reseed_for_slot(self._start_step, 0)
            self._empty = stack_episodes([sampler.sample_episode()]).map(lambda x: x[:0])
        return self._empty

    def _claim(self) -> Optional[int]:
        with self._cond:
            while not self._stop.is_set():
                if self._next_claim >= self.num_steps:
                    return None
                if self._next_claim < self._next_emit + self._window:  # backpressure
                    step = self._next_claim
                    self._next_claim += 1
                    return step
                self._cond.wait(timeout=0.2)
            return None

    def _worker(self, sampler: EpisodeSampler) -> None:
        try:
            while (step := self._claim()) is not None:
                eps = []
                for slot in range(*self.episode_range):
                    sampler.reseed_for_slot(step, slot)
                    eps.append(sampler.sample_episode())
                batch = stack_episodes(eps) if eps else self._empty_batch(sampler)
                with self._cond:
                    self._buffer[step] = batch
                    self._cond.notify_all()
        except BaseException as e:  # noqa: BLE001 — re-raised in __iter__
            with self._cond:
                self._error = e
                self._stop.set()
                self._cond.notify_all()

    def __iter__(self) -> Iterator[Episode]:
        while self._next_emit < self.num_steps:
            with tracing.span("fsar.loader.wait", step=self._next_emit), self._cond:
                while self._next_emit not in self._buffer and not self._stop.is_set():
                    self._cond.wait(timeout=0.2)
                if self._error is not None:
                    raise RuntimeError("episode worker failed") from self._error
                if self._next_emit not in self._buffer:
                    return
                batch = self._buffer.pop(self._next_emit)
                self._next_emit += 1
                self._cond.notify_all()
            yield batch

    def close(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        for th in self._threads:
            th.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
