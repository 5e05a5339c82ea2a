"""Classification data service (counterpart of
clip_fsar_tpu/data/classification.py).

Samples are (video uint8 [T, crop, crop, 3], label, clip_id); at test time
each video becomes NUM_ENSEMBLE_VIEWS x NUM_SPATIAL_CROPS clips and the
TestMeter re-assembles per-video scores by clip_id // num_clips.  The seven
registered datasets read "<path> <label>" lines (EPIC: "<path> <verb>
<noun>") or the SSv2 JSON list.

``ClassificationLoader`` is the JAX package's thread-pooled loader: per-worker
numpy generators seeded from (RANDOM_SEED, epoch, worker), worker w building
batches w, w + W, ..., a reorder buffer that yields them in order, the last
partial batch dropped in training and padded at test (copies of its last
clip with clip_id -1), and NUM_FOLDS shuffles per training epoch.  At the
same NUM_WORKERS and seed its batches are the JAX loader's, byte for byte.

Under PRETRAIN.ENABLE the registered SSL generator (PRETRAIN.GENERATOR,
data/mosi.py) takes each decoded clip and its draws come after the
decoder's: a sample is then the generator's clips uint8 [S, F, crop, crop,
3] and its labels, a dict of per-axis targets [S], batched to [b, S].

Under a process group each rank keeps rows ``row_range`` of every global
batch: a worker still draws every row's random numbers in order (the frame
indices and the crop, or the generator's on frames of the decoded shape)
but decodes and transforms only the rank's rows, so the ranks' slices put
together are the one-process batch.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

from clip_fsar_torch.data.decode import SyntheticDecoder, build_decoder
from clip_fsar_torch.data.sampling import sample_indices_for_cfg
from clip_fsar_torch.data.transforms import test_transform, train_crop_params, train_transform
from clip_fsar_torch.utils.logging import get_logger
from clip_fsar_torch.utils.registry import DATASET_REGISTRY, SSL_GENERATOR_REGISTRY

logger = get_logger(__name__)


class ClassificationDataset:
    """Video list + per-sample decode and transform."""

    list_format = "space"  # "space": "<path> <label>" lines; "ssv2_json"

    def __init__(self, cfg, split: str):
        self.cfg = cfg
        self.split = split
        self.data_root = cfg.DATA.DATA_ROOT_DIR
        self.decoder = build_decoder(cfg.DATA.get("DECODER", "auto"), self.data_root, cfg_data=cfg.DATA)
        if split == "test":
            self._num_clips = int(cfg.TEST.get("NUM_ENSEMBLE_VIEWS", 1)) * int(cfg.TEST.get("NUM_SPATIAL_CROPS", 1))
        else:
            self._num_clips = 1
        self.ssl_generator = None
        if "PRETRAIN" in cfg and cfg.PRETRAIN.get("ENABLE", False):
            from clip_fsar_torch.data import mosi as _mosi  # noqa: F401  (registers the generator)

            self.ssl_generator = SSL_GENERATOR_REGISTRY.get(str(cfg.PRETRAIN.get("GENERATOR", "MoSIGenerator")))(cfg, split)
        self._load_list()

    def _list_name(self) -> str:
        raise NotImplementedError

    def _load_list(self) -> None:
        path = os.path.join(self.cfg.DATA.ANNO_DIR, self._list_name())
        self.samples: List[Tuple[str, object]] = []
        if self.list_format == "ssv2_json":
            with open(path) as f:
                for e in json.load(f):
                    self.samples.append((str(e["id"]) + ".mp4", int(e["label_idx"])))
        else:
            dual = isinstance(self.cfg.VIDEO.HEAD.get("NUM_CLASSES", 0), (list, tuple))
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    if dual:  # EPIC verb + noun lines
                        rel, verb, noun = line.rsplit(" ", 2)
                        self.samples.append((rel, (int(verb), int(noun))))
                    else:
                        rel, label = line.rsplit(" ", 1)
                        self.samples.append((rel, int(label)))
        if not self.samples:
            raise ValueError(f"Empty dataset list {path}")
        logger.info("%s[%s]: %d videos x %d clips", type(self).__name__, self.split, len(self.samples), self._num_clips)

    def __len__(self) -> int:
        return len(self.samples) * self._num_clips

    def label(self, index: int):
        if self.ssl_generator is not None:
            return self.ssl_generator.labels
        return self.samples[index // self._num_clips][1]

    def _path(self, rel: str) -> str:
        return rel if isinstance(self.decoder, SyntheticDecoder) else os.path.join(self.data_root, rel)

    def get_item(self, index: int, rng: np.random.Generator, decode: bool = True):
        """(uint8 clip [T, crop, crop, 3], label, index), drawing from ``rng``;
        with ``decode`` False the clip is None and only the draws are taken."""
        rel, label = self.samples[index // self._num_clips]
        path = self._path(rel)
        test = self.split == "test"
        spatial_crops = int(self.cfg.TEST.get("NUM_SPATIAL_CROPS", 1)) if test else 1
        clip_in_video = index % self._num_clips
        length = self.decoder.length(path)
        fps = self.decoder.fps(path) if hasattr(self.decoder, "fps") else float(self.cfg.DATA.get("FPS", 30))
        indices = sample_indices_for_cfg(
            self.cfg, self.split, length, fps, rng,
            clip_idx=clip_in_video // spatial_crops if test else -1, num_clips=self._num_clips // spatial_crops,
        )
        if self.ssl_generator is not None:
            # the generator replaces the transform; its draws depend on the frames' shape only
            frames = self.decoder.read(path, indices) if decode else np.broadcast_to(
                np.zeros((1, 1, 1, 3), np.uint8), (len(indices), *self._frame_hw(path, indices), 3))
            clips, ssl_labels = self.ssl_generator(frames, rng)
            return (clips if decode else None), ssl_labels, index
        if not decode:
            if self.split == "train":
                train_crop_params(*self._frame_hw(path, indices), self.cfg, rng)
            return None, label, index
        frames = self.decoder.read(path, indices)
        if self.split == "train":
            return train_transform(frames, self.cfg, rng), label, index
        return test_transform(frames, self.cfg, clip_in_video % spatial_crops if test else -1), label, index

    def _frame_hw(self, path: str, indices) -> Tuple[int, int]:
        if isinstance(self.decoder, SyntheticDecoder):
            return self.decoder.height, self.decoder.width
        return tuple(self.decoder.read(path, indices[:1]).shape[1:3])


def _register(name: str, list_fmt: str, template: str):
    class _DS(ClassificationDataset):
        list_format = list_fmt

        def _list_name(self) -> str:
            return template.format("train" if "train" in self.split else ("validation" if list_fmt == "ssv2_json" else "test"))

    _DS.__name__ = name
    DATASET_REGISTRY.register(_DS, name=name)
    return _DS


HMDB51 = _register("HMDB51", "space", "hmdb51_{}_list.txt")
UCF101 = _register("UCF101", "space", "ucf101_{}_list.txt")
Kinetics400 = _register("Kinetics400", "space", "kinetics400_{}_list.txt")
Kinetics700 = _register("Kinetics700", "space", "kinetics700_{}_list.txt")
Imagenet = _register("Imagenet", "space", "imagenet_{}_list.txt")
Epickitchen100 = _register("Epickitchen100", "space", "epickitchen100_{}_list.txt")
Ssv2 = _register("Ssv2", "ssv2_json", "something-something-v2-{}-with-label.json")


class ClassificationLoader:
    """Thread-pooled epoch loader yielding (videos uint8 [b, T, H, W, 3],
    labels int32 [b] (EPIC [b, 2]), clip_ids int64 [b]) of a fixed global
    batch size, b its ``row_range`` rows (all of them by default); under
    PRETRAIN.ENABLE videos [b, S, F, H, W, 3] and labels {axis: [b, S]}."""

    def __init__(self, dataset: ClassificationDataset, batch_size: int, shuffle: bool, num_workers: int = 4, prefetch: int = 2,
                 seed: int = 0, drop_last: bool = True, folds: int = 1, row_range: Optional[Tuple[int, int]] = None):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch
        self.seed = seed
        self.folds = max(int(folds), 1)  # MultiFold: one loader epoch covers the dataset this many times
        self.row_range = row_range or (0, batch_size)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.ds) * self.folds
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch(self, idxs: np.ndarray, wrng: np.random.Generator):
        lo, hi = self.row_range
        vids, labels, clip_ids = [], [], []
        last_state = None
        for j, i in enumerate(idxs):
            if j == len(idxs) - 1:
                last_state = wrng.bit_generator.state  # a padded row copies this clip, drawn from here
            v, label, c = self.ds.get_item(int(i), wrng, decode=lo <= j < hi)
            if lo <= j < hi:
                vids.append(v)
                labels.append(label)
                clip_ids.append(c)
        pad_rows = [j for j in range(len(idxs), self.batch_size) if lo <= j < hi]
        if pad_rows:  # the tail batch: copies of its last clip, masked by clip_id -1
            if len(idxs) - 1 >= lo:
                last = vids[-1]
            else:  # the last real clip is another rank's: decode it from the draws it had
                replay = np.random.default_rng()
                replay.bit_generator.state = last_state
                last = self.ds.get_item(int(idxs[-1]), replay)[0]
            vids += [last] * len(pad_rows)
            labels += [self.ds.label(int(idxs[-1]))] * len(pad_rows)
            clip_ids += [-1] * len(pad_rows)
        if isinstance(labels[0], dict):  # SSL generator labels: per-axis targets [S] -> [b, S]
            return np.stack(vids), {k: np.stack([lab[k] for lab in labels]).astype(np.int32) for k in labels[0]}, np.asarray(clip_ids, np.int64)
        return np.stack(vids), np.asarray(labels, np.int32), np.asarray(clip_ids, np.int64)

    def __iter__(self) -> Iterator:
        rng = np.random.default_rng(self.seed * 100003 + self._epoch)
        if self.shuffle:
            order = np.concatenate([rng.permutation(len(self.ds)) for _ in range(self.folds)])
        else:
            order = np.tile(np.arange(len(self.ds)), self.folds)
        batches = [order[i : i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches = batches[:-1]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker(worker_id: int):
            try:
                wrng = np.random.default_rng(self.seed * 7919 + self._epoch * 13 + worker_id)
                for bi in range(worker_id, len(batches), self.num_workers):
                    if stop.is_set():
                        return
                    q.put((bi, self._batch(batches[bi], wrng)))
            except BaseException as e:  # handed to the consumer, which raises it
                q.put((None, e))
                return
            q.put((None, None))

        threads = [threading.Thread(target=worker, args=(w,), daemon=True) for w in range(self.num_workers)]
        for t in threads:
            t.start()
        # reorder buffer: batches in index order, so iteration is deterministic
        # and the views of one video stay contiguous
        finished, pending, next_bi = 0, {}, 0
        try:
            while finished < self.num_workers or pending:
                if next_bi in pending:
                    yield pending.pop(next_bi)
                    next_bi += 1
                    continue
                if finished == self.num_workers:
                    break
                bi, item = q.get()
                if bi is None:
                    if item is not None:
                        raise item
                    finished += 1
                    continue
                pending[bi] = item
        finally:
            stop.set()
            while any(t.is_alive() for t in threads):  # unblock workers waiting on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                for t in threads:
                    t.join(timeout=0.01)


def build_classification_loader(cfg, split: str, row_range: Optional[Tuple[int, int]] = None) -> ClassificationLoader:
    """The train or test loader of ``cfg``; ``row_range`` keeps those rows of
    each global batch (a rank's slice; parallel/mesh.py)."""
    name = cfg.TRAIN.DATASET if split == "train" else cfg.TEST.get("DATASET", cfg.TRAIN.DATASET)
    ds = DATASET_REGISTRY.get(name)(cfg, split)
    bs = int(cfg.TRAIN.BATCH_SIZE if split == "train" else cfg.TEST.get("BATCH_SIZE", cfg.TRAIN.BATCH_SIZE))
    return ClassificationLoader(
        ds, bs, shuffle=(split == "train"), num_workers=int(cfg.DATA_LOADER.get("NUM_WORKERS", 4)),
        prefetch=int(cfg.DATA_LOADER.get("PREFETCH", 2)), seed=int(cfg.get("RANDOM_SEED", 0)),
        drop_last=(split == "train"), folds=int(cfg.TRAIN.get("NUM_FOLDS", 1)) if split == "train" else 1, row_range=row_range,
    )
