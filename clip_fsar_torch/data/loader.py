"""Loader builder: config -> episodic data service (counterpart of
clip_fsar_tpu/data/loader.py:19-45), single device: no mesh slices, no
frame bank."""

from __future__ import annotations

from clip_fsar_torch.data.datasets import DATASET_REGISTRY
from clip_fsar_torch.data.episodes import EpisodeLoader


def build_few_shot_loader(cfg, split: str, num_steps: int, episodes_per_step: int, start_step: int = 0) -> EpisodeLoader:
    """``num_steps`` batches of ``episodes_per_step`` episodes of the train,
    val or test ``split``, from global step ``start_step`` on."""
    name = cfg.TRAIN.DATASET if split == "train" else cfg.TEST.get("DATASET", cfg.TRAIN.DATASET)
    dataset = DATASET_REGISTRY.get(name)(cfg, split)
    return EpisodeLoader(
        dataset.make_sampler,
        episodes_per_step=episodes_per_step,
        num_steps=num_steps,
        num_workers=int(cfg.DATA_LOADER.get("NUM_WORKERS", 4)),
        prefetch=int(cfg.DATA_LOADER.get("PREFETCH", 2)),
        start_step=start_step,
    )
