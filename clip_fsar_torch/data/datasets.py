"""Few-shot dataset flavors (counterpart of clip_fsar_tpu/data/datasets.py:21-86).

One implementation serves all five benchmarks: ``TRAIN.DATASET_FEW`` only
switches path parsing (SSv2 ids get ``<root>/<id>.mp4``, the folder styles
``<root>/<relpath>``).  Registered under the JAX package's names in the
port's own registry.
"""

from __future__ import annotations

import os

from clip_fsar_torch.data.decode import build_decoder
from clip_fsar_torch.data.episodes import EpisodeSampler
from clip_fsar_torch.data.splits import load_split_file
from clip_fsar_torch.utils.registry import Registry

DATASET_REGISTRY = Registry("DATASET")


class FewShotVideoDataset:
    """Factory for EpisodeSamplers over one split of a few-shot benchmark:
    train reads train_few_shot.txt, val and test read test_few_shot.txt
    (reference ssv2_few_shot.py:100-110)."""

    style_name = "Ssv2_few_shot"  # fallback when TRAIN.DATASET_FEW is absent

    def __init__(self, cfg, split: str):
        self.cfg = cfg
        self.split = split
        style = cfg.TRAIN.get("DATASET_FEW", self.style_name)
        self._ssv2_style = style == "Ssv2_few_shot"
        kind = "train" if split == "train" else "test"
        self.fs_split = load_split_file(os.path.join(cfg.DATA.ANNO_DIR, f"{kind}_few_shot.txt"), kind, self._ssv2_style)
        self.data_root = cfg.DATA.DATA_ROOT_DIR
        self.decoder = build_decoder(cfg.DATA.get("DECODER", "auto"), self.data_root, cfg_data=cfg.DATA)

    def path_map(self, rel: str) -> str:
        if type(self.decoder).__name__ == "SyntheticDecoder":
            return rel  # synthetic decode keys off the relative path only
        if self._ssv2_style:
            return os.path.join(self.data_root, rel + ".mp4")
        return os.path.join(self.data_root, rel)

    def make_sampler(self, worker_id: int = 0) -> EpisodeSampler:
        # worker-independent seed: the loader reseeds per (step, slot)
        del worker_id
        train = self.split == "train"
        seed = int(self.cfg.get("RANDOM_SEED", 0)) * 100003 + (0 if train else 1)  # the JAX package's split seeds
        return EpisodeSampler(self.cfg, self.fs_split, self.decoder, mode="train" if train else "test", seed=seed, path_map=self.path_map)


for _name in ("Ssv2_few_shot", "HMDB_few_shot", "UCF_few_shot", "Kinetics_few_shot", "Epic_few_shot"):
    DATASET_REGISTRY.register(type(_name, (FewShotVideoDataset,), {"style_name": _name}), name=_name)
