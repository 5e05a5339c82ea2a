"""Episodes — the fixed-shape data unit of few-shot runs (counterpart of
clip_fsar_tpu/data/types.py:21-47, a flax struct there).

A plain dataclass of numpy arrays on the host, or of tensors once moved
with ``.to(device)``.  A batch of episodes is the same structure with a
leading [E] axis.  Images are NHWC uint8 ([.., T, H, W, 3]) as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Episode:
    """One N-way K-shot episode (or a batch with a leading axis).

    support_images: [S, T, H, W, 3] with S = WAY*SHOT (shuffled order)
    support_labels: [S] episode-local labels in [0, WAY)
    real_support_labels: [S] global class ids (index into the text bank)
    target_images: [Q, T, H, W, 3] with Q = WAY*QUERY_PER_CLASS
    target_labels: [Q] episode-local labels
    real_target_labels: [Q] global class ids
    batch_class_list: [WAY] global class ids chosen for this episode
    unlabeled_images: [U, T, H, W, 3] unlabeled clips of a semi-supervised
        episode (CNN_HyRSM_plusplus_semi; the reference head reads
        inputs["target_set_weakly"], few_shot.py:2348-2352), optional: no
        sampler fills it, in either package
    """

    support_images: Any
    support_labels: Any
    real_support_labels: Any
    target_images: Any
    target_labels: Any
    real_target_labels: Any
    batch_class_list: Optional[Any] = None
    unlabeled_images: Optional[Any] = None

    def replace(self, **changes) -> "Episode":
        return dataclasses.replace(self, **changes)

    def map(self, fn) -> "Episode":
        """Apply ``fn`` to every field that is set."""
        return Episode(**{f.name: (None if (v := getattr(self, f.name)) is None else fn(v)) for f in dataclasses.fields(self)})

    def to(self, device, non_blocking: bool = True) -> "Episode":
        """Move to ``device`` as tensors.  Host arrays bound for a card go
        through pinned memory so the copy can run asynchronously."""
        device = torch.device(device)

        def move(x):
            t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
            if device.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory()
            return t.to(device, non_blocking=non_blocking)

        return self.map(move)


def stack_episodes(episodes) -> Episode:
    """[Episode] -> Episode with a leading [E] axis (numpy)."""
    first = episodes[0]
    return Episode(
        **{
            f.name: (None if getattr(first, f.name) is None else np.stack([getattr(ep, f.name) for ep in episodes]))
            for f in dataclasses.fields(Episode)
        }
    )
