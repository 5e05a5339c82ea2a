"""Few-shot split parsing (copy of clip_fsar_tpu/data/splits.py:20-63).

Same list-file formats as the reference ``Split_few_shot``
(datasets/base/ssv2_few_shot.py:33-84):

  * SSv2 style  : ``train8/78687``            -> class 8, path "78687"
  * folder style: ``train0//videos/a/b.avi``  -> class 0, path "videos/a/b.avi"

The class id is encoded as ``<split><id>`` in the first path component;
SSv2-style entries later get a ``.mp4`` suffix appended by the dataset
(ssv2_few_shot.py:369-372).
"""

from __future__ import annotations

import collections
from typing import Dict, List, Sequence, Tuple


class FewShotSplit:
    """Video list + per-class index for one split."""

    def __init__(self, lines: Sequence[str], split: str = "train", ssv2_style: bool = False):
        self.videos: List[str] = []
        self.labels: List[int] = []
        prefix_len = len(split)
        for raw in lines:
            line = raw.strip()
            if not line:
                continue
            if ssv2_style:
                path = line.split("/")[-1]
                class_id = int(line.split("/")[0][prefix_len:])
            else:
                path = line.split("//")[-1]
                class_id = int(line.split("//")[0][prefix_len:])
            self.videos.append(path)
            self.labels.append(class_id)
        if not self.videos:
            raise ValueError(f"Empty split list for split {split!r}")

        self.by_class: Dict[int, List[int]] = collections.defaultdict(list)
        for i, c in enumerate(self.labels):
            self.by_class[c].append(i)

    def unique_classes(self) -> List[int]:
        return sorted(self.by_class.keys())

    def num_videos_for_class(self, class_id: int) -> int:
        return len(self.by_class[class_id])

    def get(self, class_id: int, idx: int) -> Tuple[str, int]:
        """(video path, global video index) of the idx-th video of a class."""
        vid_index = self.by_class[class_id][idx]
        return self.videos[vid_index], vid_index

    def __len__(self) -> int:
        return len(self.videos)


def load_split_file(path: str, split: str, ssv2_style: bool) -> FewShotSplit:
    with open(path) as f:
        return FewShotSplit(f.readlines(), split=split, ssv2_style=ssv2_style)
