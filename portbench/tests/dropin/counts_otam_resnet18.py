"""Operations of the drop-in test's otam_resnet18 cells, copied to ``portbench/counts/otam_resnet18.py``:
a torchvision ResNet-18 trunk at the configuration's crop under the CNN_OTAM head."""

from __future__ import annotations

from portbench import flops

LAYERS, DIM = (2, 2, 2, 2), 512


def model_flops(cfg: dict, kind: str, episodes: int) -> float:
    """Model FLOPs of one step: the trunk over every frame, and each query's frame similarities to every support clip."""
    s = flops.episode_shapes(cfg, kind)
    crop = int(cfg["DATA"]["TRAIN_CROP_SIZE" if kind == "train" else "TEST_CROP_SIZE"])
    trunk = flops.tv_resnet_forward(LAYERS, False, crop)
    frames = episodes * (s["support"] + s["query"]) * s["frames"]
    forward = frames * trunk["total"] + episodes * 2.0 * s["query"] * s["frames"] * s["support"] * s["frames"] * DIM
    return forward if kind == "test" else 3.0 * forward - 2.0 * frames * trunk["first"]


def attention_work(cfg: dict, kind: str, episodes: int) -> list:
    """No attention kernel."""
    return []
