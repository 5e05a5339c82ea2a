"""What a cell's run is given, made from ``--seed``: the configuration, the weights, the text
banks and the frame banks, and the port's model and state assembled from them.

Everything random is drawn on the run's device from one ``torch.Generator`` per kind, in a
few large calls: the weights as one normal draw cut into leaves and scaled by fan-in (norm
weights 1, biases 0, running statistics 0 and 1, the head's scale 1), the banks as uint8
noise.  Each bank's table (which rows hold which video's frames) is worked out from the
split lists under ``portbench/splits/``: nothing is decoded.  The reference is handed the
same weights, banks and text banks.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


def load_json(kind: str, name: str) -> dict:
    """``portbench/<kind>/<name>.json``."""
    with open(os.path.join(ROOT, kind, name + ".json")) as f:
        return json.load(f)


def run_config(config_file: dict, seed: int) -> dict:
    """The configuration dict as this run uses it: the file's, with RANDOM_SEED = ``seed`` and
    the split lists' directory resolved inside the checkout."""
    cfg = json.loads(json.dumps(config_file["config"]))
    cfg["RANDOM_SEED"] = int(seed)
    cfg["DATA"]["ANNO_DIR"] = os.path.join(os.path.dirname(ROOT), cfg["DATA"]["ANNO_DIR"])
    return cfg


# ---------------------------------------------------------------------------- weights


def _fill(name: str, shape: tuple) -> str:
    """How a leaf of the head's state dict starts: 'one', 'zero' or 'normal'."""
    last = name.rsplit(".", 1)[-1]
    if last == "running_mean":
        return "zero"
    if last == "running_var":
        return "one"
    if name == "scale":
        return "one"
    if last == "bias" or last.endswith("_bias"):
        return "zero"
    if len(shape) == 1 and last == "weight":  # LayerNorm and BatchNorm gains
        return "one"
    return "normal"


def _std(name: str, shape: tuple) -> float:
    """Fan-in scaled std: 1/sqrt(fan in) for products and convolutions, 1/sqrt(width) for
    embeddings, positions and output projections kept as [width, out]."""
    last = name.rsplit(".", 1)[-1]
    if last in ("class_embedding", "positional_embedding", "proj"):
        return shape[-1] ** -0.5 if last != "proj" else shape[0] ** -0.5
    return float(np.prod(shape[1:])) ** -0.5


def make_weights(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """Float32 leaves of the given shapes from ``seed``: one normal draw on ``device`` for all
    the random ones, cut and scaled."""
    g = torch.Generator(device=device).manual_seed(int(seed) * 2 + 1)
    names = sorted(shapes)
    normal = [n for n in names if _fill(n, shapes[n]) == "normal"]
    total = sum(int(np.prod(shapes[n])) for n in normal)
    draw = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for n in names:
        shape = tuple(shapes[n])
        kind = _fill(n, shape)
        if kind == "normal":
            size = int(np.prod(shape))
            out[n] = draw[at:at + size].view(shape).mul_(_std(n, shape))
            at += size
        else:
            out[n] = torch.full(shape, 1.0 if kind == "one" else 0.0, device=device)
    return out


def make_text_banks(cfg: dict, dim: int, seed: int, device) -> tuple:
    """(train bank [C_train, D], test bank [C_test, D]) float32 class-name features from ``seed``."""
    g = torch.Generator(device=device).manual_seed(int(seed) * 2 + 2)
    n_train = len(cfg["TRAIN"]["CLASS_NAME"])
    n_test = len(cfg["TEST"]["CLASS_NAME"])
    both = torch.randn(n_train + n_test, dim, generator=g, device=device)
    return both[:n_train].contiguous(), both[n_train:].contiguous()


# ---------------------------------------------------------------------------- banks


def video_length(path: str) -> int:
    """Frames of a split video: 40 to 119 by the hash of its path (the synthetic decoder's rule)."""
    return 40 + int.from_bytes(hashlib.md5(path.encode()).digest()[:4], "little") % 80


def split_videos(cfg: dict, split: str) -> tuple:
    """The split list's distinct video paths and their class ids (``<split><class>//<path>``
    lines), in file order."""
    kind = "train" if split == "train" else "test"
    paths, classes, seen = [], [], set()
    with open(os.path.join(cfg["DATA"]["ANNO_DIR"], f"{kind}_few_shot.txt")) as f:
        for line in f:
            line = line.strip()
            if line:
                prefix, path = line.split("//")[0], line.split("//")[-1]
                if path not in seen:
                    seen.add(path)
                    paths.append(path)
                    classes.append(int(prefix[len(kind):]))
    return paths, classes


def bank_table(cfg: dict, split: str, frames: int) -> dict:
    """Rows of each video in a bank of ``frames`` grid frames a video: the uniform grid over
    the video's length (all of a shorter video's frames, its last repeated in the spare rows)."""
    paths, classes = split_videos(cfg, split)
    v = len(paths)
    orig = np.zeros((v, frames), np.int64)
    nframes = np.zeros(v, np.int32)
    length = np.zeros(v, np.int64)
    for row, path in enumerate(paths):
        n = video_length(path)
        keep = np.unique(np.linspace(0, n - 1, min(frames, n)).round().astype(np.int64))
        orig[row, :len(keep)], orig[row, len(keep):] = keep, keep[-1]
        nframes[row], length[row] = len(keep), n
    fps = np.full(v, float(cfg["DATA"].get("FPS", 30)), np.float64)
    return {"orig_idx": orig, "nframes": nframes, "length": length, "fps": fps, "paths": paths, "frames": frames,
            "classes": np.asarray(classes, np.int64)}


def make_bank_pixels(videos: int, frames: int, height: int, width: int, seed: int, salt: int, device) -> torch.Tensor:
    """uint8 noise [videos * frames, height, width, 3] on ``device``, one draw."""
    g = torch.Generator(device=device).manual_seed(int(seed) * 4 + salt)
    return torch.randint(0, 256, (videos * frames, height, width, 3), generator=g, device=device, dtype=torch.uint8)


@dataclasses.dataclass
class Inputs:
    """What the benchmark makes for a run and hands to the program and the reference alike."""

    cfg: dict
    weights: Dict[str, torch.Tensor]  # the head's state dict as it starts
    text_train: torch.Tensor
    text_test: torch.Tensor
    bank: torch.Tensor
    table: dict
