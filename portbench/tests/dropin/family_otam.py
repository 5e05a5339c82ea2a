"""A second family for the drop-in test, copied to ``portbench/families/otam.py`` in a copy of the
checkout: the port's classic CNN_OTAM head on a torchvision ResNet trunk (reference
few_shot.py:1405-1444), and its plain reference on ``reference/tv_resnet.py``.

Each clip's frames go through the trunk, its BatchNorm on the running statistics (the classic
heads keep the trunk's statistics frozen while its weights train); the frame distance is
1 - cos between a query and a support clip's frames, their bidirectional OTAM (lambda 0.1)
aligns them, and a query's logit for a class is minus the class mean over its support clips.
The loss is the query logits' cross-entropy.  The head draws nothing, and has no text tower: its
banks are the port's [1, 1] zeros.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference import episode as ref_ep
from portbench.reference import train, tv_resnet
from portbench.reference.head import cos_sim, otam
from portbench.reference.ops import Precision

Weights = Dict[str, torch.Tensor]
TRUNK = "backbone."
LAMBDA = 0.1


def build_head(cfg, device: torch.device):
    """The port's CNN_OTAM head at the configuration's trunk and compute dtype, its weights left to fill."""
    from clip_fsar_torch.models.builder import _dtype_from_cfg
    from clip_fsar_torch.utils.registry import HEAD_REGISTRY

    return HEAD_REGISTRY.get(cfg.VIDEO.HEAD.NAME)(cfg, arch=None, dtype=_dtype_from_cfg(cfg), device=device)


def trunk_part(w: Weights) -> Weights:
    """The trunk's leaves under torchvision's names, as ``tv_resnet`` reads them."""
    return {k[len(TRUNK):]: v for k, v in w.items() if k.startswith(TRUNK)}


def check_weights(weights: Weights, arch: dict) -> None:
    """The weights' shapes against the configuration's trunk: blocks a stage, feature width."""
    trunk = trunk_part(weights)
    last = trunk["layer4.0.conv3.weight" if "layer1.0.conv3.weight" in trunk else "layer4.0.conv2.weight"]
    got = {"layers": tv_resnet.stage_blocks(trunk), "feature_dim": last.shape[0]}
    want = {k: arch[k] for k in got}
    if got != want:
        raise ValueError(f"the model's trunk {got} is not the configuration's {want}")


def text_banks(cfg: dict, weights: Weights, seed: int, device) -> tuple:
    """No text tower: the port's [1, 1] zeros for both banks."""
    return torch.zeros((1, 1), device=device), torch.zeros((1, 1), device=device)


def episode_logits(w: Weights, clips_s: torch.Tensor, clips_q: torch.Tensor, support_labels: torch.Tensor, way: int,
                   prec: Precision, recompute: bool = False) -> torch.Tensor:
    """Logits [Q, way] of one episode from its normalized clips [S | Q, T, H, W, 3]."""
    s, q, t = clips_s.shape[0], clips_q.shape[0], clips_s.shape[1]
    feats = tv_resnet.resnet(torch.cat([clips_s, clips_q]).flatten(0, 1), trunk_part(w), prec, recompute).reshape(s + q, t, -1)
    sup, tgt = feats[:s], feats[s:]
    d = 1.0 - cos_sim(tgt.reshape(q * t, -1), sup.reshape(s * t, -1), prec)
    cum = otam(d.reshape(q, t, s, t).transpose(1, 2), LAMBDA)  # [Q, S]
    onehot = F.one_hot(support_labels.long(), way).float()  # [S, way]
    return -(cum @ onehot) / onehot.sum(dim=0)


def reference_step(w: Weights, batch: dict, bank: torch.Tensor, text: torch.Tensor, cfg: dict, step: int, prec: Precision,
                   arch: dict, chunks: int) -> tuple:
    """One train step of a batch of E episodes (``train.episodic_step``'s): (the mean loss, its gradient by leaf)."""
    way = int(cfg["TRAIN"]["WAY"])

    def loss(wl, clips_s, clips_q, labels, drawn, j):
        logits = episode_logits(wl, clips_s, clips_q, labels["support_labels"], way, prec, True)
        return F.cross_entropy(logits, labels["target_labels"].long())

    return train.episodic_step(w, batch, bank, cfg, step, chunks, lambda *shape: None, loss)


def reference_logits(w: Weights, episode: dict, bank: torch.Tensor, text: torch.Tensor, cfg: dict, prec: Precision,
                     arch: dict) -> torch.Tensor:
    """One test episode's logits [Q, WAY] (its bank rows and labels as tensors on the bank's device)."""
    s = episode["support"].shape[0]
    x = ref_ep.eval_episode_clips(bank, episode["support"], episode["target"], cfg["DATA"]["MEAN"], cfg["DATA"]["STD"])
    return episode_logits(w, x[:s], x[s:], episode["support_labels"], int(cfg["TRAIN"]["WAY"]), prec)
