"""CLIP-FSAR (the port's CNN_OTAM_CLIPFSAR head on a CLIP vision tower): all that the harness knows
of this head.

The program's side: the head at the configuration's widths, built by the port's own
``make_head``.  The inputs' side: the weights' shapes against the published tower, and the
class-name text banks drawn from the seed at the prototype modulation's width (the text tower is
not in the timed path).  The reference's side: a train step's loss and gradient, and a test
episode's logits, from the plain CLIP towers (``reference/towers.py``) and head
(``reference/head.py``).

The loss of an episode is the cross-entropy of its query logits against the query labels plus
USE_CLASSIFICATION_VALUE times the cross-entropy of the video-text class logits of all its clips
against their real classes (the reference code's train_net_few_shot.py).  The head draws the
prototype modulation's dropout masks once an episode chunk: the query transformer's three, then
the support transformer's three, each over the chunk's clips.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench import inputs as inp
from portbench.reference import episode as ref_ep
from portbench.reference import train
from portbench.reference.head import ATTN_DROP, FFN_DROP, head
from portbench.reference.ops import Precision
from portbench.reference.towers import tower

Weights = Dict[str, torch.Tensor]
TOWER = "backbone."  # the tower's leaves in the head's state dict


def build_head(cfg, device: torch.device):
    """The port's head at the configuration's widths (``cfg`` the port's Config), its weights left to fill."""
    from clip_fsar_torch.models.builder import _adapt_vision_resolution, make_head
    from clip_fsar_torch.models.clip.arch import ARCHS

    arch = _adapt_vision_resolution(cfg, ARCHS[cfg.VIDEO.HEAD.BACKBONE_NAME])
    return make_head(cfg, arch, device)


def check_weights(weights: Weights, arch: dict) -> None:
    """The weights' shapes against the configuration's published tower."""
    w = weights
    if arch["tower"] == "ViT":
        width, patch = w["backbone.conv1.weight"].shape[0], w["backbone.conv1.weight"].shape[-1]
        layers = len({k.split(".")[3] for k in w if k.startswith("backbone.transformer.resblocks.")})
        got = {"width": width, "patch": patch, "layers": layers, "embed_dim": w["backbone.proj"].shape[1]}
    else:
        got = {"width": w["backbone.conv3.weight"].shape[0],
               "layers": [len({k.split(".")[2] for k in w if k.startswith(f"backbone.layer{i}.")}) for i in range(1, 5)],
               "embed_dim": w["backbone.attnpool.c_proj.weight"].shape[0]}
    want = {k: arch[k] for k in got}
    if got != want:
        raise ValueError(f"the model's tower {got} is not the configuration's {want}")


def text_banks(cfg: dict, weights: Weights, seed: int, device) -> tuple:
    """(train bank, test bank) drawn from ``seed`` at the prototype modulation's width."""
    return inp.make_text_banks(cfg, weights["context2.norm_0.weight"].shape[0], seed, device)


def tower_part(w: Weights) -> Weights:
    """The tower's leaves under the names ``towers`` reads."""
    return {k[len(TOWER):]: v for k, v in w.items() if k.startswith(TOWER)}


def dropout_masks(generator: torch.Generator, eps: int, s: int, q: int, t: int, dim: int, mlp: int, device) -> dict:
    """Keep masks of one episode chunk: the query transformer's (attention output, first and second
    feed-forward layer), then the support transformer's, each over the chunk's clips."""
    def three(rows: int, n: int) -> List[torch.Tensor]:
        return [torch.rand((rows, n, width), generator=generator, device=device) < 1.0 - rate
                for width, rate in ((dim, ATTN_DROP), (mlp, FFN_DROP), (dim, FFN_DROP))]

    return {"target": three(eps * q, t), "support": three(eps * s, t + 1)}


def episode_loss(w: Weights, clips_s: torch.Tensor, clips_q: torch.Tensor, labels_s: torch.Tensor, labels_q: torch.Tensor,
                 real_s: torch.Tensor, real_q: torch.Tensor, text: torch.Tensor, masks: dict, cfg: dict, prec: Precision,
                 heads: int, recompute: bool) -> torch.Tensor:
    """One episode's loss from its normalized clips [S | Q, T, H, W, 3]."""
    s, q, t = clips_s.shape[0], clips_q.shape[0], clips_s.shape[1]
    wt = tower_part(w)
    groups = None if "class_embedding" in wt else 1  # the RN tower on the episode's batch statistics, support then query
    feats_s = tower(clips_s.flatten(0, 1), wt, prec, heads, groups, recompute).reshape(s, t, -1)
    feats_q = tower(clips_q.flatten(0, 1), wt, prec, heads, groups, recompute).reshape(q, t, -1)
    way = int(cfg["TRAIN"]["WAY"])
    logits, class_logits = head(feats_s, feats_q, labels_s, text, text[real_s.long()], w, prec, way, masks, with_class_logits=True)
    loss = F.cross_entropy(logits, labels_q.long())
    if cfg["TRAIN"].get("USE_CLASSIFICATION", False):
        loss = loss + float(cfg["TRAIN"].get("USE_CLASSIFICATION_VALUE", 1.0)) * F.cross_entropy(
            class_logits, torch.cat([real_s, real_q]).long())
    return loss


def reference_step(w: Weights, batch: dict, bank: torch.Tensor, text: torch.Tensor, cfg: dict, step: int, prec: Precision,
                   arch: dict, chunks: int) -> tuple:
    """One train step of a batch of E episodes (``train.episodic_step``'s): (the mean loss, its gradient by leaf)."""
    dim = w["context2.norm_0.weight"].shape[0]
    mlp = w["context2.ff_0.fc1.weight"].shape[0]

    def draws(generator, eps, s, q, t):
        return dropout_masks(generator, eps, s, q, t, dim, mlp, bank.device)

    def loss(wl, clips_s, clips_q, labels, masks, j):
        s, q = clips_s.shape[0], clips_q.shape[0]
        em = {k: [m[j * (q if k == "target" else s):(j + 1) * (q if k == "target" else s)] for m in v] for k, v in masks.items()}
        return episode_loss(wl, clips_s, clips_q, labels["support_labels"], labels["target_labels"], labels["real_support"],
                            labels["real_target"], text, em, cfg, prec, arch["heads"], True)

    return train.episodic_step(w, batch, bank, cfg, step, chunks, draws, loss)


def reference_logits(w: Weights, episode: dict, bank: torch.Tensor, text: torch.Tensor, cfg: dict, prec: Precision,
                     arch: dict) -> torch.Tensor:
    """One test episode's logits [Q, WAY] (its bank rows and labels as tensors on the bank's device),
    the tower's BatchNorm on the running statistics as the test step runs it."""
    s, q, t = episode["support"].shape[0], episode["target"].shape[0], episode["support"].shape[1]
    x = ref_ep.eval_episode_clips(bank, episode["support"], episode["target"], cfg["DATA"]["MEAN"], cfg["DATA"]["STD"])
    feats = tower(x.flatten(0, 1), tower_part(w), prec, arch["heads"], None).reshape(s + q, t, -1)
    labels = episode["support_labels"]
    logits, _ = head(feats[:s], feats[s:], labels, text, text[episode["real_support"].long()], w, prec, int(cfg["TRAIN"]["WAY"]))
    return logits
