"""MoLo (the port's CNN_BiMHM_MoLo head on a torchvision ResNet trunk): all that the harness knows of
this head.

The program's side: the head at the configuration's widths from the port's head registry.  The
inputs' side: the weights' shapes against the configuration's trunk and head, no text tower (the
port's [1, 1] zeros), and the trunk's BatchNorm statistics and affine drawn from the seed: the
trunk runs on its running statistics, so at the inputs' 0 / 1 / 1 / 0 a path that ignored them
would read the same numbers.  The reference's side: a train step's loss and gradient and a test
episode's logits from ``reference/molo.py``, one episode at a time (the decoder's BatchNorm takes
each episode's own statistics, so the blocking is exact).

The head draws its dropout keep masks once an episode chunk, over the chunk's clips (support then
query clips of each episode in turn): the motion stream's (the positional encoding, the
attention's output, the first and the second feed-forward layer), then the appearance stream's.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference import episode as ref_ep
from portbench.reference import molo as ref
from portbench.reference import train, tv_resnet
from portbench.reference.ops import Precision

Weights = Dict[str, torch.Tensor]
TRUNK_STATS = 0x4D6F4C6F  # the trunk's BatchNorm draws: their own stream of the seed


def build_head(cfg, device: torch.device):
    """The port's MoLo head at the configuration's trunk and compute dtype, its weights left to fill."""
    from clip_fsar_torch.models.builder import _dtype_from_cfg
    from clip_fsar_torch.utils import tracing
    from clip_fsar_torch.utils.registry import HEAD_REGISTRY

    with tracing.setup_span("fsar.setup.model"):
        return HEAD_REGISTRY.get(cfg.VIDEO.HEAD.NAME)(cfg, arch=None, dtype=_dtype_from_cfg(cfg), device=device)


def check_weights(weights: Weights, arch: dict) -> None:
    """The weights' shapes against the configuration's trunk (blocks a stage, feature width) and head
    (motion width, decoder widths, feed-forward width, classes)."""
    w = weights
    trunk = ref.trunk_part(w)
    last = trunk["layer4.0.conv3.weight" if "layer1.0.conv3.weight" in trunk else "layer4.0.conv2.weight"]
    got = {"layers": tv_resnet.stage_blocks(trunk), "feature_dim": last.shape[0], "motion_dim": w["motion_reduce.weight"].shape[0],
           "decoder": [w[f"{n}.conv.weight"].shape[0] for n in ref.DECODER] + [w["outc.weight"].shape[0]],
           "mlp": w["temporal_atte_before.ff_fc1.weight"].shape[0], "classes": w["classification_layer.weight"].shape[0]}
    want = {k: arch[k] for k in got}
    if got != want:
        raise ValueError(f"the model's trunk and head {got} are not the configuration's {want}")


def draw_trunk_statistics(weights: Weights, seed: int) -> None:
    """The trunk's BatchNorm leaves, in place, from ``seed``: running mean 0.1 N(0, 1), running variance
    0.5 + U(0, 1), weight 0.5 + U(0, 1), bias 0.1 N(0, 1); and the contrastive temperatures at 1, as the
    head initializes them."""
    names = sorted(k[:-len("running_mean")] for k in weights if k.startswith(ref.TRUNK) and k.endswith("running_mean"))
    device = weights[names[0] + "running_mean"].device
    g = torch.Generator(device=device).manual_seed(int(np.random.SeedSequence((int(seed), TRUNK_STATS)).generate_state(1)[0]))
    for p in names:
        c = weights[p + "running_mean"].shape
        weights[p + "running_mean"] = 0.1 * torch.randn(c, generator=g, device=device)
        weights[p + "running_var"] = 0.5 + torch.rand(c, generator=g, device=device)
        weights[p + "weight"] = 0.5 + torch.rand(c, generator=g, device=device)
        weights[p + "bias"] = 0.1 * torch.randn(c, generator=g, device=device)
    for name in ("scale", "scale_motion"):
        if name in weights:
            weights[name] = torch.ones_like(weights[name])


def text_banks(cfg: dict, weights: Weights, seed: int, device) -> tuple:
    """No text tower: the port's [1, 1] zeros for both banks.  The hook that is handed the weights and the
    seed: the trunk's BatchNorm leaves are drawn here (``draw_trunk_statistics``)."""
    draw_trunk_statistics(weights, seed)
    return torch.zeros((1, 1), device=device), torch.zeros((1, 1), device=device)


def dropout_masks(generator: torch.Generator, rows: int, t: int, dim: int, mlp: int, device) -> Dict[str, List[torch.Tensor]]:
    """Keep masks of one episode chunk of ``rows`` clips: the motion stream's (T tokens), then the appearance stream's (T + 1)."""
    def four(n: int) -> List[torch.Tensor]:
        return [torch.rand((rows, n, width), generator=generator, device=device) < 1.0 - rate
                for width, rate in ((dim, ref.PE_DROP), (dim, ref.ATTN_DROP), (mlp, ref.FFN_DROP), (dim, ref.FFN_DROP))]

    return {"motion": four(t), "appearance": four(t + 1)}


def reference_step(w: Weights, batch: dict, bank: torch.Tensor, text: torch.Tensor, cfg: dict, step: int, prec: Precision,
                   arch: dict, chunks: int) -> tuple:
    """One train step of a batch of E episodes (``train.episodic_step``'s): (the mean loss, its gradient by leaf)."""
    dim, mlp = w["class_token"].shape[-1], w["temporal_atte_before.ff_fc1.weight"].shape[0]
    way = int(cfg["TRAIN"]["WAY"])

    def draws(generator, eps, s, q, t):
        return dropout_masks(generator, eps * (s + q), t, dim, mlp, bank.device)

    def loss(wl, clips_s, clips_q, labels, masks, j):
        n = clips_s.shape[0] + clips_q.shape[0]
        mine = {kind: [m[j * n:(j + 1) * n] for m in v] for kind, v in masks.items()}
        out = ref.episode(wl, clips_s, clips_q, labels["support_labels"], way, prec, arch["heads"], mine, train=True, recompute=True)
        real = torch.cat([labels["real_support"], labels["real_target"]])
        return ref.episode_loss(out, labels["target_labels"], real, cfg["TRAIN"])

    return train.episodic_step(w, batch, bank, cfg, step, chunks, draws, loss)


def reference_logits(w: Weights, episode: dict, bank: torch.Tensor, text: torch.Tensor, cfg: dict, prec: Precision,
                     arch: dict) -> torch.Tensor:
    """One test episode's logits [Q, WAY] (its bank rows and labels as tensors on the bank's device): no dropout, no decoder."""
    s = episode["support"].shape[0]
    x = ref_ep.eval_episode_clips(bank, episode["support"], episode["target"], cfg["DATA"]["MEAN"], cfg["DATA"]["STD"])
    out = ref.episode(w, x[:s], x[s:], episode["support_labels"], int(cfg["TRAIN"]["WAY"]), prec, arch["heads"])
    return out["logits"]
