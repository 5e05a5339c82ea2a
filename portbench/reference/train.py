"""The episodic train step in plain PyTorch, shared by every family: the clips of each episode,
the gradient of the step's loss over its episode chunks, and the optimizer.

A step's loss is the mean over its E episodes of the family's episode loss
(``portbench/families/<family>.py``), taken E / TPU.EPISODE_CHUNKS episodes at a time.
Parameters train with Adam (b1 0.9, b2 0.999, eps 1e-8), L2 weight decay added to the gradient
(SOLVER.WEIGHT_DECAY; none on names holding "embd" or "cls_token", BN.WEIGHT_DECAY on names
holding "bn" or "norm", the reference's groups under the "head." prefix), the gradient averaged
over TRAIN.BATCH_SIZE_PER_TASK steps before each update, at the learning rate of the step that
closes the window: linear warmup over WARMUP_EPOCHS from WARMUP_START_LR, then
steps_with_relative_lrs, the epoch of step i being i // STEPS_ITER + NUM_FOLDS * i / STEPS_ITER.

Random numbers: the jitter's factors and flags and the head's own draws (dropout masks) come
from a torch.Generator seeded per step with the configuration's seed rule, drawn in the order
of the program's documented contract (the jitter of all E episodes' query clips first, then per
episode chunk what the family's head draws); the jitter's op order from a numpy generator
seeded with the same seed.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch

from portbench.reference import episode as ep

Weights = Dict[str, torch.Tensor]
LABELS = ("support_labels", "target_labels", "real_support", "real_target")


def step_seed(random_seed: int, step: int) -> int:
    """The seed of train step ``step``'s generator: SeedSequence((RANDOM_SEED + 1, step))."""
    return int(np.random.SeedSequence((int(random_seed) + 1, int(step))).generate_state(1)[0])


def learning_rate(solver: dict, num_folds: int, step: int) -> float:
    steps_iter = int(solver.get("STEPS_ITER", 1) or 1)
    epoch = step // steps_iter + num_folds * float(step) / steps_iter

    def policy(e: float) -> float:
        bounds = list(solver["STEPS"]) + [solver["MAX_EPOCH"]]
        ind = 0
        for ind, b in enumerate(bounds):
            if e < b:
                break
        return float(solver["LRS"][ind - 1]) * float(solver["BASE_LR"])

    if solver["LR_POLICY"] != "steps_with_relative_lrs":
        raise NotImplementedError(solver["LR_POLICY"])
    warm = float(solver.get("WARMUP_EPOCHS", 0))
    if epoch < warm:
        start = float(solver["WARMUP_START_LR"])
        return epoch * (policy(warm) - start) / warm + start
    return policy(epoch)


def decay_of(name: str, wd: float, bn_wd: float) -> float:
    parts = ("head." + name).lower().split(".")
    for i, p in enumerate(parts[:-1]):  # an RN shortcut's conv and BatchNorm, under the reference's names
        if p == "downsample" and parts[i + 1] in ("0", "1"):
            parts[i + 1] = {"0": "downsample_conv", "1": "downsample_bn"}[parts[i + 1]]
            del parts[i]
            break
    full = ".".join(parts)
    if "embd" in full or "cls_token" in full:
        return 0.0
    if "bn" in full or "norm" in full:
        return bn_wd
    return wd


class Adam:
    """Adam over named float32 leaves with L2 decay and a window of ``k`` averaged gradients."""

    def __init__(self, params: Weights, decay: Dict[str, float], k: int):
        self.p = params
        self.decay, self.k = decay, k
        self.m = {n: torch.zeros_like(t) for n, t in params.items()}
        self.v = {n: torch.zeros_like(t) for n, t in params.items()}
        self.acc = {n: torch.zeros_like(t) for n, t in params.items()}
        self.micro, self.t = 0, 0

    @torch.no_grad()
    def step(self, grads: Weights, lr: float) -> bool:
        for n, g in grads.items():
            self.acc[n] += g
        self.micro += 1
        if self.micro < self.k:
            return False
        self.t += 1
        for n, p in self.p.items():
            g = self.acc[n] / self.k + self.decay[n] * p
            self.m[n].mul_(0.9).add_(g, alpha=0.1)
            self.v[n].mul_(0.999).addcmul_(g, g, value=0.001)
            denom = (self.v[n] / (1 - 0.999**self.t)).sqrt() + 1e-8
            p.sub_(lr / (1 - 0.9**self.t) * self.m[n] / denom)
            self.acc[n].zero_()
        self.micro = 0
        return True


def draws(generator: torch.Generator, host: np.random.Generator, n_query: int, aug: dict, device) -> dict:
    """The jitter's draws for ``n_query`` query clips: brightness, contrast, saturation factors,
    hue shift, op order, grayscale flags (the support clips draw nothing: no colour jitter on
    them, no random erasing)."""
    if aug.get("COLOR_AUG", False) or aug.get("RANDOM_ERASING", {}).get("ENABLE", False):
        raise NotImplementedError("the reference follows AUGMENTATION.COLOR_AUG and RANDOM_ERASING.ENABLE false")
    unif = lambda lo, hi, shape: lo + (hi - lo) * torch.rand(shape, generator=generator, device=device)  # noqa: E731
    c = (n_query, 1, 1, 1, 1)
    out = {
        "brightness": unif(max(0.0, 1 - aug["BRIGHTNESS"]), 1 + aug["BRIGHTNESS"], c),
        "contrast": unif(max(0.0, 1 - aug["CONTRAST"]), 1 + aug["CONTRAST"], c),
        "saturation": unif(max(0.0, 1 - aug["SATURATION"]), 1 + aug["SATURATION"], c),
        "hue": unif(-aug["HUE"], aug["HUE"], c[:-1]),
        "order": int(host.integers(math.factorial(4))),
    }
    out["gray"] = torch.rand(c, generator=generator, device=device) < aug["GRAYSCALE"]
    return out


def episodic_step(w: Weights, batch: dict, bank: torch.Tensor, cfg: dict, step: int, chunks: int,
                  chunk_draws: Callable, episode_loss: Callable) -> tuple:
    """One train step of a batch of E episodes (host arrays: ``support``/``target`` [E, N, T + 3]
    bank indices, ``support_labels``, ``target_labels``, ``real_support``, ``real_target``
    [E, N]).  ``chunk_draws(generator, eps, s, q, t)`` draws what the head draws for a chunk of
    ``eps`` episodes of S support and Q query clips of T frames; ``episode_loss(w, clips_s,
    clips_q, labels, drawn, j)`` is the loss of the chunk's ``j``-th episode from its normalized
    clips [S | Q, T, H, W, 3], its ``LABELS`` on the device and the chunk's draws.  Returns (the
    mean loss over the E episodes, its gradient by leaf)."""
    device = bank.device
    data, aug = cfg["DATA"], cfg["AUGMENTATION"]
    t, crop = int(data["NUM_INPUT_FRAMES"]), int(data["TRAIN_CROP_SIZE"])
    mean, std = data["MEAN"], data["STD"]
    e, s = batch["support"].shape[:2]
    q = batch["target"].shape[1]
    seed = step_seed(cfg["RANDOM_SEED"], step)
    gen = torch.Generator(device=device).manual_seed(seed)
    jit = draws(gen, np.random.default_rng(seed), e * q, aug, device)
    params = {n: p for n, p in w.items() if p.is_floating_point() and "running_" not in n}
    grads = {n: torch.zeros_like(p) for n, p in params.items()}
    total = 0.0
    per = e // chunks
    for c in range(chunks):
        drawn = chunk_draws(gen, per, s, q, t)
        for j in range(per):
            i = c * per + j
            as_t = lambda key: torch.as_tensor(batch[key][i], device=device)  # noqa: E731
            clips_s = ep.normalize(ep.train_clips(bank, as_t("support"), t, crop).float() / 255.0, mean, std)
            raw_q = ep.train_clips(bank, as_t("target"), t, crop).float() / 255.0
            sl = slice(i * q, (i + 1) * q)
            raw_q = ep.color_jitter(raw_q, jit["brightness"][sl], jit["contrast"][sl], jit["saturation"][sl], jit["hue"][sl],
                                    jit["order"], jit["gray"][sl])
            clips_q = ep.normalize(raw_q, mean, std)
            leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
            wl = {**w, **leaves}
            loss = episode_loss(wl, clips_s, clips_q, {k: as_t(k) for k in LABELS}, drawn, j) / e
            got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            for n, g in zip(leaves, got):
                if g is not None:
                    grads[n] += g
            total += float(loss.detach())
            del loss, got, leaves, wl
    return total, grads
