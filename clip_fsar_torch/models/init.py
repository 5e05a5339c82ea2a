"""Weight initializers of the video models (counterpart of
clip_fsar_tpu/models/init.py), each drawing from an explicit
``torch.Generator``:

  * ``msra_fill_``   -- kaiming-normal fan_out with relu gain
    (std = sqrt(2 / (out_channels * prod(kernel)))), the reference's
    c2_msra_fill for every conv of the ResNet-style video models;
  * ``trunc_normal_`` -- normal(0, 0.02) truncated at two sigma, for the
    transformers' class tokens and position tables;
  * ``fc_init_``     -- normal(0, 0.01), for the classifier FCs;
  * ``lecun_normal_`` -- flax's default kernel init (truncated normal of
    variance 1 / fan_in), for the layers the JAX package leaves at it.
"""

from __future__ import annotations

import torch
from torch import nn


def msra_fill_(w: torch.Tensor, g: torch.Generator) -> None:
    nn.init.kaiming_normal_(w, mode="fan_out", nonlinearity="relu", generator=g)


def trunc_normal_(w: torch.Tensor, g: torch.Generator, std: float = 0.02) -> None:
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=g)


def fc_init_(w: torch.Tensor, g: torch.Generator, std: float = 0.01) -> None:
    w.normal_(0.0, std, generator=g)


def lecun_normal_(w: torch.Tensor, g: torch.Generator) -> None:
    fan_in = w[0].numel()  # in * prod(kernel) of a conv [out, in, k...], in of a linear [out, in]
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=g)
