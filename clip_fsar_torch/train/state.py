"""Training state (counterpart of clip_fsar_tpu/train/state.py).

The JAX state is an immutable pytree of arrays; here the head and the
optimizer are updated in place, and the state holds them with the step
counter and the EMA copy of the parameters (``MODEL.EMA``).  The EMA covers
the parameters only: an RN tower's BatchNorm running stats are buffers of
the head and stay as trained in both variable sets, as the JAX state's
``batch_stats`` do.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from clip_fsar_torch.parallel import tensor
from clip_fsar_torch.train.optimizer import Optimizer
from clip_fsar_torch.utils import tracing


@dataclasses.dataclass
class TrainState:
    step: int  # loader iterations taken (micro-steps included)
    head: nn.Module
    optimizer: Optimizer
    ema: Optional[Dict[str, torch.Tensor]] = None  # parameter name -> EMA value, when MODEL.EMA is on

    @classmethod
    def create(cls, cfg, head: nn.Module, optimizer: Optimizer) -> "TrainState":
        with tracing.setup_span("fsar.setup.state"):
            ema = None
            if "MODEL" in cfg and cfg.MODEL.EMA.get("ENABLE", False):
                ema = {n: p.detach().clone() for n, p in head.named_parameters()}
            return cls(step=0, head=head, optimizer=optimizer, ema=ema)

    def model_variables(self) -> Dict[str, torch.Tensor]:
        """The head's weights (its state dict)."""
        return self.head.state_dict()

    def ema_variables(self) -> Dict[str, torch.Tensor]:
        """The head's state dict with the EMA parameters in place of the
        trained ones (the trained ones when EMA is off)."""
        sd = self.head.state_dict()
        if self.ema is not None:
            sd.update(self.ema)
        return sd

    def shard_(self, shard: Optional[tensor.ModelShard]) -> None:
        """Keep this rank's model slice of the head, of its optimizer state and
        of its EMA (tensor parallelism; nothing without a model axis)."""
        if tensor.shard_module(self.head, shard):
            self.optimizer.follow_shards()
            if self.ema is not None:
                self.ema = tensor.take_named(self.ema, tensor.specs(self.head))

    @torch.no_grad()
    def update_ema(self, decay: float) -> None:
        """ema = decay * ema + (1 - decay) * params."""
        for n, p in self.head.named_parameters():
            self.ema[n].mul_(decay).add_(p.detach(), alpha=1.0 - decay)
