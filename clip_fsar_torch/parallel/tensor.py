"""Tensor parallelism over the mesh's model axis (counterpart of
clip_fsar_tpu/parallel/mesh.py:156-202, ``_tp_spec_for`` / ``shard_params``).

The JAX package places the transformer matmuls Megatron-style on a
(data, model) mesh and GSPMD inserts the collectives.  Here each model rank
is a process that keeps its slice of every sharded pair of products, and the
collectives are written out:

- a column-parallel product (the q/k/v projections, the first feed-forward
  layer) keeps the output features of the rank's heads (hidden units); its
  input passes through ``copy_to_model`` (identity forward, the gradient
  all-reduced over the model group backward);
- a row-parallel product (the output projection, the second feed-forward
  layer) keeps the input features of those heads, and its partial product
  passes through ``reduce_from_model`` (all-reduced forward, identity
  backward); its bias is added once, after the sum.

Everything else is replicated: every model rank computes it from the same
inputs and the same generator, so it holds the same values and gradients.
A pair is sharded only when its heads (its hidden width, for a feed-forward)
divide by the model axis, and stays replicated with a log line otherwise:
GSPMD can reshard inside a head, a process cannot without a copy.  A packed
q|k|v weight is cut per head out of each third (``parts`` 3), so a rank's
product is the packed [.., 3 D/M] that ``clip_mha`` reads as it is.

A dropout mask on a sharded activation is drawn at full width and sliced
(``rand``), so a run at MODEL 2 draws the masks of the run at MODEL 1 and
its generator advances alike.

Every sharded parameter carries its ``tp_spec``: checkpoints gather the
slices into the full tensor (``Spec.gather``), and a full tensor (an
optimizer moment, an EMA copy) is cut to the rank's slice with
``Spec.take``.  With no model axis nothing here runs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from clip_fsar_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """This process's place on the model axis: the model group, its rank there and the axis size."""

    group: object
    rank: int
    size: int


@dataclasses.dataclass(frozen=True)
class Spec:
    """How a parameter is cut: dimension ``dim`` of the full shape ``full``
    is ``parts`` runs (3 for a packed q|k|v), each split into ``shard.size``
    contiguous slices; the rank keeps slice ``shard.rank`` of every run."""

    dim: int
    parts: int
    full: torch.Size
    shard: ModelShard

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's slice of a tensor of the full shape."""
        n, size = self.full[self.dim], self.shard.size
        runs = t.unflatten(self.dim, (self.parts, size, n // (self.parts * size)))
        return runs.select(self.dim + 1, self.shard.rank).flatten(self.dim, self.dim + 1).contiguous()

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The full tensor from every model rank's slice ``t`` (a collective of the model group)."""
        pieces = [torch.empty_like(t) for _ in range(self.shard.size)]
        dist.all_gather(pieces, t.contiguous(), group=self.shard.group)
        runs = torch.stack([p.unflatten(self.dim, (self.parts, -1)) for p in pieces], dim=self.dim + 1)
        return runs.flatten(self.dim, self.dim + 2)


def spec(p: torch.Tensor) -> Optional[Spec]:
    return getattr(p, "tp_spec", None)


def full_shape(p: torch.Tensor) -> tuple:
    """The parameter's shape before it was sharded."""
    s = spec(p)
    return tuple(s.full) if s is not None else tuple(p.shape)


def shard_param(p: nn.Parameter, shard: ModelShard, dim: int, parts: int = 1) -> None:
    """Keep the rank's slice of ``p`` in place (the same Parameter object)."""
    s = Spec(dim, parts, p.shape, shard)
    p.data = s.take(p.data)
    p.tp_spec = s


def specs(module: nn.Module) -> Dict[str, Spec]:
    """{parameter name: Spec} of the module's sharded parameters."""
    return {n: s for n, p in module.named_parameters() if (s := spec(p)) is not None}


def gather_named(tensors: Dict[str, torch.Tensor], by_name: Dict[str, Spec]) -> Dict[str, torch.Tensor]:
    """Each sharded entry gathered to its full tensor (every model rank calls this), the rest as they are."""
    return {k: by_name[k].gather(v) if k in by_name else v for k, v in tensors.items()}


def take_named(tensors: Dict[str, torch.Tensor], by_name: Dict[str, Spec]) -> Dict[str, torch.Tensor]:
    """Each entry of a sharded parameter cut to the rank's slice, the rest as they are."""
    return {k: by_name[k].take(v) if k in by_name and tuple(v.shape) == tuple(by_name[k].full) else v for k, v in tensors.items()}


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        # a copy: under remat's ``dots`` policy x may be the saved product, which the recompute hands back
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, shard: Optional[ModelShard]) -> torch.Tensor:
    """The input of a column-parallel product: identity forward, gradient all-reduced over the model group."""
    return x if shard is None else _CopyToModel.apply(x, shard.group)


def reduce_from_model(x: torch.Tensor, shard: Optional[ModelShard]) -> torch.Tensor:
    """A row-parallel partial product summed over the model group; identity backward."""
    return x if shard is None else _ReduceFromModel.apply(x, shard.group)


def rand(shape: Sequence[int], generator: torch.Generator, device, shard: Optional[ModelShard] = None, dim: int = -1) -> torch.Tensor:
    """``torch.rand(shape)``; for a tensor sharded on ``dim``, the rank's
    slice of the draw at full width (the draw of the unsharded run)."""
    if shard is None:
        return torch.rand(tuple(shape), generator=generator, device=device)
    full = list(shape)
    full[dim] *= shard.size
    return torch.rand(full, generator=generator, device=device).narrow(dim, shard.rank * shape[dim], shape[dim])


def global_norm(tensors: List[torch.Tensor], params: List[torch.Tensor]) -> torch.Tensor:
    """The L2 norm over every tensor in full (``tensors[i]`` shaped as
    ``params[i]``): a sharded one's squares summed over the model group, a
    replicated one's counted once.  The unsharded formula when none is sharded."""
    sharded = [spec(p) for p in params]
    if not any(s is not None for s in sharded):
        return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t) for t in tensors]))
    group = next(s for s in sharded if s is not None).shard.group
    sq = lambda ts: torch.stack([torch.linalg.vector_norm(t).square() for t in ts]).sum() if ts else torch.zeros((), device=tensors[0].device)  # noqa: E731
    part = sq([t for t, s in zip(tensors, sharded) if s is not None])
    dist.all_reduce(part, group=group)
    return torch.sqrt(part + sq([t for t, s in zip(tensors, sharded) if s is None]))


def tensor_norm(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """||t|| of the full tensor, ``t`` shaped as parameter ``p``."""
    s = spec(p)
    if s is None:
        return torch.linalg.vector_norm(t)
    sq = torch.linalg.vector_norm(t).square()
    dist.all_reduce(sq, group=s.shard.group)
    return torch.sqrt(sq)


def shard_module(module: nn.Module, shard: Optional[ModelShard]) -> int:
    """Shard every pair of ``module`` that can be (each module class with a
    ``shard_`` method places its own), after the full model is built and its
    weights loaded; returns the pairs sharded.  A pair that stays replicated
    is named in one log line.  Nothing happens without a model axis."""
    if shard is None:
        return 0
    done = 0
    for name, m in module.named_modules():
        place = getattr(m, "shard_", None)
        if place is None:
            continue
        why = place(shard)
        if why:
            logger.info("tensor parallel: %s stays replicated (%s)", name or type(m).__name__, why)
        else:
            done += 1
    logger.info("tensor parallel: %d pairs sharded over %d model ranks", done, shard.size)
    return done
