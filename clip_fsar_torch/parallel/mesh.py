"""Data and tensor parallelism over torch.distributed (counterpart of
clip_fsar_tpu/parallel/mesh.py).

The JAX package runs one program over a (data, model) mesh: episode batches
are sharded on their leading axis over ``data``, the transformer matmuls
over ``model`` (``parallel/tensor.py``), every other parameter is
replicated, GSPMD inserts the gradient psum, and eval outputs come back
replicated.  Here each rank is one process with its own card (NCCL) or its
own CPU (gloo), and the same semantics are spelled out:

- the ranks form a grid of TPU.MESH.DATA x TPU.MESH.MODEL in the JAX
  package's ``reshape(data, model)`` order: rank = d * MODEL + m, so a
  model group is consecutive ranks (one host's where it can be), and the
  ranks of one data column form a data group;
- every rank holds the same weights (``broadcast_module`` sends rank 0's
  full weights at the start), then keeps its model slice of each sharded
  pair (``tensor.shard_module``);
- data rank d samples the episode slots ``local_episode_range`` of every
  global step (the loader's ``episode_range``; per-(step, slot) seeding
  makes the global batch sliceable): the ranks of one model group draw the
  same episodes;
- the train step all-reduces the gradient to its mean over the data group
  once, after its episode-chunk loop (``all_reduce_grads``), and the
  metrics and the live BatchNorms' running statistics too
  (``all_reduce_mean``), so every rank takes the same update;
- the eval loop gathers the per-episode outputs over the data group in
  rank order (``all_gather_rows``), which is the global episode order.

With no process group every function here is the identity, and a run is the
one-card run it was.  With MODEL 1 the data group is the whole world, as it
was before the model axis.  The mesh must cover the world: DATA x MODEL =
world (DATA -1 means world / MODEL), since a process group does not shrink.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Callable, Dict, Iterable, List, Optional, TypeVar

import torch
import torch.distributed as dist

from clip_fsar_torch.parallel import tensor
from clip_fsar_torch.utils.logging import get_logger

logger = get_logger(__name__)

_T = TypeVar("_T")

# a lost peer fails a collective after this long instead of hanging the run
TIMEOUT = datetime.timedelta(minutes=10)
BUCKET_BYTES = 256 << 20  # gradients are all-reduced in flat buckets of at most this size


def distributed() -> bool:
    """Whether this process is a rank of a process group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if distributed() else 1


def rank() -> int:
    return dist.get_rank() if distributed() else 0


def local_rank() -> int:
    """This rank's card on its host: LOCAL_RANK (torchrun sets it), else the
    rank modulo the host's card count (one card: every rank on card 0)."""
    if not distributed():
        return 0
    if os.environ.get("LOCAL_RANK"):
        return int(os.environ["LOCAL_RANK"])
    return rank() % max(torch.cuda.device_count(), 1)


def local_world_size() -> int:
    """The ranks on this host: LOCAL_WORLD_SIZE (torchrun sets it), else all of them."""
    return int(os.environ.get("LOCAL_WORLD_SIZE") or world_size())


def host_leader() -> bool:
    """Whether this rank is the first of its host (every process without a group)."""
    return rank() % local_world_size() == 0


def backend_for(device_kind: Optional[str]) -> str:
    """NCCL for ranks on cards, gloo for ranks on the CPU (``--device cpu``)."""
    return "gloo" if torch.device(device_kind or "cuda").type == "cpu" else "nccl"


def retry_transient(fn: Callable[[], _T], what: str, attempts: int = 4, base_delay: float = 5.0) -> _T:
    """Run ``fn`` with bounded exponential-backoff retries on the card's
    out-of-memory error (another tenant's allocation spike on a shared card
    can fail a small upload that fits in steady state).  Wrap uploads only:
    batches and frame banks, never a train step, whose state is half updated
    after a failure.  Under a process group a rank that sleeps here holds its
    peers at their next collective, for at most ``TIMEOUT``."""
    delay = base_delay
    for k in range(attempts):
        try:
            return fn()
        except torch.OutOfMemoryError:
            if k == attempts - 1:
                raise
            # remaining sleeps: this one (base * 2^k) and those of attempts k+1 .. attempts-2 (the last one raises)
            total_backoff = base_delay * (2.0 ** (attempts - 1) - 2.0 ** k)
            logger.warning("out of device memory during %s (attempt %d/%d) - retrying in %.0f s (<=%.0f s more backoff before a "
                           "real out-of-memory error would surface)", what, k + 1, attempts, delay, total_backoff)
            time.sleep(delay)
            delay *= 2.0
    raise AssertionError("unreachable")


def maybe_init_distributed(cfg=None, backend: str = "nccl") -> bool:
    """Join the process group that the environment describes (reference
    utils/launcher.py:9-36, JAX mesh.py:227-266): WORLD_SIZE (or
    JAX_NUM_PROCESSES) above 1 with a rendezvous address -- torchrun's
    MASTER_ADDR / MASTER_PORT, or JAX_COORDINATOR_ADDRESS (or
    COORDINATOR_ADDRESS) as host:port -- or with PAI on, at rank RANK (or
    JAX_PROCESS_ID).  A single process, or a process that is already a rank
    (a caller that made the group itself), is left as it is.  Sets
    ``cfg.SHARD_ID`` / ``cfg.NUM_SHARDS`` under a group.  Returns True when
    this call made the group (its caller destroys it)."""
    made = False
    if not distributed():
        coord = os.environ.get("JAX_COORDINATOR_ADDRESS") or os.environ.get("COORDINATOR_ADDRESS")
        if not coord and os.environ.get("MASTER_ADDR"):
            coord = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
        world = int(os.environ.get("WORLD_SIZE", os.environ.get("JAX_NUM_PROCESSES", "1")) or "1")
        rank_ = int(os.environ.get("RANK", os.environ.get("JAX_PROCESS_ID", "0")) or "0")
        pai = bool(cfg.get("PAI", False)) if cfg is not None else False
        if world <= 1 or not (coord or pai):
            return False
        if not coord:
            raise RuntimeError("multi-process run requested (WORLD_SIZE>1 with PAI=true) but no coordinator address: set "
                               "JAX_COORDINATOR_ADDRESS (or COORDINATOR_ADDRESS), or MASTER_ADDR and MASTER_PORT")
        device_id = None
        if backend == "nccl":
            local = int(os.environ.get("LOCAL_RANK") or rank_ % max(torch.cuda.device_count(), 1))
            torch.cuda.set_device(local)
            device_id = torch.device("cuda", local)
        dist.init_process_group(backend, init_method=f"tcp://{coord}", world_size=world, rank=rank_, timeout=TIMEOUT, device_id=device_id)
        made = True
    if cfg is not None:  # reference cfg bookkeeping (launcher.py:21-27)
        cfg.SHARD_ID = rank()
        cfg.NUM_SHARDS = world_size()
    return made


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The run's ranks: ``data`` x ``model`` of them, rank = data_rank * model + model_rank."""

    world: int
    rank: int
    local_rank: int
    data: int
    backend: Optional[str]  # None without a process group
    device: torch.device
    model: int = 1
    data_group: object = None  # None: the whole world (MODEL 1) or no process group
    model_group: object = None  # None: no model axis

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def model_shard(self) -> Optional[tensor.ModelShard]:
        """This rank's place on the model axis (None without one)."""
        return None if self.model == 1 else tensor.ModelShard(self.model_group, self.model_rank, self.model)


def check_mesh_cfg(cfg, world: int) -> int:
    """The data axis size TPU.MESH asks for on ``world`` ranks, refusing
    (before any work) what the JAX package refuses, with its messages:
    MODEL not dividing the world, a DATA x MODEL grid larger than it, DATA
    above it; and what a process group cannot do: a grid smaller than the
    world (a process group does not shrink: launch that many processes)."""
    mesh_cfg = cfg.TPU.get("MESH", None) if (cfg is not None and "TPU" in cfg) else None
    get = mesh_cfg.get if mesh_cfg is not None else (lambda *_: -1)
    model = int(get("MODEL", 1) or 1)
    want = int(get("DATA", -1) or -1)
    if model > 1:
        if world % model:
            raise ValueError(f"TPU.MESH.MODEL={model} must divide the device count {world}")
        data = want if want > 0 else world // model
        if data * model > world:
            raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {world}")
        if data * model < world:
            raise ValueError(f"TPU.MESH {data}x{model} with {world} ranks: every rank of the process group is on the mesh, so launch "
                             f"{data * model} processes (torchrun --nproc_per_node={data * model}) or set TPU.MESH.DATA -1")
        return data
    if want > world:
        raise ValueError(f"TPU.MESH.DATA={want} but only {world} devices present")
    if 0 < want < world:
        raise ValueError(f"TPU.MESH.DATA={want} with {world} ranks: every rank of the process group is a data rank, so launch "
                         f"{want} processes (torchrun --nproc_per_node={want}) or set TPU.MESH.DATA -1")
    return world


_SUBGROUPS: Dict[tuple, tuple] = {}  # (model axis size, world group) -> (data group, model group) of this rank
_ACTIVE: tuple = (None, None)  # the (data group, model group) of the last mesh built


def _subgroups(model: int) -> tuple:
    """This rank's (data group, model group) for a model axis of ``model``,
    made the first time (every rank makes them together, in the same order)."""
    key = (model, dist.group.WORLD)
    if key not in _SUBGROUPS:
        world = world_size()
        model_group, _ = dist.new_subgroups_by_enumeration([list(range(d * model, (d + 1) * model)) for d in range(world // model)])
        data_group, _ = dist.new_subgroups_by_enumeration([list(range(m, world, model)) for m in range(model)])
        _SUBGROUPS[key] = (data_group, model_group)
    return _SUBGROUPS[key]


def build_mesh(cfg=None, device=None) -> Mesh:
    """The mesh of the current process group (one rank without one), after
    ``check_mesh_cfg``; ``device`` is the caller's device kind, resolved by
    ``runtime.device`` (under a group on a card: this rank's card).  Makes
    the mesh's data and model groups the ones the collectives below use."""
    from clip_fsar_torch import runtime

    global _ACTIVE
    world = world_size()
    data = check_mesh_cfg(cfg, world)
    model = world // data
    groups = _subgroups(model) if model > 1 else (None, None)
    _ACTIVE = groups
    return Mesh(world=world, rank=rank(), local_rank=local_rank(), data=data, backend=dist.get_backend() if distributed() else None,
                device=runtime.device(device), model=model, data_group=groups[0], model_group=groups[1])


def data_size() -> int:
    """The ranks on the data axis of the last mesh built (the world with MODEL 1)."""
    return dist.get_world_size(_ACTIVE[0]) if (_ACTIVE[0] is not None and distributed()) else world_size()


def data_rank() -> int:
    """This rank's place on the data axis of the last mesh built (its rank with MODEL 1)."""
    return dist.get_rank(_ACTIVE[0]) if (_ACTIVE[0] is not None and distributed()) else rank()


def data_axis_size(mesh: Mesh) -> int:
    return mesh.data


def round_to_data_mesh(episodes_per_step: int, mesh: Mesh) -> int:
    """Round UP to a data-axis multiple (each rank takes an equal slice;
    rounding down would silently shrink the configured batch)."""
    n = data_axis_size(mesh)
    return max(-(-int(episodes_per_step) // n), 1) * n


def check_batch_divisible(episodes_per_step: int, mesh: Mesh) -> None:
    n = data_axis_size(mesh)
    if episodes_per_step % n:
        raise ValueError(f"TPU.EPISODES_PER_STEP={episodes_per_step} must be divisible by the data-mesh size {n} "
                         "(each device takes an equal episode slice)")


def local_episode_range(global_e: int, mesh: Mesh) -> tuple:
    """The contiguous [lo, hi) slice of the global episode batch this rank
    samples: data rank d of n takes rows [d E/n, (d+1) E/n), the same on
    every rank of its model group (replaces the reference's per-rank
    DataLoader sharding, utils/launcher.py:55-57)."""
    if mesh.data == 1:
        return 0, int(global_e)
    check_batch_divisible(global_e, mesh)
    per = int(global_e) // mesh.data
    return mesh.data_rank * per, (mesh.data_rank + 1) * per


def _buckets(tensors: List[torch.Tensor], limit: int) -> Iterable[List[int]]:
    """Indices of ``tensors`` in runs of one dtype and device of at most ``limit`` bytes (one tensor may exceed it)."""
    run: List[int] = []
    size = 0
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        if run and (t.dtype != tensors[run[0]].dtype or t.device != tensors[run[0]].device or size + nbytes > limit):
            yield run
            run, size = [], 0
        run.append(i)
        size += nbytes
    if run:
        yield run


@torch.no_grad()
def _reduce_mean_(tensors: List[torch.Tensor], limit: int = BUCKET_BYTES) -> None:
    """Each tensor, in place, becomes its mean over the data ranks: one
    all-reduce (a sum) per flat bucket over the data group, then a division
    by the data axis size."""
    group, n = _ACTIVE[0], data_size()
    for run in _buckets(tensors, limit):
        parts = [tensors[i] for i in run]
        flat = torch.cat([t.reshape(-1) for t in parts])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        torch._foreach_copy_(parts, [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in parts]), parts)])


def all_reduce_mean(tensors: List[torch.Tensor]) -> None:
    """Each tensor, in place, becomes its mean over the data ranks (no-op without a process group)."""
    if distributed():
        _reduce_mean_(tensors)


def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Every set ``.grad`` of ``params`` becomes its mean over the data
    ranks, in flat buckets of at most BUCKET_BYTES (no-op without a process
    group).  Every rank must hold gradients for the same parameters.  A
    sharded parameter's gradient is its slice's, a replicated one's the same
    on every model rank: neither is reduced over the model group."""
    if distributed():
        _reduce_mean_([p.grad for p in params if p.grad is not None])


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Every rank takes rank ``src``'s parameters and buffers, in flat
    buckets (no-op without a process group)."""
    if not distributed():
        return
    tensors = [t.data for t in list(module.parameters()) + list(module.buffers())]
    for run in _buckets(tensors, BUCKET_BYTES):
        parts = [tensors[i] for i in run]
        flat = torch.cat([t.reshape(-1) for t in parts])
        dist.broadcast(flat, src)
        torch._foreach_copy_(parts, [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in parts]), parts)])


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """[n, ...] on every rank -> [data * n, ...] over the data group, data
    rank 0's rows first: the global episode order.  NCCL has no bool: bools
    travel as uint8.  The identity without a process group."""
    if not distributed():
        return x
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(wire) for _ in range(data_size())]
    dist.all_gather(parts, wire, group=_ACTIVE[0])  # the list form: gloo gathers CUDA tensors in it too
    out = torch.cat(parts)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def destroy() -> None:
    """Leave the process group (and forget this host's group and the mesh's groups)."""
    global _HOST_GROUP, _ACTIVE
    _HOST_GROUP, _ACTIVE = None, (None, None)
    _SUBGROUPS.clear()
    dist.destroy_process_group()


def barrier() -> None:
    """Every rank waits here for the others (no-op without a process group)."""
    if distributed():
        dist.barrier()


def host_group():
    """The ranks of this host, as a process group (the default group when
    every rank is on this host); a host's ranks are consecutive, as torchrun
    numbers them.  Every rank must call this together the first time."""
    global _HOST_GROUP
    world, local = world_size(), local_world_size()
    if local >= world:
        return None
    if _HOST_GROUP is None:
        _HOST_GROUP, _ = dist.new_subgroups(group_size=local)
    return _HOST_GROUP


_HOST_GROUP = None


def broadcast_from_host_leader(tensor: torch.Tensor, obj: Optional[Dict] = None):
    """Local rank 0's ``tensor`` (in place) and picklable ``obj`` to every
    rank of this host; returns ``obj`` as local rank 0 holds it."""
    if not distributed():
        return obj
    group = host_group()
    src = dist.get_global_rank(group, 0) if group is not None else 0
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group, device=tensor.device if dist.get_backend(group) == "nccl" else None)
    dist.broadcast(tensor, src=src, group=group)
    return box[0]
