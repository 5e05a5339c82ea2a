"""Model statistics and device memory in the log, and the classification
trainer's eval and checkpoint cadence (counterpart of
clip_fsar_tpu/utils/misc.py:23-111, reference utils/misc.py:40-180).

The JAX package also reports XLA's cost analysis of the compiled step
(``compiled_stats``); eager torch compiles nothing, so the line holds the
parameter count and, on a card, the allocator's memory figures under the
JAX package's key names.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import math

import torch

from clip_fsar_torch.parallel.tensor import full_shape
from clip_fsar_torch.utils.logging import get_logger, log_json_stats

logger = get_logger(__name__)


def params_count(module: torch.nn.Module) -> int:
    """Total number of parameter elements (reference misc.py:40-50); buffers
    such as BatchNorm running stats are not parameters, as flax's
    ``batch_stats`` are not ``params``.  A tensor-parallel parameter counts
    in full, as the JAX package counts a sharded array."""
    return int(sum(math.prod(full_shape(p)) for p in module.parameters()))


def device_mem_usage(device) -> Optional[Dict[str, float]]:
    """The card's memory in MB (reference gpu_mem_usage, misc.py:52-66):
    bytes the caching allocator holds for tensors now and at its peak, and
    the card's total.  None on the CPU, as the JAX package returns None
    where the backend has no memory stats."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    mb = 1024.0 * 1024.0
    return {
        "bytes_in_use_mb": round(stats.get("allocated_bytes.all.current", 0) / mb, 1),
        "peak_bytes_in_use_mb": round(stats.get("allocated_bytes.all.peak", 0) / mb, 1),
        "bytes_limit_mb": round(total / mb, 1),
    }


def log_model_info(module: torch.nn.Module, label: str = "model", device=None) -> Dict[str, Any]:
    """Log one ``{"_type": "model_info", "label": ..., "params": ...}`` line
    (reference log_model_info, misc.py:145-165), with the memory figures of
    ``device`` when it is a card.  Returns the logged entries."""
    info: Dict[str, Any] = {"_type": "model_info", "label": label, "params": params_count(module)}
    mem = device_mem_usage(device if device is not None else next(module.parameters()).device)
    if mem:
        info.update(mem)
    log_json_stats(info, logger)
    return info


def _pretraining(cfg) -> bool:
    return bool(cfg.PRETRAIN.get("ENABLE", False)) if "PRETRAIN" in cfg else False


def is_eval_epoch(cfg, cur_epoch: int) -> bool:
    """Evaluate after epoch ``cur_epoch`` (0-based) when cur_epoch + 1 is a
    multiple of TRAIN.EVAL_PERIOD, or in the last 10 epochs outside
    pretraining; never with EVAL_PERIOD 0 (JAX misc.py:88-99)."""
    period = int(cfg.TRAIN.get("EVAL_PERIOD", 0) or 0)
    if period == 0:
        return False
    if cur_epoch + 1 >= int(cfg.SOLVER.MAX_EPOCH) - 10 and not _pretraining(cfg):
        return True
    return (cur_epoch + 1) % period == 0


def is_checkpoint_epoch(cfg, cur_epoch: int) -> bool:
    """Checkpoint after epoch ``cur_epoch`` on TRAIN.CHECKPOINT_PERIOD
    multiples, at the last epoch, and in the last 10 epochs outside
    pretraining (JAX misc.py:102-111)."""
    max_epoch = int(cfg.SOLVER.MAX_EPOCH)
    if cur_epoch + 1 >= max_epoch - 10 and not _pretraining(cfg):
        return True
    period = int(cfg.TRAIN.get("CHECKPOINT_PERIOD", 10) or 10)
    return (cur_epoch + 1) % period == 0 or cur_epoch + 1 == max_epoch
