"""Process-zero logging with JSON stat lines (counterpart of
clip_fsar_tpu/utils/logging.py).

Own module rather than a reuse: the JAX one probes ``jax._src.distributed``
to find the primary process; here the rank comes from torch.distributed.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import sys
from typing import Any, Dict, Optional

_NAME = "clip_fsar_torch"


def is_primary() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class _PrimaryOnly(logging.Filter):
    """Passes records on the primary process only, asked at each record: a
    logger set up before the process group was joined goes quiet on the
    other ranks once it is."""

    def filter(self, record: logging.LogRecord) -> bool:
        return is_primary()


def setup_logging(output_dir: Optional[str] = None) -> logging.Logger:
    """Configure the package logger once: stdout on the primary process,
    plus ``<output_dir>/stdout.log`` when an output dir is given."""
    logger = logging.getLogger(_NAME)
    if getattr(logger, "_clip_fsar_configured", False):
        return logger
    logger._clip_fsar_configured = True
    logger.setLevel(logging.INFO)
    logger.propagate = False
    fmt = logging.Formatter("[%(asctime)s][%(levelname)s] %(filename)s:%(lineno)d: %(message)s", datefmt="%m/%d %H:%M:%S")
    if not is_primary():
        logger.addHandler(logging.NullHandler())
        return logger
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    sh.addFilter(_PrimaryOnly())
    logger.addHandler(sh)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, "stdout.log"))
        fh.setFormatter(fmt)
        fh.addFilter(_PrimaryOnly())
        logger.addHandler(fh)
        atexit.register(fh.close)
    return logger


def get_logger(name: str = _NAME) -> logging.Logger:
    """Child of the package logger; handlers are attached by setup_logging."""
    return logging.getLogger(name if name.startswith(_NAME) else f"{_NAME}.{name}")


def log_json_stats(stats: Dict[str, Any], logger: Optional[logging.Logger] = None) -> None:
    """Emit one machine-parsable JSON line (same format as the JAX package)."""

    def _clean(v: Any) -> Any:
        if hasattr(v, "item"):  # numpy / torch scalars
            v = v.item()
        if isinstance(v, float):
            return float(f"{v:.6g}")
        return v

    (logger or get_logger()).info("json_stats: %s", json.dumps({k: _clean(v) for k, v in stats.items()}, sort_keys=True))
