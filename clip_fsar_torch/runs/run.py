"""CLI entry point of the port (counterpart of clip_fsar_tpu/runs/run.py:61-140).

    python -m clip_fsar_torch.runs.run --cfg configs/projects/CLIPFSAR/hmdb51/CLIPFSAR_HMDB51_1shot_v1.yaml [--device cpu] [KEY.SUB value ...]

Runs on the CUDA card and fails without one; ``--device cpu`` (before the
overrides) asks for the CPU, where the kernels' plain versions run.

Data parallel over N cards of a host (or N CPU processes with ``--device
cpu``), one process per card, through torchrun:

    torchrun --nproc_per_node=N -m clip_fsar_torch.runs.run --cfg ... [--device cpu] [KEY.SUB value ...]

The ranks join one process group before the runners (NCCL on cards, gloo on
the CPU; parallel/mesh.py) and leave it after them.  TPU.EPISODES_PER_STEP,
TPU.EVAL_EPISODES_PER_STEP and TEST.BATCH_SIZE are global episode counts,
each rank runs its slice of every step, and the results are those of one
process running them all.
Dispatches on TASK_TYPE and queues the runs in the JAX package's order.
The few-shot runners are ported (``TRAIN.ENABLE True`` trains, then tests
the last checkpoint); every other runner raises NotImplementedError before
any work starts.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from clip_fsar_torch import runtime
from clip_fsar_torch.config.config import load_config, parse_args
from clip_fsar_torch.parallel import mesh
from clip_fsar_torch.train.loop import test_few_shot, train_few_shot
from clip_fsar_torch.utils.logging import get_logger, setup_logging

logger = get_logger(__name__)

_RUNNERS = {"train_few_shot": train_few_shot, "test_few_shot": test_few_shot}
# runners not ported yet -> the ROADMAP item that brings them
_NOT_PORTED = {
    "train": "classification / pretrain (ROADMAP Queue 1, breadth)",
    "test": "classification (ROADMAP Queue 1, breadth)",
    "submission_classification": "classification (ROADMAP Queue 1, breadth)",
    "train_localization": "localization (ROADMAP Queue 1, breadth)",
    "test_epic_localization": "localization (ROADMAP Queue 1, breadth)",
    "submission_test": "localization (ROADMAP Queue 1, breadth)",
}


def _run_list(cfg) -> List[tuple]:
    """[(cfg, runner_name)], each with its own copy of the config (the JAX
    run list without the multi-scale re-test, which is classification-only)."""
    task = cfg.get("TASK_TYPE", "classification")
    runs: List[tuple] = []
    if task == "few_shot_action":
        if cfg.TRAIN.get("ENABLE", False):
            runs.append((cfg.deep_copy(), "train_few_shot"))
        runs.append((cfg.deep_copy(), "test_few_shot"))
    elif task == "classification":
        if cfg.TRAIN.get("ENABLE", False):
            runs.append((cfg.deep_copy(), "train"))
        if cfg.TEST.get("ENABLE", False):
            runs.append((cfg.deep_copy(), "test"))
        if cfg.get("SUBMISSION", {}).get("ENABLE", False):
            runs.append((cfg.deep_copy(), "submission_classification"))
    elif task == "localization":
        if cfg.TRAIN.get("ENABLE", False):
            runs.append((cfg.deep_copy(), "train_localization"))
        runs.append((cfg.deep_copy(), "test_epic_localization"))
    elif task == "submission":
        runs.append((cfg.deep_copy(), "submission_test"))
    elif task == "pretrain":
        runs.append((cfg.deep_copy(), "train"))
    else:
        raise ValueError(f"Unknown TASK_TYPE {task!r}")
    return runs


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Run the queued runners; returns each runner's result by name."""
    args = parse_args(argv)
    runtime.device(args.device)  # no card and no --device cpu: raises here, before any work
    cfg = load_config(args.cfg_file, args.opts)
    runs = _run_list(cfg)
    for _, name in runs:  # refuse before any work starts, never skip silently
        if name in _NOT_PORTED:
            raise NotImplementedError(f"runner {name!r} is not ported yet: {_NOT_PORTED[name]}")
    joined = mesh.maybe_init_distributed(cfg, mesh.backend_for(args.device))
    try:
        device = runtime.device(args.device)  # under a process group: this rank's card
        setup_logging(cfg.get("OUTPUT_DIR", None))
        logger.info("TASK_TYPE=%s OUTPUT_DIR=%s", cfg.get("TASK_TYPE"), cfg.get("OUTPUT_DIR"))
        if cfg.get("LOG_CONFIG_INFO", True) and cfg.get("OUTPUT_DIR", None) and mesh.rank() == 0:
            cfg.dump(os.path.join(cfg.OUTPUT_DIR, str(cfg.get("OUTPUT_CFG_FILE", "configuration.log"))))
        results = {}
        for run_cfg, name in runs:
            logger.info("=== run: %s ===", name)
            results[name] = _RUNNERS[name](run_cfg, device=device)
        return results
    finally:
        if joined:
            mesh.destroy()


if __name__ == "__main__":
    main()
