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
each data rank runs its slice of every step, and the results are those of
one process running them all.  With TPU.MESH.MODEL M the N ranks form a grid
of N / M data ranks by M model ranks, and the transformers' matmuls are
tensor-parallel over each model group (parallel/tensor.py):

    torchrun --nproc_per_node=4 -m clip_fsar_torch.runs.run --cfg ... TPU.MESH "{DATA: 2, MODEL: 2}"
Dispatches on TASK_TYPE and queues the runs in the JAX package's order:
few-shot training and the few-shot test protocol; classification training,
its test, the automatic multi-scale re-test (TEST.AUTOMATIC_MULTI_SCALE_TEST:
10 views, and 3 spatial crops on Kinetics and EPIC) and the EPIC submission
test; BMN training and the sliding-window EPIC test (TASK_TYPE localization)
and the EPIC detection submission (TASK_TYPE submission), which run as one
process and raise before any work under a group of more than one rank; and
MoSI self-supervised pretraining (TASK_TYPE pretrain: the classification
trainer under PRETRAIN.ENABLE, with its SSL validation).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from clip_fsar_torch import runtime
from clip_fsar_torch.config.config import load_config, parse_args
from clip_fsar_torch.parallel import mesh
from clip_fsar_torch.train import classification, localization
from clip_fsar_torch.train.loop import test_few_shot, train_few_shot
from clip_fsar_torch.utils.logging import get_logger, setup_logging

logger = get_logger(__name__)

_RUNNERS = {"train_few_shot": train_few_shot, "test_few_shot": test_few_shot, "train": classification.train, "test": classification.test,
            "submission_classification": classification.submission_test, "train_localization": localization.train_localization,
            "test_epic_localization": localization.test_epic_localization, "submission_test": localization.submission_test}
# runners that run as one process only
_ONE_PROCESS = ("train_localization", "test_epic_localization", "submission_test")


def _multi_scale_cfg(cfg):
    """The second, automatically queued classification test (JAX run.py:39-58):
    10 ensemble views x 1 crop, 3 spatial crops on Kinetics and EPIC,
    1 x 3 on ImageNet (outside pretraining) and SSv2."""
    ms = cfg.deep_copy()
    ms.LOG_MODEL_INFO = False
    ms.LOG_CONFIG_INFO = False
    ms.TEST.NUM_ENSEMBLE_VIEWS = 10
    ms.TEST.NUM_SPATIAL_CROPS = 1
    dataset = str(ms.TEST.get("DATASET", ms.TRAIN.get("DATASET", ""))).lower()
    if "kinetics" in dataset or "epickitchen" in dataset:
        ms.TEST.NUM_SPATIAL_CROPS = 3
    if "imagenet" in dataset and not ms.get("PRETRAIN", {}).get("ENABLE", False):
        ms.TEST.NUM_ENSEMBLE_VIEWS = 1
        ms.TEST.NUM_SPATIAL_CROPS = 3
    if "ssv2" in dataset:
        ms.TEST.NUM_ENSEMBLE_VIEWS = 1
        ms.TEST.NUM_SPATIAL_CROPS = 3
    ms.TEST.LOG_FILE = f"val_{ms.TEST.NUM_ENSEMBLE_VIEWS}clipsx{ms.TEST.NUM_SPATIAL_CROPS}crops.log"
    return ms


def _run_list(cfg) -> List[tuple]:
    """[(cfg, runner_name)], each with its own copy of the config (the JAX
    run list, run.py:61-99).  The pretrain task queues the classification
    trainer, which pretrains under PRETRAIN.ENABLE."""
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
            if cfg.TEST.get("AUTOMATIC_MULTI_SCALE_TEST", False):
                runs.append((_multi_scale_cfg(cfg), "test"))
        if cfg.get("SUBMISSION", {}).get("ENABLE", False):
            sub = cfg.deep_copy()
            sub.LOG_MODEL_INFO = False
            sub.TEST.NUM_ENSEMBLE_VIEWS = 10
            sub.TEST.NUM_SPATIAL_CROPS = 3
            runs.append((sub, "submission_classification"))
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
    """Run the queued runners; returns each runner's result by name (a list
    where a runner ran more than once: the classification test and its
    multi-scale re-test)."""
    args = parse_args(argv)
    runtime.device(args.device)  # no card and no --device cpu: raises here, before any work
    cfg = load_config(args.cfg_file, args.opts)
    runs = _run_list(cfg)
    world = int(os.environ.get("WORLD_SIZE", os.environ.get("JAX_NUM_PROCESSES", "1")) or "1")
    for run_cfg, name in runs:  # refuse before any work starts, never skip silently
        if name in _ONE_PROCESS and (world > 1 or mesh.world_size() > 1):
            raise NotImplementedError(f"runner {name!r} under a process group of {max(world, mesh.world_size())} ranks: the localization "
                                      "runners run as one process")
    joined = mesh.maybe_init_distributed(cfg, mesh.backend_for(args.device))
    try:
        device = runtime.device(args.device)  # under a process group: this rank's card
        setup_logging(cfg.get("OUTPUT_DIR", None))
        logger.info("TASK_TYPE=%s OUTPUT_DIR=%s", cfg.get("TASK_TYPE"), cfg.get("OUTPUT_DIR"))
        if cfg.get("LOG_CONFIG_INFO", True) and cfg.get("OUTPUT_DIR", None) and mesh.rank() == 0:
            cfg.dump(os.path.join(cfg.OUTPUT_DIR, str(cfg.get("OUTPUT_CFG_FILE", "configuration.log"))))
        results: Dict[str, Any] = {}
        for run_cfg, name in runs:
            logger.info("=== run: %s ===", name)
            result = _RUNNERS[name](run_cfg, device=device)
            results[name] = [results[name], result] if name in results else result
        return results
    finally:
        if joined:
            mesh.destroy()


if __name__ == "__main__":
    main()
