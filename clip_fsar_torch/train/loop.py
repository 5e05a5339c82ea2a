"""Few-shot train and test loops (counterpart of
clip_fsar_tpu/train/loop.py:47-368).

Iteration accounting as in the JAX package: one step consumes
TPU.EPISODES_PER_STEP episodes and corresponds to one reference iteration,
so the LR schedule, VAL_FRE_ITER and NUM_TRAIN_TASKS transfer unchanged;
with TRAIN.BATCH_SIZE_PER_TASK = k the optimizer updates every k steps.
The train loop reads metrics back from the device only where it logs,
validates or ends (one read for all the steps since the last), so the host
runs ahead of the card between those steps and the next batch's copy is
started while the card still works on the step before.

``TPU.EVAL_FRAME_BANK`` runs the test protocol, and the interleaved
validations, off a card-resident bank of the split's frames, and
``TPU.TRAIN_FRAME_BANK`` trains off one (data/frame_bank.py): the loader
then ships int32 bank rows instead of pixels.  As in the JAX package
(loop.py:63-83, 225-238, 253-263), the val bank is built once and serves
every interleaved validation.
"""

from __future__ import annotations

import collections
import contextlib
import statistics
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from clip_fsar_torch.data.frame_bank import (
    FrameBank,
    IndexEpisodeSampler,
    TrainIndexEpisodeSampler,
    build_eval_frame_bank,
    build_train_frame_bank,
)
from clip_fsar_torch.data.loader import build_few_shot_loader
from clip_fsar_torch.models.builder import FewShotModel, build_few_shot_model, tower_execution
from clip_fsar_torch.parallel import mesh, tensor
from clip_fsar_torch.train.checkpoint import Checkpointer, auto_resume, load_checkpoint_file, load_test_weights
from clip_fsar_torch.train.optimizer import Optimizer, epoch_for_iter, get_lr_at_epoch
from clip_fsar_torch.train.pretrain import surgery_flags
from clip_fsar_torch.train.state import TrainState
from clip_fsar_torch.train.step import make_eval_step, make_train_step
from clip_fsar_torch.utils import tracing
from clip_fsar_torch.utils.logging import get_logger, log_json_stats, setup_logging
from clip_fsar_torch.utils.misc import log_model_info

logger = get_logger(__name__)


def _bank_info(bank: FrameBank) -> Dict[str, float]:
    return {"gb": bank.nbytes / 1e9, "build_seconds": bank.build_seconds, "upload_seconds": bank.upload_seconds}


def evaluate(
    cfg, model: FewShotModel, num_tasks: int, episodes_per_step: int, split: str = "test", device=None, bank: Optional[FrameBank] = None,
) -> Dict[str, Any]:
    """Episode-sampled evaluation: top-1/top-5 over exactly ``num_tasks``
    episodes plus per-class top-1 (reference test_net_few_shot.py:35-224).

    With ``bank`` the episodes are gathered from that eval frame bank; without
    one, TPU.EVAL_FRAME_BANK builds the split's bank on ``device`` first (a
    caller that evaluates repeatedly builds it once and passes it).

    Under a process group ``episodes_per_step`` is rounded up to a multiple
    of the ranks (as the JAX package rounds it to its data mesh), each rank
    runs its slots of every step, and the per-episode outputs are gathered
    in global episode order before they are counted: every rank returns the
    same stats.

    Returns the JAX package's stats (top1_acc, top5_acc, loss, episodes)
    plus ``per_class`` (top-1 per real class, by class name), ``episode_logits``
    [num_tasks, Q, WAY], ``seconds``, the wall time of the episode loop (data
    included, model and bank builds excluded), ``h2d_bytes_per_step``, the
    bytes of one batch the host copies to this rank's device, and, where a
    bank served, ``frame_bank`` (its GB and the seconds of its build and
    upload)."""
    data = mesh.build_mesh(cfg, device)
    device = data.device
    e = mesh.round_to_data_mesh(episodes_per_step, data)
    num_steps = max(-(-num_tasks // e), 1)  # surplus episodes of the last step are not counted
    if bank is None and "TPU" in cfg and bool(cfg.TPU.get("EVAL_FRAME_BANK", False)):
        bank = build_eval_frame_bank(cfg, split, device)
    sampler_wrap = None if bank is None else (lambda sampler: IndexEpisodeSampler(sampler, bank.table))
    eval_step = make_eval_step(model.head, cfg, model.text_train, model.text_test, None if bank is None else bank.pixels)

    top1 = top5 = count = 0
    loss_sum = 0.0
    episodes_left = num_tasks
    per_class = collections.defaultdict(lambda: [0.0, 0])  # real label -> [correct, total]
    logits_kept = []
    queries = 0

    def consume(out: Dict[str, torch.Tensor], step: int) -> None:
        nonlocal top1, top5, count, loss_sum, episodes_left, queries
        with tracing.span("fsar.eval.fetch", step=step):
            out = {k: v.cpu().numpy() for k, v in out.items()}  # waits for the step
        with tracing.span("fsar.eval.account", step=step):
            take = min(e, episodes_left)
            episodes_left -= take
            top1 += int(out["top1_correct"][:take].sum())
            top5 += int(out["top5_correct"][:take].sum())
            count += int(out["count"][:take].sum())
            queries = int(out["count"][0])
            loss_sum += float(out["loss"][:take].mean())
            logits_kept.append(out["logits"][:take])
            for real, corr in zip(out["real_labels"][:take].reshape(-1), out["correct"][:take].reshape(-1)):
                per_class[int(real)][0] += float(corr)
                per_class[int(real)][1] += 1

    log_every = 50
    pending: Optional[Dict[str, torch.Tensor]] = None
    h2d_bytes = 0
    t0 = time.perf_counter()
    with build_few_shot_loader(cfg, split, num_steps=num_steps, episodes_per_step=e, sampler_wrap=sampler_wrap,
                               episode_range=mesh.local_episode_range(e, data)) as loader:
        for steps_done, batch in enumerate(loader):
            h2d_bytes = _batch_bytes(batch)
            # launch step N (and its gather) before fetching step N-1, so
            # host-side metric accounting overlaps the device's next batch
            out = eval_step(mesh.retry_transient(lambda: batch.to(device, non_blocking=True), "eval batch upload"))  # noqa: B023
            fut = {k: mesh.all_gather_rows(v) for k, v in out.items()}
            if pending is not None:
                consume(pending, steps_done - 1)
                if steps_done % log_every == 0:
                    with tracing.span("fsar.eval.account", step=steps_done - 1):
                        done = num_tasks - episodes_left
                        log_json_stats(
                            {
                                "_type": f"eval_{split}_iter",
                                "episodes": done,
                                "of": num_tasks,
                                "top1_acc": round(top1 / max(count, 1) * 100.0, 2),
                                "eps_per_sec": round(done / max(time.perf_counter() - t0, 1e-9), 2),
                            },
                            logger,
                        )
            pending = fut
        if pending is not None:
            consume(pending, steps_done)
    seconds = time.perf_counter() - t0

    stats = {
        "top1_acc": top1 / max(count, 1) * 100.0,
        "top5_acc": top5 / max(count, 1) * 100.0,
        "loss": loss_sum / max(num_steps, 1),
        "episodes": count // max(queries, 1),
    }
    class_names = list(cfg.TEST.get("CLASS_NAME", []) or [])
    per_class_acc = {
        class_names[k] if k < len(class_names) else str(k): round(v[0] / max(v[1], 1) * 100.0, 2) for k, v in sorted(per_class.items())
    }
    log_json_stats({"_type": f"eval_{split}", **stats}, logger)
    log_json_stats({"_type": "eval_per_class", **per_class_acc}, logger)
    out = {**stats, "per_class": per_class_acc, "episode_logits": np.concatenate(logits_kept), "seconds": seconds,
           "h2d_bytes_per_step": h2d_bytes}
    if bank is not None:
        out["frame_bank"] = _bank_info(bank)
    return out


def _episodes_per_step(e: int, data: mesh.Mesh) -> int:
    """``e`` rounded up to a multiple of the data ranks, with the JAX
    package's log lines (loop.py:184-195)."""
    rounded = mesh.round_to_data_mesh(e, data)
    if rounded != e:
        logger.info("TPU.EPISODES_PER_STEP=%d is not divisible by the %d-device data mesh — rounding up to %d episodes/step",
                    e, mesh.data_axis_size(data), rounded)
    mesh.check_batch_divisible(rounded, data)
    logger.info("mesh: %d devices on axis 'data'%s; %d episodes/step", data.data,
                f", {data.model} on axis 'model'" if data.model > 1 else "", rounded)
    return rounded


def _batch_bytes(batch) -> int:
    """Bytes of a host batch's arrays: what one step copies to the device."""
    return sum(v.nbytes for v in vars(batch).values() if v is not None)


def step_generator(cfg, step: int, device) -> torch.Generator:
    """The generator of train step ``step`` (jitter draws and dropout),
    seeded from RANDOM_SEED + 1 and the step index, so a resumed run draws
    what an uninterrupted one would."""
    seed = np.random.SeedSequence((int(cfg.get("RANDOM_SEED", 0)) + 1, step)).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


@contextlib.contextmanager
def _weights(head: torch.nn.Module, state_dict: Dict[str, torch.Tensor]):
    """Run the head with ``state_dict`` loaded, then put its own weights back."""
    own = {k: v.clone() for k, v in head.state_dict().items()}
    head.load_state_dict(state_dict)
    try:
        yield head
    finally:
        head.load_state_dict(own)


def check_run_cfg(cfg, training: bool) -> None:
    """Before any work: refuse the config keys that would change the run's
    layout and that this port does not act on yet (TPU.MESH beyond data
    parallelism over the process group's ranks:
    ``parallel.mesh.check_mesh_cfg``), and say in one log line which
    speed-only keys it leaves aside (the results are the same without them)."""
    mesh.check_mesh_cfg(cfg, mesh.world_size())
    if "TPU" not in cfg:
        return
    if tower_execution(cfg)[1]:  # the JAX package's scan over depth (model.py:282-289) changes how XLA compiles it, not the math
        logger.info("TPU.SCAN_LAYERS set: eager torch runs the tower's blocks as a loop either way (same episodes and results, "
                    "other speed)")


def train_few_shot(cfg, device=None) -> Dict[str, Any]:
    """Episodic training: NUM_TRAIN_TASKS steps of TPU.EPISODES_PER_STEP
    episodes, validation on the val split every VAL_FRE_ITER steps (and on
    the EMA weights too when MODEL.EMA is on), a checkpoint at each
    validation and at the end, auto-resume from OUTPUT_DIR.  Returns the JAX
    package's stats (best_val_top1, final_iter) plus the per-step losses,
    the optimizer updates made, whether TRAIN.CHECKPOINT_FILE_PATH gave the
    start weights (``init_weights``: that path or "fresh"; a resumed run says
    "resumed"), the wall seconds of the step loop (data
    included, model and bank builds excluded), the part of them spent
    validating and checkpointing, the steps this call ran, and, where frame
    banks served (TPU.TRAIN_FRAME_BANK; TPU.EVAL_FRAME_BANK for the
    validations), ``frame_banks``: each one's GB and the seconds of its build
    and upload.  Logs the model_info line under LOG_MODEL_INFO.  Runs on the
    card unless ``device`` names the CPU.

    Joins the process group the environment describes (torchrun;
    ``parallel.mesh.maybe_init_distributed``) or runs under the caller's:
    TPU.EPISODES_PER_STEP is then the global E, rounded up to a multiple of
    the ranks, each rank samples its slots of every step, the start weights
    are rank 0's, and every step is the global one (train/step.py); rank 0
    logs and writes the checkpoints, and every rank returns the same stats."""
    setup_logging(cfg.get("OUTPUT_DIR", None))
    mesh.maybe_init_distributed(cfg, mesh.backend_for(device))
    data = mesh.build_mesh(cfg, device)
    check_run_cfg(cfg, training=True)
    device = data.device
    e = _episodes_per_step(int(cfg.TPU.get("EPISODES_PER_STEP", 1)), data)
    model = build_few_shot_model(cfg, flow="train", device=device)
    state = TrainState.create(cfg, model.head, Optimizer(cfg, model.head))
    if cfg.get("LOG_MODEL_INFO", False):
        log_model_info(model.head, label=f"{cfg.VIDEO.HEAD.NAME}/{cfg.VIDEO.HEAD.BACKBONE_NAME}", device=device)
    ckpt = Checkpointer(cfg.OUTPUT_DIR)
    start_iter = auto_resume(cfg, ckpt, state) or 0
    init_weights = "resumed" if start_iter else "fresh"
    if start_iter:
        logger.info("auto-resumed at iteration %d", start_iter)
    elif cfg.TRAIN.get("CHECKPOINT_FILE_PATH", "") and load_checkpoint_file(str(cfg.TRAIN.CHECKPOINT_FILE_PATH), model.head, cfg.VIDEO.HEAD.NAME,
                                                                            cfg, *surgery_flags(cfg)):
        init_weights = str(cfg.TRAIN.CHECKPOINT_FILE_PATH)
        if state.ema is not None:
            state.ema = {n: p.detach().clone() for n, p in model.head.named_parameters()}
    mesh.broadcast_module(model.head)
    state.shard_(data.model_shard)
    train_bank = build_train_frame_bank(cfg, device) if bool(cfg.TPU.get("TRAIN_FRAME_BANK", False)) else None
    train_wrap = None if train_bank is None else (lambda sampler: TrainIndexEpisodeSampler(sampler, train_bank.table))
    train_step = make_train_step(model.head, cfg, model.text_train, model.text_test, None if train_bank is None else train_bank.pixels)

    num_train_tasks = int(cfg.TRAIN.NUM_TRAIN_TASKS)
    val_every = int(cfg.TRAIN.get("VAL_FRE_ITER", 0) or 0)
    num_val_tasks = int(cfg.TRAIN.get("NUM_VAL_TASKS", 500))
    e_val = int(cfg.TPU.get("EVAL_EPISODES_PER_STEP", 0) or e)
    # interleaved validation runs on the val split (reference train_net_few_shot.py:78-82); one bank serves them all
    val_bank = build_eval_frame_bank(cfg, "val", device) if val_every and bool(cfg.TPU.get("EVAL_FRAME_BANK", False)) else None
    log_period = int(cfg.get("LOG_PERIOD", 10))
    window = collections.deque(maxlen=log_period)
    best = {"top1_acc": 0.0}
    losses, updates, val_seconds = [], 0, 0.0
    pending = []  # metrics of the steps since the last fetch, still on the device

    def fetch() -> float:
        """Bring the pending steps' metrics to the host in one read (it waits
        for the last of those steps); returns the last step's top1."""
        nonlocal updates
        rows = torch.stack([torch.stack([m["loss"], m["top1"], m["updated"].to(m["loss"].dtype)]) for m in pending]).tolist()
        pending.clear()
        for loss, _, updated in rows:
            losses.append(loss)
            window.append(loss)
            updates += int(updated)
        return rows[-1][1]

    remaining = max(num_train_tasks - start_iter, 0)
    logger.info("train loop: %d iterations x %d episodes/step on %s", remaining, e, device)
    t0 = time.perf_counter()
    with build_few_shot_loader(cfg, "train", num_steps=remaining, episodes_per_step=e, start_step=start_iter, sampler_wrap=train_wrap,
                               episode_range=mesh.local_episode_range(e, data)) as loader:
        cur_iter = start_iter
        t_last, iters_last = time.perf_counter(), cur_iter
        for batch in loader:
            lr = get_lr_at_epoch(cfg, epoch_for_iter(cfg, cur_iter))
            on_device = mesh.retry_transient(lambda: batch.to(device, non_blocking=True), "train batch upload")  # noqa: B023
            pending.append(train_step(state, on_device, lr, step_generator(cfg, cur_iter, device)))
            cur_iter += 1
            if cur_iter % log_period == 0 or cur_iter == num_train_tasks:
                top1 = fetch()
                now = time.perf_counter()
                log_json_stats(
                    {
                        "_type": "train_iter",
                        "iter": f"{cur_iter}/{num_train_tasks}",
                        "loss": round(statistics.median(window), 5),
                        "top1": round(top1 * 100, 2),
                        "lr": lr,
                        "eps_per_sec": round(e * (cur_iter - iters_last) / max(now - t_last, 1e-9), 3),
                    },
                    logger,
                )
                t_last, iters_last = now, cur_iter
            if val_every and cur_iter % val_every == 0:
                if pending:
                    fetch()
                t_val = time.perf_counter()
                ckpt.save(cur_iter, state)
                stats = evaluate(cfg, model, num_val_tasks, e_val, split="val", device=device, bank=val_bank)
                if stats["top1_acc"] >= best["top1_acc"]:
                    best = stats
                if state.ema is not None:
                    with _weights(model.head, state.ema_variables()):
                        evaluate(cfg, model, num_val_tasks, e_val, split="val", device=device, bank=val_bank)
                val_seconds += time.perf_counter() - t_val
                t_last, iters_last = time.perf_counter(), cur_iter  # keep validation out of the rate window
    if pending:
        fetch()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    ckpt.save(max(num_train_tasks, 1), state)
    logger.info("training done at iter %d; best interleaved top1=%.3f", num_train_tasks, best["top1_acc"])
    banks = {name: _bank_info(b) for name, b in (("train", train_bank), ("val", val_bank)) if b is not None}
    return {
        "best_val_top1": best["top1_acc"],
        "final_iter": num_train_tasks,
        "losses": losses,
        "updates": updates,
        "init_weights": init_weights,
        "seconds": seconds,
        "val_seconds": val_seconds,
        "steps": len(losses),
        **({"frame_banks": banks} if banks else {}),
    }


def test_few_shot(cfg, device=None) -> Dict[str, Any]:
    """The few-shot test protocol: build the model, pick its weights
    (checkpoint search), run TRAIN.NUM_TEST_TASKS episodes in steps of
    TEST.BATCH_SIZE episodes.  The stats say which weights were tested
    (``weights``: a checkpoint path or "fresh").  Runs on the card unless
    ``device`` names the CPU; under a process group as ``train_few_shot``
    says, every rank testing rank 0's weights on its slots of each step."""
    setup_logging(cfg.get("OUTPUT_DIR", None))
    mesh.maybe_init_distributed(cfg, mesh.backend_for(device))
    data = mesh.build_mesh(cfg, device)
    check_run_cfg(cfg, training=False)
    device = data.device
    model = build_few_shot_model(cfg, flow="test", device=device)
    weights = load_test_weights(cfg, model.head)
    mesh.broadcast_module(model.head)
    tensor.shard_module(model.head, data.model_shard)
    num_tasks = int(cfg.TRAIN.get("NUM_TEST_TASKS", 10000))
    e = _episodes_per_step(int(cfg.TEST.get("BATCH_SIZE", cfg.TPU.get("EPISODES_PER_STEP", 1))), data)
    logger.info("few-shot test: %d episodes, %d per step, on %s", num_tasks, e, device)
    return {**evaluate(cfg, model, num_tasks, e, device=device), "weights": weights}
