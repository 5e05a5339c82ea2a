"""Where the time of the few-shot train slice goes on a CUDA card.

    python -m clip_fsar_torch.tools.profile_train [--out chiprun_out/profile_train.txt]
        [--sections loader,step,loop] [--paths fused,pallas] [--loop-steps 18] [--backbone RN50 | ViT-L/14@336px]
        [--cfg configs/projects/MoLo/hmdb51/MoLo_HMDB51_1shot_v1.yaml]

The slice, which ``chip_smoke.py`` also drives: the HMDB51 1-shot config with
a ViT-B/16 tower at full width (fresh weights from the seed), the synthetic
decoder, E = 4 episodes (960 frames of 224 px) per step in 2 episode chunks,
BATCH_SIZE_PER_TASK 4, bf16.  Each reading is printed on a line that starts
with the tag of its reading set:

- ``loader[train w=4 native omp=8]`` ...: the host train loader alone (no
  device), ms per step over 4 steps with the config's 4 worker threads, with
  the native C++ resize and with the numpy replica, in turn, twice
  (``omp`` is the library's OpenMP threads per clip, the OpenMP default: run
  with ``OMP_NUM_THREADS=1`` in the environment for the one-thread reading);
- ``step[<path> #i]``: one batch resident on the card, the whole train step
  (augmentation, forward and backward of both chunks, the optimizer's
  micro-step) timed with CUDA events, three timings of 4 steps, and beside
  each the host's time to queue a step (the launch thread alone: the step
  reads nothing back, so the host clock stops before the card does);
- ``kernels[<path> #i]``: ``torch.profiler`` over two such steps: device time
  per kernel name (device events only), grouped into the attention forward
  kernel / backward kernels (``clip_mha_bwd``, or ``flash_mha_bwd_dq``, which
  in bf16 forms delta itself, and ``flash_mha_bwd_dkv``) / GEMM / softmax /
  memcpy / other, the wall time, and the busy share of the wall;
- ``dp[<path> #i]``: the cost of data parallelism to a step, on one card: the
  step with its batch resident (CUDA events) without a process group and
  then as the one rank of an NCCL process group, and under the group the
  gradient all-reduce of one step alone (``parallel.mesh.all_reduce_grads``:
  its flat buckets, CUDA events); more than one card is not measured here;
- ``loop[<path> #i]``: ``train_few_shot`` over 6 steps (no validation), first
  as it runs for a user (wall seconds of the step loop and train episodes/s),
  then with the program's spans recording (``utils/tracing.recording``, no
  profiler: the two rates give the tracing's cost), then under the
  profiler: wall seconds, device busy time (the union of device-event
  intervals) and idle share, peak device memory, and the ten longest idle
  gaps of the card named by the ``fsar.`` span open at their start
  (``profile_eval.say_gaps``).

``<path>`` is ``fused`` (the clip_mha kernels), ``split`` (plain attention
with fp32 logits) or ``pallas`` (``TPU.PALLAS_ATTENTION``: the flash_mha
kernels), run in the order fused, split, pallas, fused, split, pallas;
``--paths`` picks some of them and ``--loop-steps`` the loops' length.
``--sections`` picks the reading sets: ``loader``, ``step`` (with
``kernels``), ``dp`` and ``loop``.  ``--backbone`` sets the tower (default
ViT-B/16); ``ViT-L/14@336px`` runs the ViT-L/14@336px 16-frame configuration
(``profile_eval.VIT_L336_OPTS``: the tower rematerialized in 4 frame chunks)
with E = 2 episodes (960 frames of 336 px) in 2 chunks; an RN tower reads the
``split`` path only (no attention path of
the config reaches it) and adds ``rn_split[...]`` to each ``kernels`` set:
device time in the convolutions, in the BatchNorm chain and in the rest
(``profile_eval.report_split``).  ``--cfg`` profiles another config as it is
written (its head, backbone and episode shape; ``--backbone`` is not read) at
E = 4 in 2 episode chunks, e.g. a shipped HyRSM++ or MoLo config on its
torchvision ResNet-50 trunk: the ``split`` path only, and each ``kernels`` set
adds ``split[...]`` (``profile_eval.report_classic_split``: convolutions, the
BatchNorm chain, the trunk's and MoLo's decoder's forward, the rest).  Metrics are
never read inside a timed window: the train step returns them on the device
and these readings do not fetch them.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional

import torch

from clip_fsar_torch.tools import profile_eval
from clip_fsar_torch.tools.profile_eval import (
    CONFIG,
    PATHS,
    VIT_L336,
    _busy_us,
    _device_events,
    _report_kernels,
    backbone_opts,
    card,
    classic_ranges,
    config_opts,
    is_rn,
    report_classic_split,
    report_split,
    say,
    say_gaps,
)
from clip_fsar_torch.utils import tracing

EPISODES = 4
TRAIN_OPTS = [
    "VIDEO.HEAD.BACKBONE_NAME", "ViT-B/16",
    "TRAIN.ENABLE", "True",
    "DATA.DECODER", "synthetic",
    "TPU.EPISODES_PER_STEP", str(EPISODES),
    "TPU.EPISODE_CHUNKS", "2",
    "TRAIN.BATCH_SIZE_PER_TASK", "4",
    "TRAIN.VAL_FRE_ITER", "0",
    "LOG_PERIOD", "100",
]
STEPS = 4  # steps per timing
SECTIONS = ("loader", "step", "dp", "loop")  # the reading sets, in the order they are taken


def train_cfg(*extra: str, backbone: Optional[str] = "ViT-B/16", cfg_path: Optional[str] = None):
    """The slice's config on ``backbone`` (the ViT-L/14@336px configuration at E = 2) with ``extra``, or
    ``cfg_path`` as it is written at the slice's E = 4 in 2 chunks."""
    from clip_fsar_torch.runs.run import load_config

    if cfg_path:
        return load_config(cfg_path, config_opts(cfg_path) + TRAIN_OPTS[2:] + list(extra))
    episodes = ["TPU.EPISODES_PER_STEP", "2"] if backbone == VIT_L336 else []
    return load_config(CONFIG, TRAIN_OPTS + backbone_opts(backbone) + episodes + list(extra))


def frames_per_step(cfg) -> int:
    t = cfg.TRAIN
    return int(cfg.TPU.EPISODES_PER_STEP) * int(t.WAY) * (int(t.SHOT) + int(t.QUERY_PER_CLASS)) * int(cfg.DATA.NUM_INPUT_FRAMES)


def time_loader(steps: int = STEPS, backbone: Optional[str] = "ViT-B/16", cfg_path: Optional[str] = None) -> None:
    from clip_fsar_torch.data.loader import build_few_shot_loader

    cfg = train_cfg(backbone=backbone, cfg_path=cfg_path)
    workers = int(cfg.DATA_LOADER.NUM_WORKERS)
    episodes = int(cfg.TPU.EPISODES_PER_STEP)
    variants = profile_eval.resize_variants()
    for reading in (1, 2):
        for label, switch in variants:
            switch()
            t0 = time.perf_counter()
            with build_few_shot_loader(cfg, "train", num_steps=steps, episodes_per_step=episodes) as loader:
                got = sum(1 for _ in loader)
            ms = (time.perf_counter() - t0) * 1e3
            say(f"loader[train w={workers} {label} #{reading}]: {got} steps of {episodes} episodes ({frames_per_step(cfg)} frames) "
                f"in {ms:.1f} ms, {ms / got:.1f} ms per step (host only, {os.cpu_count()} cores)")
    profile_eval.restore_resize()


def profile_step(path: str, reading: int, steps: int = STEPS, backbone: Optional[str] = "ViT-B/16", cfg_path: Optional[str] = None) -> None:
    from torch.profiler import ProfilerActivity, profile

    from clip_fsar_torch.data.loader import build_few_shot_loader
    from clip_fsar_torch.models.builder import build_few_shot_model
    from clip_fsar_torch.train.loop import step_generator
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.state import TrainState
    from clip_fsar_torch.train.step import make_train_step

    dev = torch.device("cuda")
    cfg = train_cfg(*PATHS[path], backbone=backbone, cfg_path=cfg_path)
    model = build_few_shot_model(cfg, flow="train", device=dev)
    state = TrainState.create(cfg, model.head, Optimizer(cfg, model.head))
    train_step = make_train_step(model.head, cfg, model.text_train, model.text_test)
    with build_few_shot_loader(cfg, "train", num_steps=1, episodes_per_step=int(cfg.TPU.EPISODES_PER_STEP)) as loader:
        batch = next(iter(loader)).to(dev)
    gen = step_generator(cfg, 0, dev)
    train_step(state, batch, 1e-6, gen)
    torch.cuda.synchronize()

    tag = f"step[{path} #{reading}]"
    readings, queued = [], []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(steps):
            train_step(state, batch, 1e-6, gen)
        queued.append((time.perf_counter() - t0) * 1e3 / steps)  # the step reads nothing back: this is the launch thread alone
        end.record()
        torch.cuda.synchronize()
        readings.append(start.elapsed_time(end) / steps)
    say(f"{tag}: batch resident, {frames_per_step(cfg)} frames in 2 chunks, ms per train step over {steps} steps: "
        + " / ".join(f"{ms:.3f}" for ms in readings) + "; the host queued a step in " + " / ".join(f"{ms:.3f}" for ms in queued) + " ms")

    with classic_ranges(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            train_step(state, batch, 1e-6, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = _report_kernels(f"kernels[{path} #{reading}]", prof, wall_ms, 2)
    if cfg_path:
        report_classic_split(f"split[{path} #{reading}]", prof, busy)
    elif is_rn(backbone):
        report_split(f"rn_split[{path} #{reading}]", prof, busy)
    del model, state, train_step, batch
    torch.cuda.empty_cache()


def resident_step_ms(model, cfg, batch, bank=None, steps: int = STEPS) -> dict:
    """``make_train_step`` with its batch resident (pixels, or train bank rows with ``bank``), under the caller's
    process group if there is one: CUDA-event ms a step over ``steps`` steps after a warm-up step, and the host's
    ms to queue one; under a group also the gradient all-reduce of one step alone (``all_reduce_grads`` on the
    gradients a step leaves, CUDA events over ``steps`` repeats) and the megabytes it reduces."""
    from clip_fsar_torch.parallel import mesh
    from clip_fsar_torch.train.loop import step_generator
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.state import TrainState
    from clip_fsar_torch.train.step import make_grad_fn, make_train_step

    dev = batch.support_images.device
    state = TrainState.create(cfg, model.head, Optimizer(cfg, model.head))
    step = make_train_step(model.head, cfg, model.text_train, model.text_test, bank)
    step(state, batch, 1e-6, step_generator(cfg, 0, dev))
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for i in range(steps):
        step(state, batch, 1e-6, step_generator(cfg, i, dev))
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    end.record()
    torch.cuda.synchronize()
    out = {"step_ms": start.elapsed_time(end) / steps, "host_ms": host_ms}
    if mesh.distributed():
        make_grad_fn(model.head, cfg, model.text_train, model.text_test, bank)(batch, step_generator(cfg, 0, dev))
        grads = [p.grad for p in model.head.parameters() if p.grad is not None]
        torch.cuda.synchronize()
        start.record()
        for _ in range(steps):
            mesh.all_reduce_grads(model.head.parameters())
        end.record()
        torch.cuda.synchronize()
        out.update(all_reduce_ms=start.elapsed_time(end) / steps, all_reduce_mb=sum(g.numel() * g.element_size() for g in grads) / 1e6)
        model.head.zero_grad(set_to_none=True)
    return out


def profile_dp(path: str, reading: int, backbone: Optional[str] = "ViT-B/16", cfg_path: Optional[str] = None) -> None:
    import torch.distributed as dist

    from clip_fsar_torch.data.loader import build_few_shot_loader
    from clip_fsar_torch.models.builder import build_few_shot_model
    from clip_fsar_torch.parallel import mesh

    dev = torch.device("cuda")
    cfg = train_cfg(*PATHS[path], backbone=backbone, cfg_path=cfg_path)
    model = build_few_shot_model(cfg, flow="train", device=dev)
    with build_few_shot_loader(cfg, "train", num_steps=1, episodes_per_step=int(cfg.TPU.EPISODES_PER_STEP)) as loader:
        batch = next(iter(loader)).to(dev)
    alone = resident_step_ms(model, cfg, batch)
    with tempfile.TemporaryDirectory() as store:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(store, "store"), 1), rank=0, world_size=1,
                                timeout=mesh.TIMEOUT, device_id=torch.device("cuda", torch.cuda.current_device()))
        try:
            grouped = resident_step_ms(model, cfg, batch)
        finally:
            mesh.destroy()
    say(f"dp[{path} #{reading}]: batch resident, ms per train step over {STEPS} steps: {alone['step_ms']:.3f} without a process group "
        f"(host {alone['host_ms']:.3f}), {grouped['step_ms']:.3f} as the one rank of an NCCL group (host {grouped['host_ms']:.3f}); "
        f"the gradient all-reduce alone {grouped['all_reduce_ms']:.3f} ms for {grouped['all_reduce_mb']:.1f} MB "
        f"(buckets of at most {mesh.BUCKET_BYTES >> 20} MiB)")
    del model, batch
    torch.cuda.empty_cache()


def profile_loop(path: str, reading: int, steps: int = 6, backbone: Optional[str] = "ViT-B/16", cfg_path: Optional[str] = None) -> None:
    from torch.profiler import ProfilerActivity, profile

    from clip_fsar_torch.train.loop import train_few_shot

    tag = f"loop[{path} #{reading}]"
    with tempfile.TemporaryDirectory() as out_dir:
        loop_cfg = train_cfg(*PATHS[path], "TRAIN.NUM_TRAIN_TASKS", str(steps), "OUTPUT_DIR", out_dir, backbone=backbone, cfg_path=cfg_path)
        stats = train_few_shot(loop_cfg)
    episodes = int(loop_cfg.TPU.EPISODES_PER_STEP)
    rate = stats["steps"] * episodes / stats["seconds"]
    say(f"{tag}: {stats['steps']} steps, {stats['seconds']:.3f} s without the profiler, {rate:.3f} train episodes/s")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir, tracing.recording():
        loop_cfg = train_cfg(*PATHS[path], "TRAIN.NUM_TRAIN_TASKS", str(steps), "OUTPUT_DIR", out_dir, backbone=backbone, cfg_path=cfg_path)
        stats = train_few_shot(loop_cfg)
    say(f"{tag}: {stats['steps']} steps, {stats['seconds']:.3f} s, {stats['steps'] * episodes / stats['seconds']:.3f} train "
        f"episodes/s with the program's spans recording (no profiler) against {rate:.3f} without")
    tracing.reset()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as out_dir:
        loop_cfg = train_cfg(*PATHS[path], "TRAIN.NUM_TRAIN_TASKS", str(steps), "OUTPUT_DIR", out_dir, backbone=backbone, cfg_path=cfg_path)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            stats = train_few_shot(loop_cfg)
            torch.cuda.synchronize()
    busy_s = _busy_us(_device_events(prof)) / 1e6
    say(f"{tag}: {stats['steps']} steps, {stats['seconds']:.3f} s under the profiler, "
        f"{stats['steps'] * episodes / stats['seconds']:.3f} train episodes/s, device busy {busy_s:.3f} s, "
        f"idle {(1 - busy_s / stats['seconds']) * 100:.1f} % of the loop; peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    say_gaps(tag, prof)
    torch.cuda.empty_cache()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also append every line to this file")
    ap.add_argument("--sections", default=",".join(SECTIONS), help="comma-separated reading sets to take, of " + ", ".join(SECTIONS))
    ap.add_argument("--paths", default=",".join(PATHS), help="comma-separated attention paths to read, of " + ", ".join(PATHS))
    ap.add_argument("--loop-steps", type=int, default=6, help="steps of each train loop (two lengths tell the loop's start from its steady step)")
    ap.add_argument("--backbone", default="ViT-B/16", help=f"the CLIP tower (an RN tower reads the split path only; {VIT_L336} its 16-frame configuration)")
    ap.add_argument("--cfg", default=None, help="profile this config as it is written instead (its head and backbone; the split path only)")
    args = ap.parse_args(argv)
    backbone = None if args.cfg else args.backbone
    sections, paths = args.sections.split(","), (["split"] if (args.cfg or is_rn(backbone)) else args.paths.split(","))
    if set(sections) - set(SECTIONS) or set(paths) - set(PATHS):
        ap.error(f"--sections takes {', '.join(SECTIONS)} and --paths {', '.join(PATHS)}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: torch sees no CUDA device; this script measures the card only")
    profile_eval.set_out(args.out)
    from clip_fsar_torch import runtime

    runtime.device("cuda")
    say(card())
    say(f"torch {torch.__version__} cuda {torch.version.cuda} " + (f"config {args.cfg}" if args.cfg else f"backbone {backbone}"))
    from clip_fsar_torch.ops import _build

    _build.library()  # built before any reading, so no loop's seconds hold the compile
    if "loader" in sections:
        time_loader(backbone=backbone, cfg_path=args.cfg)
    for reading in (1, 2):
        for path in paths:
            if "step" in sections:
                profile_step(path, reading, backbone=backbone, cfg_path=args.cfg)
            if "dp" in sections:
                profile_dp(path, reading, backbone=backbone, cfg_path=args.cfg)
            if "loop" in sections:
                profile_loop(path, reading, args.loop_steps, backbone=backbone, cfg_path=args.cfg)


if __name__ == "__main__":
    main()
