"""The 3-D pools' backward on the card: what a launch costs the launch thread beside what it costs the card, at each
shape a preset's train step launches it at, and that train step's time.

    python -m clip_fsar_torch.tools.profile_pools [--presets s3dg] [--batch 2] [--dtype bfloat16] [--steps 10]
        [--rounds 3] [--calls 50] [--out FILE]

Each preset is ``configs/pool/backbone/<preset>.yaml`` over ``configs/pool/run/training/from_scratch_large.yaml`` at
full width, 400 classes, with the preset's own DATA, fresh weights from RANDOM_SEED, one batch of random clips resident
on the card: at batch 2 in bf16 as phase 25 of ``chip_smoke.py`` builds it, or as the classification CLI runs TAda2D
(``configs/classification/TAda2D_K400.yaml``: batch 8, float32) with ``--presets tada2d --batch 8 --dtype float32``.
Each reading is printed on a line that starts with its tag:

- ``step[<preset>]``: the train step (``make_classification_train_step``: forward, loss, backward, update), CUDA-event
  ms a step over ``--steps`` steps after a warm-up step, in each of ``--rounds`` rounds, and the host's ms to return
  from one step call;
- ``pool[<preset>]``: every distinct call of ``ops.pool3d.pool3d_bwd_cuda`` that one step made, called again on the
  step's own dy and argmax: the host's microseconds to return from a call (``--calls`` calls without a synchronisation
  between them), CUDA-event ms a call over ``--calls`` calls back to back, and the card's ms a call (``card_ms``).

The tool uses only the port's public functions, so it reads a tree from before the tiled pool kernel as well: put that
tree's root first on the path (``PYTHONPATH=<tree> python <this file>``); the configurations are read from the tree
whose ``clip_fsar_torch`` was imported.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import List, Optional
from unittest import mock

import torch


def preset_cfg(root: str, preset: str, out_dir: str, batch: int):
    """The preset at full width over from_scratch_large.yaml at ``batch`` clips a step, with the preset's own DATA where it
    has one."""
    import yaml

    from clip_fsar_torch.runs.run import load_config

    path = os.path.join(out_dir, f"{preset}.yaml")
    with open(path, "w") as f:
        f.write(f"_BASE_RUN: {os.path.join(root, 'configs', 'pool', 'run', 'training', 'from_scratch_large.yaml')}\n"
                f"_BASE_MODEL: {os.path.join(root, 'configs', 'pool', 'backbone', preset + '.yaml')}\n"
                f"TASK_TYPE: classification\nTRAIN:\n  BATCH_SIZE: {batch}\nVIDEO:\n  HEAD:\n    NUM_CLASSES: 400\n")
    with open(os.path.join(root, "configs", "pool", "backbone", f"{preset}.yaml")) as f:
        data = yaml.safe_load(f).get("DATA", {})
    return load_config(path, [x for k, v in data.items() for x in (f"DATA.{k}", str(v))])


def build_step(cfg, dev, dtype: torch.dtype):
    """The model in ``dtype``, its train state and step, and one resident batch; returns ``run(i)``, one step."""
    from clip_fsar_torch.models.video.model import build_video_model
    from clip_fsar_torch.train.classification import make_classification_train_step, step_generator
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.state import TrainState

    model = build_video_model(cfg, dtype=dtype, device=dev)
    state = TrainState.create(cfg, model, Optimizer(cfg, model, name_prefix=""))
    step = make_classification_train_step(model, cfg)
    g = torch.Generator(device=dev).manual_seed(1)
    b, t, crop = int(cfg.TRAIN.BATCH_SIZE), int(cfg.DATA.NUM_INPUT_FRAMES), int(cfg.DATA.TRAIN_CROP_SIZE)
    videos = torch.randint(0, 256, (b, t, crop, crop, 3), generator=g, device=dev, dtype=torch.uint8)
    labels = torch.randint(0, int(cfg.VIDEO.HEAD.NUM_CLASSES), (b,), generator=g, device=dev, dtype=torch.int32)
    return lambda i: step(state, videos, labels, 1e-6, step_generator(cfg, 0, i, dev))


def time_step(run, steps: int, rounds: int) -> List[tuple]:
    """(CUDA-event ms a step, the host's ms to return from a step call) in each round, after a warm-up step."""
    run(0)
    torch.cuda.synchronize()
    out = []
    for r in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for i in range(steps):
            run(1 + r * steps + i)
        host = (time.perf_counter() - t0) * 1e3 / steps
        end.record()
        torch.cuda.synchronize()
        out.append((start.elapsed_time(end) / steps, host))
    return out


def record_pools(run) -> dict:
    """The distinct calls of ``pool3d_bwd_cuda`` in one step: (mode, x shape, kernel, stride, padding, channels_last,
    dtype) -> (dy, argmax) of its first call."""
    from clip_fsar_torch.ops import pool3d

    launch, calls = pool3d.pool3d_bwd_cuda, {}

    def recorded(mode, dy, argmax, in_shape, kernel, stride, padding, channels_last):
        key = (mode, tuple(in_shape), tuple(kernel), tuple(stride), tuple(padding), bool(channels_last), dy.dtype)
        calls.setdefault(key, (dy, argmax))
        return launch(mode, dy, argmax, in_shape, kernel, stride, padding, channels_last)

    with mock.patch.object(pool3d, "pool3d_bwd_cuda", recorded):
        run(0)
    torch.cuda.synchronize()
    return calls


def card_ms(fn, iters: int = 10, cycles: int = 50_000_000) -> float:
    """The card's ms a call of ``fn``: ``iters`` calls queued behind a spin of the card (``torch.cuda._sleep``) that lasts
    until the launch thread has queued them all, timed by CUDA events around the calls, so that the launch thread's gaps
    between small launches do not count (CUDA events around calls issued one after another time the launch thread
    instead).  The spin doubles until the first event is still pending when the last call is queued."""
    fn()
    torch.cuda.synchronize()
    for _ in range(6):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_in_time = not start.query()
        torch.cuda.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / iters
        cycles *= 2
    raise RuntimeError(f"the card's spin of {cycles // 2} cycles ended before {iters} calls were queued")


def time_pool(key: tuple, dy: torch.Tensor, argmax, calls: int) -> dict:
    """The host's us a call, CUDA-event ms a call and the card's ms a call of one pool backward."""
    from clip_fsar_torch.ops import pool3d

    mode, shape, kernel, stride, padding, channels_last, _ = key

    def call():
        pool3d.pool3d_bwd_cuda(mode, dy, argmax, shape, kernel, stride, padding, channels_last)

    for _ in range(5):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    host_us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        call()
    end.record()
    torch.cuda.synchronize()
    return {"host_us": host_us, "event_ms": start.elapsed_time(end) / calls, "device_ms": card_ms(call, calls)}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--presets", default="s3dg", help="comma-separated presets of configs/pool/backbone")
    ap.add_argument("--batch", type=int, default=2, help="clips a step")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"), help="the model's compute dtype")
    ap.add_argument("--steps", type=int, default=10, help="train steps a round")
    ap.add_argument("--rounds", type=int, default=3, help="rounds of the step's timing")
    ap.add_argument("--calls", type=int, default=50, help="calls of each pool backward a reading")
    ap.add_argument("--out", default=None, help="also append every line to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_pools: torch sees no CUDA device; this script measures the card only")
    import clip_fsar_torch
    from clip_fsar_torch import runtime
    from clip_fsar_torch.tools.profile_eval import card, say, set_out

    set_out(args.out)
    root = os.path.dirname(os.path.dirname(os.path.abspath(clip_fsar_torch.__file__)))
    dev = runtime.device("cuda")
    say(card())
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; the port from {root}; batch {args.batch}, {args.dtype}")
    with tempfile.TemporaryDirectory() as tmp:
        for preset in args.presets.split(","):
            run = build_step(preset_cfg(root, preset, tmp, args.batch), dev, getattr(torch, args.dtype))
            for r, (ms, host) in enumerate(time_step(run, args.steps, args.rounds)):
                say(f"step[{preset}] round {r}: {ms:.4f} ms a step (CUDA events, {args.steps} steps), the host returned from a step "
                    f"call in {host:.4f} ms")
            for key, (dy, argmax) in record_pools(run).items():
                t = time_pool(key, dy, argmax, args.calls)
                mode, shape, kernel, stride, padding, channels_last, dtype = key
                say(f"pool[{preset}] {mode} x {list(shape)} kernel {kernel} stride {stride} padding {padding} {str(dtype)[6:]}"
                    f"{' channels_last' if channels_last else ''}: host {t['host_us']:.1f} us a call, CUDA events {t['event_ms']:.4f} ms "
                    f"a call, the card {t['device_ms']:.4f} ms a call ({args.calls} calls)")
            del run
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
