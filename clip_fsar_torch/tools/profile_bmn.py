"""Where BMN's train step spends the card, and whether two trainings give the same bits.

    python -m clip_fsar_torch.tools.profile_bmn [--out out/profile_bmn.txt] [--windows 8]
        [--cudnn default,deterministic] [--sections step,split,repeat] [--repeat-steps 4]

The configuration is ``configs/localization/BMN_EPIC100.yaml`` at full width (T = D = 200, 2304 feature
channels, N = 32 samples, the regression and the 97 / 300 verb / noun maps), synthetic features, fresh
weights from RANDOM_SEED, float32 with TF32 off, the first ``--windows`` train windows resident on the
card.  Each reading is printed on a line that starts with its tag:

- ``step[<cudnn>]``: the train step (``make_localization_train_step``: forward, the losses, backward, Adam),
  CUDA-event ms a step over 3 steps after a warm-up step, the host's ms to queue one, and the peak memory;
- ``split[<cudnn>]``: ``torch.profiler`` over one step: the card's busy ms, then device ms by operator and
  input shapes (each operator's self device time: the kernels it launched itself, so that a convolution
  is told from another by its shapes), and by kernel name;
- ``repeat[<cudnn>]``: two trainings of ``--repeat-steps`` steps from the same start (a fresh model from the
  seed, the same batch and loss draws each step): the first step whose loss differs in its bits, and the
  parameters whose bits differ after the last step.

``<cudnn>`` is ``default`` (the step built with ``runtime.deterministic_convolutions`` left out, so cuDNN
picks its convolution algorithms freely) or ``deterministic`` (the flag ``torch.backends.cudnn.deterministic``
set around each step call).  The tool uses only the localization runner's public functions, so it reads a
tree from before the boundary-matching kernel as well.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import os
import time
from typing import Callable, Dict, List, Optional
from unittest import mock

import torch

from clip_fsar_torch.tools.profile_eval import _busy_us, _device_events, card, say, set_out

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(REPO, "configs", "localization", "BMN_EPIC100.yaml")
OPTS = ["DATA.DECODER", "synthetic", "SOLVER.MAX_EPOCH", "1"]
CUDNN = ("default", "deterministic")
SECTIONS = ("step", "split", "repeat")
TOP = 15  # rows printed per table


@contextlib.contextmanager
def _free_pick():
    yield


def build_step(cfg, dev, cudnn: str, windows: int):
    """A fresh BMN model on ``dev``, its optimizer state and train step, and ``run(i)``: step i on the first
    ``windows`` train windows with step i's loss draws, under ``cudnn`` (see the module docstring)."""
    from clip_fsar_torch import runtime
    from clip_fsar_torch.data.tal_features import TalFeatureDataset
    from clip_fsar_torch.train import localization as loc
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.state import TrainState

    feats, maps, _ = next(loc._batches(TalFeatureDataset(cfg, "train"), windows, False, 0))
    x, y = torch.from_numpy(feats).to(dev), {k: torch.from_numpy(v).to(dev) for k, v in maps.items()}
    model = loc.build_bmn_model(cfg, dev)
    state = TrainState.create(cfg, model, Optimizer(cfg, model, name_prefix=""))
    with mock.patch.object(runtime, "deterministic_convolutions", _free_pick) if cudnn == "default" else contextlib.nullcontext():
        step = loc.make_localization_train_step(model, cfg)

    def run(i: int) -> torch.Tensor:
        before = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = cudnn == "deterministic"
        try:
            return step(state, x, y, 1e-4, loc.step_generator(cfg, 0, i, dev))[0]
        finally:
            torch.backends.cudnn.deterministic = before

    return model, run


def time_step(run: Callable[[int], torch.Tensor], steps: int = 3) -> Dict[str, float]:
    """CUDA-event ms a step over ``steps`` steps after a warm-up step, the host's ms to queue one, and the peak GiB."""
    run(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        run(i)
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    end.record()
    torch.cuda.synchronize()
    return {"step_ms": start.elapsed_time(end) / steps, "host_ms": host_ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def _device_ms(avg, self_only: bool) -> float:
    for name in (("self_device_time_total", "self_cuda_time_total") if self_only else ("device_time_total", "cuda_time_total")):
        if hasattr(avg, name):
            return getattr(avg, name) / 1e3
    return 0.0


def split_step(run: Callable[[int], torch.Tensor], i: int = 100) -> Dict[str, object]:
    """``torch.profiler`` over one step ``run(i)``: the card's busy ms (the union of its kernels' intervals), device
    ms by (operator, input shapes) of the operators' self device time, and by kernel name, each largest first."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA],
                                record_shapes=True) as prof:
        run(i)
        torch.cuda.synchronize()
    events = _device_events(prof)
    by_op = [(avg.key, [list(s) for s in (avg.input_shapes or [])[:2]], _device_ms(avg, True))
             for avg in prof.key_averages(group_by_input_shape=True)]
    by_op = sorted((row for row in by_op if row[2] > 0), key=lambda row: -row[2])
    by_kernel: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        by_kernel[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_kernel[e.name][1] += 1
    return {"busy_ms": _busy_us(events) / 1e3, "kernel_ms": sum(ms for ms, _ in by_kernel.values()), "launches": len(events),
            "by_op": by_op, "by_kernel": sorted(((name, ms, n) for name, (ms, n) in by_kernel.items()), key=lambda row: -row[1])}


def report_split(tag: str, split: Dict[str, object], top: int = TOP) -> None:
    say(f"{tag}: the card busy {split['busy_ms']:.3f} ms in {split['launches']} kernels and copies ({split['kernel_ms']:.3f} ms summed)")
    for name, shapes, ms in split["by_op"][:top]:
        say(f"{tag}   op {ms:10.3f} ms  {name} {shapes}")
    for name, ms, n in split["by_kernel"][:top]:
        say(f"{tag}   kernel {ms:10.3f} ms  x{n:<4d} {name[:140]}")


def repeat_runs(cfg, dev, cudnn: str, windows: int, steps: int) -> Dict[str, object]:
    """Two trainings of ``steps`` steps from the same start: every step's loss of both, the first step whose
    loss bits differ (None: none), and the parameters whose bits differ after the last step."""
    runs = []
    for _ in range(2):
        model, run = build_step(cfg, dev, cudnn, windows)
        losses = torch.stack([run(i) for i in range(steps)]).cpu()
        runs.append((losses, {k: v.detach().clone() for k, v in model.state_dict().items()}))
        del model, run
        torch.cuda.empty_cache()
    (a, first), (b, second) = runs
    parted = next((i for i in range(steps) if not torch.equal(a[i], b[i])), None)
    return {"losses": [a.tolist(), b.tolist()], "parted_at_step": parted,
            "params_differ": sorted(k for k in first if not torch.equal(first[k], second[k])), "params": len(first)}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also append every line to this file")
    ap.add_argument("--windows", type=int, default=8, help="windows a step (the preset's 64 are over 8 cards)")
    ap.add_argument("--cudnn", default=",".join(CUDNN), help="comma-separated cuDNN modes to read, of " + ", ".join(CUDNN))
    ap.add_argument("--sections", default=",".join(SECTIONS), help="comma-separated reading sets, of " + ", ".join(SECTIONS))
    ap.add_argument("--repeat-steps", type=int, default=4, help="steps of each of the two trainings of the repeat reading")
    args = ap.parse_args(argv)
    modes, sections = args.cudnn.split(","), args.sections.split(",")
    if set(modes) - set(CUDNN) or set(sections) - set(SECTIONS):
        ap.error(f"--cudnn takes {', '.join(CUDNN)} and --sections {', '.join(SECTIONS)}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_bmn: torch sees no CUDA device; this script measures the card only")
    set_out(args.out)
    from clip_fsar_torch import runtime
    from clip_fsar_torch.runs.run import load_config

    dev = runtime.device("cuda")
    cfg = load_config(CONFIG, OPTS + ["TRAIN.BATCH_SIZE", str(args.windows)])
    say(card())
    say(f"torch {torch.__version__} cuda {torch.version.cuda} BMN {CONFIG} at {args.windows} windows a step, fp32")
    for cudnn in modes:
        if "step" in sections or "split" in sections:
            model, run = build_step(cfg, dev, cudnn, args.windows)
            if "step" in sections:
                t = time_step(run)
                say(f"step[{cudnn}]: {t['step_ms']:.3f} ms a step (CUDA events, 3 steps), the host queued one in {t['host_ms']:.3f} ms; "
                    f"peak {t['peak_gib']:.3f} GiB")
            if "split" in sections:
                report_split(f"split[{cudnn}]", split_step(run))
            del model, run
            torch.cuda.empty_cache()
        if "repeat" in sections:
            r = repeat_runs(cfg, dev, cudnn, args.windows, args.repeat_steps)
            say(f"repeat[{cudnn}]: two trainings of {args.repeat_steps} steps from one start: losses {r['losses'][0]} / {r['losses'][1]}; "
                f"first step whose loss bits differ: {r['parted_at_step']}; parameters whose bits differ after the last step: "
                f"{len(r['params_differ'])} of {r['params']} {r['params_differ'][:8]}")


if __name__ == "__main__":
    main()
