"""Where the time of the few-shot test slice goes on a CUDA card.

    python -m clip_fsar_torch.tools.profile_eval [--out profile_eval.txt] [--backbone RN50 | ViT-L/14@336px]
        [--cfg configs/projects/hyrsmplusplus/hmdb51/HyRSMplusplus_HMDB51_5shot_v1.yaml]

The slice, which ``chip_smoke.py`` also drives: the HMDB51 1-shot config with a ViT-B/16
tower at full width (fresh weights from the seed), the synthetic decoder,
E = 4 episodes (320 frames of 224 px) per step, bf16.  Each reading is
printed on a line that starts with the tag of its reading set:

- ``loader[w=4 native omp=8]`` ...: the host loader alone (no device), ms
  per step over 8 steps with 4 and 8 worker threads, with the native C++
  resize (``clip_fsar_torch/native/frameops``) and with the numpy replica,
  in turn, twice (``--loader-only`` stops after these; ``omp`` is the
  library's OpenMP threads per clip, the OpenMP default: run with
  ``OMP_NUM_THREADS=1`` in the environment for the one-thread reading);
- ``step[<path> #i]``: one batch resident on the card, the eval step timed
  with CUDA events, three timings of 8 steps;
- ``kernels[<path> #i]``: ``torch.profiler`` over two such steps: device
  time per kernel name (device events only, so no op is counted twice),
  grouped into attention kernel (``clip_mha`` or ``flash_mha``) / GEMM /
  softmax / memcpy / other, the wall time, and the busy share of the wall;
- ``loop[<path> #i]``: ``evaluate`` over 16 episodes (loader, H2D copies,
  steps), without the profiler with the program's spans off and then
  recording (``utils/tracing.recording``: the two rates give the tracing's
  cost), and under the profiler: wall seconds, device busy time (the union
  of device-event intervals) and idle share, the ten longest idle gaps of
  the card named by the ``fsar.`` span open at their start
  (``tracing.name_gaps``), and the peak device memory of the loop.

``<path>`` is ``fused`` (the clip_mha kernel), ``split`` (plain attention
with fp32 logits) or ``pallas`` (``TPU.PALLAS_ATTENTION``: the flash_mha
kernel); they run in the order fused, split, pallas, fused, split, pallas,
so each is read twice with the others in between.

``--backbone`` sets the tower (default ViT-B/16).  ``ViT-L/14@336px`` runs
the ViT-L/14@336px 16-frame configuration (``VIT_L336_OPTS``: 640 frames of
336 px per step, the tower in 4 frame chunks).  An RN tower runs no
attention path of the config (its attention pool is plain float32 softmax),
so only ``split`` is read, and its ``kernels`` sets also print
``rn_split[...]``: the device time inside the convolutions (``aten::convolution``
and its backward), inside BatchNorm (the program's ``fsar.bn`` range around
every BatchNorm call, and its autograd backward) and the rest, from the
profiler's per-op device totals.

``--cfg`` profiles another config as it is written (its head and backbone;
``--backbone`` is not read), e.g. a shipped HyRSM++ or MoLo config on its
torchvision ResNet-50 trunk: only ``split`` is read (no attention path of the
config reaches a kernel), and its ``kernels`` sets print ``split[...]``: the
device time in the convolutions, in the BatchNorm chain, inside the trunk's
forward, inside MoLo's decoder forward, and the rest (the head).  Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import os
import subprocess
import time
from typing import Dict, List, Optional

import torch

from clip_fsar_torch.utils import tracing

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(REPO, "configs", "projects", "CLIPFSAR", "hmdb51", "CLIPFSAR_HMDB51_1shot_v1.yaml")
SLICE_OPTS = [
    "VIDEO.HEAD.BACKBONE_NAME", "ViT-B/16",
    "TRAIN.ENABLE", "False",
    "DATA.DECODER", "synthetic",
    "TRAIN.NUM_TEST_TASKS", "16",
    "TEST.BATCH_SIZE", "4",
]
# the ViT-L/14@336px 16-frame configuration (the JAX package's BASELINE.json configs[4], set up as its bench
# builds it, __graft_entry__.py:21-35): the crop at 336 px with the scales raised so it fits (the shipped 256
# times 336/224), TPU.REMAT as base.yaml has it (auto: on for this 24-layer tower) and the JAX package's 4 frame
# chunks; added to a slice's options by ``--backbone ViT-L/14@336px``
VIT_L336 = "ViT-L/14@336px"
VIT_L336_OPTS = ["VIDEO.HEAD.BACKBONE_NAME", VIT_L336, "DATA.NUM_INPUT_FRAMES", "16", "DATA.TRAIN_CROP_SIZE", "336", "DATA.TEST_CROP_SIZE", "336",
                 "DATA.TEST_SCALE", "384", "DATA.TRAIN_JITTER_SCALES", "[384, 384]", "TPU.FRAME_CHUNKS", "4"]
# the plain attention path with the kernel's math (fp32 logits and softmax)
PLAIN_OPTS = ["TPU.ATTENTION_LAYOUT", "split", "TPU.SOFTMAX_DTYPE", "float32"]
PATHS = {"fused": ["TPU.ATTENTION_LAYOUT", "fused"], "split": PLAIN_OPTS, "pallas": ["TPU.PALLAS_ATTENTION", "True"]}
EPISODES_PER_STEP = 4
STEPS = 8  # steps per timing
TOP = 12  # kernel rows printed per profiled set

_out: Optional[str] = None


def set_out(path: Optional[str]) -> None:
    """Also append every ``say`` line to ``path`` (its directory is made)."""
    global _out
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _out = path


def say(line: str) -> None:
    print(line, flush=True)
    if _out:
        with open(_out, "a") as f:
            f.write(line + "\n")


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]


def config_opts(path: str) -> list:
    """The options that read ``path`` as it is written, from any working directory: its ANNO_DIR made absolute."""
    from clip_fsar_torch.config.config import load_config

    anno = str(load_config(path, []).DATA.ANNO_DIR)
    return ["DATA.ANNO_DIR", anno if os.path.isabs(anno) else os.path.join(REPO, anno)]


def slice_cfg(*extra: str, cfg_path: Optional[str] = None):
    """The test slice's config: the CLIP-FSAR config (``extra`` sets the tower), or ``cfg_path`` as it is written."""
    from clip_fsar_torch.config.config import load_config

    if cfg_path:
        return load_config(cfg_path, config_opts(cfg_path) + SLICE_OPTS[2:] + list(extra))
    return load_config(CONFIG, SLICE_OPTS + list(extra))


def is_rn(backbone: Optional[str]) -> bool:
    return backbone is not None and backbone.startswith("RN")


def backbone_opts(backbone: Optional[str]) -> list:
    """The options that put a slice on ``backbone``: the ViT-L/14@336px configuration's, the tower alone, or none
    (a config read as it is written)."""
    if backbone is None:
        return []
    return list(VIT_L336_OPTS) if backbone == VIT_L336 else ["VIDEO.HEAD.BACKBONE_NAME", backbone]


@contextlib.contextmanager
def classic_ranges():
    """A classic head's torchvision trunk forward inside a profiler range named ``trunk`` and MoLo's decoder
    forward inside ``decoder``, for ``report_classic_split``; the model's code is untouched."""
    from unittest import mock

    from clip_fsar_torch.models.heads.molo import MoLoHead
    from clip_fsar_torch.models.resnet import TorchResNet

    def ranged(fn, name):
        def call(self, *args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(self, *args, **kwargs)

        return call

    with mock.patch.object(TorchResNet, "forward", ranged(TorchResNet.forward, "trunk")), \
            mock.patch.object(MoLoHead, "_decode", ranged(MoLoHead._decode, "decoder")):
        yield


def report_classic_split(tag: str, prof, busy_ms: float) -> None:
    """A classic head's step on the card: the convolutions (the trunk's and the decoder's), the BatchNorm chain,
    the trunk's and the decoder's forward ranges (each holds its own convolutions and BatchNorms), and the rest."""
    rows = {row.key: row for row in prof.key_averages()}
    pick = lambda *names: sum(_device_total_ms(rows[n]) for n in names if n in rows)  # noqa: E731
    conv_fwd, conv_bwd = pick("aten::convolution"), pick("aten::convolution_backward")
    bn_fwd = pick("fsar.bn")
    bn_bwd = pick("_BatchNormFnBackward") or pick("autograd::engine::evaluate_function: _BatchNormFnBackward")
    trunk, decoder = pick("trunk"), pick("decoder")
    if not conv_fwd + bn_fwd:
        say(f"{tag}: the profiler's op rows carry no device time; read the kernel groups above instead")
        return
    say(f"{tag}: convolutions {conv_fwd:.3f} ms forward + {conv_bwd:.3f} ms backward, BatchNorm chain {bn_fwd:.3f} ms forward + "
        f"{bn_bwd:.3f} ms backward; trunk forward {trunk:.3f} ms, decoder forward {decoder:.3f} ms, the rest (the head; in a train "
        f"step also every backward and the optimizer) {busy_ms - trunk - decoder:.3f} ms, of {busy_ms:.3f} ms device busy")


def _device_total_ms(row) -> float:
    total = getattr(row, "device_time_total", None)
    return (total if total is not None else row.cuda_time_total) / 1e3


def report_split(tag: str, prof, busy_ms: float) -> None:
    """The RN step's device time split into convolutions, the BatchNorm chain (the program's ``fsar.bn``
    ranges, and the autograd node ``_BatchNormFnBackward``) and the rest, from the profiler's per-op totals
    (each op's own kernels and its children's)."""
    rows = {row.key: row for row in prof.key_averages()}
    pick = lambda *names: sum(_device_total_ms(rows[n]) for n in names if n in rows)  # noqa: E731
    conv_fwd, conv_bwd = pick("aten::convolution"), pick("aten::convolution_backward")
    bn_fwd = pick("fsar.bn")
    bn_bwd = pick("_BatchNormFnBackward") or pick("autograd::engine::evaluate_function: _BatchNormFnBackward")
    if not conv_fwd + bn_fwd:
        say(f"{tag}: the profiler's op rows carry no device time; read the kernel groups above instead")
        return
    rest = busy_ms - conv_fwd - conv_bwd - bn_fwd - bn_bwd
    say(f"{tag}: convolutions {conv_fwd:.3f} ms forward + {conv_bwd:.3f} ms backward, BatchNorm chain {bn_fwd:.3f} ms forward + "
        f"{bn_bwd:.3f} ms backward, the rest {rest:.3f} ms, of {busy_ms:.3f} ms device busy")


def _group(name: str) -> str:
    low = name.lower()
    if "flash_mha_bwd_dkv" in low:
        return "flash_mha_bwd_dkv"
    if "flash_mha_bwd" in low:  # K4 and the delta pass before it
        return "flash_mha_bwd_dq"
    if "flash_mha" in low:
        return "flash_mha"
    if "clip_mha_bwd" in low:
        return "clip_mha_bwd"
    if "clip_mha" in low:
        return "clip_mha"
    if any(s in low for s in ("fprop", "dgrad", "wgrad", "convolve", "conv2d", "convolution")):
        return "conv"
    if any(s in low for s in ("nchwtonhwc", "nhwctonchw")):
        return "conv layout"
    if any(s in low for s in ("gemm", "nvjet", "xmma", "cutlass", "sm90_", "sm80_")):
        return "gemm"
    if "softmax" in low:
        return "softmax"
    if "memcpy" in low or "memset" in low:
        return "memcpy"
    return "other"


def _device_events(prof) -> List:
    """The card's kernels and copies, without the spans that profiler ranges leave on the device timeline."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def _busy_us(events) -> float:
    """Length of the union of the events' intervals."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        if stop <= end:
            continue
        busy += stop - max(start, end)
        end = stop
    return busy


def _report_kernels(tag: str, prof, wall_ms: float, steps: int) -> float:
    """Prints the kernel groups and top kernels; returns the device busy ms."""
    events = _device_events(prof)
    if not events:
        say(f"{tag}: the profiler recorded no device events")
        return 0.0
    per_name: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        per_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        per_name[e.name][1] += 1
    groups: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    for name, (ms, n) in per_name.items():
        groups[_group(name)][0] += ms
        groups[_group(name)][1] += n
    total = sum(ms for ms, _ in per_name.values())
    busy = _busy_us(events) / 1e3
    say(f"{tag}: {steps} steps, wall {wall_ms:.3f} ms, device-event sum {total:.3f} ms, busy {busy:.3f} ms "
        f"({busy / wall_ms * 100:.1f} % of wall)")
    say(f"{tag}: groups " + ", ".join(f"{g} {ms:.3f} ms x{n}" for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])))
    for name, (ms, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:TOP]:
        say(f"{tag}: {ms:10.3f} ms {ms / total * 100:5.1f} % x{n:<5d} {name[:110]}")
    return busy


def say_gaps(tag: str, prof) -> None:
    """The ten longest idle gaps of the card in a profiled loop from its first step on, each named by the
    program's span open at its start; then drops the recorded spans."""
    spans = tracing.collect()["spans"]
    first = min((s.start_ns for s in spans if s.name == "fsar.step"), default=0)
    gaps = tracing.name_gaps([iv for iv in tracing.device_intervals(prof) if iv[1] >= first], spans)
    say(f"{tag}: longest idle gaps from the first step on: " + ", ".join(f"{name} {length / 1e6:.3f} ms" for name, _, length in gaps))
    tracing.reset()


def resize_variants():
    """(label, switch) for each way the loaders can resize: the native library (at the OpenMP
    default, which OMP_NUM_THREADS sets for the whole process), then the numpy replica.
    ``switch()`` selects it for the calls that follow; without the library only the numpy
    replica is listed."""
    from clip_fsar_torch.native import frameops

    variants = []
    if frameops.available():
        variants = [(f"native omp={frameops.num_threads()}", lambda: frameops.set_enabled(True))]
    else:
        say(f"loader: native frameops unavailable ({frameops.failure()}); numpy replica only")
    return variants + [("numpy", lambda: frameops.set_enabled(False))]


def restore_resize() -> None:
    """Back to the loaders' default: the native library where it built."""
    from clip_fsar_torch.native import frameops

    frameops.set_enabled(True)


def time_loader(workers: int, steps: int = STEPS, backbone: Optional[str] = "ViT-B/16", cfg_path: Optional[str] = None) -> None:
    """The test loader alone with each resize variant in turn, twice."""
    from clip_fsar_torch.data.loader import build_few_shot_loader

    cfg = slice_cfg("DATA_LOADER.NUM_WORKERS", str(workers), *backbone_opts(backbone), cfg_path=cfg_path)
    variants = resize_variants()
    for reading in (1, 2):
        for label, switch in variants:
            switch()
            t0 = time.perf_counter()
            with build_few_shot_loader(cfg, "test", num_steps=steps, episodes_per_step=EPISODES_PER_STEP) as loader:
                got = sum(1 for _ in loader)
            ms = (time.perf_counter() - t0) * 1e3
            say(f"loader[w={workers} {label} #{reading}]: {got} steps of {EPISODES_PER_STEP} episodes in {ms:.1f} ms, "
                f"{ms / got:.1f} ms per step (host only, {os.cpu_count()} cores)")
    restore_resize()


def profile_path(path: str, reading: int, steps: int = STEPS, backbone: Optional[str] = "ViT-B/16", cfg_path: Optional[str] = None) -> None:
    from torch.profiler import ProfilerActivity, profile

    from clip_fsar_torch.data.loader import build_few_shot_loader
    from clip_fsar_torch.models.builder import build_few_shot_model
    from clip_fsar_torch.train.loop import evaluate
    from clip_fsar_torch.train.step import make_eval_step

    dev = torch.device("cuda")
    cfg = slice_cfg(*PATHS[path], *backbone_opts(backbone), cfg_path=cfg_path)
    model = build_few_shot_model(cfg, flow="test", device=dev)
    eval_step = make_eval_step(model.head, cfg, model.text_train, model.text_test)
    with build_few_shot_loader(cfg, "test", num_steps=1, episodes_per_step=EPISODES_PER_STEP) as loader:
        batch = next(iter(loader)).to(dev)
    eval_step(batch)
    torch.cuda.synchronize()

    tag = f"step[{path} #{reading}]"
    readings = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            eval_step(batch)
        end.record()
        torch.cuda.synchronize()
        readings.append(start.elapsed_time(end) / steps)
    frames = batch.support_images.shape[:3].numel() + batch.target_images.shape[:3].numel()
    say(f"{tag}: batch resident, {frames} frames, ms per step over {steps} steps: " + " / ".join(f"{ms:.3f}" for ms in readings))

    with classic_ranges(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            eval_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = _report_kernels(f"kernels[{path} #{reading}]", prof, wall_ms, 2)
    if cfg_path:
        report_classic_split(f"split[{path} #{reading}]", prof, busy)
    elif is_rn(backbone):
        report_split(f"rn_split[{path} #{reading}]", prof, busy)

    tag = f"loop[{path} #{reading}]"
    episodes = int(cfg.TRAIN.NUM_TEST_TASKS)
    torch.cuda.reset_peak_memory_stats()
    plain = evaluate(cfg, model, episodes, EPISODES_PER_STEP, device=dev)
    say(f"{tag}: {episodes} episodes, {plain['seconds']:.3f} s, {episodes / plain['seconds']:.3f} episodes/s (no profiler), "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    with tracing.recording():
        spanned = evaluate(cfg, model, episodes, EPISODES_PER_STEP, device=dev)
    say(f"{tag}: {episodes} episodes, {spanned['seconds']:.3f} s, {episodes / spanned['seconds']:.3f} episodes/s with the "
        f"program's spans recording (no profiler) against {episodes / plain['seconds']:.3f} without")
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = evaluate(cfg, model, episodes, EPISODES_PER_STEP, device=dev)
        torch.cuda.synchronize()
    events = _device_events(prof)
    busy_s = _busy_us(events) / 1e6
    say(f"{tag}: {episodes} episodes, {traced['seconds']:.3f} s under the profiler, device busy {busy_s:.3f} s, "
        f"idle {(1 - busy_s / traced['seconds']) * 100:.1f} % of the loop")
    say_gaps(tag, prof)
    del model, eval_step, batch
    torch.cuda.empty_cache()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also append every line to this file")
    ap.add_argument("--loader-only", action="store_true", help="time the host loader and stop")
    ap.add_argument("--backbone", default="ViT-B/16", help=f"the CLIP tower (an RN tower reads the split path only; {VIT_L336} its 16-frame configuration)")
    ap.add_argument("--cfg", default=None, help="profile this config as it is written instead (its head and backbone; the split path only)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval: torch sees no CUDA device; this script measures the card only")
    set_out(args.out)
    backbone = None if args.cfg else args.backbone
    say(card())
    say(f"torch {torch.__version__} cuda {torch.version.cuda} " + (f"config {args.cfg}" if args.cfg else f"backbone {backbone}"))
    for workers in (4, 8):
        time_loader(workers, backbone=backbone, cfg_path=args.cfg)
    if args.loader_only:
        return
    for reading in (1, 2):
        for path in ["split"] if (args.cfg or is_rn(backbone)) else PATHS:
            profile_path(path, reading, backbone=backbone, cfg_path=args.cfg)


if __name__ == "__main__":
    main()
