"""From a ``torch.profiler`` trace to what the per-layer metrics read.

Copies, so that later changes to the program cannot move the yardstick: the union of the
device events' intervals and the kernel-name groups (``clip_fsar_torch/tools/profile_eval.py``
``_busy_us`` and ``_group``), and the ``bn_chain`` profiler range around every RN
``BatchNorm.forward``, put on from outside the model (``bn_ranges`` there), whose backward is
the autograd node ``_BatchNormFnBackward``.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Dict, List, Tuple

import torch

HOST = "pb."  # the benchmark's own host ranges (drive.Spans)


def group(name: str) -> str:
    low = name.lower()
    if "flash_mha_bwd_dkv" in low:
        return "flash_mha_bwd_dkv"
    if "flash_mha_bwd" in low:
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


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop <= end:
            continue
        busy += stop - max(start, end)
        end = stop
    return busy


def _merged(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for start, stop in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], stop)
        else:
            out.append([start, stop])
    return [(a, b) for a, b in out]


@contextlib.contextmanager
def bn_ranges():
    """Every RN BatchNorm forward inside a profiler range named ``bn_chain``; the model's code is untouched."""
    from unittest import mock

    from clip_fsar_torch.models.clip.model import BatchNorm

    forward = BatchNorm.forward

    def ranged(self, *args, **kwargs):
        with torch.profiler.record_function("bn_chain"):
            return forward(self, *args, **kwargs)

    with mock.patch.object(BatchNorm, "forward", ranged):
        yield


def profiler():
    """The traced run's profiler: host and card activity, no shapes or stacks."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)


def _device_total_s(row) -> float:
    total = getattr(row, "device_time_total", None)
    return (total if total is not None else row.cuda_time_total) / 1e6


def summarize(prof, steps: int) -> dict:
    """The trace's device events by name, busy and window seconds, kernel groups, the ranges'
    device seconds, and the longest idle gaps of the card named by the host range they fall in."""
    events = prof.events()
    device, host = [], []
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and e.name != "bn_chain" and not e.name.startswith(HOST):
                device.append((e.name, e.time_range.start, e.time_range.end))
        elif e.name.startswith(HOST):
            host.append((e.name[len(HOST):], e.time_range.start, e.time_range.end))
    steps_ranges = [(a, b) for n, a, b in host if n == "step"]
    start = min((a for a, _ in steps_ranges), default=min((a for _, a, _ in device), default=0.0))
    end = max((b for _, _, b in device), default=start)
    busy = busy_us((a, b) for _, a, b in device)
    groups: Dict[str, float] = collections.defaultdict(float)
    per_name: Dict[str, float] = collections.defaultdict(float)
    for name, a, b in device:
        groups[group(name)] += (b - a) / 1e6
        per_name[name] += (b - a) / 1e6
    rows = {row.key: row for row in prof.key_averages()}
    ranges = {k: _device_total_s(rows[k]) for k in ("bn_chain", "_BatchNormFnBackward",
                                                    "autograd::engine::evaluate_function: _BatchNormFnBackward") if k in rows}
    spans = sorted(((a, b, n) for n, a, b in host if n != "step"), key=lambda s: (s[0], -s[1]))
    gaps = []
    merged = _merged((a, b) for _, a, b in device)
    for (_, prev_end), (nxt, _) in zip(merged, merged[1:]):
        inside = [n for a, b, n in spans if a <= prev_end < b]
        gaps.append((inside[-1] if inside else "other host work", (nxt - prev_end) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    return {
        "steps": steps,
        "device_events": len(device),
        "busy_s": busy / 1e6,
        "window_s": max(end - start, 0.0) / 1e6,
        "groups": dict(groups),
        "per_name": dict(per_name),
        "ranges": ranges,
        "gaps": gaps[:10],
    }


def breakdown(summary: dict) -> dict:
    """The result line's ``breakdown``: the ten largest of the kernel groups' device seconds, the
    "other" group (elementwise kernels and the rest) shown by kernel name, and the ten longest
    idle gaps of the card, named by the host range they fall in."""
    items = [(g, v) for g, v in summary["groups"].items() if g != "other"]
    items += [("other: " + n[:80], v) for n, v in summary["per_name"].items() if group(n) == "other"]
    ops = sorted(items, key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[n, s] for n, s in summary["gaps"]]}
