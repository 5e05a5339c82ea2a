"""One run of one cell: set-up, the measured window, the check, the result line.

Everything that belongs to one cell, configuration or per-layer metric is found by name:
``BENCHMARK.json`` at the checkout's root names each cell's configuration and metrics,
``portbench/workloads/<cell>.json`` holds the cell's traffic, its trace and check sizes and
its limits, ``portbench/configs/<config>.json`` the configuration, ``portbench/counts/<config>.py``
its operations, ``portbench/families/<family>.py`` (the configuration's ``family``) its head:
``build_head`` (the program's head at the configuration's widths), ``check_weights``,
``text_banks``, ``reference_step`` and ``reference_logits`` (the plain reference of a train step
and of a test episode), and ``portbench/metrics/<metric>.py`` each per-layer metric's reader (or
``portbench/metrics/<metric up to its first dot>.py``, one reader for ``<name>.train`` and
``<name>.test``).
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time
from typing import Callable, Optional

import torch

from portbench import drive, inputs as inp, judge, trace
from portbench.peaks import peaks
from portbench.reference.ops import Precision

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(ROOT)


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def benchmark(path: Optional[str] = None) -> dict:
    with open(path or os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_spec(bench: dict, name: str) -> dict:
    """The cell's entry in BENCHMARK.json merged with its workload file."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(entries)}")
    return {**inp.load_json("workloads", name), **entries[name]}


def metrics_of(bench: dict, cell: dict, section: str) -> list:
    """The ``section`` ("end_to_end" or "per_layer") metrics this cell reports: those that list
    it, or, without a list, those whose end-to-end metric it reports."""
    reported = {m["name"] for m in metrics_of(bench, cell, "end_to_end")} if section == "per_layer" else None
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if cell["name"] in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in reported:
            out.append(m)
    return out


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (metric names hold dots); a metric without a
    file of its own is read by ``portbench/metrics/<name up to its first dot>.py``, which serves
    both kinds of cell (``ctx["kind"]``)."""
    path = os.path.join(ROOT, kind, name + ".py")
    if kind == "metrics" and not os.path.exists(path):
        path = os.path.join(ROOT, kind, name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family_of(config_file: dict):
    """The configuration's family: ``portbench/families/<family>.py``."""
    return load_module("families", config_file["family"])


def make_inputs(config_file: dict, cell: dict, seed: int, device, family) -> inp.Inputs:
    """The run's inputs from ``seed``: weights, text banks and the bank of the cell's kind."""
    cfg = inp.run_config(config_file, seed)
    kind = cell["kind"]
    shapes = drive.head_shapes(cfg, device, family)
    weights = inp.make_weights(shapes, seed, device)
    family.check_weights(weights, config_file["arch"])
    text_train, text_test = family.text_banks(cfg, weights, seed, device)
    data = cfg["DATA"]
    key = "TRAIN_FRAME_BANK_FRAMES" if kind == "train" else "EVAL_FRAME_BANK_FRAMES"
    frames = int(cfg["TPU"].get(key) or data.get("FRAME_CACHE_FRAMES", 64))  # the port's rule (data/frame_bank.py)
    table = inp.bank_table(cfg, kind, frames)
    if kind == "train":
        hw, salt = tuple(int(v) for v in data["TRAIN_JITTER_SCALES"]), 1
    else:
        hw, salt = (int(data["TEST_CROP_SIZE"]),) * 2, 2
    pixels = inp.make_bank_pixels(len(table["paths"]), table["frames"], hw[0], hw[1], seed, salt, device)
    return inp.Inputs(cfg=cfg, weights=weights, text_train=text_train, text_test=text_test, bank=pixels, table=table)


def run_cell(name: str, seed: int, seconds: float, traced: bool, device="cuda", t_start: Optional[float] = None,
             bench: Optional[dict] = None, config_file: Optional[dict] = None, precision: str = "fp32",
             fault: Optional[Callable] = None, readings_out: Optional[dict] = None, ref_cache: Optional[dict] = None) -> dict:
    """One run of cell ``name``; returns the result line's object.  ``precision`` "fp8" puts the
    reference in the program's place at that precision (the control: portbench/control.py; "bf16"
    a witness), and ``readings_out`` receives every reading of the check.  ``config_file`` (in
    place of the cell's) and ``fault`` (called with the run's program objects before set-up's
    steps, to break the timed path) serve the CPU tests and portbench/control.py, which passes
    ``ref_cache`` to reuse a train cell's float32 reference between runs of one seed on the same
    batches."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or benchmark()
    cell = cell_spec(bench, name)
    config_file = config_file or inp.load_json("configs", cell["config"])
    counts = load_module("counts", cell["config"])
    family = family_of(config_file)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    kind = cell["kind"]
    inputs = make_inputs(config_file, cell, seed, device, family)
    data = inputs.cfg["DATA"]
    say(f"inputs made at {time.perf_counter() - t_start:.3f} s")
    w0 = {k: v.detach().cpu().clone() for k, v in inputs.weights.items()}
    spans = drive.Spans()
    with trace.bn_ranges() if traced else contextlib.nullcontext():
        if kind == "train":
            run = drive.TrainRun(inputs, device, spans, family)
            inputs.weights = w0  # the model holds its own copy: the reference's waits on the host
            say(f"model built at {time.perf_counter() - t_start:.3f} s")
            if fault is not None:
                fault(run)
            setup = drive.train_setup(run, int(cell["check_steps"]), w0)
        else:
            run = drive.TestRun(inputs, device, spans, family)
            inputs.weights = w0
            if fault is not None:
                fault(run)
            run.chunk(-1, int(cell["warmup_episodes"]), keep=False)
        e = run.e
        drive._sync(device)
        spans.ms.clear()
        setup_s = time.perf_counter() - t_start
        say(f"set-up {setup_s:.3f} s")
        if kind == "train":
            win = drive.train_window(run, seconds, int(cell["trace_steps"]) if traced else 0, trace.profiler)
        else:
            win = drive.test_window(run, seconds, int(cell["chunk_episodes"]), int(cell["trace_episodes"]) if traced else 0,
                                    trace.profiler)
    peak_bytes = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    say(f"window {win['seconds']:.3f} s, {win['samples']} samples")
    run.close()

    summary = None
    if traced:
        t0 = time.perf_counter()
        summary = trace.summarize(win["prof"], int(cell["trace_steps"]) if kind == "train" else int(cell["trace_episodes"]) // e)
        say(f"trace read in {time.perf_counter() - t0:.1f} s: {summary['device_events']} device events")
    win.pop("prof", None)

    # the check, once the window has closed and the program's state is freed
    t0 = time.perf_counter()
    prec = Precision(precision)
    arch = config_file["arch"]
    t = int(data["NUM_INPUT_FRAMES"])
    way = int(inputs.cfg["TRAIN"]["WAY"])
    if kind == "train":
        batches = [drive.host_batch(b) for b in setup["batches"]]
        program = {k: setup[k] for k in ("losses", "first_grad", "moment", "moment2", "change", "change_t")}
        del run
        drive.free()
        crop, hw = int(data["TRAIN_CROP_SIZE"]), tuple(inputs.bank.shape[1:3])
        bad = sum(judge.episode_bad_rows(inputs.table, {k: v[i] for k, v in b.items()}, t, way, crop, hw)
                  for b in batches for i in range(len(b["support"])))
        if ref_cache is not None and ref_cache.get("batches") is not None and _same_batches(ref_cache["batches"], batches):
            ref = ref_cache["ref"]
        else:
            ref = judge.reference_train(inputs, batches, family, arch, device, Precision("fp32"))
            if ref_cache is not None:
                ref_cache.update(batches=batches, ref=ref)
        if precision != "fp32":  # the control: the reference in the program's place
            program = judge.reference_train(inputs, batches, family, arch, device, prec)
        readings = judge.train_readings(program, ref, bad)
    else:
        picks = drive.pick_episodes(run.logits, int(cell["check_episodes"]), seed)
        program_logits = drive.pick_logits(run.logits, picks)
        del run
        drive.free()
        episodes = drive.redraw_test_episodes(inputs, e, picks)
        bad = sum(judge.episode_bad_rows(inputs.table, ep, t, way) for ep in episodes)
        ref = judge.reference_test_logits(inputs, episodes, family, arch, device, Precision("fp32"))
        if precision != "fp32":
            program_logits = judge.reference_test_logits(inputs, episodes, family, arch, device, prec)
        readings = judge.test_readings(program_logits, ref, bad)
    check_s = time.perf_counter() - t0
    correct, compared = judge.verdict(readings, cell["limits"])
    if readings_out is not None:
        raw = {"program": _plain(program), "reference": _plain(ref)} if kind == "train" else {
            "program": [x.tolist() for x in program_logits], "reference": [x.tolist() for x in ref]}
        readings_out.update(readings, check_s=check_s, setup_s=setup_s, raw=raw)
    say(f"check {check_s:.1f} s; readings {json.dumps(readings)}")

    result = {"correct": bool(correct), "attempted": int(win["samples"]), "failed": 0}
    dev = device_info(device, peak_bytes, summary)
    if traced:
        card = torch.cuda.get_device_name(device) if device.type == "cuda" else "H100"  # the CPU tests read against the H100
        ctx = {"kind": kind, "cell": cell, "cfg": inputs.cfg, "counts": counts, "spans": spans.ms, "trace": summary,
               "window": win, "episodes_per_step": e, "peak": peaks(card)}
        metrics = {}
        for m in metrics_of(bench, cell, "per_layer"):
            value = load_module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        result["metrics"] = metrics
        result["device"] = dev
        result["breakdown"] = trace.breakdown(summary)
    else:
        values = {"setup_s": setup_s, "peak_gib": peak_bytes / 2**30,
                  f"{kind}_samples_per_s": win["samples"] / win["seconds"]}
        result["metrics"] = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                             for m in metrics_of(bench, cell, "end_to_end")}
        result["device"] = dev
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    for k, (v, lim) in compared.items():
        say(f"compared {k} {v!r} limit {lim!r}")
    return result


def _same_batches(a: list, b: list) -> bool:
    import numpy as np

    return len(a) == len(b) and all(x.keys() == y.keys() and all(np.array_equal(np.asarray(x[k]), np.asarray(y[k])) for k in x)
                                    for x, y in zip(a, b))


def _plain(readings: dict) -> dict:
    """The readings without their host tensors (for a JSON dump)."""
    return {k: v for k, v in readings.items() if k not in ("change_t", "moment_t")}


def device_info(device: torch.device, peak_bytes: int, summary: Optional[dict]) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1, "memory_peak_bytes": int(peak_bytes),
           "power_limit_w": power_limit()}
    if summary is not None:
        out["busy_s"] = summary["busy_s"]
        out["window_s"] = summary["window_s"]
    return out


def power_limit() -> Optional[float]:
    """The card's power limit in watts as nvidia-smi reads it, or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None

