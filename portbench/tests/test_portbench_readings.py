"""The four cells' inputs and check readings at the tiny size on the CPU, held to the bit to those
recorded in ``readings.json`` before the harness reached CLIP-FSAR through a configuration family:
the checksums of the weights, text banks and bank a seed makes, and every reading of the check
(the numbers compared, the worst leaves, the program's and the reference's norms by leaf or logits),
with the program in bf16 and in float32.

The CPU's convolutions and products round as the torch build and the instruction set it
dispatches to (``torch.backends.cpu.get_cpu_capability()``) have them, so ``readings.json`` keeps
both beside the commit it was recorded on, and the readings are held to the bit only on a host
that matches.  On another host the input checksums are still held to the bit, the float32
program has to read correct with every number compared under ``FOREIGN_SHARE`` of its limit, and
the bf16 readings are not held (the test skips there and says why).  Recorded with torch 2.13 on
AVX-512, against torch 2.11 on AVX-512 and torch 2.13 dispatching AVX2: the checksums were equal
on all three, the float32 numbers compared at most 4.6e-4 of their limits, and the bf16 numbers
moved by up to 80x (their rounding gaps).  ``record`` runs on a tree from before the family too,
so a recording can be made there and compared:

    python3 -m portbench.tests.test_portbench_readings [--out PATH] [--commit SHA]
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import sys
import tempfile

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

CELLS = ["clipfsar_vitb16.train_bank", "clipfsar_rn50.train_bank", "clipfsar_vitb16.test_bank", "clipfsar_rn50.test_bank"]
SEED = 2**31 + 977  # test_portbench_reference.py's
THREADS = 4  # the CPU's reductions split by thread: the same count when recording and when checking
WINDOW_S = 0.05  # one train step or one evaluate chunk: the test cells' check picks from the window's episodes
FOREIGN_SHARE = 1e-2  # float32 numbers compared on another host: rounding, measured at most 4.6e-4 of the limit
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "readings.json")


def digest(tensors: dict) -> str:
    """sha256 over each tensor's name, dtype, shape and bytes, in name order."""
    h = hashlib.sha256()
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        h.update(f"{name}|{t.dtype}|{tuple(t.shape)}|".encode())
        h.update(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")
    return h.hexdigest()


@contextlib.contextmanager
def threads(n: int):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _plain(x):
    """JSON-safe copy: dict keys as strings, tuples as lists, tensors refused."""
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, torch.Tensor):
        raise TypeError("a tensor among the readings")
    return x


def record(cell: str, fp32: bool, splits: str) -> dict:
    """One cell's input checksums and check readings at ``SEED`` (the raw readings, every norm by
    leaf or logit of both sides, as one checksum)."""
    cf = tiny.config(cell.split(".")[0], splits, fp32)
    bench = harness.benchmark()
    with threads(THREADS):
        # a tree from before the family: its harness knows one head and takes none
        family = (harness.family_of(cf),) if hasattr(harness, "family_of") else ()
        inputs = harness.make_inputs(cf, harness.cell_spec(bench, cell), SEED, torch.device("cpu"), *family)
        sums = {"weights": digest(inputs.weights), "text": digest({"train": inputs.text_train, "test": inputs.text_test}),
                "bank": digest({"bank": inputs.bank})}
        del inputs
        readings: dict = {}
        out = harness.run_cell(cell, SEED, WINDOW_S, False, "cpu", bench=bench, config_file=cf, readings_out=readings)
    for timing in ("check_s", "setup_s"):
        readings.pop(timing)
    raw = json.dumps(_plain(readings.pop("raw")), sort_keys=True)  # floats by repr: the same text for the same bits
    sums["raw"] = hashlib.sha256(raw.encode()).hexdigest()
    return _plain({"inputs": sums, "correct": out["correct"], "compared": out["compared"], "readings": readings})


CASES = [(c, p) for c in CELLS for p in ("bf16", "fp32")]


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    return tiny.write_splits(str(tmp_path_factory.mktemp("splits")))


def host() -> dict:
    """What the CPU's rounding depends on, besides the thread count."""
    return {"torch": torch.__version__, "cpu_capability": torch.backends.cpu.get_cpu_capability(), "threads": THREADS}


@pytest.fixture(scope="module")
def recorded():
    with open(FIXTURE) as f:
        return json.load(f)


@pytest.mark.parametrize("cell,precision", CASES)
def test_readings_are_the_recorded_ones(cell, precision, splits, recorded):
    on = recorded["recorded_on"]
    want = recorded[f"{cell}.{precision}"]
    got = record(cell, precision == "fp32", splits)
    for part in ("weights", "text", "bank"):
        assert got["inputs"][part] == want["inputs"][part], part
    if {k: on[k] for k in host()} != host():
        if precision != "fp32":
            pytest.skip(f"readings.json was recorded with {on}, this host is {host()}: bf16 rounds otherwise")
        assert got["correct"] is True
        for name, c in got["compared"].items():
            assert c["value"] <= FOREIGN_SHARE * c["limit"], (name, c)
        return
    assert got["compared"] == want["compared"]
    assert got["readings"] == want["readings"]
    assert got == want


def main() -> int:
    ap = argparse.ArgumentParser(description="record the four tiny cells' inputs and readings")
    ap.add_argument("--out", default=FIXTURE)
    ap.add_argument("--commit", default=None, help="the commit of the tree recorded, kept in the file")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as d:
        splits = tiny.write_splits(os.path.join(d, "splits"))
        out = {f"{c}.{p}": record(c, p == "fp32", splits) for c, p in CASES}
    out["recorded_on"] = {**host(), "commit": args.commit}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
