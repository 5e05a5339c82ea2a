"""BENCHMARK.json against the files the harness finds by name, and a cell, configuration and
per-layer metric dropped in as files and entries, found without a code edit."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

CHECKOUT = harness.CHECKOUT
BENCH = harness.benchmark()


def missing_files(bench: dict, checkout: str) -> list:
    """The files that the names in ``bench`` lead to and that ``checkout`` lacks: each
    configuration's file, its counts and its family's module."""
    root = os.path.join(checkout, "portbench")
    missing = []
    for c in bench["configs"]:
        need = [os.path.join(checkout, c["file"]), os.path.join(root, "counts", c["name"] + ".py")]
        if os.path.exists(need[0]):
            with open(need[0]) as f:
                need.append(os.path.join(root, "families", json.load(f)["family"] + ".py"))
        missing += [p for p in need if not os.path.exists(p)]
    return missing


def test_every_name_has_its_files():
    missing = missing_files(BENCH, CHECKOUT)
    assert not missing, f"missing: {missing}"
    for c in BENCH["configs"]:
        cf = json.load(open(os.path.join(CHECKOUT, c["file"])))
        assert cf["reduced"] == c["reduced"] and cf["source"] == c["source"]
    for w in BENCH["workloads"]:
        spec = harness.cell_spec(BENCH, w["name"])
        assert spec["kind"] in ("train", "test") and spec["config"] == w["config"]
        assert {m["name"] for m in harness.metrics_of(BENCH, spec, "end_to_end")} >= {"setup_s", f"{spec['kind']}_samples_per_s"}
        assert harness.metrics_of(BENCH, spec, "per_layer")


def test_a_family_with_no_file_is_named(tmp_path):
    """A configuration whose family has no module fails the layout check, which names the path."""
    cf = json.load(open(os.path.join(harness.ROOT, "configs", "clipfsar_rn50.json")))
    cf["family"] = "no_such_family"
    (tmp_path / "portbench" / "configs").mkdir(parents=True)
    (tmp_path / "portbench" / "configs" / "clipfsar_rn50.json").write_text(json.dumps(cf))
    bench = {"configs": [c for c in BENCH["configs"] if c["name"] == "clipfsar_rn50"]}
    assert str(tmp_path / "portbench" / "families" / "no_such_family.py") in missing_files(bench, str(tmp_path))


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_metric_has_a_reader(metric):
    mod = harness.load_module("metrics", metric)
    assert callable(mod.read)
    assert not {"LAYER", "UNIT", "BETTER", "SOURCE", "MOVES"} & set(vars(mod)), "BENCHMARK.json alone says these"


def test_a_dropped_in_cell_config_and_metric_are_found(tmp_path):
    """Copies of the benchmark with a new configuration, cell and metric added as files and
    entries: the harness lists them, unedited."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cf = json.load(open(os.path.join(CHECKOUT, "portbench/configs/clipfsar_vitb16.json")))
    cf["name"] = "clipfsar_vitb32"
    (root / "portbench/configs/clipfsar_vitb32.json").write_text(json.dumps(cf))
    shutil.copy(root / "portbench/counts/clipfsar_vitb16.py", root / "portbench/counts/clipfsar_vitb32.py")
    (root / "portbench/workloads/clipfsar_vitb32.test_bank.json").write_text(
        (root / "portbench/workloads/clipfsar_vitb16.test_bank.json").read_text())
    (root / "portbench/metrics/launches_per_step.py").write_text("def read(ctx):\n    return 7.0 if ctx['kind'] == 'test' else 8.0\n")
    bench["configs"].append({"name": "clipfsar_vitb32", "source": "x", "file": "portbench/configs/clipfsar_vitb32.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "clipfsar_vitb32.test_bank", "config": "clipfsar_vitb32", "traffic": "test_bank",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "launches_per_step.test", "unit": "1", "better": "lower", "source": "device_trace",
                               "layer": "step launch", "moves": "test_samples_per_s", "workloads": ["clipfsar_vitb32.test_bank"]})
    for m in bench["end_to_end"]:
        if m["name"] == "test_samples_per_s":
            m["workloads"].append("clipfsar_vitb32.test_bank")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    probe = (
        "import json, sys; sys.path.insert(0, %r)\n"
        "from portbench import harness\n"
        "b = harness.benchmark(); c = harness.cell_spec(b, 'clipfsar_vitb32.test_bank')\n"
        "per = [m['name'] for m in harness.metrics_of(b, c, 'per_layer')]\n"
        "e2e = [m['name'] for m in harness.metrics_of(b, c, 'end_to_end')]\n"
        "print(json.dumps({'kind': c['kind'], 'per': per, 'e2e': e2e,"
        " 'read': harness.load_module('metrics', 'launches_per_step.test').read({'kind': 'test'}),"
        " 'counts': harness.load_module('counts', c['config']).__name__}))\n" % str(root))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, cwd=str(root), check=True).stdout
    got = json.loads(out.strip().splitlines()[-1])
    assert got["kind"] == "test" and got["per"] == ["launches_per_step.test"] and got["read"] == 7.0
    assert set(got["e2e"]) == {"test_samples_per_s", "peak_gib", "setup_s"}
