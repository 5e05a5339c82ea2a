"""Nothing a run imports is the JAX stack or the JAX package (by whole top-level names), the
reference imports nothing of the port, and a run without a card, or without the port beside
the benchmark, prints no result and exits non-zero."""

from __future__ import annotations

import ast
import glob
import json
import os
import shutil
import subprocess
import sys

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "clip_fsar_tpu"}


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in glob.glob(os.path.join(harness.ROOT, "**", "*.py"), recursive=True):
        assert not (_imports(path) & FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_port():
    for path in glob.glob(os.path.join(harness.ROOT, "reference", "*.py")):
        assert "clip_fsar_torch" not in _imports(path), path


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run on the CPU in a fresh process, then the run's own test of sys.modules."""
    probe = (
        "import json, sys; sys.path.insert(0, %r)\n"
        "from portbench import harness, run\n"
        "from portbench.tests import tiny\n"
        "cf = tiny.config('clipfsar_rn50', tiny.write_splits(%r))\n"
        "harness.run_cell('clipfsar_rn50.test_bank', 5, 0.5, True, 'cpu', config_file=cf)\n"
        "print(json.dumps(run.forbidden_modules()))\n" % (harness.CHECKOUT, str(tmp_path / "splits")))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, cwd=harness.CHECKOUT, check=True).stdout
    assert json.loads(out.strip().splitlines()[-1]) == []


def _run(cwd: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "clipfsar_rn50.test_bank", "--seed", "3",
                           "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=cwd, timeout=300)


def test_no_card_no_result():
    out = _run(harness.CHECKOUT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_port_no_result(tmp_path):
    shutil.copytree(harness.ROOT, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.CHECKOUT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = _run(str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""
    json.loads((tmp_path / "BENCHMARK.json").read_text())
