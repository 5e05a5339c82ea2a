"""TASK_TYPE localization and submission through ``python -m
clip_fsar_torch.runs.run --device cpu`` on configs/localization/BMN_EPIC100.yaml
at a tiny size (T = D = 32, 16 feature channels, N = 8, 3 verbs and 4
nouns, synthetic features): train two epochs, test and submit; the mAP dict
and the submission JSON against the JAX runners on the trained weights; and
the refusal of a process group of more than one rank."""

import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "localization", "BMN_EPIC100.yaml")
TINY = ["DATA.TEMPORAL_SCALE", "32", "DATA.DURATION_SCALE", "32", "DATA.NUM_INPUT_CHANNELS", "16", "DATA.DECODER", "synthetic",
        "VIDEO.DIM1D", "32", "VIDEO.DIM2D", "16", "VIDEO.DIM3D", "16", "VIDEO.HEAD.NUM_SAMPLE", "8", "VIDEO.HEAD.NUM_CLASSES", "[3, 4]",
        "TRAIN.BATCH_SIZE", "4", "TEST.BATCH_SIZE", "4", "SOLVER.MAX_EPOCH", "2", "SOLVER.WARMUP_EPOCHS", "0", "LOG_PERIOD", "1",
        "SUBMISSION.SAVE_RESULTS_PATH", "sub.json"]


def _cli(out_dir, task: str):
    cmd = [sys.executable, "-m", "clip_fsar_torch.runs.run", "--cfg", CONFIG, "--device", "cpu", *TINY, "TASK_TYPE", task, "OUTPUT_DIR", str(out_dir)]
    proc = subprocess.run(cmd, cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "2"}, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout + proc.stderr


def _flax_params(state: dict) -> dict:
    """The port's BMNModel state dict -> the JAX BMNModel's params tree."""
    params: dict = {}
    for key, v in state.items():
        *path, leaf = key.split(".")
        node = params
        for p in path:
            node = node.setdefault(p, {})
        v = v.numpy()
        node["kernel" if leaf == "weight" else leaf] = v.transpose(*range(2, v.ndim), 1, 0) if leaf == "weight" else v
    return params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's CLI: localization (train, then test the step-2 checkpoint)
    and submission in one OUTPUT_DIR; the JAX runners' test and submission
    on the weights the port trained."""
    from clip_fsar_tpu.config.config import load_config
    from clip_fsar_tpu.train import localization as jloc

    root = tmp_path_factory.mktemp("tal_cli")
    out = root / "port"
    log = _cli(out, "localization")
    sub_log = _cli(out, "submission")
    state = torch.load(str(out / "checkpoints" / "2.pt"), map_location="cpu", weights_only=True)["head"]
    variables = {"params": _flax_params(state)}
    jcfg = load_config(CONFIG, TINY + ["OUTPUT_DIR", str(root / "jax")])
    with mock.patch.object(jloc.BMNModel, "init", lambda self, rng: variables):
        stats = jloc.test_epic_localization(jcfg)
        with open(jloc.submission_test(jcfg)) as f:
            want_sub = json.load(f)
    with open(out / "sub.json") as f:
        sub = json.load(f)
    port_stats = [json.loads(line[line.index("{"):]) for line in log.splitlines() if '"tal_eval"' in line]
    epochs = [json.loads(line[line.index("{"):]) for line in log.splitlines() if '"tal_train_epoch"' in line]
    return {"log": log, "sub_log": sub_log, "port_stats": port_stats, "epochs": epochs, "jax_stats": stats, "sub": sub, "jax_sub": want_sub,
            "out": out}


def test_cli_trains_tests_and_submits(runs):
    """Both runners ran, two epochs of finite losses, the test read the
    step-2 checkpoint, and the submission read it too."""
    assert "=== run: train_localization ===" in runs["log"] and "=== run: test_epic_localization ===" in runs["log"]
    assert "=== run: submission_test ===" in runs["sub_log"]
    assert [e["epoch"] for e in runs["epochs"]] == [1, 2] and all(np.isfinite(e["loss"]) for e in runs["epochs"])
    assert "testing with checkpoint at step 2" in runs["log"] and "testing with checkpoint at step 2" in runs["sub_log"]


def test_map_matches_jax_on_the_same_weights(runs):
    """The port's mAP dict (its tal_eval line: 3 streams x 5 tIoUs and their
    averages, rounded to 4 digits) is the JAX runner's on the same weights."""
    (got,) = runs["port_stats"]
    want = runs["jax_stats"]
    assert set(got) - {"_type"} == set(want) and len(want) == 18
    for k, v in want.items():
        assert got[k] == round(v, 4), k


def test_submission_json_matches_jax_on_the_same_weights(runs):
    """The EPIC submission JSON: the JAX runner's (given the weights the port
    trained) in schema, videos, detections and labels; scores at 1e-5."""
    got, want = runs["sub"], runs["jax_sub"]
    assert {k: v for k, v in got.items() if k != "results"} == {k: v for k, v in want.items() if k != "results"}
    assert got["results"].keys() == want["results"].keys() and sum(len(v) for v in want["results"].values()) > 0
    for video, dets in want["results"].items():
        assert len(got["results"][video]) == len(dets), video
        for g, w in zip(got["results"][video], dets):
            assert {k: g[k] for k in ("label", "verb", "noun")} == {k: w[k] for k in ("label", "verb", "noun")}
            np.testing.assert_allclose(g["segment"], w["segment"], rtol=1e-6)
            np.testing.assert_allclose(g["score"], w["score"], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("task", ["localization", "submission"])
def test_cli_refuses_a_process_group(tmp_path, task):
    """Under a launcher's WORLD_SIZE of 2 the CLI raises before any work:
    the localization runners run as one process."""
    from clip_fsar_torch.runs.run import main

    with mock.patch.dict(os.environ, {"WORLD_SIZE": "2"}), pytest.raises(NotImplementedError, match="under a process group of 2 ranks"):
        main(["--cfg", CONFIG, "--device", "cpu", *TINY, "TASK_TYPE", task, "OUTPUT_DIR", str(tmp_path)])
    assert not os.path.exists(tmp_path / "checkpoints") and not os.path.exists(tmp_path / "sub.json")
