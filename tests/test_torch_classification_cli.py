"""The classification CLI of clip_fsar_torch against clip_fsar_tpu's
runs/run.py on the CPU: configs/classification/TAda2D_K400.yaml at a tiny
size (26-bottleneck TAda2D of narrow widths, 4 frames of 32 px, fp32) on
synthetic Kinetics-400 lists, both packages starting from the JAX model's
weights as a ``.npz`` archive named by TRAIN.CHECKPOINT_FILE_PATH: one
epoch of training, validation, checkpoints, the test of the trained
checkpoint and the automatic multi-scale re-test (10 views x 3 crops).
Per-video scores at 1e-4, top-1 / top-5 equal.  Then the same drive with
jax and clip_fsar_tpu unimportable, the refusal without a card, and EPIC's
train, test and submission JSON."""

import json
import os
import subprocess
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from tests.torch_video_parity import SMALL_RESNET, REPO, cfg_dict

torch.set_num_threads(2)

# TRAIN.BATCH_SIZE and TEST.BATCH_SIZE are multiples of the JAX tests' 8-device CPU mesh
CONFIG = os.path.join(REPO, "configs", "classification", "TAda2D_K400.yaml")
TINY = ["VIDEO.BACKBONE.DEPTH", "26", "VIDEO.BACKBONE.NUM_FILTERS", "[8, 16, 16, 32, 32]", "VIDEO.HEAD.NUM_CLASSES", "4",
        "DATA.NUM_INPUT_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32", "DATA.TEST_SCALE", "36",
        "DATA.TRAIN_JITTER_SCALES", "[36, 44]", "DATA.DECODER", "synthetic", "TPU.COMPUTE_DTYPE", "float32", "SOLVER.MAX_EPOCH", "1",
        "TRAIN.EVAL_PERIOD", "1", "TRAIN.BATCH_SIZE", "8", "TEST.BATCH_SIZE", "8", "DATA_LOADER.NUM_WORKERS", "2", "LOG_PERIOD", "1"]


def _lists(root, train: int = 16, test: int = 3, epic: bool = False) -> str:
    os.makedirs(root, exist_ok=True)
    name = "epickitchen100" if epic else "kinetics400"
    for split, n in (("train", train), ("test", test)):
        with open(os.path.join(root, f"{name}_{split}_list.txt"), "w") as f:
            for i in range(n):
                label = f"{i % 3} {i % 2}" if epic else f"{i % 4}"
                f.write(f"videos/c{i % 4}/{split}_{i:03d}.mp4 {label}\n")
    return str(root)


def _start_weights(tmp_path, head=(("VIDEO.HEAD.NUM_CLASSES", 4),), name: str = "start") -> str:
    """The JAX model's fresh variables for the tiny config, as an archive."""
    from clip_fsar_tpu.config import Config as JaxConfig
    from clip_fsar_tpu.models.video.model import build_video_model
    from clip_fsar_tpu.train.pretrain import save_weights_npz

    d = cfg_dict("tada2d", 4, SMALL_RESNET + (("VIDEO.BACKBONE.DEPTH", "26"),) + head)
    model = build_video_model(JaxConfig(d))
    v = jax.device_get(model.init(jax.random.PRNGKey(5), np.zeros((1, 4, 32, 32, 3), np.float32), train=False))
    path = str(tmp_path / f"{name}.npz")
    save_weights_npz(path, v)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs on the same lists and start weights: (port results, JAX
    per-video scores and stats of its two tests, the overrides)."""
    from clip_fsar_tpu.runs import run as jax_run
    from clip_fsar_tpu.utils import meters as jax_meters
    from clip_fsar_torch.runs.run import main

    tmp = tmp_path_factory.mktemp("cli")
    argv = TINY + ["DATA.ANNO_DIR", _lists(tmp / "lists"), "TRAIN.CHECKPOINT_FILE_PATH", _start_weights(tmp)]
    seen = []
    finalize = jax_meters.TestMeter.finalize_metrics

    def capture(self, *a, **k):
        stats = finalize(self, *a, **k)
        seen.append((self.video_preds.copy(), self.clip_count.copy(), stats))
        return stats

    with mock.patch.object(jax_meters.TestMeter, "finalize_metrics", capture):
        assert jax_run.main(["--cfg", CONFIG, *argv, "OUTPUT_DIR", str(tmp / "jax")]) == 0
    port = main(["--cfg", CONFIG, "--device", "cpu", *argv, "OUTPUT_DIR", str(tmp / "port")])
    return port, seen, argv, tmp


def test_cli_trains_validates_checkpoints_and_tests_like_jax(runs):
    port, seen, _, tmp = runs
    train = port["train"]
    assert train["init_weights"].endswith("start.npz") and train["steps"] == 2 and train["updates"] == 2
    assert np.isfinite(train["losses"]).all() and "best_top1" in train
    assert sorted(os.listdir(tmp / "port" / "checkpoints")) == ["1.pt"]
    single, multi = port["test"]
    assert single["weights"].endswith(os.path.join("checkpoints", "1.pt")) and len(seen) == 2
    for got, (want_preds, want_counts, want_stats) in zip((single, multi), seen):
        np.testing.assert_allclose(got["meter"].video_preds, want_preds, atol=1e-4, rtol=1e-4)
        assert np.array_equal(got["meter"].clip_count, want_counts)
        assert (got["top1_acc"], got["top5_acc"]) == (want_stats["top1_acc"], want_stats["top5_acc"])


def test_multi_scale_retest_sees_thirty_clips_a_video(runs):
    """Kinetics: 10 ensemble views x 3 spatial crops after the single-view test."""
    port, _, _, _ = runs
    single, multi = port["test"]
    assert single["clips_per_video"] == 1 and multi["clips_per_video"] == 30
    assert 0.0 <= multi["top1_acc"] <= multi["top5_acc"] <= 100.0


_NO_JAX = """
import sys
for name in ("clip_fsar_tpu", "jax", "jaxlib", "flax", "optax", "orbax"):
    sys.modules[name] = None  # any import of them now raises ImportError
from clip_fsar_torch.runs.run import main
out = main(sys.argv[1:])
single, multi = out["test"]
assert out["train"]["steps"] == 2 and multi["clips_per_video"] == 30, out
print("CLS_OK", single["top1_acc"], multi["top1_acc"])
"""


def test_cli_runs_with_jax_blocked(runs):
    """The port's drive again with clip_fsar_tpu, jax, jaxlib, flax, optax and
    orbax unimportable, from the same ``.npz`` start weights."""
    _, _, argv, tmp = runs
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, "--cfg", CONFIG, "--device", "cpu", *argv, "OUTPUT_DIR", str(tmp / "blocked")],
                          cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "2"}, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "CLS_OK" in proc.stdout


def test_cli_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    from clip_fsar_torch.runs.run import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--cfg", CONFIG, *TINY, "DATA.ANNO_DIR", _lists(tmp_path / "lists"), "OUTPUT_DIR", str(tmp_path / "out")])
    assert not os.path.exists(tmp_path / "out")


def test_epic_train_test_and_submission_json(tmp_path):
    """EPIC verb + noun (BaseHeadx2, NUM_CLASSES [3, 2]): the port trains with
    the dual-head loss, tests with the EPIC meter and writes the submission
    JSON (10 views x 3 crops); from the same ``.npz`` weights its per-video
    ensembled scores are the JAX package's submission_test's at 1e-4."""
    from clip_fsar_tpu.config.config import load_config as jax_load_config
    from clip_fsar_tpu.train.classification import submission_test as jax_submission
    from clip_fsar_torch.runs.run import main

    epic = ["TRAIN.DATASET", "Epickitchen100", "TEST.DATASET", "Epickitchen100", "VIDEO.HEAD.NAME", "BaseHeadx2",
            "VIDEO.HEAD.NUM_CLASSES", "[3, 2]", "SUBMISSION.ENABLE", "True", "TEST.AUTOMATIC_MULTI_SCALE_TEST", "False",
            "DATA.ANNO_DIR", _lists(tmp_path / "lists", epic=True)]
    out = main(["--cfg", CONFIG, "--device", "cpu", *TINY, *epic, "OUTPUT_DIR", str(tmp_path / "out")])
    assert np.isfinite(out["train"]["losses"]).all() and out["train"]["updates"] == 2
    assert {"top_1_acc_verb", "top_1_acc_noun", "top_1_acc_action", "top_5_acc_joint"} <= set(out["test"])
    with open(out["submission_classification"]["submission"]) as f:
        trained = json.load(f)
    assert trained["version"] == "0.2" and len(trained["results"]) == 3

    start = _start_weights(tmp_path, (("VIDEO.HEAD.NAME", "BaseHeadx2"), ("VIDEO.HEAD.NUM_CLASSES", (3, 2))), "epic")
    same = [*TINY, *epic, "TRAIN.ENABLE", "False", "TEST.ENABLE", "False", "TEST.CHECKPOINT_FILE_PATH", start]
    got = main(["--cfg", CONFIG, "--device", "cpu", *same, "OUTPUT_DIR", str(tmp_path / "port")])["submission_classification"]
    assert got["weights"] == start
    jcfg = jax_load_config(CONFIG, [*same, "OUTPUT_DIR", str(tmp_path / "jax"), "TEST.NUM_ENSEMBLE_VIEWS", "10", "TEST.NUM_SPATIAL_CROPS", "3"])
    jax_submission(jcfg)
    with open(tmp_path / "port" / "submission.json") as f:
        got = json.load(f)
    with open(tmp_path / "jax" / "submission.json") as f:
        want = json.load(f)
    assert set(got["results"]) == set(want["results"])
    for video, scores in want["results"].items():
        for head in ("verb", "noun"):
            np.testing.assert_allclose([got["results"][video][head][c] for c in scores[head]], list(scores[head].values()), atol=1e-4, rtol=1e-4)


def test_feature_map_visualization_writes_the_jax_packages_files(tmp_path):
    """VISUALIZATION.FEATURE_MAPS during the test (forward hooks on the residual
    blocks where the JAX package sows them): from the same ``.npz`` weights the
    same image files under the same names as the JAX package's test writes,
    one directory per real clip, and the same tiles (JPEG-decoded, within 2
    levels of 255)."""
    import cv2

    from clip_fsar_tpu.config.config import load_config as jax_load_config
    from clip_fsar_tpu.train.classification import test as jax_test
    from clip_fsar_torch.runs.run import load_config
    from clip_fsar_torch.train.classification import test

    start = _start_weights(tmp_path)
    opts = [*TINY, "DATA.ANNO_DIR", _lists(tmp_path / "lists"), "TEST.CHECKPOINT_FILE_PATH", start, "VISUALIZATION.ENABLE", "True",
            "VISUALIZATION.NAME", "tada", "VISUALIZATION.FEATURE_MAPS.ENABLE", "True"]
    jax_test(jax_load_config(CONFIG, opts + ["OUTPUT_DIR", str(tmp_path / "jax"), "VISUALIZATION.FEATURE_MAPS.BASE_OUTPUT_DIR", str(tmp_path / "jv")]))
    test(load_config(CONFIG, opts + ["OUTPUT_DIR", str(tmp_path / "port"), "VISUALIZATION.FEATURE_MAPS.BASE_OUTPUT_DIR", str(tmp_path / "pv")]),
         device="cpu")
    want = sorted(str(p.relative_to(tmp_path / "jv")) for p in (tmp_path / "jv").rglob("*.jpg"))
    got = sorted(str(p.relative_to(tmp_path / "pv")) for p in (tmp_path / "pv").rglob("*.jpg"))
    assert got == want and len({os.path.dirname(p) for p in got}) == 3 and any("res_" in p for p in got)
    for rel in want:
        a, b = cv2.imread(str(tmp_path / "pv" / rel), cv2.IMREAD_GRAYSCALE), cv2.imread(str(tmp_path / "jv" / rel), cv2.IMREAD_GRAYSCALE)
        assert a.shape == b.shape and np.abs(a.astype(int) - b.astype(int)).max() <= 2, rel
