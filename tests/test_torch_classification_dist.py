"""Classification under data parallelism: two gloo ranks (processes of
tests/_torch_cls_dist_worker.py meeting through a FileStore in the test's tmp
dir, each under a timeout) against one process with no group, on the tiny
TAda2D config with jitter, random erasing and elem-mode mixup / cutmix on.
Each rank loads its half of every global batch of 4 (drawing the other
half's random numbers without decoding it), the augmentation and mixup draws
are the global batch's, mixup's partners come from the other rank, and the
gradient and metrics are all-reduced; the test gathers both ranks' scores in
clip order for the meter."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_cls_dist_worker.py")
TIMEOUT_S = 300


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cls_dist")
    anno = root / "lists"
    anno.mkdir()
    for split, n in (("train", 12), ("test", 3)):
        with open(anno / f"kinetics400_{split}_list.txt", "w") as f:
            for i in range(n):
                f.write(f"videos/c{i % 4}/{split}_{i:03d}.mp4 {i % 4}\n")
    procs = {}
    for name, world, rank in (("world1", 1, 0), ("rank0", 2, 0), ("rank1", 2, 1)):
        procs[name] = subprocess.Popen(
            [sys.executable, WORKER, "--world", str(world), "--rank", str(rank), "--store", str(root / "store"), "--anno", str(anno),
             "--run", str(root / name), "--out", str(root / f"{name}.pt")],
            env={**os.environ, "OMP_NUM_THREADS": "2"}, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        logs = {name: p.communicate(timeout=TIMEOUT_S)[0] for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, p in procs.items():
        assert p.returncode == 0, f"{name} failed:\n{logs[name][-4000:]}"
    return {name: torch.load(str(root / f"{name}.pt"), weights_only=False) for name in procs}


def test_two_ranks_train_as_one_process(runs):
    """Three steps: losses at 1e-4; the all-reduced gradient of every step
    and the parameters after training at 2e-4 (fp32); the two ranks the same
    bits."""
    one, r0, r1 = runs["world1"], runs["rank0"], runs["rank1"]
    assert one["stats"]["steps"] == r0["stats"]["steps"] == 3 and r0["stats"]["updates"] == 3
    np.testing.assert_allclose(r0["stats"]["losses"], one["stats"]["losses"], atol=1e-4, rtol=1e-4)
    for g2, g1 in zip(r0["grads"], one["grads"]):
        for name, g in g1.items():
            torch.testing.assert_close(g2[name], g, atol=2e-4, rtol=2e-4, msg=lambda m, name=name: f"grad {name}: {m}")
    for key, v in one["state"].items():
        torch.testing.assert_close(r0["state"][key], v, atol=2e-4, rtol=2e-4, msg=lambda m, key=key: f"{key}: {m}")
        assert torch.equal(r0["state"][key], r1["state"][key]), key
    assert r0["stats"]["losses"] == r1["stats"]["losses"]


def test_two_ranks_test_as_one_process(runs):
    """The multi-view test (3 videos x 2 views in global batches of 4, the
    last padded): every rank's meter holds one process's per-video scores
    at 1e-4, with every clip of every video counted once."""
    one, r0, r1 = runs["world1"]["test"], runs["rank0"]["test"], runs["rank1"]["test"]
    assert one["weights"].endswith("1.pt") and r0["weights"].endswith("1.pt")
    for got in (r0, r1):
        np.testing.assert_allclose(got["video_preds"], one["video_preds"], atol=1e-4, rtol=1e-4)
        assert np.array_equal(got["clip_count"], one["clip_count"]) and (one["clip_count"] == 2).all()
