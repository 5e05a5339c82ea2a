"""Tensor parallelism where the JAX package cannot be the reference (its
dropout and jitter draw from other generators): the port at TPU.MESH
{DATA: 1, MODEL: 2} (two gloo ranks, tests/_torch_tp_worker.py) against the
port at MODEL 1 (one process, no group), on the CPU at the tiny archs in
float32, through the entry points.

- CLIP-FSAR training with the heads' dropout, the jitter and
  TRAIN.CLIP_GRAD_NORM on: each mask on a sharded activation is the slice of
  the full-width draw, so the two runs draw the same masks;
- LARS (per-tensor norms of the full tensors);
- checkpoints: written at MODEL 2 and resumed at MODEL 1, and the reverse,
  each resumed step the uninterrupted run's;
- TimeSformer classification training with its attention-probability,
  feed-forward and stochastic-depth dropout on;
- TPU.REMAT, TPU.FRAME_CHUNKS and the flash attention path at MODEL 2."""

import os

import numpy as np
import pytest
import torch

from tests.torch_parity import CONFIG, REPO, TINY_OPTS
from tests.torch_tp_parity import TP, TRAIN_OPTS, assert_close, assert_params_close, workers

torch.set_num_threads(2)

STEPS = 3
CLIP = 0.05  # TRAIN.CLIP_GRAD_NORM, below the tiny model's gradient norm: every step is clipped
TIMESFORMER = ["VIDEO.BACKBONE.DEPTH", "2", "VIDEO.BACKBONE.NUM_FEATURES", "32", "VIDEO.BACKBONE.NUM_OUT_FEATURES", "32",
               "VIDEO.BACKBONE.NUM_HEADS", "4", "VIDEO.BACKBONE.ATTN_DROPOUT", "0.1", "VIDEO.BACKBONE.FF_DROPOUT", "0.1",
               "VIDEO.BACKBONE.DROP_PATH", "0.1", "VIDEO.HEAD.NUM_CLASSES", "4", "DATA.NUM_INPUT_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32",
               "DATA.TEST_CROP_SIZE", "32", "DATA.TEST_SCALE", "36", "DATA.TRAIN_JITTER_SCALES", "[36, 44]", "DATA.DECODER", "synthetic",
               "TPU.COMPUTE_DTYPE", "float32", "SOLVER.MAX_EPOCH", "1", "SOLVER.WARMUP_EPOCHS", "0", "SOLVER.BASE_LR", "0.001",
               "TRAIN.EVAL_PERIOD", "0", "TRAIN.BATCH_SIZE", "4", "DATA_LOADER.NUM_WORKERS", "1", "AUGMENTATION.COLOR_AUG", "True",
               "TRAIN.DATASET", "Kinetics400", "TEST.DATASET", "Kinetics400"]


def _timesformer_cfg(root: str) -> str:
    """TimeSformer over the classification run preset, on Kinetics-style synthetic lists of 8 train videos (2 steps of 4)."""
    for split, n in (("train", 8), ("test", 4)):
        with open(os.path.join(root, f"kinetics400_{split}_list.txt"), "w") as f:
            f.writelines(f"videos/{split}_{i:03d}.mp4 {i % 4}\n" for i in range(n))
    path = os.path.join(root, "timesformer.yaml")
    with open(path, "w") as f:
        f.write(f"_BASE_RUN: {os.path.join(REPO, 'configs', 'pool', 'run', 'training', 'from_scratch_large.yaml')}\n"
                f"_BASE_MODEL: {os.path.join(REPO, 'configs', 'pool', 'backbone', 'timesformer.yaml')}\nTASK_TYPE: classification\n")
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp_runs"))
    clipped = os.path.join(root, "clipped.yaml")  # base.yaml has no CLIP_GRAD_NORM key: a config sets it
    with open(clipped, "w") as f:
        f.write(f"_BASE: {CONFIG}\nTRAIN:\n  CLIP_GRAD_NORM: {CLIP}\n")

    def train(name, steps, out_dir, mesh=(), extra=(), wait=False):
        job = {"name": name, "kind": "fewshot", "runner": "train", "dropout": True, "jitter": True, "cfg": clipped,
               "opts": TINY_OPTS + TRAIN_OPTS + list(mesh) + list(extra) + ["TRAIN.NUM_TRAIN_TASKS", str(steps), "OUTPUT_DIR", os.path.join(root, out_dir)]}
        if wait:  # the other world's step-3 checkpoint
            job["wait_for"] = os.path.join(root, out_dir, "checkpoints", f"{STEPS}.pt")
        return job

    lars = ["SOLVER.OPTIM_METHOD", "lars", "SOLVER.BASE_LR", "0.1"]
    video = _timesformer_cfg(root)

    def timesformer(mesh=()):
        return {"name": "timesformer", "kind": "classification", "runner": "train", "cfg": video, "dropout": True,
                "opts": TIMESFORMER + list(mesh) + ["DATA.ANNO_DIR", root, "OUTPUT_DIR", os.path.join(root, f"video{len(mesh)}")]}

    remat = ["TPU.REMAT", "True", "TPU.REMAT_POLICY", "dots", "TPU.FRAME_CHUNKS", "2", "TPU.PALLAS_ATTENTION", "True"]
    groups = {
        # two model ranks: 3 steps that write a checkpoint, LARS, the resume of MODEL 1's checkpoint, TimeSformer, remat
        "m": (2, [train("train", STEPS, "m2_first", TP), train("lars", 2, "m2_lars", TP, lars),
                  train("resumed", STEPS + 1, "m1_first", TP, wait=True), timesformer(TP), train("remat", 2, "m2_remat", TP, remat)]),
        # one process: 3 steps that write a checkpoint, 4 uninterrupted, LARS, the resume of MODEL 2's checkpoint, TimeSformer
        "w": (1, [train("train", STEPS, "m1_first"), train("whole", STEPS + 1, "m1_whole"), train("lars", 2, "m1_lars", extra=lars),
                  train("resumed", STEPS + 1, "m2_first", wait=True), timesformer()]),
    }
    with workers(root, groups) as collect:
        return collect()


def _same_run(got, want, what):
    np.testing.assert_allclose(got["stats"]["losses"], want["stats"]["losses"], atol=1e-4, rtol=1e-4, err_msg=what)
    assert_params_close(got["state"], want["state"])


def test_dropout_jitter_and_clipping_at_model_2_are_model_1(runs):
    """Three steps with the prototype transformer's dropout (its sharded
    feed-forward hidden included), the jitter and clip_by_global_norm on:
    the losses at 1e-4, the full gradient each update saw and the parameters
    after the steps at 2e-4 (the key bias at 5e-4: see
    ``assert_params_close``); every step was clipped (the full gradient's
    norm above CLIP_GRAD_NORM) and the parameters moved."""
    got, want = runs["m0"]["train"], runs["w"]["train"]
    _same_run(got, want, "model 2 against model 1")
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        assert_close(g["grads"], w["grads"], 2e-4, f"step {i} grad")
        assert torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(v) for v in w["grads"].values()])) > CLIP
    assert max((want["state"][k] - v).abs().max().item() for k, v in want["steps"][0]["params"].items()) > 1e-3


def test_remat_frame_chunks_and_flash_attention_at_model_2(runs):
    """TPU.REMAT (policy dots: the saved products are handed back to the
    recompute, which reduces its own copy of them), TPU.FRAME_CHUNKS 2 and
    the flash path (K3-K5's plain versions at each rank's heads) at two model
    ranks, with dropout and jitter on: the recomputed forwards replay their
    collectives in the same order on both ranks, and the two steps are the
    first two of the run without them at MODEL 1 (losses at 1e-4, each
    update's full gradient and the parameters at 2e-4, the key bias at 5e-4)."""
    got, want = runs["m0"]["remat"], runs["w"]["train"]
    np.testing.assert_allclose(got["stats"]["losses"], want["stats"]["losses"][:2], atol=1e-4, rtol=1e-4)
    for i, g in enumerate(got["steps"]):
        assert_close(g["grads"], want["steps"][i]["grads"], 2e-4, f"step {i} grad")
    assert_params_close(got["state"], want["steps"][2]["params"])


def test_lars_at_model_2_is_model_1(runs):
    """Two LARS steps (trust ratio of each full tensor's norms, summed over
    the model group for a sharded one): losses at 1e-4, parameters at 2e-4."""
    _same_run(runs["m0"]["lars"], runs["w"]["lars"], "lars")
    assert runs["m0"]["lars"]["stats"]["updates"] == 2


def test_replicated_gradients_agree_across_model_ranks_with_dropout(runs):
    """With dropout and jitter on, every replicated parameter's gradient is
    the same bits on both model ranks (the replicated masks come from one
    generator state)."""
    for s0, s1 in zip(runs["m0"]["train"]["steps"], runs["m1"]["train"]["steps"]):
        for n, g in s0["replicated_grads"].items():
            assert torch.equal(g, s1["replicated_grads"][n]), n


@pytest.mark.parametrize("direction", ["model 2 -> model 1", "model 1 -> model 2"])
def test_checkpoints_cross_the_model_axis(runs, direction):
    """A checkpoint holds full tensors (parameters, Adam moments, the EMA
    where on) whatever MODEL wrote it: the step-3 checkpoint of one world,
    resumed by the other, takes the uninterrupted run's 4th step (loss at
    1e-4, parameters at 2e-4, the key bias at 5e-4); only rank 0 writes."""
    resumed = runs["w"]["resumed"] if direction.startswith("model 2") else runs["m0"]["resumed"]
    whole = runs["w"]["whole"]
    assert resumed["stats"]["init_weights"] == "resumed" and resumed["stats"]["steps"] == 1
    np.testing.assert_allclose(resumed["stats"]["losses"], whole["stats"]["losses"][STEPS:], atol=1e-4, rtol=1e-4)
    assert_params_close(resumed["state"], whole["state"])
    assert runs["m0"]["train"]["saves"] == [f"{STEPS}.pt"] and runs["m1"]["train"]["saves"] == []


def test_timesformer_training_at_model_2_is_model_1(runs):
    """Two TimeSformer classification steps with the attention probabilities'
    dropout (sliced over the heads), the feed-forward's (over its hidden
    units) and stochastic depth on: losses at 1e-4, each update's full
    gradient and the parameters after the steps at 2e-4 (the key bias at
    5e-4: see ``assert_params_close``)."""
    got, want = runs["m0"]["timesformer"], runs["w"]["timesformer"]
    assert got["stats"]["steps"] == want["stats"]["steps"] == 2
    np.testing.assert_allclose(got["stats"]["losses"], want["stats"]["losses"], atol=1e-4, rtol=1e-4)
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        assert_close(g["grads"], w["grads"], 2e-4, f"step {i} grad")
    assert_params_close(got["state"], want["state"])
