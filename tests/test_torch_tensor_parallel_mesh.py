"""The port's 2-D mesh: TPU.MESH {DATA: 2, MODEL: 2} over four gloo ranks
(tests/_torch_tp_worker.py) against the JAX package on a 2x2 (data, model)
mesh of four of the conftest's CPU devices, at the tiny ViT in float32,
dropout and jitter off: two train steps through ``train_few_shot`` (each
data rank's 1 of the 2 episodes a step, each model rank's half of the
heads), and the test protocol's stats gathered over the data ranks."""

import os

import jax
import numpy as np
import pytest
import torch

from tests.torch_parity import TINY_OPTS, tiny_cfg
from tests.torch_tp_parity import TRAIN_OPTS, assert_grads_close, assert_params_close, jax_mesh_steps, jax_model, workers, write_weights

torch.set_num_threads(2)

STEPS = 2
MESH = "{DATA: 2, MODEL: 2}"
NUM_TEST, TEST_E = 6, 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from clip_fsar_tpu.parallel.mesh import build_mesh
    from clip_fsar_tpu.train.loop import evaluate

    root = str(tmp_path_factory.mktemp("tp_mesh"))
    cfg, clip_vars, model = jax_model("split", MESH)
    cfg_path, head_path = write_weights(root, model, clip_vars)
    opts = TINY_OPTS + ["TPU.MESH", MESH, "TRAIN.CHECKPOINT_FILE_PATH", head_path]
    spec = [{"name": "train", "kind": "fewshot", "runner": "train", "cfg": cfg_path, "jitter": False,
             "opts": opts + TRAIN_OPTS + ["TPU.ATTENTION_LAYOUT", "split", "TRAIN.NUM_TRAIN_TASKS", str(STEPS), "OUTPUT_DIR", os.path.join(root, "train")]},
            {"name": "eval", "kind": "fewshot", "runner": "test", "cfg": cfg_path,
             "opts": opts + ["TRAIN.NUM_TEST_TASKS", str(NUM_TEST), "TEST.BATCH_SIZE", str(TEST_E), "OUTPUT_DIR", os.path.join(root, "eval")]}]
    with workers(root, {"g": (4, spec)}) as collect:
        jax_steps = jax_mesh_steps(cfg, model, 4, STEPS)
        eval_cfg = tiny_cfg("TPU.MESH", MESH)
        jax_eval = evaluate(eval_cfg, model, model.variables, build_mesh(eval_cfg, devices=jax.devices()[:4]), NUM_TEST, TEST_E)
        out = collect()
    return {**out, "jax": jax_steps, "jax_eval": jax_eval}


def test_two_by_two_mesh_trains_as_the_jax_mesh(runs):
    """Two steps (E = 2: one episode a data rank, which TPU.EPISODE_CHUNKS 2
    leaves in one chunk) against the JAX 2x2 mesh's from
    the same converted weights and batches: losses at 1e-4, each step's full
    gradient and the parameters after the steps at 2e-4 (the key bias at
    5e-4); all four ranks hold the same losses and full parameters."""
    want_losses, want_grads, want_params = runs["jax"]
    got = runs["g0"]["train"]
    np.testing.assert_allclose(got["stats"]["losses"], want_losses, atol=1e-4, rtol=1e-4)
    assert_grads_close(got["steps"], want_grads)
    assert_params_close(got["state"], want_params)
    for rank in ("g1", "g2", "g3"):
        other = runs[rank]["train"]
        assert other["stats"]["losses"] == got["stats"]["losses"]
        assert all(torch.equal(v, other["state"][k]) for k, v in got["state"].items()), rank


def test_two_by_two_mesh_gathers_the_test_protocol_over_the_data_ranks(runs):
    """The test protocol on 6 episodes at TEST.BATCH_SIZE 2: each data rank
    runs one episode a step, the model ranks of a data rank the same one;
    the stats gathered over the data ranks are the JAX 2x2 mesh's (top-1 and
    top-5 equal, the loss at 1e-5) on every rank, with 6 episodes' logits."""
    want = runs["jax_eval"]
    for rank in ("g0", "g1", "g2", "g3"):
        got = runs[rank]["eval"]["stats"]
        assert got["episodes"] == want["episodes"] == NUM_TEST and got["episode_logits"].shape[0] == NUM_TEST
        assert got["top1_acc"] == pytest.approx(want["top1_acc"]) and got["top5_acc"] == pytest.approx(want["top5_acc"])
        np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(got["episode_logits"], runs["g0"]["eval"]["stats"]["episode_logits"])
