"""Tensor parallelism on the fused attention path (TPU.ATTENTION_LAYOUT
fused): three CLIP-FSAR train steps of two gloo model ranks at TPU.MESH
{DATA: 1, MODEL: 2}, where K1 and K2's plain versions read each rank's
packed q|k|v of its own heads, against the JAX steps with the Pallas
kernels in interpret mode on a (data 1, model 2) mesh of two of the
conftest's CPU devices; tiny ViT, float32, dropout and jitter off.  The
plain path and the placement: tests/test_torch_tensor_parallel.py."""

import pytest
import torch

from tests.test_torch_tensor_parallel import STEPS, check_train_run, tp_train_job
from tests.torch_tp_parity import jax_mesh_steps, jax_model, workers, write_weights

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp_fused"))
    cfg, clip_vars, model = jax_model("fused")
    cfg_path, head_path = write_weights(root, model, clip_vars)
    with workers(root, {"m": (2, [tp_train_job(root, cfg_path, head_path, "fused")])}) as collect:
        jax_ref = jax_mesh_steps(cfg, model, 2, STEPS)
        out = collect()
    return {**out, "jax": jax_ref}


def test_two_model_ranks_train_as_the_jax_model_mesh_on_the_fused_path(runs):
    """Losses at 1e-4, each step's full gradient and the full parameters
    after the three steps at 2e-4 (the key bias at 5e-4) against the JAX
    mesh's; the two ranks gather the same parameters."""
    check_train_run(runs, "train_fused", runs["jax"])
