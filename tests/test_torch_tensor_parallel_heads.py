"""Tensor parallelism beyond the CLIP-FSAR head, and the classification
test's feature maps under a process group, on the CPU in float32:

- one HyRSM++ 5-shot train step (its pre-norm self-attention's packed
  q|k|v per head out of each third, on the tiny ViT tower) and the forward
  and backward of a tiny TimeSformer, each at TPU.MESH {DATA: 1, MODEL: 2}
  over two gloo ranks (tests/_torch_tp_worker.py) against the JAX package on
  a (data 1, model 2) mesh of two of the conftest's CPU devices, from the
  same converted weights and inputs, dropout off;
- VISUALIZATION.FEATURE_MAPS in the classification test over two data ranks:
  the maps gathered to rank 0 in global row order, the files one process
  writes."""

import dataclasses
import os
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clip_fsar_torch.data.types import Episode
from clip_fsar_torch.models.clip.convert import params_from_jax
from tests.torch_tp_parity import TP, assert_close, workers

torch.set_num_threads(2)

HYRSM = "CNN_HyRSM_plusplus_5shot"
JAX_TP = {"DATA": 1, "MODEL": 2}


def _jax_hyrsm_step():
    """One JAX make_train_step step of the tiny HyRSM++ 5-shot head on a
    (1, 2) mesh, its batch from the JAX loader, dropout and jitter off:
    (variables, batch, loss, the gradient in the port's names)."""
    from clip_fsar_tpu.data.loader import build_few_shot_loader as jloader
    from clip_fsar_tpu.models.builder import FewShotModel
    from clip_fsar_tpu.parallel.mesh import build_mesh, shard_batch, shard_params
    from clip_fsar_tpu.train import step as jstep
    from clip_fsar_tpu.train.loop import build_state
    from clip_fsar_tpu.train.optimizer import build_optimizer
    from tests.test_torch_fsheads import HYRSM_5SHOT, TRAIN_OPTS, head_cfg, jax_head

    cfg = head_cfg(HYRSM_5SHOT, HYRSM, *TRAIN_OPTS, *TP, package="jax")
    head, variables = jax_head(HYRSM_5SHOT, HYRSM)
    model = FewShotModel(head=head, variables=variables, text_train=jnp.zeros((1, 1)), text_test=jnp.zeros((1, 1)))
    inner = build_optimizer(cfg, variables["params"], name_prefix="head")
    tx = optax.GradientTransformation(
        lambda p: (inner.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)),
        lambda g, s, p=None: (lambda u, s0: (u, (s0, g)))(*inner.update(g, s[0], p)),
    )
    grid = build_mesh(cfg, devices=jax.devices()[:2])
    state = shard_params(build_state(cfg, model, tx), grid)
    with jloader(cfg, "train", num_steps=1, episodes_per_step=2) as loader:
        (batch,) = list(loader)
    with mock.patch.object(fnn.Dropout, "__call__", lambda self, x, *a, **k: x), \
            mock.patch("clip_fsar_tpu.data.augment.color_jitter_batch", lambda key, x, **kw: x):
        state, metrics = jax.jit(jstep.make_train_step(head, tx, cfg, model.text_train, model.text_test))(
            state, shard_batch(batch, grid), jnp.float32(1e-3), jax.random.PRNGKey(0))
    return variables, batch, float(metrics["loss"]), params_from_jax({"params": jax.device_get(state.opt_state[1])})


def _jax_timesformer():
    """The tiny TimeSformer's random variables, and its train-mode logits and
    the gradient of sum(logits * w) with the variables sharded on a (1, 2) mesh."""
    from clip_fsar_tpu.config import Config as JaxConfig
    from clip_fsar_tpu.models.video.model import build_video_model
    from clip_fsar_tpu.parallel.mesh import build_mesh, shard_params
    from tests.torch_video_parity import SMALL_TRANSFORMER, cfg_dict, jax_case

    case = jax_case("timesformer", 4, SMALL_TRANSFORMER)
    d = cfg_dict("timesformer", 4, SMALL_TRANSFORMER)
    d["TPU"]["MESH"] = dict(JAX_TP)
    model = build_video_model(JaxConfig(d), dtype=jnp.float32)
    v = shard_params(case["variables"], build_mesh(JaxConfig(d), devices=jax.devices()[:2]))
    w = jnp.asarray(case["w"])

    def loss(params, x):
        out = model.apply({**v, "params": params}, x, train=True)[0]
        return (out * w).sum(), out

    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"], jnp.asarray(case["x"]))
    return d, case, np.asarray(logits), jax.device_get(grads)


def _tada_lists(root: str) -> str:
    os.makedirs(root, exist_ok=True)
    for split, n in (("train", 4), ("test", 3)):
        with open(os.path.join(root, f"kinetics400_{split}_list.txt"), "w") as f:
            f.writelines(f"videos/c{i % 4}/{split}_{i:03d}.mp4 {i % 4}\n" for i in range(n))
    return root


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from clip_fsar_torch.models.video.convert import params_from_jax as video_params
    from tests.test_torch_classification_cli import CONFIG as TADA, TINY as TADA_TINY
    from tests.test_torch_fsheads import HYRSM_5SHOT, TINY, TRAIN_OPTS

    root = str(tmp_path_factory.mktemp("tp_heads"))
    variables, batch, loss, grads = _jax_hyrsm_step()
    fields = {f.name: torch.from_numpy(np.array(getattr(batch, f.name))) for f in dataclasses.fields(Episode) if getattr(batch, f.name) is not None}
    torch.save({"state": params_from_jax(variables), "batch": fields}, os.path.join(root, "hyrsm.pt"))
    d, case, logits, video_grads = _jax_timesformer()
    port_d = {**d, "TPU": {**d["TPU"], "MESH": dict(JAX_TP)}}
    torch.save({"cfg": port_d, "state": video_params(case["variables"]), "x": torch.from_numpy(case["x"]), "w": torch.from_numpy(case["w"])},
               os.path.join(root, "video.pt"))
    hyrsm_opts = TINY + ["DATA.ANNO_DIR", os.path.dirname(HYRSM_5SHOT) + "/"] + TRAIN_OPTS + TP
    maps = TADA_TINY + ["DATA.ANNO_DIR", _tada_lists(os.path.join(root, "lists")), "TEST.BATCH_SIZE", "4", "VISUALIZATION.ENABLE", "True",
                        "VISUALIZATION.NAME", "tada", "VISUALIZATION.FEATURE_MAPS.ENABLE", "True"]

    def feature_maps(world):
        return {"name": "maps", "kind": "classification", "runner": "test", "cfg": TADA,
                "opts": maps + ["OUTPUT_DIR", os.path.join(root, f"out{world}"), "VISUALIZATION.FEATURE_MAPS.BASE_OUTPUT_DIR",
                                os.path.join(root, f"maps{world}")]}

    groups = {"m": (2, [{"name": "hyrsm", "kind": "hyrsm", "cfg": HYRSM_5SHOT, "opts": hyrsm_opts, "data": os.path.join(root, "hyrsm.pt")},
                        {"name": "video", "kind": "video_grad", "data": os.path.join(root, "video.pt")}, feature_maps(2)]),
              "w": (1, [feature_maps(1)])}
    with workers(root, groups) as collect:
        out = collect()
    return {**out, "root": root, "jax_hyrsm": (loss, grads), "jax_video": (logits, video_params({"params": video_grads}))}


def test_hyrsm_pp_step_at_model_2_matches_the_jax_model_mesh(runs):
    """One HyRSM++ 5-shot train step (E = 2 in 2 chunks; CE, the per-frame
    class CE and the temporal regularizer) at two model ranks: the loss at
    1e-4 and the full gradient the update took at 2e-4 against the JAX
    step's on its (1, 2) mesh; the pre-norm self-attention is sharded."""
    want_loss, want_grads = runs["jax_hyrsm"]
    for rank in ("m0", "m1"):
        got = runs[rank]["hyrsm"]
        np.testing.assert_allclose(got["stats"]["losses"], [want_loss], atol=1e-4, rtol=1e-4)
        (step,) = got["steps"]
        assert_close(step["grads"], {k: v for k, v in want_grads.items() if k in step["grads"]}, 2e-4, "grad")
        assert any("to_qkv" in n for n in step["grads"]) and len(step["grads"]) > len(step["replicated_grads"])


def test_timesformer_at_model_2_matches_the_jax_model_mesh(runs):
    """The tiny TimeSformer (divided space-time attention, 4 heads: 2 a rank)
    in train mode: logits at 1e-4 and every parameter's full gradient at 2e-4
    against the JAX model on its (1, 2) mesh."""
    want_logits, want_grads = runs["jax_video"]
    for rank in ("m0", "m1"):
        got = runs[rank]["video"]["stats"]
        np.testing.assert_allclose(got["logits"].numpy(), want_logits, atol=1e-4, rtol=1e-4)
        assert_close(got["grads"], want_grads, 2e-4, "grad")


def test_feature_maps_under_a_process_group_are_one_processs(runs):
    """The feature-map test over two data ranks writes, on rank 0 alone,
    the files one process writes: the same names (one directory per real
    clip, every residual block) and the same tiles."""
    import cv2

    one, two = os.path.join(runs["root"], "maps1"), os.path.join(runs["root"], "maps2")
    rel = lambda base: sorted(os.path.relpath(os.path.join(d, f), base) for d, _, fs in os.walk(base) for f in fs)  # noqa: E731
    want = rel(one)
    assert rel(two) == want and want and any("res_" in p for p in want)
    for path in want:
        a, b = (cv2.imread(os.path.join(base, path), cv2.IMREAD_GRAYSCALE) for base in (two, one))
        np.testing.assert_array_equal(a, b, err_msg=path)
