"""Tensor parallelism of the port over TPU.MESH.MODEL (parallel/tensor.py,
parallel/mesh.py) against the JAX package's (data, model) mesh
(clip_fsar_tpu/parallel/mesh.py:68-91, 161-202), on the CPU at the tiny
archs in float32.

Without a process group: the placement of every tiny model against
``_tp_spec_for`` / ``shard_params`` (CLIP-FSAR on ViT-Tiny-Test and on
RN-Tiny-Test, the HyRSM++ head, a tiny TimeSformer), the mesh keys against
the JAX ``build_mesh``, the packed q|k|v slices, and the localization
runners, which do not read TPU.MESH.

With two gloo ranks at TPU.MESH {DATA: 1, MODEL: 2} (tests/_torch_tp_worker.py,
rendezvous through a FileStore), while the JAX steps run here on a
(data 1, model 2) mesh of two of the conftest's CPU devices: three
CLIP-FSAR train steps through ``train_few_shot`` on the plain attention path
(the fused path's: tests/test_torch_tensor_parallel_fused.py), and the test
protocol's logits on the fused path.  Dropout and jitter off on both sides
(their generators differ)."""

import logging
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_fsar_torch.models.clip.convert import params_from_jax
from clip_fsar_torch.models.clip.model import MultiheadAttention
from clip_fsar_torch.parallel import mesh, tensor
from tests.torch_parity import CONFIG, TINY_OPTS, tiny_cfg
from tests.torch_tp_parity import TP, TRAIN_OPTS, assert_grads_close, assert_params_close, jax_mesh_steps, jax_model, workers, write_weights

torch.set_num_threads(2)

STEPS = 3
SHARD = tensor.ModelShard(group=None, rank=0, size=2)  # placement alone: no collective runs
# the pairs the port keeps replicated where the JAX package shards a leaf: AttentionPool2d's q/k/v (its c_proj is not
# on the JAX row list, so the port keeps the whole pool replicated)
REPLICATED_DIVERGENCE = ("attnpool.q_proj.", "attnpool.k_proj.", "attnpool.v_proj.")


# ---------------------------------------------------------------------------
# placement against _tp_spec_for / shard_params
# ---------------------------------------------------------------------------


def _jax_marks(variables) -> dict:
    """Each leaf of a JAX variable tree as an array of 1. where shard_params
    puts it on the model axis of a 2-wide mesh (its spec names 'model' and
    the dimension divides), 0. where it replicates it."""
    from clip_fsar_tpu.parallel.mesh import _tp_spec_for

    def mark(path, x):
        parts = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        spec = _tp_spec_for(parts, x.shape)
        dims = [d for d, name in enumerate(spec) if name == "model"]
        sharded = bool(dims) and all(x.shape[d] % 2 == 0 for d in dims)
        return np.full(x.shape, 1.0 if sharded else 0.0, np.float32)

    return jax.tree_util.tree_map_with_path(mark, jax.device_get(variables))


def _clipfsar(backbone):
    from clip_fsar_torch.models.builder import build_few_shot_model
    from tests.torch_parity import jax_tiny_model

    model = jax_model()[2] if backbone == "ViT-Tiny-Test" else jax_tiny_model(backbone=backbone)[3]
    marks = params_from_jax(_jax_marks({k: v for k, v in model.variables.items() if k == "params"}))
    head = build_few_shot_model(tiny_cfg("VIDEO.HEAD.BACKBONE_NAME", backbone), flow="test", device="cpu").head
    return marks, head


def _hyrsm():
    from clip_fsar_torch.models.builder import build_few_shot_model
    from tests.test_torch_fsheads import HYRSM_5SHOT, head_cfg, jax_head

    name = "CNN_HyRSM_plusplus_5shot"
    _, variables = jax_head(HYRSM_5SHOT, name)
    marks = params_from_jax(_jax_marks({"params": variables["params"]}))
    return marks, build_few_shot_model(head_cfg(HYRSM_5SHOT, name), flow="test", device="cpu").head


def _timesformer():
    from clip_fsar_tpu.models.video.model import build_video_model as jax_build
    from clip_fsar_torch.models.video.convert import params_from_jax as video_params
    from clip_fsar_torch.models.video.model import build_video_model
    from tests.torch_video_parity import SMALL_TRANSFORMER, configs

    jcfg, pcfg = configs("timesformer", 4, SMALL_TRANSFORMER)
    shapes = jax.eval_shape(lambda: jax_build(jcfg, dtype=jnp.float32).init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 32, 32, 3)), train=False))
    variables = jax.tree_util.tree_map(lambda sd: np.zeros(sd.shape, np.float32), shapes)
    return video_params(_jax_marks({"params": variables["params"]})), build_video_model(pcfg)


MODELS = {"clipfsar_vit": lambda: _clipfsar("ViT-Tiny-Test"), "clipfsar_rn": lambda: _clipfsar("RN-Tiny-Test"), "hyrsm_pp": _hyrsm,
          "timesformer": _timesformer}


@pytest.mark.parametrize("case", list(MODELS))
def test_placement_matches_the_jax_rules(case):
    """After ``shard_module`` on a 2-wide model axis, every parameter that
    the JAX package shards is sharded in the port (AttentionPool2d's q/k/v
    excepted: the port keeps that pool replicated), and every parameter it
    replicates is replicated; a sharded one keeps half of its full shape,
    and the parameter count stays the full model's."""
    from clip_fsar_torch.utils.misc import params_count

    marks, model = MODELS[case]()
    full = {n: tuple(p.shape) for n, p in model.named_parameters()}
    count = params_count(model)
    assert tensor.shard_module(model, SHARD) > 0
    specs = tensor.specs(model)
    assert params_count(model) == count  # the model_info line counts full parameters, as the JAX package counts sharded arrays
    checked = 0
    for name, p in model.named_parameters():
        if name not in marks:
            continue
        m = marks[name].numpy()
        assert m.min() == m.max(), f"{name}: JAX shards part of what the port holds as one parameter"
        if m.max() == 1.0 and not name.startswith(tuple("backbone." + d for d in REPLICATED_DIVERGENCE)):
            assert name in specs, f"{name}: sharded in JAX, replicated in the port"
            assert np.prod(p.shape) * 2 == np.prod(full[name]) and tensor.full_shape(p) == full[name]
            checked += 1
        elif m.max() == 0.0:
            assert name not in specs, f"{name}: replicated in JAX, sharded in the port"
        else:
            assert name not in specs
    assert checked > 0


def test_packed_qkv_slices_hold_the_ranks_heads_of_q_k_and_v():
    """A 4-head packed in-projection on a 2-wide model axis: rank m keeps
    heads 2m, 2m+1 of q, then of k, then of v (rows of the [3D, D] weight),
    so its product is the packed [B, N, 3D/2] of 2 heads; the out-projection
    keeps the same heads' input columns; gather puts the full tensors back."""
    dim, heads = 16, 4
    for rank in (0, 1):
        attn = MultiheadAttention(dim, heads)
        rows = torch.arange(3 * dim, dtype=torch.float32)
        with torch.no_grad():
            attn.in_proj_weight.copy_(rows[:, None].expand(3 * dim, dim))
            attn.in_proj_bias.copy_(rows)
            attn.out_proj.weight.copy_(torch.arange(dim, dtype=torch.float32)[None, :].expand(dim, dim))
        assert attn.shard_(tensor.ModelShard(None, rank, 2)) is None and attn.heads == 2
        half = dim // 2
        want = torch.cat([torch.arange(t * dim + rank * half, t * dim + (rank + 1) * half) for t in range(3)]).float()
        assert torch.equal(attn.in_proj_weight[:, 0], want) and torch.equal(attn.in_proj_bias, want)
        assert torch.equal(attn.out_proj.weight[0], torch.arange(rank * half, (rank + 1) * half).float())
        assert attn.out_proj.bias.shape == (dim,) and tensor.spec(attn.out_proj.bias) is None
        spec = tensor.spec(attn.in_proj_weight)
        assert (spec.dim, spec.parts, tuple(spec.full)) == (0, 3, (3 * dim, dim))
        assert torch.equal(spec.take(rows[:, None].expand(3 * dim, dim))[:, 0], want)


def test_pairs_whose_heads_do_not_divide_stay_replicated(caplog):
    """3 heads on a 2-wide axis: the attention stays whole, and one log line names it."""
    attn = MultiheadAttention(12, 3)
    package_logger = logging.getLogger("clip_fsar_torch")  # a run's setup_logging stops it propagating to caplog's root handler
    package_logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger="clip_fsar_torch"):
            assert tensor.shard_module(torch.nn.ModuleDict({"attn": attn}), SHARD) == 0
    finally:
        package_logger.removeHandler(caplog.handler)
    assert attn.heads == 3 and not tensor.specs(attn) and attn.in_proj_weight.shape == (36, 12)
    assert any("attn stays replicated (3 heads)" in r.getMessage() for r in caplog.records)


# ---------------------------------------------------------------------------
# the mesh keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("data, model, world", [(-1, 2, 1), (-1, 2, 2), (-1, 2, 4), (2, 2, 4), (4, 2, 4), (-1, 3, 4), (1, 2, 4)])
def test_mesh_keys_match_jax(data, model, world):
    """TPU.MESH {DATA, MODEL} on ``world`` ranks against the JAX build_mesh on
    as many devices: the same data axis, or the same ValueError message.
    One divergence: a grid smaller than the world (DATA 1 x MODEL 2 of 4),
    which JAX runs on a subset of its devices, is refused (a process group
    does not shrink), with the count of processes to launch."""
    from clip_fsar_tpu.parallel import mesh as jmesh

    cfg = tiny_cfg("TPU.MESH", f"{{DATA: {data}, MODEL: {model}}}")
    try:
        jm = jmesh.build_mesh(cfg, devices=jax.devices()[:world])
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).replace("(", r"\(").replace(")", r"\)")):
            mesh.check_mesh_cfg(cfg, world)
        return
    if jm.devices.size < world:
        with pytest.raises(ValueError, match=f"launch {jm.devices.size} processes"):
            mesh.check_mesh_cfg(cfg, world)
        return
    assert mesh.check_mesh_cfg(cfg, world) == jm.shape["data"] and world // jm.shape["data"] == jm.shape["model"]


def test_model_axis_without_a_process_group_raises_before_any_model():
    """MODEL 2 on one process: the JAX package's ValueError from the entry
    points, before a model is built; the one-process mesh has no model axis."""
    from clip_fsar_torch.train import loop

    cfg = tiny_cfg(*TP)
    with mock.patch.object(loop, "build_few_shot_model", side_effect=AssertionError("a model was built")):
        with pytest.raises(ValueError, match="TPU.MESH.MODEL=2 must divide the device count 1"):
            loop.test_few_shot(cfg, device="cpu")
    grid = mesh.build_mesh(tiny_cfg(), "cpu")
    assert (grid.model, grid.data_rank, grid.model_rank, grid.model_shard, grid.data_group) == (1, 0, 0, None, None)


def test_localization_runners_do_not_read_the_mesh(monkeypatch):
    """As the JAX localization runners, the port's run as one process
    whatever TPU.MESH says; a process group of more than one rank is still
    refused."""
    from clip_fsar_torch.config.config import load_config
    from clip_fsar_torch.train import localization

    cfg = load_config(os.path.join(os.path.dirname(CONFIG), "..", "..", "..", "localization", "BMN_EPIC100.yaml"),
                      ["TPU.MESH", "{DATA: 4, MODEL: 2}"])
    localization._one_process(cfg, "train_localization")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="run as one process"):
        localization._one_process(cfg, "train_localization")


# ---------------------------------------------------------------------------
# two model ranks against the JAX (data 1, model 2) mesh
# ---------------------------------------------------------------------------


def _jax_tp_logits(cfg, model, num_tasks, e):
    """The test protocol's per-episode logits from the JAX head with its variables sharded on the (1, 2) mesh."""
    from clip_fsar_tpu.data.loader import build_few_shot_loader
    from clip_fsar_tpu.parallel.mesh import build_mesh, shard_params
    from clip_fsar_tpu.train.step import _normalize_episode

    variables = shard_params(model.variables, build_mesh(cfg, devices=jax.devices()[:2]))
    mean, std = tuple(cfg.DATA.MEAN), tuple(cfg.DATA.STD)
    head_logits = jax.jit(lambda v, b: jax.vmap(lambda ep: model.head.apply(v, ep, model.text_train, model.text_test, train=False)["logits"])(
        _normalize_episode(b, mean, std)))
    with build_few_shot_loader(cfg, "test", num_steps=-(-num_tasks // e), episodes_per_step=e) as loader:
        return np.concatenate([np.asarray(head_logits(variables, b)) for b in loader])[:num_tasks]


def tp_train_job(root, cfg_path, head_path, layout, steps=STEPS):
    return {"name": f"train_{layout}", "kind": "fewshot", "runner": "train", "cfg": cfg_path, "jitter": False,
            "opts": TINY_OPTS + TRAIN_OPTS + TP + ["TRAIN.CHECKPOINT_FILE_PATH", head_path, "TPU.ATTENTION_LAYOUT", layout,
                                                   "TRAIN.NUM_TRAIN_TASKS", str(steps), "OUTPUT_DIR", os.path.join(root, layout)]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"m0"/"m1": the two model ranks' outputs, "jax": (losses, params), "jax_logits": [5, Q, WAY]}."""
    root = str(tmp_path_factory.mktemp("tp"))
    cfg, clip_vars, model = jax_model("split")
    cfg_path, head_path = write_weights(root, model, clip_vars)
    spec = [tp_train_job(root, cfg_path, head_path, "split"),
            {"name": "eval", "kind": "fewshot", "runner": "test", "cfg": cfg_path, "opts": TINY_OPTS + TP + [
                "TRAIN.CHECKPOINT_FILE_PATH", head_path, "TPU.ATTENTION_LAYOUT", "fused", "TRAIN.NUM_TEST_TASKS", "5", "TEST.BATCH_SIZE", "2",
                "OUTPUT_DIR", os.path.join(root, "eval")]}]
    with workers(root, {"m": (2, spec)}) as collect:
        jax_ref = jax_mesh_steps(cfg, model, 2, STEPS)
        logits = _jax_tp_logits(tiny_cfg(*TP), model, 5, 2)
        out = collect()
    return {**out, "jax": jax_ref, "jax_logits": logits}


def check_train_run(runs, name, want):
    """The run ``name`` of both model ranks against the JAX steps ``want`` = (losses, gradients, params)."""
    want_losses, want_grads, want_params = want
    got = runs["m0"][name]
    assert got["stats"]["updates"] == STEPS
    np.testing.assert_allclose(got["stats"]["losses"], want_losses, atol=1e-4, rtol=1e-4)
    assert_grads_close(got["steps"], want_grads)
    state = got["state"]
    assert_params_close(state, want_params)
    assert max((state[k] - v).abs().max().item() for k, v in got["steps"][0]["params"].items()) > 1e-3  # the parameters moved
    other = runs["m1"][name]
    assert other["stats"]["losses"] == got["stats"]["losses"]
    assert all(torch.equal(v, other["state"][k]) for k, v in state.items())


def test_two_model_ranks_train_as_the_jax_model_mesh(runs):
    """Three train steps (E = 2 in 2 chunks) of two model ranks, each holding
    half of every tower block's heads and MLP and of the prototype
    transformer's, on the plain attention path, against the JAX steps on a
    (data 1, model 2) mesh from the same converted weights and batches:
    losses at 1e-4, the full gradient of each step and the full parameters
    after the steps at 2e-4 (the key bias at 5e-4: ``assert_params_close``);
    the two ranks gather the same parameters.  The fused path:
    test_torch_tensor_parallel_fused.py."""
    check_train_run(runs, "train_split", runs["jax"])


def test_replicated_gradients_are_the_same_on_both_model_ranks(runs):
    """Every replicated parameter's gradient (LayerNorms, embeddings, the
    row-parallel biases, the head's scale) is the same bits on both model
    ranks at every step, as GSPMD's replicated gradient is one array."""
    r0, r1 = runs["m0"]["train_split"]["steps"], runs["m1"]["train_split"]["steps"]
    assert len(r0) == STEPS and r0[0]["replicated_grads"]
    assert any(n.endswith("out_proj.bias") for n in r0[0]["replicated_grads"])
    for s0, s1 in zip(r0, r1):
        assert set(s0["replicated_grads"]) == set(s1["replicated_grads"])
        for n, g in s0["replicated_grads"].items():
            assert torch.equal(g, s1["replicated_grads"][n]), n


def test_test_protocol_logits_match_the_jax_model_mesh(runs):
    """The test protocol on 5 episodes (fused path) at two model ranks: the
    per-episode logits of the JAX head on its (1, 2) mesh at rtol 2e-4,
    atol 1e-5 (tests/test_harness.py's tolerance), the same on both ranks."""
    for rank in ("m0", "m1"):
        got = runs[rank]["eval"]["stats"]
        assert got["episodes"] == 5
        np.testing.assert_allclose(got["episode_logits"], runs["jax_logits"], rtol=2e-4, atol=1e-5)
