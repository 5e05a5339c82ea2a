"""Helpers of the tests that hold the port's tensor parallelism to the JAX
package's (data, model) mesh (tests/test_torch_tensor_parallel*.py): the JAX
tiny few-shot model and its train steps on a mesh of the conftest's CPU
devices, the converted weights as files the port's entry points read, and
the launch of tests/_torch_tp_worker.py processes (gloo ranks meeting
through a FileStore, or one process with no group), each with a timeout,
while the caller runs its JAX work."""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax
import torch

from clip_fsar_torch.models.clip.convert import params_from_jax
from tests.torch_parity import CONFIG, jax_tiny_clip, openai_state_dict, port_head_state, tiny_cfg

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_tp_worker.py")
TIMEOUT_S = 240  # each process (its group times out at 240 s)
TP = ["TPU.MESH", "{DATA: 1, MODEL: 2}"]
# lr 1e-3 from the first step (no warmup), one Adam update per step, E = 2 in 2 episode chunks
EPISODES = 2
TRAIN_OPTS = ["TRAIN.ENABLE", "True", "SOLVER.BASE_LR", "1e-3", "SOLVER.WARMUP_EPOCHS", "0", "TRAIN.BATCH_SIZE_PER_TASK", "1",
              "TPU.EPISODES_PER_STEP", str(EPISODES), "TPU.EPISODE_CHUNKS", "2", "TRAIN.VAL_FRE_ITER", "0"]


@functools.lru_cache(maxsize=None)
def jax_model(layout: str = "split", mesh: str = TP[1]):
    """(cfg, clip_vars, JAX FewShotModel) of the tiny ViT train config on TPU.MESH ``mesh``."""
    from clip_fsar_tpu.models import builder as jbuilder

    cfg = tiny_cfg(*TRAIN_OPTS, "TPU.ATTENTION_LAYOUT", layout, "TPU.MESH", mesh)
    _, arch, clip_vars = jax_tiny_clip()
    with mock.patch.object(jbuilder, "load_or_init_clip", return_value=(arch, clip_vars)):
        model = jbuilder.build_few_shot_model(cfg, jax.random.PRNGKey(0), flow="train")
    return cfg, clip_vars, model


def jax_mesh_steps(cfg, model, devices: int, steps: int, episodes: int = EPISODES):
    """``steps`` JAX train steps on the mesh TPU.MESH asks for over
    ``devices`` CPU devices (shard_params over 'model', each batch sharded
    over 'data'), jitter and dropout off: (losses, the gradient each update
    took, the parameters after the steps), in the port's names."""
    from clip_fsar_tpu.data.loader import build_few_shot_loader
    from clip_fsar_tpu.parallel.mesh import build_mesh, shard_batch, shard_params
    from clip_fsar_tpu.train import step as jstep
    from clip_fsar_tpu.train.loop import build_state
    from clip_fsar_tpu.train.optimizer import build_optimizer, epoch_for_iter, get_lr_at_epoch

    grid = build_mesh(cfg, devices=jax.devices()[:devices])
    assert grid.axis_names == ("data", "model")
    inner = build_optimizer(cfg, model.variables["params"], name_prefix="head")
    tx = optax.GradientTransformation(  # keeps the last gradient beside the optimizer state
        lambda p: (inner.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)),
        lambda g, s, p=None: (lambda u, s0: (u, (s0, g)))(*inner.update(g, s[0], p)),
    )
    state = shard_params(build_state(cfg, model, tx), grid)
    with build_few_shot_loader(cfg, "train", num_steps=steps, episodes_per_step=episodes) as loader:
        batches = list(loader)
    losses, grads = [], []
    with mock.patch.object(fnn.Dropout, "__call__", lambda self, x, *a, **k: x), \
            mock.patch("clip_fsar_tpu.data.augment.color_jitter_batch", lambda key, x, **kw: x):
        step = jax.jit(jstep.make_train_step(model.head, tx, cfg, model.text_train, model.text_test))
        for i, batch in enumerate(batches):
            lr = jnp.float32(get_lr_at_epoch(cfg, epoch_for_iter(cfg, i)))
            state, metrics = step(state, shard_batch(batch, grid), lr, jax.random.PRNGKey(i))
            losses.append(float(metrics["loss"]))
            grads.append(params_from_jax({"params": jax.device_get(state.opt_state[1])}))
    return losses, grads, params_from_jax({"params": jax.device_get(state.params)})


def write_weights(root: str, model, clip_vars) -> tuple:
    """The JAX model's weights as the port reads them: a config whose
    TRAIN.CLIP_WEIGHTS is an OpenAI-format CLIP file, and a head checkpoint.
    Returns (config path, head checkpoint path)."""
    head_sd = {k: v for k, v in port_head_state(model, clip_vars).items() if not k.startswith("text.")}
    head_path = os.path.join(root, "head.pt")
    torch.save({"head": head_sd}, head_path)
    torch.save(openai_state_dict(port_head_state(model, clip_vars), clip_vars["params"]["logit_scale"]), os.path.join(root, "clip.pt"))
    cfg_path = os.path.join(root, "child.yaml")
    with open(cfg_path, "w") as f:
        f.write(f"_BASE: {CONFIG}\nTRAIN:\n  CLIP_WEIGHTS: {os.path.join(root, 'clip.pt')}\n")
    return cfg_path, head_path


@contextlib.contextmanager
def workers(root: str, groups: dict):
    """Start every group's processes (``groups``: {name: (world, spec list)};
    world 1 is one process with no group, named ``name``, else ranks named
    ``name0``, ``name1``, ...); yields a function that waits for them all and
    returns {process name: its output}.  Processes still running on the way
    out are killed."""
    procs = {}
    for group, (world, spec) in groups.items():
        spec_path = os.path.join(root, f"spec_{group}.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        for rank in range(world):
            name = group if world == 1 else f"{group}{rank}"
            procs[name] = subprocess.Popen(
                [sys.executable, WORKER, "--spec", spec_path, "--world", str(world), "--rank", str(rank),
                 "--store", os.path.join(root, f"store_{group}"), "--out", os.path.join(root, f"{name}.pt")],
                env={**os.environ, "OMP_NUM_THREADS": "1"}, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def collect() -> dict:
        logs = {name: p.communicate(timeout=TIMEOUT_S)[0] for name, p in procs.items()}
        for name, p in procs.items():
            assert p.returncode == 0, f"{name} failed:\n{logs[name][-4000:]}"
        return {name: torch.load(os.path.join(root, f"{name}.pt"), weights_only=False) for name in procs}

    try:
        yield collect
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def assert_close(got: dict, want: dict, atol: float, what: str) -> None:
    assert set(got) == set(want), what
    for name, v in want.items():
        torch.testing.assert_close(got[name], v, atol=atol, rtol=atol, msg=lambda m, name=name: f"{what} {name}: {m}")


def assert_params_close(state: dict, want: dict, atol: float = 2e-4, key_bias_atol: float = 5e-4) -> None:
    """The entries of ``want`` that the port's ``state`` holds, at ``atol``,
    but the key third of each packed q|k|v bias at ``key_bias_atol``,
    half of one Adam step at lr 1e-3: that bias's gradient is zero in exact
    arithmetic (softmax ignores a shift of a whole row), and Adam divides the
    rounding noise left in it by its own RMS, so it moves by up to lr either
    way on each side (tests/test_torch_train.py measured 1.6e-4)."""
    got = {k: v for k, v in state.items() if k in want}
    want = {k: v for k, v in want.items() if k in state}
    keys = [k for k in want if k.endswith(("attn.in_proj_bias", "to_qkv.bias"))]
    assert_close({k: v for k, v in got.items() if k not in keys}, {k: v for k, v in want.items() if k not in keys}, atol, "param")
    for k in keys:
        d = want[k].shape[0] // 3
        qv = [0, 2]
        torch.testing.assert_close(got[k].view(3, d)[qv], want[k].view(3, d)[qv], atol=atol, rtol=atol, msg=lambda m, k=k: f"param {k}: {m}")
        torch.testing.assert_close(got[k][d:2 * d], want[k][d:2 * d], atol=key_bias_atol, rtol=0, msg=lambda m, k=k: f"key bias {k}: {m}")


def assert_grads_close(steps: list, want_grads: list, atol: float = 2e-4) -> None:
    """The full gradient each of the port's optimizer steps saw against the JAX steps', at ``atol``."""
    assert len(steps) == len(want_grads)
    for i, (step, want) in enumerate(zip(steps, want_grads)):
        assert_close(step["grads"], {k: v for k, v in want.items() if k in step["grads"]}, atol, f"step {i} grad")
