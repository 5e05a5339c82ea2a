"""Helpers for the tests that hold clip_fsar_torch's video classification
models to clip_fsar_tpu's: one config dict for both packages (the HMDB51
1-shot config's pool defaults, a backbone preset, 4 frames of 32 px, 5
classes), the JAX model's variables made random (every kernel perturbed,
zero-initialized ones included, BatchNorm scales around 1 and random running
statistics), and the JAX outputs of one fixed input: eval predictions,
train-mode logits and the gradient of a fixed linear function of them."""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HMDB1 = os.path.join(REPO, "configs", "projects", "CLIPFSAR", "hmdb51", "CLIPFSAR_HMDB51_1shot_v1.yaml")
NUM_CLASSES = 5
SMALL_RESNET = (("VIDEO.BACKBONE.NUM_FILTERS", (8, 16, 16, 32, 32)),)
# DEPTH 2 at width 32 with 4 heads, dropout off on both sides (jax.random and torch draw different masks)
SMALL_TRANSFORMER = (("VIDEO.BACKBONE.DEPTH", 2), ("VIDEO.BACKBONE.NUM_FEATURES", 32), ("VIDEO.BACKBONE.NUM_HEADS", 4),
                     ("VIDEO.BACKBONE.ATTN_DROPOUT", 0.0), ("VIDEO.BACKBONE.FF_DROPOUT", 0.0), ("VIDEO.BACKBONE.DROP_PATH", 0.0))


def cfg_dict(preset: str, frames: int = 4, overrides=()) -> dict:
    from clip_fsar_tpu.config.config import load_config, merge_into

    base = load_config(HMDB1).to_dict()
    with open(os.path.join(REPO, "configs", "pool", "backbone", f"{preset}.yaml")) as f:
        merge_into(base, yaml.safe_load(f))
    base["TASK_TYPE"] = "classification"
    base["DATA"].update(NUM_INPUT_FRAMES=frames, TRAIN_CROP_SIZE=32)
    base["VIDEO"]["HEAD"]["NUM_CLASSES"] = NUM_CLASSES
    base["TPU"]["COMPUTE_DTYPE"] = "float32"
    for key, value in overrides:
        node = base
        *parents, leaf = key.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = list(value) if isinstance(value, tuple) else value
    return base


def configs(preset: str, frames: int = 4, overrides=()):
    """(JAX Config, port Config) of the same dict."""
    from clip_fsar_tpu.config import Config as JaxConfig
    from clip_fsar_torch.config.config import Config

    d = cfg_dict(preset, frames, overrides)
    return JaxConfig(d), Config(d)


def randomize(tree, rng: np.random.Generator, stats: bool = False):
    def leaf(path, x):
        x = np.asarray(x)
        name = str(getattr(path[-1], "key", path[-1]))
        if stats:
            return (rng.uniform(0.5, 1.5, x.shape) if name == "var" else rng.normal(0.0, 0.1, x.shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
        s = float(x.std()) if x.size > 1 and x.std() > 0 else 0.1
        return (x + 0.3 * s * rng.normal(size=x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def inputs(frames: int, size: int = 32, batch: int = 2, seed: int = 0):
    rng = np.random.default_rng(seed)
    return rng.random((batch, frames, size, size, 3)).astype(np.float32), rng.normal(size=(batch, NUM_CLASSES)).astype(np.float32)


def _as_jax(x, pair_alpha):
    return [jnp.asarray(x[:, ::pair_alpha]), jnp.asarray(x)] if pair_alpha else jnp.asarray(x)


def as_port(x, pair_alpha):
    return [torch.from_numpy(np.ascontiguousarray(x[:, ::pair_alpha])), torch.from_numpy(x)] if pair_alpha else torch.from_numpy(x)


@functools.lru_cache(maxsize=None)
def jax_case(preset: str, frames: int = 4, overrides=(), pair_alpha: int = 0, eval_size: int = 32):
    """The JAX model's random variables and outputs on ``inputs(frames)``
    (``pair_alpha``: as a [x[:, ::alpha], x] pair; ``eval_size``: the eval
    input's side).  Returns a dict: variables, eval (predictions), train
    (logits), grads (of sum(logits * w) by parameter), x, w, x_eval."""
    from clip_fsar_tpu.models.video.model import build_video_model

    jcfg, _ = configs(preset, frames, overrides)
    model = build_video_model(jcfg, dtype=jnp.float32)
    x, w = inputs(frames)
    x_eval = x if eval_size == 32 else inputs(frames, eval_size, seed=1)[0]
    rng = np.random.default_rng(0)
    v = jax.device_get(model.init(jax.random.PRNGKey(0), _as_jax(x, pair_alpha), train=False))
    v = {"params": randomize(v["params"], rng), **({"batch_stats": randomize(v["batch_stats"], rng, True)} if "batch_stats" in v else {})}
    preds = jax.jit(lambda v_, x_: model.apply(v_, x_, train=False)[0])(v, _as_jax(x_eval, pair_alpha))

    def loss(params, x_):
        out = model.apply({**v, "params": params}, x_, train=True)[0]
        outs = out if isinstance(out, tuple) else (out,)
        return sum((o * w[:, : o.shape[-1]]).sum() for o in outs), out

    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"], _as_jax(x, pair_alpha))
    grads = jax.device_get(grads)
    host = lambda o: tuple(np.asarray(t) for t in o) if isinstance(o, tuple) else np.asarray(o)  # noqa: E731
    return {"variables": v, "eval": host(preds), "train": host(logits), "grads": grads, "x": x, "w": w, "x_eval": x_eval}


def port_model(preset: str, frames: int, overrides, variables):
    """The port's model of the case with the JAX variables ``variables``."""
    from clip_fsar_torch.models.video.convert import params_from_jax
    from clip_fsar_torch.models.video.model import build_video_model

    _, pcfg = configs(preset, frames, overrides)
    model = build_video_model(pcfg)
    model.load_state_dict(params_from_jax(variables))
    return model


def assert_close(got, want, atol: float, what: str) -> None:
    if isinstance(want, tuple):
        for g, w_, i in zip(got, want, range(len(want))):
            assert_close(g, w_, atol, f"{what}[{i}]")
        return
    np.testing.assert_allclose(got.detach().numpy(), want, atol=atol, rtol=atol, err_msg=what)


def check_eval(preset: str, frames: int = 4, overrides=(), pair_alpha: int = 0, eval_size: int = 32) -> None:
    """Eval predictions (HEAD.ACTIVATION applied) at 1e-4 in fp32 against the JAX model."""
    want = jax_case(preset, frames, overrides, pair_alpha, eval_size)
    model = port_model(preset, frames, overrides, want["variables"])
    with torch.no_grad():
        assert_close(model(as_port(want["x_eval"], pair_alpha), train=False)[0], want["eval"], 1e-4, "eval predictions")


def check_train(preset: str, frames: int = 4, overrides=(), pair_alpha: int = 0) -> None:
    """Train-mode logits at 1e-4 and every parameter's gradient at 2e-4 (fp32)
    against the JAX model."""
    from clip_fsar_torch.models.video.convert import params_from_jax

    want = jax_case(preset, frames, overrides, pair_alpha, 32)
    model = port_model(preset, frames, overrides, want["variables"])
    logits = model(as_port(want["x"], pair_alpha), train=True)[0]
    assert_close(logits, want["train"], 1e-4, "train-mode logits")
    outs = logits if isinstance(logits, tuple) else (logits,)
    w = torch.from_numpy(want["w"])
    sum((o * w[:, : o.shape[-1]]).sum() for o in outs).backward()
    grads = params_from_jax({"params": want["grads"]})
    moved = 0.0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(), atol=2e-4, rtol=2e-4, err_msg=f"grad {name}")
        moved = max(moved, float(p.grad.abs().max()))
    assert moved > 1e-3  # the gradients are not all zero


def _port_name(path) -> str:
    """A flax parameter path -> the port's parameter name (models/video/convert.py)."""
    parts = [str(getattr(k, "key", k)) for k in path if str(getattr(k, "key", k)) != "BatchNorm_0"]
    parts[-1] = {"kernel": "weight", "scale": "weight"}.get(parts[-1], parts[-1])
    return ".".join(parts)


def check_names(preset: str, frames: int = 4, overrides=()) -> None:
    """The port's state dict holds the converted JAX variables' entries and
    no other, and every parameter falls in the reference's group that its
    JAX counterpart falls in (train/optimizer.py, prefix "")."""
    from clip_fsar_tpu.models.video.model import build_video_model as jax_build
    from clip_fsar_tpu.train.optimizer import param_groups as jax_groups
    from clip_fsar_torch.models.video.convert import params_from_jax
    from clip_fsar_torch.models.video.model import build_video_model
    from clip_fsar_torch.train.optimizer import param_groups

    jcfg, pcfg = configs(preset, frames, overrides)
    shapes = jax.eval_shape(lambda: jax_build(jcfg, dtype=jnp.float32).init(jax.random.PRNGKey(0), jnp.zeros((1, frames, 32, 32, 3)), train=False))
    v = jax.tree_util.tree_map(lambda sd: np.zeros(sd.shape, np.float32), shapes)
    model = build_video_model(pcfg)
    assert set(model.state_dict()) == set(params_from_jax(v))
    want = dict(jax.tree_util.tree_flatten_with_path(jax_groups(v["params"]))[0])
    want = {_port_name(path): group for path, group in want.items()}
    assert param_groups([n for n, _ in model.named_parameters()], name_prefix="") == want
