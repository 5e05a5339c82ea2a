"""Helpers for the tests that hold clip_fsar_torch to clip_fsar_tpu.

Both packages get the same weights (the JAX variables, converted with
``clip_fsar_torch.models.clip.convert.params_from_jax``) and the same inputs
(numpy arrays from a seed).  The tiny config is ViT-Tiny-Test at 64 px with
4 frames in float32 and the synthetic decoder; ``backbone="RN-Tiny-Test"``
gives the tiny RN tower instead, with random BatchNorm running stats.
"""

from __future__ import annotations

import contextlib
import functools
import os

import jax
import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "projects", "CLIPFSAR", "hmdb51", "CLIPFSAR_HMDB51_1shot_v1.yaml")
TINY_OPTS = [
    "VIDEO.HEAD.BACKBONE_NAME", "ViT-Tiny-Test",
    "TRAIN.ENABLE", "False",
    "DATA.DECODER", "synthetic",
    "DATA.NUM_INPUT_FRAMES", "4",
    "DATA.TRAIN_CROP_SIZE", "64",
    "DATA.TEST_CROP_SIZE", "64",
    "DATA.TEST_SCALE", "72",
    "DATA.TRAIN_JITTER_SCALES", "[72, 80]",
    "DATA.ANNO_DIR", os.path.join(REPO, "configs", "projects", "CLIPFSAR", "hmdb51") + "/",
    "DATA_LOADER.NUM_WORKERS", "2",
    "TPU.COMPUTE_DTYPE", "float32",
    "TRAIN.NUM_TEST_TASKS", "4",
    "TEST.BATCH_SIZE", "2",
]


def tiny_cfg(*extra):
    from clip_fsar_tpu.config.config import load_config

    return load_config(CONFIG, TINY_OPTS + list(extra))


def backbone_opts(backbone: str) -> list:
    return [] if backbone == "ViT-Tiny-Test" else ["VIDEO.HEAD.BACKBONE_NAME", backbone]


def random_batch_stats(tree, seed: int = 0):
    """A batch_stats tree of the same shapes with random running means and
    variances (flax starts them at 0 and 1, which would hide a swap)."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.uniform(0.5, 1.5, x.shape) if path[-1].key == "var" else rng.normal(0.0, 0.5, x.shape)).astype(np.float32), tree
    )


@functools.lru_cache(maxsize=None)
def jax_tiny_clip(backbone: str = "ViT-Tiny-Test"):
    """(cfg, arch, clip_vars): the JAX package's fresh CLIP weights for the
    tiny config, drawn from its RANDOM_SEED as its builder draws them (an RN
    tower's running stats then drawn at random)."""
    from clip_fsar_tpu.models import builder

    cfg = tiny_cfg(*backbone_opts(backbone))
    arch, clip_vars = builder.load_or_init_clip(cfg, jax.random.PRNGKey(int(cfg.get("RANDOM_SEED", 0))), flow="test")
    if "batch_stats" in clip_vars:
        clip_vars = {**clip_vars, "batch_stats": random_batch_stats(jax.device_get(clip_vars["batch_stats"]))}
    return cfg, arch, clip_vars


@functools.lru_cache(maxsize=None)
def jax_tiny_model(layout: str = "split", pallas: bool = False, backbone: str = "ViT-Tiny-Test"):
    """(cfg, arch, clip_vars, FewShotModel) of the JAX package for the tiny
    config, with TPU.ATTENTION_LAYOUT ``layout`` (fused runs the Pallas
    kernel in interpret mode on the CPU) and TPU.PALLAS_ATTENTION ``pallas``
    (flash_mha; call inside ``pallas_interpret()``), on the tiny ViT or
    ``backbone``."""
    from unittest import mock

    from clip_fsar_tpu.models import builder

    cfg = tiny_cfg("TPU.ATTENTION_LAYOUT", layout, "TPU.PALLAS_ATTENTION", str(pallas), *backbone_opts(backbone))
    rng = jax.random.PRNGKey(int(cfg.get("RANDOM_SEED", 0)))
    _, arch, clip_vars = jax_tiny_clip(backbone)
    # the builder would draw the same CLIP weights again from the same key;
    # hand it the ones already drawn instead of paying for a second init
    with mock.patch.object(builder, "load_or_init_clip", return_value=(arch, clip_vars)):
        model = builder.build_few_shot_model(cfg, rng, flow="test")
    return cfg, arch, clip_vars, model


@contextlib.contextmanager
def pallas_interpret():
    """Every pl.pallas_call inside runs in interpret mode, on the CPU (the
    patch tests/test_flash_attention.py applies: flash_mha, unlike clip_mha,
    does not switch to interpret mode by itself)."""
    from unittest import mock

    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    with mock.patch.object(pl, "pallas_call", lambda *a, **kw: orig(*a, **{**kw, "interpret": True})):
        yield


_HOST_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__float__", "__int__", "__index__", "__array__")


@contextlib.contextmanager
def host_reads(where=lambda: None):
    """Yields a list that gets one (method, where()) entry for every read of
    a tensor's values from python while the context is open: ``.item()``,
    ``.tolist()``, ``.cpu()``, ``.numpy()``, ``bool()``, ``float()``,
    ``int()``, use as an index, ``np.asarray``.  On a card each of these
    waits for the device; the CPU tests count them instead."""
    from unittest import mock

    reads = []
    with contextlib.ExitStack() as stack:
        for name in _HOST_READS:
            def counted(self, *args, _orig=getattr(torch.Tensor, name), _name=name, **kwargs):
                reads.append((_name, where()))
                return _orig(self, *args, **kwargs)

            stack.enter_context(mock.patch.object(torch.Tensor, name, counted))
        yield reads


def port_clip_state(clip_vars):
    """The JAX CLIP variables as the port's head-state entries: the vision
    tower under ``backbone.``, the text tower under ``text.``."""
    from clip_fsar_torch.models.clip import convert

    params = jax.device_get(clip_vars["params"])
    sd = {}
    convert._vision(sd, "backbone", params["visual"], jax.device_get(clip_vars.get("batch_stats", {})).get("visual"))
    convert._text(sd, "text", params["text"])
    return sd


def port_head_state(model, clip_vars):
    """The JAX FewShotModel + CLIP text params as the port's head state dict
    (with ``text.`` entries)."""
    from clip_fsar_torch.models.clip.convert import params_from_jax

    return params_from_jax(jax.device_get(model.variables), text_params=jax.device_get(clip_vars["params"]["text"]))


def openai_state_dict(head_state, logit_scale):
    """OpenAI CLIP key space from the port's head state: backbone.* ->
    visual.*, text.* -> top level."""
    sd = {f"visual.{k[len('backbone.'):]}": v for k, v in head_state.items() if k.startswith("backbone.")}
    sd.update({k[len("text."):]: v for k, v in head_state.items() if k.startswith("text.")})
    sd["logit_scale"] = torch.tensor(np.array(logit_scale, np.float32))
    return sd

