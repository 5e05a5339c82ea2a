"""Checkpoint surgery and the classification trainer's checkpoint loading
(counterpart of clip_fsar_tpu/train/pretrain.py:40-316, the reference's
utils/checkpoint.py).

The surgery works on the port's state dicts (names as the models', torch
layouts), as the JAX package's works on its flax trees:

  * ``inflate_2d_to_3d`` -- I3D inflation: a 2D conv weight [O, I, H, W]
    under a 3D one [O, I, D, H, W] is repeated D times along depth and
    divided by D;
  * ``preprocess_checkpoint`` (TRAIN.CHECKPOINT_PRE_PROCESS) -- POP_HEAD
    under TRAIN.FINE_TUNE drops every entry whose name holds "head";
    POS_EMBED ``repeat`` tiles ``backbone.pos_embd``'s spatial rows once per
    (tubelet) frame, ``super-resolution`` resizes its grid to the
    TRAIN_CROP_SIZE patch grid bilinearly and ``backbone.temp_embd`` to the
    frame count linearly (jax.image.resize's arithmetic); PATCH_EMBD
    ``central_frame`` / ``average`` turns a one-frame patch kernel
    ``backbone.stem.conv1.weight`` into a tubelet kernel (the kernel in the
    centre frame, or repeated and divided);
  * ``merge_non_strict`` -- every entry whose name and shape match the
    template is taken, the rest are logged and skipped.

Checkpoint files are the port's ``.pt`` (a train checkpoint or a bare state
dict) and the JAX package's ``.npz`` weight archives (``save_weights_npz``),
converted by ``models/video/convert.py``, at a local path or a remote one
(fetched through ``utils/storage.py``).  As everywhere in the port, a
path that does not exist is passed over and one that exists but cannot be
read into the model (a directory, a reference-framework file, a file in
which nothing matches) raises: a run never goes on with fresh weights where
a checkpoint was named.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from clip_fsar_torch.models.convert_reference import is_reference_checkpoint
from clip_fsar_torch.models.heads.molo import resize_bilinear
from clip_fsar_torch.utils import storage
from clip_fsar_torch.utils.logging import get_logger

logger = get_logger(__name__)

StateDict = Dict[str, torch.Tensor]


def merge_non_strict(template: StateDict, loaded: StateDict, label: str = "checkpoint") -> Tuple[StateDict, int]:
    """``template`` with every entry of ``loaded`` whose name and shape match
    it; returns (merged, entries taken)."""
    merged = dict(template)
    used = 0
    for k, v in loaded.items():
        if k not in template:
            logger.info("%s: ignoring unknown key %s", label, k)
            continue
        if tuple(v.shape) != tuple(template[k].shape):
            logger.info("%s: shape mismatch for %s: %s vs %s", label, k, tuple(v.shape), tuple(template[k].shape))
            continue
        merged[k] = v.to(template[k].dtype)
        used += 1
    missing = set(template) - set(loaded)
    if missing:
        logger.info("%s: %d entries kept from init (not in checkpoint)", label, len(missing))
    return merged, used


def inflate_2d_to_3d(src: StateDict, template: StateDict) -> StateDict:
    """``template`` with the entries of ``src`` it holds: 2D conv weights
    under 3D ones inflated along depth, the rest where the shapes agree."""
    out = dict(template)
    for k, v in src.items():
        if k not in template:
            continue
        t = template[k]
        if v.dim() == 4 and t.dim() == 5 and tuple(v.shape) == tuple(t.shape[:2]) + tuple(t.shape[3:]):
            d = t.shape[2]
            logger.info("inflate %s: %s -> %s", k, tuple(v.shape), tuple(t.shape))
            out[k] = v[:, :, None].repeat(1, 1, d, 1, 1) / float(d)
        elif v.shape == t.shape:
            out[k] = v.to(t.dtype)
        else:
            logger.info("inflate: unexpected %s: %s -|> %s", k, tuple(v.shape), tuple(t.shape))
    return out


def _resize_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """[..., rows, C] -> [..., n, C], jax.image.resize's linear rows."""
    return resize_bilinear(x, (n, x.shape[-1]))


def preprocess_checkpoint(cfg, sd: StateDict) -> StateDict:
    """TRAIN.CHECKPOINT_PRE_PROCESS's position-table, tubelet and head surgery."""
    pp = cfg.TRAIN.get("CHECKPOINT_PRE_PROCESS", {})
    get = pp.get if hasattr(pp, "get") else (lambda *_: None)
    sd = dict(sd)
    bb = cfg.VIDEO.BACKBONE
    if bool(cfg.TRAIN.get("FINE_TUNE", False)) and bool(get("POP_HEAD", False)):
        popped = [k for k in sd if "head" in k.lower()]
        for k in popped:
            sd.pop(k)
        logger.info("checkpoint_preprocess: popped %d head entries", len(popped))

    pos_mode, key = get("POS_EMBED", None), "backbone.pos_embd"
    if pos_mode == "repeat" and key in sd:
        pe = sd[key]  # [1, N, C]
        _, n, c = pe.shape
        f = int(cfg.DATA.NUM_INPUT_FRAMES)
        ts = int(bb.get("TUBELET_SIZE", 0) or 0)
        if ts:
            f //= ts
        sd[key] = torch.cat([pe[:, :1], pe[0, 1:][None, None].repeat(1, f, 1, 1).reshape(1, f * (n - 1), c)], dim=1)
        logger.info("checkpoint_preprocess: repeated pos_embd %d -> %d tokens", n, sd[key].shape[1])
    elif pos_mode == "super-resolution" and key in sd:
        pe = sd[key]
        _, n, c = pe.shape
        side = int(cfg.DATA.TRAIN_CROP_SIZE) // int(bb.PATCH_SIZE)
        side_ckp = int(round((n - 1) ** 0.5))
        if side != side_ckp:
            grid = resize_bilinear(pe[0, 1:].reshape(side_ckp, side_ckp, c).permute(2, 0, 1), (side, side)).permute(1, 2, 0)
            sd[key] = torch.cat([pe[:, :1], grid.reshape(1, side * side, c)], dim=1)
            logger.info("checkpoint_preprocess: pos_embd %dx%d -> %dx%d", side_ckp, side_ckp, side, side)
        tkey = "backbone.temp_embd"
        if tkey in sd:
            te = sd[tkey]
            n_t = int(cfg.DATA.NUM_INPUT_FRAMES) // int(bb.get("TUBELET_SIZE", 1) or 1)
            if te.shape[1] - 1 != n_t:
                sd[tkey] = torch.cat([te[:, :1], _resize_rows(te[:, 1:], n_t)], dim=1)
                logger.info("checkpoint_preprocess: temp_embd -> %d tokens", n_t)
    elif pos_mode in ("repeat", "super-resolution"):
        raise KeyError(f"POS_EMBED={pos_mode!r} requested but the checkpoint has no {key!r} entry (keys look like: {sorted(sd)[:5]}...)")
    elif pos_mode not in (None, "", False):
        raise NotImplementedError(f"Unknown POS_EMBED preprocess {pos_mode!r}")

    patch_mode, ckey = get("PATCH_EMBD", None), "backbone.stem.conv1.weight"
    if patch_mode in ("central_frame", "average") and ckey in sd:
        w = sd[ckey]  # [O, I, 1, p, p] (or [O, I, p, p] from a 2D source)
        ts = int(bb.get("TUBELET_SIZE", 1) or 1)
        w2d = w.reshape(w.shape[:2] + w.shape[-2:]) if w.dim() == 5 else w
        if patch_mode == "central_frame":
            new = torch.zeros(w2d.shape[:2] + (ts,) + w2d.shape[2:], dtype=w.dtype)
            new[:, :, ts // 2] = w2d
        else:
            new = w2d[:, :, None].repeat(1, 1, ts, 1, 1) / float(ts)
        sd[ckey] = new
        logger.info("checkpoint_preprocess: %s tubelet init (size %d)", patch_mode, ts)
    elif patch_mode in ("central_frame", "average"):
        raise KeyError(f"PATCH_EMBD={patch_mode!r} requested but the checkpoint has no {ckey!r} entry")
    elif patch_mode not in (None, "", False):
        raise NotImplementedError(f"Unknown PATCH_EMBD preprocess {patch_mode!r}")
    return sd


def surgery(cfg, sd: StateDict, template: StateDict, pre_process: bool, inflation: bool) -> StateDict:
    """TRAIN.CHECKPOINT_PRE_PROCESS, then TRAIN.CHECKPOINT_INFLATE, on a loaded
    state dict, in the JAX package's order (load_checkpoint_file)."""
    if pre_process:
        sd = preprocess_checkpoint(cfg, sd)
    if inflation:
        sd = inflate_2d_to_3d(sd, template)
    return sd


def surgery_flags(cfg) -> Tuple[bool, bool]:
    """(TRAIN.CHECKPOINT_PRE_PROCESS.ENABLE, TRAIN.CHECKPOINT_INFLATE)."""
    pp = cfg.TRAIN.get("CHECKPOINT_PRE_PROCESS", {})
    return (bool(pp.get("ENABLE", False)) if hasattr(pp, "get") else False), bool(cfg.TRAIN.get("CHECKPOINT_INFLATE", False))


def _npz_state(path: str) -> StateDict:
    from clip_fsar_torch.models.video.convert import params_from_jax

    tree: Dict = {}
    with np.load(path) as archive:
        for key in archive.files:
            node = tree
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = archive[key]
    return params_from_jax(tree if ("params" in tree or "batch_stats" in tree) else {"params": tree})


def load_state(path: str) -> Optional[StateDict]:
    """The state dict in a checkpoint file: the port's ``.pt`` (its model
    entries) or a JAX-package ``.npz``; None when the path does not exist.
    A remote path (``oss://``, ``gs://``, a registered scheme) is fetched
    into the local cache first (utils/storage.py)."""
    if storage.is_remote(path):
        path = storage.fetch(path)
    if not os.path.exists(path):
        logger.info("checkpoint path %s not found", path)
        return None
    if os.path.isdir(path):
        raise ValueError(f"checkpoint path {path} is a directory (an orbax checkpoint of the JAX package?), which the port does not read: "
                         "export the weights with clip_fsar_tpu.train.pretrain.save_weights_npz and point the config at that .npz")
    if path.endswith(".npz"):
        return _npz_state(path)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if is_reference_checkpoint(raw):
        raise NotImplementedError(f"checkpoint path {path} is a reference-framework checkpoint, which the port reads for CNN_OTAM_CLIPFSAR "
                                  "heads only (the JAX package's mapping covers that head only)")
    return raw.get("head", raw)


def load_checkpoint_file(cfg, path: str, model: nn.Module, pre_process: bool = False, inflation: bool = False) -> bool:
    """Non-strict load of ``path`` into ``model`` after the surgery asked
    for; False when the path does not exist, raises when nothing of it
    matches the model."""
    sd = load_state(path)
    if sd is None:
        return False
    own = model.state_dict()
    merged, used = merge_non_strict(own, surgery(cfg, sd, own, pre_process, inflation), label=path)
    if not used:
        raise ValueError(f"checkpoint file {path} holds no entry that matches the model by name and shape (e.g. {sorted(sd)[:3]})")
    model.load_state_dict(merged)
    logger.info("loaded %d entries from %s", used, path)
    return True


def load_test_variables(cfg, checkpointer, model: nn.Module) -> str:
    """The test-time search: TEST.CHECKPOINT_FILE_PATH -> the last OUTPUT_DIR
    checkpoint -> TRAIN.CHECKPOINT_FILE_PATH -> the fresh weights.  Returns
    which one ``model`` now holds."""
    test_path = str(cfg.TEST.get("CHECKPOINT_FILE_PATH", "") or "") if "TEST" in cfg else ""
    train_path = str(cfg.TRAIN.get("CHECKPOINT_FILE_PATH", "") or "") if "TRAIN" in cfg else ""
    if test_path and load_checkpoint_file(cfg, test_path, model):
        logger.info("testing with TEST.CHECKPOINT_FILE_PATH: %s", test_path)
        return test_path
    step = None if checkpointer is None else checkpointer.latest_step()
    if step is not None:
        model.load_state_dict(checkpointer.load(step)["head"])
        logger.info("testing with the last OUTPUT_DIR checkpoint (step %d)", step)
        return checkpointer.path(step)
    if train_path and load_checkpoint_file(cfg, train_path, model):
        logger.info("testing with TRAIN.CHECKPOINT_FILE_PATH: %s", train_path)
        return train_path
    logger.info("no checkpoint found — testing with freshly built weights")
    return "fresh"


def load_train_checkpoint_file(cfg, model: nn.Module) -> bool:
    """TRAIN.CHECKPOINT_FILE_PATH as a run's start weights, with the surgery
    its keys ask for (used when auto-resume found nothing)."""
    path = str(cfg.TRAIN.get("CHECKPOINT_FILE_PATH", "") or "")
    if not path:
        return False
    return load_checkpoint_file(cfg, path, model, *surgery_flags(cfg))
