"""Checkpoints saved by the port, auto-resume, and the test-time checkpoint
search (counterpart of clip_fsar_tpu/train/checkpoint.py and
clip_fsar_tpu/train/pretrain.py:247-301).

``Checkpointer(OUTPUT_DIR)`` writes ``OUTPUT_DIR/checkpoints/<step>.pt``
(``torch.save`` of the step, the head's state dict with an RN tower's
BatchNorm running stats, the optimizer with its accumulation window, and the
EMA parameters), atomically, keeping the newest five; under a process group
rank 0 writes and every rank waits for the file.  Under tensor parallelism
the model ranks gather their slices first, so the file holds full tensors
(parameters, optimizer moments, the accumulation window, the EMA) whatever
TPU.MESH.MODEL wrote it; a run reads it into its full model and then cuts
its slices (``TrainState.shard_``), so a checkpoint written at MODEL 2
resumes at MODEL 1, and the reverse.  A head checkpoint file (``save_checkpoint``) holds the head's state
dict alone.  Loading a checkpoint FILE (TEST/TRAIN.CHECKPOINT_FILE_PATH) is
non-strict as in the JAX package: entries whose name and shape match the head
are taken, the rest are skipped with a log line.

Three formats are read: the port's own ``.pt`` files, the JAX package's
``.npz`` weight archives (``clip_fsar_tpu.train.pretrain.save_weights_npz``:
flat "/"-keyed numpy arrays), which is the route for weights the JAX package
trained, and the reference framework's ``.pyth`` / ``.pth`` files of a
CNN_OTAM_CLIPFSAR head (models/convert_reference.py).  A torch file is told
apart by its content, not its suffix: a ``model_state`` entry or the
reference's ``module.`` / ``head.`` prefixes make it a reference file (the
JAX package also reads a reference ``.pt``, pretrain.py:217-221), which
raises for any other head.  A path that does not exist is logged and the
search goes on, as in the JAX package; a path that exists in a format the
port cannot read (an orbax checkpoint directory, a file in which nothing
matches the head) raises, so that a run never tests or finetunes fresh
weights where a checkpoint was named.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from clip_fsar_torch.models.clip.convert import params_from_jax
from clip_fsar_torch.models.convert_reference import is_reference_checkpoint, reference_head_state
from clip_fsar_torch.models.heads.clipfsar import CLIPFSARHead
from clip_fsar_torch.parallel import mesh, tensor
from clip_fsar_torch.train.state import TrainState
from clip_fsar_torch.utils.logging import get_logger

logger = get_logger(__name__)

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _atomic_save(obj, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)  # a reader sees the whole file or none


def save_checkpoint(path: str, head: nn.Module) -> None:
    """The head's state dict to ``path`` in full tensors, written by rank 0
    (every rank holds the same weights, or its model slice of them); every
    rank returns once the file is whole."""
    sd = tensor.gather_named(head.state_dict(), tensor.specs(head))
    if mesh.rank() == 0:
        _atomic_save({"head": sd}, path)
    mesh.barrier()


_NPZ_ROUTE = ("export the weights with clip_fsar_tpu.train.pretrain.save_weights_npz(path, variables) where the JAX package "
              "runs, and point the config at that .npz")


def _load_npz(path: str) -> Dict[str, torch.Tensor]:
    """A JAX-package weight archive (flat "/"-keyed arrays, with or without
    the ``params/`` collection prefix; an RN tower's running stats under
    ``batch_stats/``) as a head state dict."""
    tree: Dict[str, Any] = {}
    with np.load(path) as archive:
        for key in archive.files:
            node = tree
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = archive[key]
    try:
        return params_from_jax(tree if "params" in tree else {"params": tree})
    except KeyError as e:
        raise ValueError(f"{path} is not a weight archive of the JAX package's few-shot model: it has no entry {e}") from e


def load_checkpoint_file(path: str, head: nn.Module, head_name: str = "", cfg=None, pre_process: bool = False, inflation: bool = False) -> bool:
    """Non-strict load of a checkpoint file into ``head`` (``head_name``, the
    config's VIDEO.HEAD.NAME, for the messages): the port's own ``.pt``, a
    JAX-package ``.npz`` weight archive or a reference ``.pyth`` / ``.pth`` of
    a CNN_OTAM_CLIPFSAR head.  ``pre_process`` and ``inflation`` apply
    ``cfg``'s checkpoint surgery to the loaded entries first
    (train/pretrain.py).  False when the path does not exist; raises when
    it exists and cannot be read into the head."""
    if not os.path.exists(path):
        logger.info("checkpoint path %s not found", path)
        return False
    if os.path.isdir(path):
        raise ValueError(f"checkpoint path {path} is a directory (an orbax checkpoint of the JAX package?), which the port does not read: {_NPZ_ROUTE}")
    if path.endswith(".npz"):
        sd = _load_npz(path)
    else:
        raw = torch.load(path, map_location="cpu", weights_only=True)
        if is_reference_checkpoint(raw):
            if not isinstance(head, CLIPFSARHead):
                raise NotImplementedError(
                    f"checkpoint path {path} is a reference-framework checkpoint, which the port reads for CNN_OTAM_CLIPFSAR "
                    f"heads only, not for {head_name or type(head).__name__} (the JAX package's mapping covers CLIP-FSAR only)")
            sd = reference_head_state(raw, head.arch, path)
        else:
            sd = raw.get("head", raw)
    own = head.state_dict()
    if pre_process or inflation:
        from clip_fsar_torch.train.pretrain import surgery

        sd = surgery(cfg, sd, own, pre_process, inflation)
    take = {k: v for k, v in sd.items() if k in own and own[k].shape == v.shape}
    skipped = sorted(set(sd) - set(take))
    if not take:
        raise ValueError(f"checkpoint file {path} holds no entry that matches the head by name and shape (e.g. {skipped[:3]})")
    if skipped:
        logger.info("%s: skipped %d entries that do not match the head (e.g. %s)", path, len(skipped), skipped[:3])
    head.load_state_dict(take, strict=False)
    logger.info("loaded %d of %d head entries from %s", len(take), len(own), path)
    return True


class Checkpointer:
    """Step-stamped train checkpoints under ``<output_dir>/checkpoints``."""

    def __init__(self, output_dir: str, max_to_keep: int = 5):
        self.dir = os.path.abspath(os.path.join(output_dir, "checkpoints"))
        self.max_to_keep = max_to_keep

    def steps(self) -> list:
        if not os.path.isdir(self.dir):
            return []
        return sorted(int(m.group(1)) for name in os.listdir(self.dir) if (m := _STEP_FILE.match(name)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"{step}.pt")

    def save(self, step: int, state: TrainState) -> str:
        """Written by rank 0 (every rank holds the same state, or its model
        slice of it: every rank then gathers); every rank returns once the
        file is whole."""
        specs = tensor.specs(state.head)
        if specs or mesh.rank() == 0:
            full = lambda sd: {k: v.detach().cpu() for k, v in tensor.gather_named(sd, specs).items()}  # noqa: E731
            payload = {
                "step": state.step,
                "head": full(state.model_variables()),
                "optimizer": state.optimizer.state_dict(),
                "ema": None if state.ema is None else full(state.ema),
            }
        if mesh.rank() == 0:
            _atomic_save(payload, self.path(step))
            for old in self.steps()[: -self.max_to_keep]:
                os.unlink(self.path(old))
            logger.info("Saved checkpoint at step %d", step)
        mesh.barrier()
        return self.path(step)

    def load(self, step: Optional[int] = None) -> Optional[dict]:
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self.path(step), map_location="cpu", weights_only=True)

    def restore(self, state: TrainState, step: Optional[int] = None) -> Optional[int]:
        """Load checkpoint ``step`` (the latest by default) into ``state`` in
        place; returns the restored step, None when there is none.  The
        head must match (a mismatch raises); an optimizer state or EMA from
        another configuration is reinitialized with a warning, as the JAX
        package's non-strict restore does."""
        raw = self.load(step)
        if raw is None:
            return None
        state.head.load_state_dict(raw["head"])  # strict: a params mismatch is never skippable
        kept = []
        if raw["optimizer"]["signature"] == state.optimizer.signature():
            state.optimizer.load_state_dict(raw["optimizer"])
        else:
            kept.append("optimizer")
        if (state.ema is None) != (raw["ema"] is None):
            kept.append("ema")
        elif state.ema is not None:
            state.ema = {k: v.to(state.ema[k].device) for k, v in raw["ema"].items()}
        if kept:
            logger.warning("Checkpoint step %d does not match the current run configuration in %s: those were reinitialized", raw["step"], kept)
        state.step = int(raw["step"])
        logger.info("Restored checkpoint from step %d", state.step)
        return state.step


def auto_resume(cfg, checkpointer: Checkpointer, state: TrainState) -> Optional[int]:
    """Resume from the latest OUTPUT_DIR checkpoint when TRAIN.AUTO_RESUME
    (reference checkpoint.py:532-577); returns the step or None."""
    if not bool(cfg.TRAIN.get("AUTO_RESUME", True)):
        return None
    mesh.barrier()  # no rank reads while another may still be writing
    return checkpointer.restore(state)


def load_test_weights(cfg, head: nn.Module) -> str:
    """Test-time search (reference checkpoint.py:452-529, JAX
    pretrain.py:279-301): TEST.CHECKPOINT_FILE_PATH -> the latest
    checkpoint in OUTPUT_DIR/checkpoints (the trained weights, not EMA) ->
    TRAIN.CHECKPOINT_FILE_PATH -> the freshly built weights.  Returns which
    one the head now holds.  Every rank of a process group reads the same
    file."""
    mesh.barrier()  # no rank reads while another may still be writing
    test_path = str(cfg.TEST.get("CHECKPOINT_FILE_PATH", "") or "") if "TEST" in cfg else ""
    train_path = str(cfg.TRAIN.get("CHECKPOINT_FILE_PATH", "") or "") if "TRAIN" in cfg else ""
    head_name = cfg.VIDEO.HEAD.NAME
    if test_path and load_checkpoint_file(test_path, head, head_name):
        logger.info("testing with TEST.CHECKPOINT_FILE_PATH: %s", test_path)
        return test_path
    ckpt = Checkpointer(cfg.get("OUTPUT_DIR", None) or ".")
    step = ckpt.latest_step()
    if step is not None:
        head.load_state_dict(ckpt.load(step)["head"])
        logger.info("testing with the last OUTPUT_DIR checkpoint (step %d)", step)
        return ckpt.path(step)
    if train_path and load_checkpoint_file(train_path, head, head_name):
        logger.info("testing with TRAIN.CHECKPOINT_FILE_PATH: %s", train_path)
        return train_path
    logger.info("no checkpoint found — testing with freshly built weights")
    return "fresh"
