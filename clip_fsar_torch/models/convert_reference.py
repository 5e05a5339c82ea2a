"""Reference-framework checkpoints (``.pyth`` / ``.pth``: torch.save dicts
of the reference's utils/checkpoint.py:122-129) into the port's
CNN_OTAM_CLIPFSAR head (counterpart of
clip_fsar_tpu/models/convert_reference.py:21-107).

The reference stores its model under ``model_state``, with DDP's
``module.`` and the model's ``head.`` prefixes.  Its CNN_OTAM_CLIPFSAR head
(few_shot.py:2691-2993) keeps the CLIP visual tower under ``backbone.`` in
OpenAI's names, which the port's head uses as they are, the prototype
modulation transformer (Transformer_v1, few_shot.py:979-999) as
``context2.layers.{i}.0`` (PreNormattention: ``norm``, ``fn.to_q`` /
``to_k`` / ``to_v`` / ``to_out.0``) and ``context2.layers.{i}.1``
(FeedForward: ``net.0``, ``net.3``), and ``scale``.  The mapping covers
that head only, as the JAX package's does.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import torch

from clip_fsar_torch.models.clip.arch import CLIPArch
from clip_fsar_torch.models.clip.convert import infer_arch

# reference Transformer_v1 names -> the port's TransformerV1 names
_CONTEXT2 = [
    (r"context2\.layers\.(\d+)\.0\.norm\.", r"context2.norm_\1."),
    (r"context2\.layers\.(\d+)\.0\.fn\.to_out\.0\.", r"context2.attn_\1.to_out."),
    (r"context2\.layers\.(\d+)\.0\.fn\.(to_[qkv])\.", r"context2.attn_\1.\2."),
    (r"context2\.layers\.(\d+)\.1\.net\.0\.", r"context2.ff_\1.fc1."),
    (r"context2\.layers\.(\d+)\.1\.net\.3\.", r"context2.ff_\1.fc2."),
]
_BN_COUNTER = ".num_batches_tracked"  # torch BatchNorm's step counter: the port's BatchNorm has none
_VISION_FIELDS = ("image_resolution", "vision_layers", "vision_width", "vision_patch_size", "embed_dim")


def strip_prefixes(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Remove DDP's ``module.`` prefix, then keep the model's ``head.``
    entries without their prefix where there are any (a full-model dict)."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    if any(k.startswith("head.") for k in sd):
        sd = {k[len("head."):]: v for k, v in sd.items() if k.startswith("head.")}
    return sd


def is_reference_checkpoint(blob: Any) -> bool:
    """Whether a loaded checkpoint is the reference framework's, by content:
    a ``model_state`` entry, ``module.`` / ``head.`` prefixes, or the
    reference's ``context2.layers.`` names.  The port's own files hold its
    head state under ``head`` (no dot) in the port's names."""
    if not isinstance(blob, Mapping):
        return False
    if "model_state" in blob:
        return True
    return any(isinstance(k, str) and k.startswith(("module.", "head.", "context2.layers.")) for k in blob)


def reference_arch(sd: Mapping[str, torch.Tensor]) -> CLIPArch:
    """The CLIP visual tower's arch, inferred from the ``backbone.`` shapes
    (OpenAI's rule; the text-side fields are placeholders: reference head
    checkpoints hold no text tower)."""
    visual = {f"visual.{k[len('backbone.'):]}": v for k, v in sd.items() if k.startswith("backbone.")}
    if "visual.proj" in visual:
        embed_dim = visual["visual.proj"].shape[1]
    elif "visual.attnpool.c_proj.weight" in visual:
        embed_dim = visual["visual.attnpool.c_proj.weight"].shape[0]
    else:
        raise ValueError("no CLIP visual tower under backbone.* (neither backbone.proj nor backbone.attnpool): "
                         "not a CNN_OTAM_CLIPFSAR checkpoint")
    visual.update({"text_projection": torch.zeros(embed_dim, embed_dim), "positional_embedding": torch.zeros(77, embed_dim),
                   "token_embedding.weight": torch.zeros(1, embed_dim), "ln_final.weight": torch.zeros(embed_dim)})
    try:
        return infer_arch(visual)
    except KeyError as e:
        raise ValueError(f"the CLIP visual tower under backbone.* lacks the entry {e}") from e


# the port's TransformerV1 names -> the reference's (the inverse of _CONTEXT2)
_TO_REFERENCE = [
    (r"context2\.norm_(\d+)\.", r"context2.layers.\1.0.norm."),
    (r"context2\.attn_(\d+)\.to_out\.", r"context2.layers.\1.0.fn.to_out.0."),
    (r"context2\.attn_(\d+)\.(to_[qkv])\.", r"context2.layers.\1.0.fn.\2."),
    (r"context2\.ff_(\d+)\.fc1\.", r"context2.layers.\1.1.net.0."),
    (r"context2\.ff_(\d+)\.fc2\.", r"context2.layers.\1.1.net.3."),
]


def reference_state_dict(head_state: Mapping[str, torch.Tensor], prefix: str = "module.head.") -> Dict[str, torch.Tensor]:
    """A CNN_OTAM_CLIPFSAR head's state dict in the reference's names under
    ``prefix`` (DDP's full-model prefix by default): what the reference would
    hold under ``model_state`` for the same weights."""
    out = {}
    for k, v in head_state.items():
        for pattern, repl in _TO_REFERENCE:
            k = re.sub(f"^{pattern}", repl, k)
        out[prefix + k] = v
    return out


def convert_clipfsar_state_dict(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference CNN_OTAM_CLIPFSAR state dict (a head's, or a full model's
    with ``head.`` / ``module.head.`` prefixes) -> the port head's state dict
    in float32, BatchNorm step counters dropped."""
    out = {}
    for k, v in strip_prefixes(sd).items():
        if k.endswith(_BN_COUNTER):
            continue
        for pattern, repl in _CONTEXT2:
            k = re.sub(f"^{pattern}", repl, k)
        out[k] = torch.as_tensor(v).float()
    return out


def reference_head_state(blob: Mapping[str, Any], arch: CLIPArch, source: str = "checkpoint") -> Dict[str, torch.Tensor]:
    """A loaded reference checkpoint (its ``model_state``, or a bare state
    dict) -> the state dict of a CNN_OTAM_CLIPFSAR head on ``arch``; raises
    when the file's tower is another arch (by its shapes)."""
    sd = convert_clipfsar_state_dict(blob.get("model_state", blob))
    found = reference_arch(sd)
    mismatch = {f: (getattr(found, f), getattr(arch, f)) for f in _VISION_FIELDS if getattr(found, f) != getattr(arch, f)}
    if mismatch:
        raise ValueError(f"{source}: its CLIP tower is not the config's (field: (file, config)): {mismatch}")
    return sd


def load_reference_checkpoint(path: str, arch: CLIPArch) -> Dict[str, torch.Tensor]:
    """Read a reference ``.pyth`` / ``.pth`` file (tensors only:
    ``weights_only=True``) as the state dict of a CNN_OTAM_CLIPFSAR head on
    ``arch``."""
    return reference_head_state(torch.load(path, map_location="cpu", weights_only=True), arch, path)
