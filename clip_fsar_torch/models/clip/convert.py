"""Weights into the port: OpenAI CLIP ``.pt`` files and the JAX package's
variables (counterpart of clip_fsar_tpu/models/clip/convert.py).

The port keeps CLIP weights as one state dict in OpenAI's names — vision
tower under ``visual.`` — except that the text tower sits under ``text.``
(OpenAI keeps it at the top level), so an OpenAI file maps by renaming.
``params_from_jax`` maps the flax parameter tree of ``clip_fsar_tpu``
(numpy arrays) onto the port's state dicts:

* Dense ``kernel`` (in, out) -> ``weight`` (out, in);
* ``q_proj`` / ``k_proj`` / ``v_proj`` -> one packed ``in_proj`` (q | k | v);
* ``_PatchEmbed`` kernel (p, p, c, width) -> conv layout (width, c, p, p);
* the ``LayerNorm_0`` child scope -> ``weight`` / ``bias``;
* RN towers: conv ``kernel`` (kh, kw, in, out) -> ``weight`` (out, in, kh, kw),
  ``BatchNorm_0`` {scale, bias} -> ``weight`` / ``bias`` and the
  ``batch_stats`` {mean, var} -> ``running_mean`` / ``running_var``,
  ``layer{s}_{i}`` -> ``layer{s}.{i}``, ``downsample_conv`` /
  ``downsample_bn`` -> ``downsample.0`` / ``downsample.1``;
* embeddings, projections and the head ``scale`` as they are.
"""

from __future__ import annotations

import dataclasses
import zipfile
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from clip_fsar_torch.models.clip.arch import ARCHS, CLIPArch

_OPENAI_META_KEYS = ("input_resolution", "context_length", "vocab_size")
_BN_COUNTER = ".num_batches_tracked"  # torch BatchNorm2d's step counter: flax has none, nor has the port


def infer_arch(sd: Mapping[str, Any]) -> CLIPArch:
    """Shape-based architecture inference for OpenAI-format state dicts
    (the reference's build_model rule, few_shot.py:849-886).  Head counts
    follow the OpenAI rule (width / 64) unless the shapes match a named
    entry of ARCHS exactly, whose head counts are then used (the tiny test
    archs break the rule)."""
    is_vit = "visual.proj" in sd
    if is_vit:
        vision_width = sd["visual.conv1.weight"].shape[0]
        vision_layers = len([k for k in sd if k.startswith("visual.") and k.endswith(".attn.in_proj_weight")])
        vision_patch_size = sd["visual.conv1.weight"].shape[-1]
        grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
        image_resolution = vision_patch_size * grid
    else:
        vision_layers = tuple(len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{s}")}) for s in (1, 2, 3, 4))
        vision_width = sd["visual.layer1.0.conv1.weight"].shape[0]
        vision_patch_size = None
        image_resolution = round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5) * 32
    arch = CLIPArch(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=image_resolution,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=vision_patch_size,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=sd["ln_final.weight"].shape[0],
        transformer_heads=sd["ln_final.weight"].shape[0] // 64,
        transformer_layers=len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks")}),
    )
    for named in ARCHS.values():
        if dataclasses.replace(named, transformer_heads=arch.transformer_heads, vision_heads_override=None) == arch:
            return named
    return arch


def openai_to_port(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """OpenAI CLIP names -> the port's CLIP names (text tower under ``text.``)."""
    out = {}
    for k, v in sd.items():
        if k in _OPENAI_META_KEYS or k.endswith(_BN_COUNTER):
            continue
        name = k if (k.startswith("visual.") or k == "logit_scale") else f"text.{k}"
        out[name] = torch.as_tensor(v).float()
    return out


def load_openai_checkpoint(path: str) -> Tuple[CLIPArch, Dict[str, torch.Tensor]]:
    """Load an OpenAI CLIP ``.pt`` (a TorchScript archive as OpenAI ships
    it, or a plain saved state dict) -> (arch, the port's CLIP state dict)."""
    with zipfile.ZipFile(path) as z:
        scripted = any(name.endswith("constants.pkl") for name in z.namelist())
    if scripted:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    else:
        obj = torch.load(path, map_location="cpu", weights_only=True)
        sd = obj.get("state_dict", obj)
    sd = {k: v for k, v in sd.items() if k not in _OPENAI_META_KEYS}
    return infer_arch(sd), openai_to_port(sd)


def resize_vision_pos_embed(sd: Dict[str, torch.Tensor], arch: CLIPArch) -> Dict[str, torch.Tensor]:
    """Bilinearly resample the vision positional table to ``arch``'s
    (non-native) resolution, keeping the first row (JAX convert.py:227-254,
    which uses jax.image.resize: half-pixel centres, antialiased when
    shrinking): ``visual.positional_embedding`` on the ViT's patch grid, or
    ``visual.attnpool.positional_embedding`` on the RN towers' stride-32 grid."""
    key = "visual.positional_embedding" if "visual.positional_embedding" in sd else "visual.attnpool.positional_embedding"
    pos = sd[key]
    g_old = round((pos.shape[0] - 1) ** 0.5)
    g_new = arch.image_resolution // (arch.vision_patch_size or 32)
    if g_old == g_new:
        return sd
    grid = pos[1:].reshape(g_old, g_old, -1).permute(2, 0, 1)[None]
    grid = F.interpolate(grid, size=(g_new, g_new), mode="bilinear", align_corners=False, antialias=g_new < g_old)
    out = dict(sd)
    out[key] = torch.cat([pos[:1], grid[0].permute(1, 2, 0).reshape(g_new * g_new, -1)], dim=0)
    return out


# ---------------------------------------------------------------------------
# JAX (flax) parameter tree -> port state dicts
# ---------------------------------------------------------------------------


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(out: Dict, name: str, tree: Mapping) -> None:
    out[f"{name}.weight"] = _t(tree["kernel"]).T.contiguous()
    if "bias" in tree:
        out[f"{name}.bias"] = _t(tree["bias"])


def _norm(out: Dict, name: str, tree: Mapping) -> None:
    tree = tree.get("LayerNorm_0", tree)  # CLIP LayerNorm keeps its params in a child scope
    out[f"{name}.weight"] = _t(tree["scale"])
    out[f"{name}.bias"] = _t(tree["bias"])


def _transformer(out: Dict, prefix: str, tree: Mapping) -> None:
    i = 0
    while f"resblocks_{i}" in tree:
        blk, p = tree[f"resblocks_{i}"], f"{prefix}.resblocks.{i}"
        _norm(out, f"{p}.ln_1", blk["ln_1"])
        _norm(out, f"{p}.ln_2", blk["ln_2"])
        attn = blk["attn"]
        out[f"{p}.attn.in_proj_weight"] = torch.cat([_t(attn[n]["kernel"]).T for n in ("q_proj", "k_proj", "v_proj")], 0)
        out[f"{p}.attn.in_proj_bias"] = torch.cat([_t(attn[n]["bias"]) for n in ("q_proj", "k_proj", "v_proj")], 0)
        _dense(out, f"{p}.attn.out_proj", attn["out_proj"])
        _dense(out, f"{p}.mlp.c_fc", blk["mlp_c_fc"])
        _dense(out, f"{p}.mlp.c_proj", blk["mlp_c_proj"])
        i += 1


def _conv(out: Dict, name: str, tree: Mapping) -> None:
    out[f"{name}.weight"] = _t(tree["kernel"]).permute(3, 2, 0, 1).contiguous()  # (kh, kw, in, out) -> (out, in, kh, kw)


def _batch_norm(out: Dict, name: str, tree: Mapping, stats: Optional[Mapping]) -> None:
    _norm(out, name, tree["BatchNorm_0"])
    if stats is not None:
        out[f"{name}.running_mean"] = _t(stats["BatchNorm_0"]["mean"])
        out[f"{name}.running_var"] = _t(stats["BatchNorm_0"]["var"])


def _resnet(out: Dict, prefix: str, tree: Mapping, stats: Optional[Mapping]) -> None:
    """ModifiedResNet params (and, when given, its batch_stats) -> OpenAI names."""
    sub = lambda name: None if stats is None else stats[name]  # noqa: E731
    for j in (1, 2, 3):
        _conv(out, f"{prefix}.conv{j}", tree[f"conv{j}"])
        _batch_norm(out, f"{prefix}.bn{j}", tree[f"bn{j}"], sub(f"bn{j}"))
    for stage in (1, 2, 3, 4):
        i = 0
        while f"layer{stage}_{i}" in tree:
            name, blk = f"layer{stage}_{i}", tree[f"layer{stage}_{i}"]
            p = f"{prefix}.layer{stage}.{i}"
            blk_stats = sub(name)
            for j in (1, 2, 3):
                _conv(out, f"{p}.conv{j}", blk[f"conv{j}"])
                _batch_norm(out, f"{p}.bn{j}", blk[f"bn{j}"], None if blk_stats is None else blk_stats[f"bn{j}"])
            if "downsample_conv" in blk:
                _conv(out, f"{p}.downsample.0", blk["downsample_conv"])
                _batch_norm(out, f"{p}.downsample.1", blk["downsample_bn"], None if blk_stats is None else blk_stats["downsample_bn"])
            i += 1
    pool = tree["attnpool"]
    out[f"{prefix}.attnpool.positional_embedding"] = _t(pool["positional_embedding"])
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _dense(out, f"{prefix}.attnpool.{name}", pool[name])


def _vision(out: Dict, prefix: str, tree: Mapping, stats: Optional[Mapping] = None) -> None:
    if "attnpool" in tree:
        _resnet(out, prefix, tree, stats)
        return
    out[f"{prefix}.conv1.weight"] = _t(tree["conv1"]["kernel"]).permute(3, 2, 0, 1).contiguous()  # (p,p,c,w) -> (w,c,p,p)
    for name in ("class_embedding", "positional_embedding", "proj"):
        out[f"{prefix}.{name}"] = _t(tree[name])
    _norm(out, f"{prefix}.ln_pre", tree["ln_pre"])
    _norm(out, f"{prefix}.ln_post", tree["ln_post"])
    _transformer(out, f"{prefix}.transformer", tree["transformer"])


def _text(out: Dict, prefix: str, tree: Mapping) -> None:
    out[f"{prefix}.token_embedding.weight"] = _t(tree["token_embedding"]["embedding"])
    out[f"{prefix}.positional_embedding"] = _t(tree["positional_embedding"])
    out[f"{prefix}.text_projection"] = _t(tree["text_projection"])
    _norm(out, f"{prefix}.ln_final", tree["ln_final"])
    _transformer(out, f"{prefix}.transformer", tree["transformer"])


def _context2(out: Dict, tree: Mapping) -> None:
    i = 0
    while f"norm_{i}" in tree:
        _norm(out, f"context2.norm_{i}", tree[f"norm_{i}"])
        for proj, sub in tree[f"attn_{i}"].items():  # to_q / to_k / to_v (biasless), to_out
            _dense(out, f"context2.attn_{i}.{proj}", sub)
        for fc, sub in tree[f"ff_{i}"].items():
            _dense(out, f"context2.ff_{i}.{fc}", sub)
        i += 1


def params_from_jax(variables: Mapping, text_params: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """The JAX FewShotModel variables ({"params": {"backbone", "context2",
    "scale"}}, numpy leaves, and for the RN towers {"batch_stats":
    {"backbone"}}) -> a CLIPFSARHead state dict; without batch_stats the RN
    running stats are left out.  With ``text_params`` (the JAX CLIP's
    ``params["text"]``) the text tower's entries are added under ``text.``,
    the names of ``CLIP.text``."""
    params = variables["params"]
    out: Dict[str, torch.Tensor] = {}
    _vision(out, "backbone", params["backbone"], (variables.get("batch_stats") or {}).get("backbone"))
    _context2(out, params["context2"])
    out["scale"] = _t(params["scale"])
    if text_params is not None:
        _text(out, "text", text_params)
    return out

