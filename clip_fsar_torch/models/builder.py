"""Model builder: config -> (head module, text banks) (counterpart of
clip_fsar_tpu/models/builder.py:61-363).

Builds the CLIP towers from an OpenAI ``.pt`` when one is found (same
search paths as the JAX package), otherwise from fresh weights drawn from
an explicit ``torch.Generator`` with the flax initializer families (the
values differ from JAX's; only the distributions match).  Precomputes the
class-name text banks once, in float32, and assembles the head that
``VIDEO.HEAD.NAME`` names in ``HEAD_REGISTRY``: CNN_OTAM_CLIPFSAR, or one of
the classic heads and MoLo (``models/heads/fsheads.py``, ``molo.py``), whose
torchvision ResNet trunk takes ImageNet weights from a torchvision state
dict where one is found.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from clip_fsar_torch.models.clip.tokenizer import tokenize
from clip_fsar_torch import runtime
from clip_fsar_torch.models.clip.arch import ARCHS, CLIPArch
from clip_fsar_torch.models.clip.convert import load_openai_checkpoint, resize_vision_pos_embed
from clip_fsar_torch.models.clip.model import (
    AttentionPool2d,
    BatchNorm,
    Conv2d,
    Dense,
    LayerNorm,
    MultiheadAttention,
    PatchEmbed,
    TextTransformer,
    VisionTransformer,
    build_vision_tower,
)
from clip_fsar_torch.models.heads import fsheads, molo  # noqa: F401  (registers the classic heads and MoLo)
from clip_fsar_torch.models.heads.clipfsar import CLIPFSARConfig, CLIPFSARHead
from clip_fsar_torch.models.resnet import RESNET_SPECS, load_torchvision_resnet
from clip_fsar_torch.utils.logging import get_logger
from clip_fsar_torch.utils.registry import HEAD_REGISTRY

logger = get_logger(__name__)


class FewShotModel(NamedTuple):
    head: nn.Module
    text_train: torch.Tensor
    text_test: torch.Tensor


def _dtype_from_cfg(cfg) -> torch.dtype:
    name = str(cfg.TPU.get("COMPUTE_DTYPE", "bfloat16")) if "TPU" in cfg else "float32"
    return {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}[name]


def _attention_backend_from_cfg(cfg, device: torch.device) -> str:
    """Attention core of the CLIP towers.  ``TPU.PALLAS_ATTENTION`` -> pallas
    (flash_mha: the K3-K5 kernels on a card, their plain versions on the
    CPU), read before the layout as the JAX builder does.
    ``TPU.ATTENTION_LAYOUT``: fused -> the clip_mha kernel; auto -> fused on
    a card, the plain path on the CPU; split / unsplit -> the plain path (the
    two only shaped XLA fusion in the JAX package; the math is the same).
    ``TPU.SOFTMAX_DTYPE bfloat16`` keeps the plain path's logits in the
    compute dtype."""
    if "TPU" not in cfg:
        return "plain"
    if cfg.TPU.get("PALLAS_ATTENTION", False):
        return "pallas"
    layout = str(cfg.TPU.get("ATTENTION_LAYOUT", "auto"))
    if layout == "auto":
        layout = "fused" if device.type == "cuda" else "split"
    if layout == "fused":
        return "fused"
    return "plain:bf16" if str(cfg.TPU.get("SOFTMAX_DTYPE", "float32")) == "bfloat16" else "plain"


def _resolve_tower_execution(cfg, arch: Optional[CLIPArch]) -> Tuple[bool, bool]:
    """(remat, scan_layers) for the vision tower, as the JAX builder resolves
    them (builder.py:91-111): TPU.REMAT and TPU.SCAN_LAYERS take true, false
    or "auto", which is on for towers of 24 or more layers (ViT-L and up;
    an RN tower's layers are a tuple and never deep).  ``arch`` is the one
    the tower is built at, TPU.VISION_DEPTH applied."""

    def resolve(value, deep_default: bool) -> bool:
        if isinstance(value, str) and value.lower() == "auto":
            return deep_default
        return bool(value)

    layers = getattr(arch, "vision_layers", 0) if arch is not None else 0
    deep = isinstance(layers, int) and layers >= 24
    if "TPU" not in cfg:
        return False, False
    return resolve(cfg.TPU.get("REMAT", False), deep), resolve(cfg.TPU.get("SCAN_LAYERS", False), deep)


def tower_execution(cfg) -> Tuple[bool, bool]:
    """(remat, scan_layers) of the config's named backbone at its depth
    (TPU.VISION_DEPTH applied), without building it."""
    name = cfg.VIDEO.HEAD.BACKBONE_NAME
    return _resolve_tower_execution(cfg, _adapt_vision_depth(cfg, ARCHS[name]) if name in ARCHS else None)


def _clip_checkpoint_path(cfg) -> Optional[str]:
    """An OpenAI-format CLIP checkpoint to initialize from, if available:
    TRAIN.CLIP_WEIGHTS, then the user's CLIP cache, the root user's CLIP
    cache and ./weights, the JAX builder's roots in its order."""
    p = cfg.TRAIN.get("CLIP_WEIGHTS", "") if "TRAIN" in cfg else ""
    if p:
        return p
    name = cfg.VIDEO.HEAD.BACKBONE_NAME.replace("/", "-")
    root_cache = os.path.join(os.sep, "root", ".cache", "clip")  # the root user's cache, as the JAX builder spells it
    for root in (os.path.expanduser("~/.cache/clip"), root_cache, "./weights"):
        p = os.path.join(root, f"{name}.pt")
        if os.path.exists(p):
            return p
    return None


def _adapt_vision_resolution(cfg, arch: CLIPArch, flow: str = "auto") -> CLIPArch:
    """The tower's resolution follows the crop size of the flow ("train",
    "test", or "auto" = train when TRAIN.ENABLE else test), where the crop
    tiles the patch; a no-op at the shipped configs' native crops."""
    if "DATA" not in cfg:
        return arch
    train_crop = int(cfg.DATA.get("TRAIN_CROP_SIZE", 0) or 0)
    test_crop = int(cfg.DATA.get("TEST_CROP_SIZE", 0) or 0)
    if flow == "auto":
        flow = "train" if ("TRAIN" in cfg and bool(cfg.TRAIN.get("ENABLE", False))) else "test"
    crop = (train_crop or test_crop) if flow == "train" else (test_crop or train_crop)
    if not crop or crop == arch.image_resolution:
        return arch
    tile = arch.vision_patch_size if arch.vision_patch_size else 32
    if crop % tile:
        logger.warning("crop %d does not tile the %d-px vision stem; keeping native %d", crop, tile, arch.image_resolution)
        return arch
    logger.info("CLIP vision tower at %dpx (native %dpx)", crop, arch.image_resolution)
    return dataclasses.replace(arch, image_resolution=crop)


def _adapt_vision_depth(cfg, arch: CLIPArch) -> CLIPArch:
    """TPU.VISION_DEPTH / TPU.TEXT_DEPTH > 0 cut a fresh CLIP tower to that
    many real blocks (width and heads unchanged)."""
    if "TPU" not in cfg:
        return arch
    vdepth = int(cfg.TPU.get("VISION_DEPTH", 0) or 0)
    if vdepth and arch.is_vit and vdepth != arch.vision_layers:
        logger.info("CLIP vision tower truncated to %d/%d blocks (TPU.VISION_DEPTH)", vdepth, arch.vision_layers)
        arch = dataclasses.replace(arch, vision_layers=vdepth)
    tdepth = int(cfg.TPU.get("TEXT_DEPTH", 0) or 0)
    if tdepth and tdepth != arch.transformer_layers:
        logger.info("CLIP text tower truncated to %d/%d blocks (TPU.TEXT_DEPTH)", tdepth, arch.transformer_layers)
        arch = dataclasses.replace(arch, transformer_layers=tdepth)
    return arch


def _lecun_normal_(p: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    """flax lecun_normal: truncated normal at +-2 sigma, variance 1/fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std, generator=g)


@torch.no_grad()
def init_weights(module: nn.Module, g: torch.Generator) -> None:
    """Fill every parameter of ``module`` with the flax initializer family
    the JAX package uses for it, drawing from ``g`` in module order, and
    reset BatchNorm's running stats to flax's (mean 0, var 1).  A module
    with parameters of its own kind fills them in ``init_own_parameters``."""
    for m in module.modules():
        if hasattr(m, "init_own_parameters"):
            m.init_own_parameters(g)
        if isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, Dense):
            _lecun_normal_(m.weight, m.weight.shape[1], g)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, MultiheadAttention):
            _lecun_normal_(m.in_proj_weight, m.in_proj_weight.shape[1], g)
            m.in_proj_bias.zero_()
        elif isinstance(m, (PatchEmbed, Conv2d)):
            _lecun_normal_(m.weight, m.weight[0].numel(), g)  # fan-in kh * kw * in (kt * kh * kw * in in 3-D)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, AttentionPool2d):
            m.positional_embedding.normal_(0.0, m.positional_embedding.shape[1] ** -0.5, generator=g)
        elif isinstance(m, VisionTransformer):
            std = m.class_embedding.shape[0] ** -0.5
            for p in (m.class_embedding, m.positional_embedding, m.proj):
                p.normal_(0.0, std, generator=g)
        elif isinstance(m, TextTransformer):
            width = m.positional_embedding.shape[1]
            m.token_embedding.weight.normal_(0.0, width**-0.5, generator=g)
            m.positional_embedding.normal_(0.0, 0.01, generator=g)
            m.text_projection.normal_(0.0, width**-0.5, generator=g)


def _sub(sd: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def load_or_init_clip(cfg, generator: torch.Generator, flow: str = "auto"):
    """Returns (arch, CLIP state dict with ``visual.`` and ``text.`` entries).
    Loads OpenAI weights when present, otherwise draws fresh ones."""
    ckpt = _clip_checkpoint_path(cfg)
    if ckpt:
        logger.info("Loading CLIP weights from %s", ckpt)
        arch, sd = load_openai_checkpoint(ckpt)
        resized = _adapt_vision_resolution(cfg, arch, flow)
        if resized.image_resolution != arch.image_resolution:
            sd = resize_vision_pos_embed(sd, resized)
        return resized, sd
    name = cfg.VIDEO.HEAD.BACKBONE_NAME
    if name not in ARCHS:
        raise KeyError(f"Unknown backbone {name!r}; known: {sorted(ARCHS)}")
    arch = _adapt_vision_depth(cfg, _adapt_vision_resolution(cfg, ARCHS[name], flow))
    logger.info("No CLIP checkpoint found for %s — fresh weights", name)
    visual, text = build_vision_tower(arch), TextTransformer(arch)
    init_weights(visual, generator)
    init_weights(text, generator)
    sd = {f"visual.{k}": v for k, v in visual.state_dict().items()}
    sd.update({f"text.{k}": v for k, v in text.state_dict().items()})
    return arch, sd


def encode_class_names(arch: CLIPArch, clip_sd, class_names, prompt: Optional[str] = None, device=None) -> torch.Tensor:
    """Tokenize prompted class names and run the text tower once, in float32
    whatever TPU.COMPUTE_DTYPE says (as the JAX package does)."""
    template = prompt or "a photo of {}"
    tower = TextTransformer(arch)
    tower.load_state_dict(_sub(clip_sd, "text."))
    tower.to(device).eval()
    toks = torch.from_numpy(tokenize([template.format(n) for n in class_names])).long().to(device)
    with torch.no_grad():
        return tower(toks)


def make_head(cfg, arch: CLIPArch, device: torch.device) -> CLIPFSARHead:
    """The CNN_OTAM_CLIPFSAR head of the config at ``arch``, its weights
    left for the caller to fill: compute dtype, attention path, BatchNorm
    mode and the tower's execution (TPU.REMAT, REMAT_POLICY, FRAME_CHUNKS;
    JAX builder.py:240-252)."""
    # the reference trains the whole model, so RN BatchNorm runs on batch statistics unless BN.FREEZE (JAX builder.py:341-352)
    bn_freeze = bool(cfg.BN.get("FREEZE", False)) if "BN" in cfg else False
    remat, _ = _resolve_tower_execution(cfg, arch)  # TPU.SCAN_LAYERS only shapes XLA's compile: train/loop.py reports it
    remat_policy = str(cfg.TPU.get("REMAT_POLICY", "nothing")) if "TPU" in cfg else "nothing"
    frame_chunks = int(cfg.TPU.get("FRAME_CHUNKS", 1) or 1) if "TPU" in cfg else 1
    if remat and remat_policy == "dots" and frame_chunks > 1 and arch.is_vit:
        # the per-block policy would keep every frame chunk's products from the forward until that chunk's
        # backward, where the JAX package keeps one chunk's: recompute them instead (same numbers)
        logger.info("TPU.REMAT_POLICY dots under TPU.FRAME_CHUNKS %d: the blocks recompute their products too", frame_chunks)
        remat_policy = "nothing"
    return CLIPFSARHead(
        arch, CLIPFSARConfig.from_cfg(cfg), dtype=_dtype_from_cfg(cfg), attention_backend=_attention_backend_from_cfg(cfg, device),
        train_backbone_bn=not bn_freeze, remat=remat, remat_policy=remat_policy, frame_chunks=frame_chunks,
    )


@HEAD_REGISTRY.register(name="CNN_OTAM_CLIPFSAR")
def _build_clipfsar_head(cfg, arch: CLIPArch, device: torch.device, **kw) -> CLIPFSARHead:
    return make_head(cfg, arch, device)


def backbone_weights_path(cfg) -> Optional[str]:
    """A torchvision state dict for a ResNet trunk: TRAIN.BACKBONE_WEIGHTS,
    else the first ``{name}*.pth`` in torch hub's checkpoint cache or
    ./weights (JAX builder.py:316-334)."""
    path = str(cfg.TRAIN.get("BACKBONE_WEIGHTS", "") or "") if "TRAIN" in cfg else ""
    if path:
        return path
    name = cfg.VIDEO.HEAD.BACKBONE_NAME
    for root in (os.path.expanduser("~/.cache/torch/hub/checkpoints"), "./weights"):
        hits = sorted(glob.glob(os.path.join(root, f"{name}*.pth")))
        if hits:
            return hits[0]
    return None


def _assemble_classic_head(cfg, head: nn.Module, g: torch.Generator, clip_sd) -> None:
    """Fresh weights for a classic head from ``g``; then the CLIP visual
    tower where the backbone is a CLIP arch (an RN tower's token projection,
    which no CLIP file holds, stays fresh), or torchvision weights for a
    ResNet trunk where a file is found (JAX builder.py:280-336)."""
    init_weights(head, g)
    if clip_sd is not None:
        missing, unexpected = head.backbone.load_state_dict(_sub(clip_sd, "visual."), strict=False)
        if unexpected or any(not k.startswith("attnpool.c_proj_tokens.") for k in missing):
            raise KeyError(f"the CLIP visual weights do not fit the head's tower: missing {missing}, unexpected {unexpected}")
        return
    path = backbone_weights_path(cfg) if cfg.VIDEO.HEAD.BACKBONE_NAME in RESNET_SPECS else None
    if path and os.path.exists(path):
        load_torchvision_resnet(head.backbone, torch.load(path, map_location="cpu", weights_only=True))
        logger.info("Loaded torchvision %s weights from %s", cfg.VIDEO.HEAD.BACKBONE_NAME, path)


def build_few_shot_model(cfg, generator: Optional[torch.Generator] = None, flow: str = "auto", device=None) -> FewShotModel:
    """The head that VIDEO.HEAD.NAME names on ``device`` (in train mode for
    the "train" flow) plus its text banks, fp32 constants: the text tower is
    not trained.  A head on a torchvision ResNet has no text tower; its
    banks are [1, 1] zeros, as in the JAX package."""
    device = runtime.device(device)
    factory = HEAD_REGISTRY.get(cfg.VIDEO.HEAD.NAME)
    g = generator if generator is not None else torch.Generator().manual_seed(int(cfg.get("RANDOM_SEED", 0)))
    arch = clip_sd = None
    banks = [torch.zeros((1, 1), device=device)] * 2
    if cfg.VIDEO.HEAD.NAME == "CNN_OTAM_CLIPFSAR" or cfg.VIDEO.HEAD.BACKBONE_NAME in ARCHS:
        arch, clip_sd = load_or_init_clip(cfg, g, flow)
        prompt = cfg.TEST.get("PROMPT", None) if "TEST" in cfg else None
        banks = []
        for names in (cfg.TRAIN.get("CLASS_NAME", []) or [], cfg.TEST.get("CLASS_NAME", []) or []):
            names = list(names)
            banks.append(encode_class_names(arch, clip_sd, names, prompt, device) if names else torch.zeros((1, arch.embed_dim), device=device))

    head = factory(cfg, arch=arch, dtype=_dtype_from_cfg(cfg), device=device)
    if isinstance(head, CLIPFSARHead):
        head.backbone.load_state_dict(_sub(clip_sd, "visual."))  # strict: an OpenAI RN file's BN running stats included
        init_weights(head.context2, g)
    else:
        _assemble_classic_head(cfg, head, g, clip_sd)
    head.to(device).train(flow == "train")
    return FewShotModel(head=head, text_train=banks[0], text_test=banks[1])
