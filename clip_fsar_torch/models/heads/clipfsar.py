"""CLIP-FSAR head: CLIP visual features + text-prototype modulation + OTAM
(counterpart of clip_fsar_tpu/models/heads/clipfsar.py:37-261).

The head takes a batch of E episodes and runs the CLIP tower ONCE over all
E*(S+Q)*T frames — the JAX head is vmapped over E, which XLA turns into the
same single batched tower call.  Everything after the tower keeps the
leading E axis.  The one exception is an RN tower in the train branch with
live BatchNorm (``train_backbone_bn``, BN.FREEZE off): as in the JAX head
(clipfsar.py:126-156,192-199) support and target are encoded in two calls,
support first, each over the E episodes with per-episode batch statistics.

``frame_chunks`` c > 1 (TPU.FRAME_CHUNKS, ViT towers only, as in the JAX
head, clipfsar.py:135-155) runs the tower call's frames in c sequential
parts, each under a checkpoint of its own while autograd records (around the
blocks' own when ``remat`` is on), so only one part's layer boundaries are
alive at a time; the backward recomputes each part's tower forward once more.
The JAX head tests (S+Q)*T % c per episode inside its vmap over E; the test
here is the same, and each part then holds E*(S+Q)*T/c frames, the live size
of the JAX scan.  Frames are independent, so the features are those of one
call.

Eval variants (gated by cfg.TRAIN keys, as in the reference): plain OTAM,
``EVAL_TEXT`` (zero-shot text matching), ``COMBINE`` (text^a *
visual_softmax^(1-a) fusion), ``MERGE_BEFORE`` (class-mean before
modulation), ``SINGLE_DIRECT`` (one-directional OTAM).  The train branch modulates the
prototypes with the train text bank, makes the class logits only under
``USE_CLASSIFICATION``, and runs the prototype-modulation transformer's
dropout from the generator it is given.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from clip_fsar_torch.data.types import Episode
from clip_fsar_torch.models.clip.arch import CLIPArch
from clip_fsar_torch.models.clip.model import BatchNorm, build_vision_tower, rematerialized
from clip_fsar_torch.models.heads.common import TransformerV1, class_mean, cos_sim
from clip_fsar_torch.ops.otam import otam_distance


@dataclasses.dataclass(frozen=True)
class CLIPFSARConfig:
    """Static head hyperparameters extracted from the YAML config (copy of
    the JAX CLIPFSARConfig, whose module imports flax)."""

    way: int = 5
    num_frames: int = 8
    transformer_depth: int = 1
    use_classification: bool = True
    merge_before: bool = False
    combine: bool = False
    eval_text: bool = False
    single_direct: bool = False
    text_coff: Optional[float] = None  # None -> 0.9 (reference default)

    @classmethod
    def from_cfg(cls, cfg) -> "CLIPFSARConfig":
        t = cfg.TRAIN
        depth = t.get("TRANSFORMER_DEPTH", None)
        return cls(
            way=int(t.WAY),
            num_frames=int(cfg.DATA.NUM_INPUT_FRAMES),
            transformer_depth=int(depth) if depth else 1,
            use_classification=bool(t.get("USE_CLASSIFICATION", False)),
            merge_before=bool(t.get("MERGE_BEFORE", False)),
            combine=bool(t.get("COMBINE", False)),
            eval_text=bool(t.get("EVAL_TEXT", False)),
            single_direct=bool(t.get("SINGLE_DIRECT", False)),
            # reference gate `hasattr(...) and cfg.TRAIN.TEXT_COFF`: an
            # explicit 0.0 falls back to 0.9 there too
            text_coff=t.get("TEXT_COFF", None) or None,
        )


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True)


class CLIPFSARHead(nn.Module):
    def __init__(
        self, arch: CLIPArch, head_cfg: CLIPFSARConfig, dtype: torch.dtype = torch.float32, attention_backend: str = "plain",
        train_backbone_bn: bool = False, remat: bool = False, remat_policy: str = "nothing", frame_chunks: int = 1,
    ):
        super().__init__()
        self.arch = arch
        self.head_cfg = head_cfg
        # ViT, or ModifiedResNet for RN* (which ignores the remat options)
        self.backbone = build_vision_tower(arch, dtype=dtype, attention_backend=attention_backend, remat=remat, remat_policy=remat_policy)
        self.frame_chunks = frame_chunks
        self.train_backbone_bn = train_backbone_bn  # RN towers: BatchNorm on batch statistics in the train branch
        mid = arch.embed_dim  # 1024 for RN50, 512 for ViT-B/16 (few_shot.py:2699-2713)
        self.context2 = TransformerV1(
            mid, heads=8, dim_head_k=mid // 8, dropout_atte=0.2, depth=head_cfg.transformer_depth, dtype=dtype
        )
        self.scale = nn.Parameter(torch.ones(1, dtype=torch.float32))

    def live_batch_norms(self) -> list:
        """The BatchNorms that run on batch statistics in the train branch: an
        RN tower's, unless BN.FREEZE."""
        live = self.train_backbone_bn and not self.arch.is_vit
        return [m for m in self.backbone.modules() if isinstance(m, BatchNorm)] if live else []

    def _encode(self, images: torch.Tensor, bn_groups: Optional[int] = None) -> torch.Tensor:
        """[E, N, T, H, W, 3] -> float32 features [E, N, T, D] in one tower
        call, or in ``frame_chunks`` sequential parts of it."""
        flat = images.reshape((-1,) + images.shape[3:])
        c = self.frame_chunks
        if not self.arch.is_vit:
            feats = self.backbone(flat, bn_groups)
        elif c > 1 and (images.shape[1] * images.shape[2]) % c == 0:
            feats = torch.cat([rematerialized(self.backbone, part) for part in flat.chunk(c)])
        else:
            feats = self.backbone(flat)
        return feats.float().reshape(images.shape[:3] + (-1,))

    def _text_logits(self, text_bank, ep: Episode, image_features: torch.Tensor) -> torch.Tensor:
        """softmax(scale * <image, class-mean support text>) over the way
        axis (EVAL_TEXT and COMBINE's text term)."""
        text_feats = class_mean(text_bank[ep.real_support_labels], ep.support_labels, self.head_cfg.way)
        logits = torch.matmul(self.scale * _normalize(image_features), _normalize(text_feats).transpose(-1, -2))
        return torch.softmax(logits, dim=-1)

    def forward(
        self, ep: Episode, text_train: torch.Tensor, text_test: Optional[torch.Tensor] = None, train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, Any]:
        """ep: E episodes ([E, S, T, H, W, 3] normalized float images ...).
        Returns {"logits": [E, Q, WAY], "class_logits": [E, S+Q, C_train] | None}.
        ``generator`` drives the train branch's dropout (off when None)."""
        hc = self.head_cfg
        way, t = hc.way, hc.num_frames
        e, s_clips = ep.support_images.shape[:2]
        if s_clips % way:
            raise ValueError(f"episode has {s_clips} support clips, not divisible by WAY={way} — episode/head config mismatch")
        if ep.support_images.shape[2] != t:
            raise ValueError(f"episode has {ep.support_images.shape[2]} frames, head expects NUM_INPUT_FRAMES={t}")
        text_eval = text_test if text_test is not None else text_train

        if train and self.train_backbone_bn and not self.arch.is_vit:
            # live BatchNorm: the support call, then the target call, each episode on its own statistics
            support_features, target_features = self._encode(ep.support_images, e), self._encode(ep.target_images, e)
        else:  # one tower call over every frame of the step, BatchNorm (if any) on its running stats
            feats = self._encode(torch.cat([ep.support_images, ep.target_images], dim=1))  # [E, S+Q, T, D]
            support_features, target_features = feats[:, :s_clips], feats[:, s_clips:]
        nq = target_features.shape[1]

        if not train and hc.eval_text:  # zero-shot: mean target feature vs class-mean support text
            return {"logits": self._text_logits(text_eval, ep, target_features.mean(dim=2)), "class_logits": None}

        # video-text classification logits: always in eval, under USE_CLASSIFICATION in train
        class_logits = None
        if not train or hc.use_classification:
            all_feats = torch.cat([support_features, target_features], dim=1).mean(dim=2)
            class_logits = cos_sim(all_feats, text_train) * self.scale

        # prototype modulation (few_shot.py:2791-2811)
        bank = text_train if train else text_eval
        context_support = bank[ep.real_support_labels][:, :, None, :].float()  # [E, S, 1, D]
        raw_target_mean = target_features.mean(dim=2)  # COMBINE's text term uses pre-modulation features
        flat_t = target_features.reshape(e * nq, t, -1)
        target_features = self.context2(flat_t, flat_t, flat_t, generator).reshape(e, nq, t, -1)

        support_feats = support_features
        if hc.merge_before:
            support_feats = class_mean(support_feats, ep.support_labels, way)
            context_support = class_mean(context_support, ep.support_labels, way)
        merged = torch.cat([support_feats, context_support], dim=2)  # [E, n, T+1, D]
        flat_m = merged.reshape((-1,) + merged.shape[2:])
        support_feats = self.context2(flat_m, flat_m, flat_m, generator)[:, :t].reshape(merged.shape[:2] + (t, -1))
        if not hc.merge_before:
            support_feats = class_mean(support_feats, ep.support_labels, way)
        # prototypes are ordered by class id 0..WAY-1

        # OTAM frame-alignment distance (few_shot.py:2813-2832)
        frame_dists = 1.0 - cos_sim(target_features.reshape(e, nq * t, -1), support_feats.reshape(e, way * t, -1))
        dists = frame_dists.reshape(e, nq, t, way, t).transpose(2, 3)  # [E, Q, WAY, Tq, Ts]
        cum_dists = otam_distance(dists, single_direction=hc.single_direct)  # [E, Q, WAY]

        if not train and hc.combine:
            # text-visual fusion (few_shot.py:2924-2928); 8.0 is the
            # reference's hard-coded constant, not NUM_INPUT_FRAMES
            text_probs = self._text_logits(text_eval, ep, raw_target_mean)
            soft_visual = torch.softmax((8.0 - cum_dists) / 8.0, dim=-1)
            a = hc.text_coff if hc.text_coff is not None else 0.9
            return {"logits": torch.pow(text_probs, a) * torch.pow(soft_visual, 1.0 - a), "class_logits": None}
        return {"logits": -cum_dists, "class_logits": class_logits}
