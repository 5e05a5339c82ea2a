"""The classic few-shot heads (counterpart of
clip_fsar_tpu/models/heads/fsheads.py, reference models/base/few_shot.py):

  CNN_TSN                  :1533-1572  mean-pool cosine baseline
  CNN_OTAM                 :1405-1444  bidirectional OTAM, lambda 0.1
  CNN_TRX                  :1227-1366  temporal-relational cross-transformers
  CNN_CrossTransformer     :1451-1529  spatial query-aligned prototypes
  CNN_HyRSM_1shot / _5shot :1689-1900  hybrid relation + set matching (Bi-MHM)
  CNN_HyRSM_plusplus_1shot / _5shot / _semi :1902-2390  HyRSM with the
                           temporal-coherence regularizer (and pseudo-labelled
                           unlabeled clips)

Every head takes the whole batch of E episodes ([E, S, T, H, W, 3] normalized
images ...) and runs its trunk ONCE over all E*(S+Q)*T frames (the JAX head is
vmapped over E).  What is per episode stays per episode: the class grouping,
the class means, the relation attention and every mean that makes a loss
term.  The trunk is a torchvision ResNet (``models/resnet.py``) or a CLIP
vision tower on the plain attention path, its BatchNorm (RN towers) on the
running statistics, as the JAX heads build it.

Dropout draws from the generator the train step passes (off without one).
Outputs: ``logits`` [E, Q, WAY] float32, ``class_logits`` [E, rows, C]
float32 or None, and for HyRSM++ ``loss_temporal_regular`` [E].
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clip_fsar_torch.data.types import Episode
from clip_fsar_torch.models.clip.arch import ARCHS, CLIPArch
from clip_fsar_torch.models.clip.model import Dense, LayerNorm, build_vision_tower
from clip_fsar_torch.models.heads.common import (
    HyRSMPositionalEncoding,
    PreNormSelfAttention,
    ResidualMHA,
    class_mean,
    class_sorted_order,
    cos_sim,
    dropout,
    trx_positional_table,
)
from clip_fsar_torch.models.resnet import RESNET_SPECS, TorchResNet
from clip_fsar_torch.ops.otam import otam_distance
from clip_fsar_torch.utils import tracing
from clip_fsar_torch.utils.registry import HEAD_REGISTRY


def make_backbone(name: str, dtype: torch.dtype, arch: Optional[CLIPArch] = None, tokens: bool = False):
    """(module, feature dim) for a backbone name: a torchvision ResNet, or a
    CLIP vision tower (``arch``, by default the named one) on the plain
    attention path; ``tokens`` gives an RN tower the token projection that
    MoLo reads."""
    if name in RESNET_SPECS:
        return TorchResNet(name, dtype=dtype), RESNET_SPECS[name][2]
    if arch is None and name in ARCHS:
        arch = ARCHS[name]
    if arch is None:
        raise KeyError(f"Unknown backbone {name!r}")
    return build_vision_tower(arch, dtype=dtype, tokens=tokens), arch.embed_dim


def _grouped(feats: torch.Tensor, labels: torch.Tensor, way: int) -> torch.Tensor:
    """Class-blocked view [E, WAY, SHOT, ...] in label order (stable) of
    feats [E, N, ...] with labels [E, N]."""
    e, n = labels.shape
    order = class_sorted_order(labels)
    rows = feats[torch.arange(e, device=feats.device)[:, None], order]
    return rows.reshape((e, way, n // way) + feats.shape[2:])


def _normalized(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-12)


class ClassicHead(nn.Module):
    """The trunk and the episode checks the classic heads share."""

    def __init__(self, backbone_name: str, way: int, num_frames: int, dtype: torch.dtype = torch.float32,
                 arch: Optional[CLIPArch] = None, tokens: bool = False):
        super().__init__()
        self.backbone, self.dim = make_backbone(backbone_name, dtype, arch, tokens)
        self.backbone_name, self.way, self.num_frames, self.dtype = backbone_name, way, num_frames, dtype

    def live_batch_norms(self) -> list:
        """The BatchNorms that run on batch statistics in the train branch
        (the train step commits their running stats): none, the trunk runs
        on its running statistics."""
        return []

    def check(self, support_images: torch.Tensor) -> None:
        """Raise when the episodes do not fit the head's WAY and NUM_INPUT_FRAMES."""
        if support_images.shape[1] % self.way:
            raise ValueError(f"episode has {support_images.shape[1]} support clips, not divisible by WAY={self.way}")
        if support_images.shape[2] != self.num_frames:
            raise ValueError(f"episode has {support_images.shape[2]} frames, head expects NUM_INPUT_FRAMES={self.num_frames}")

    def encode(self, *image_sets: torch.Tensor):
        """[E, N_i, T, H, W, 3] each, support first -> float32 features
        [E, N_i, T, D] each, from ONE trunk call over every frame of every set."""
        self.check(image_sets[0])
        images = torch.cat(image_sets, dim=1) if len(image_sets) > 1 else image_sets[0]
        with tracing.span("fsar.tower"):
            feats = self.backbone(images.reshape((-1,) + images.shape[3:])).float().reshape(images.shape[:3] + (-1,))
        return feats.split([s.shape[1] for s in image_sets], dim=1)


class CNNTSNHead(ClassicHead):
    """CNN_TSN: mean frame feature, cosine similarity to every support clip,
    class mean of the similarities (or -||.||^2 to the class prototypes)."""

    def __init__(self, *args, norm_sq_dist: bool = False, **kw):
        super().__init__(*args, **kw)
        self.norm_sq_dist = norm_sq_dist

    def forward(self, ep: Episode, *unused, train: bool = False, generator=None) -> Dict[str, Any]:
        sup, tgt = (f.mean(dim=2) for f in self.encode(ep.support_images, ep.target_images))  # [E, S, D], [E, Q, D]
        if self.norm_sq_dist:
            d = tgt[:, :, None] - class_mean(sup, ep.support_labels, self.way)[:, None]
            logits = -(d * d).sum(dim=-1)
        else:
            logits = class_mean(cos_sim(tgt, sup).transpose(-1, -2), ep.support_labels, self.way).transpose(-1, -2)
        return {"logits": logits, "class_logits": None}


class CNNOTAMHead(ClassicHead):
    """CNN_OTAM: bidirectional OTAM (lambda 0.1) to every support clip, then
    the class mean over support clips."""

    def forward(self, ep: Episode, *unused, train: bool = False, generator=None) -> Dict[str, Any]:
        sup, tgt = self.encode(ep.support_images, ep.target_images)  # [E, S, T, D], [E, Q, T, D]
        (e, s, t, d), q = sup.shape, tgt.shape[1]
        dists = (1.0 - cos_sim(tgt.reshape(e, q * t, d), sup.reshape(e, s * t, d))).reshape(e, q, t, s, t).transpose(2, 3)
        cum = otam_distance(dists, lbda=0.1)  # [E, Q, S]
        return {"logits": -class_mean(cum.transpose(-1, -2), ep.support_labels, self.way).transpose(-1, -2), "class_logits": None}


class TemporalCrossTransformer(nn.Module):
    """One tuple cardinality of TRX (reference :1227-1326): positional
    encoding, frame tuples, key / value projections, attention jointly over
    (support clip of the class x support tuple) per query tuple."""

    def __init__(self, in_dim: int, out_dim: int, num_frames: int, way: int, temporal_set_size: int = 3, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        tuples = list(itertools.combinations(range(num_frames), temporal_set_size))
        self.register_buffer("pe", trx_positional_table(int(num_frames * 1.5), in_dim), persistent=False)
        self.register_buffer("tuples", torch.tensor(tuples, dtype=torch.long), persistent=False)
        self.k_linear = Dense(in_dim * temporal_set_size, out_dim, dtype=dtype)
        self.v_linear = Dense(in_dim * temporal_set_size, out_dim, dtype=dtype)
        self.norm_k = LayerNorm(out_dim)
        self.out_dim, self.way, self.rate = out_dim, way, dropout

    def forward(self, support: torch.Tensor, support_labels: torch.Tensor, queries: torch.Tensor, generator=None) -> torch.Tensor:
        """support [E, S, T, D], queries [E, Q, T, D] -> [E, Q, WAY]."""
        support = dropout(support + self.pe[: support.shape[2]], self.rate, generator)
        queries = dropout(queries + self.pe[: queries.shape[2]], self.rate, generator)
        n_tuples = self.tuples.shape[0]
        s = support[:, :, self.tuples].flatten(3)  # [E, S, n_tuples, size * D]
        q = queries[:, :, self.tuples].flatten(3)
        q_ks, q_vs = self.norm_k(self.k_linear(q).float()), self.v_linear(q).float()
        ks = _grouped(self.norm_k(self.k_linear(s).float()), support_labels, self.way)  # [E, WAY, SHOT, n_tuples, out]
        vs = _grouped(self.v_linear(s).float(), support_labels, self.way)
        e, nq, shot = q.shape[0], q.shape[1], ks.shape[2]
        scores = torch.einsum("eqtd,ewksd->eqwkts", q_ks, ks) / float(np.sqrt(np.float32(self.out_dim)))
        scores = scores.transpose(3, 4).reshape(e, nq, self.way, n_tuples, shot * n_tuples)
        probs = torch.softmax(scores, dim=-1).reshape(e, nq, self.way, n_tuples, shot, n_tuples)
        proto = torch.einsum("eqwtks,ewksd->eqwtd", probs, vs)  # [E, Q, WAY, tuples, out]
        diff = q_vs[:, :, None] - proto
        return -(diff * diff).sum(dim=(-2, -1)) / n_tuples


class CNNTRXHead(ClassicHead):
    """CNN_TRX: the mean of the TemporalCrossTransformer logits over the tuple
    cardinalities (2, 3) (reference :1330-1366)."""

    def __init__(self, *args, temp_set=(2, 3), out_dim: int = 1152, **kw):
        super().__init__(*args, **kw)
        for s in temp_set:
            self.add_module(f"trx_{s}", TemporalCrossTransformer(self.dim, out_dim, self.num_frames, self.way, s, dtype=self.dtype))
        self.temp_set = tuple(temp_set)

    def forward(self, ep: Episode, *unused, train: bool = False, generator=None) -> Dict[str, Any]:
        sup, tgt = self.encode(ep.support_images, ep.target_images)
        g = generator if train else None
        logits = [getattr(self, f"trx_{s}")(sup, ep.support_labels, tgt, g) for s in self.temp_set]
        return {"logits": torch.stack(logits, dim=-1).mean(dim=-1), "class_logits": None}


class CNNCrossTransformerHead(ClassicHead):
    """CNN_CrossTransformer: query-aligned prototypes over the (frame x shot)
    support tokens, one projection for keys and queries (reference
    :1451-1529)."""

    def __init__(self, *args, shot: int = 1, hidden_dim: int = 1024, **kw):
        super().__init__(*args, **kw)
        self.key_head = Dense(self.dim, hidden_dim, bias=False, dtype=self.dtype)
        self.value_head = Dense(self.dim, hidden_dim, bias=False, dtype=self.dtype)
        self.shot, self.hidden_dim = shot, hidden_dim

    def forward(self, ep: Episode, *unused, train: bool = False, generator=None) -> Dict[str, Any]:
        sup, tgt = self.encode(ep.support_images, ep.target_images)
        e, t, h = sup.shape[0], self.num_frames, self.hidden_dim
        sup = _grouped(sup, ep.support_labels, self.way)  # [E, WAY, SHOT, T, D]
        # frame-major (t * shot + j) token order, the reference's permute(0, 2, 3, 1).view(way, hidden, T * shot)
        sup_k = self.key_head(sup).float().transpose(2, 3).reshape(e, self.way, t * self.shot, h)
        sup_v = self.value_head(sup).float().transpose(2, 3).reshape(e, self.way, t * self.shot, h)
        attn = torch.softmax(torch.einsum("eqtd,ewvd->eqwtv", self.key_head(tgt).float(), sup_k) * (h**-0.5), dim=-1)
        proto = torch.einsum("eqwtv,ewvd->eqwtd", attn, sup_v)
        logits = torch.einsum("eqwtd,eqtd->eqw", _normalized(proto), _normalized(self.value_head(tgt).float())) / 8.0  # the reference's 8
        return {"logits": logits, "class_logits": None}


class HyRSMFeatures(nn.Module):
    """Shared HyRSM machinery: sinusoidal positional encoding -> pre-norm
    temporal self-attention -> ReLU; per-frame class logits; the
    cross-video relation attention; the 1x1 fuse of the doubled width."""

    def __init__(self, dim: int, num_frames: int, num_class: int = 64, heads: int = 8, dtype: torch.dtype = torch.float32,
                 position_a: float = 10.0, position_b: float = 1.0):
        super().__init__()
        self.temporal_atte_before = PreNormSelfAttention(dim, heads=heads, dim_head=dim // heads, dropout=0.2, dtype=dtype)
        self.temporal_atte = ResidualMHA(heads, dim, dim // heads, dim // heads, dropout=0.05, dtype=dtype)
        self.layer2 = Dense(2 * dim, dim, dtype=dtype)  # conv1d k=1 == dense
        self.classification_layer = Dense(dim, num_class, dtype=dtype)
        self.pe = HyRSMPositionalEncoding(dim, position_a, position_b)
        self.num_frames, self.num_class = num_frames, num_class

    def temporal(self, feats: torch.Tensor, generator, use_pe: bool = True) -> torch.Tensor:
        """[E, N, T, D] -> ReLU(pre-norm self-attention over T), per clip."""
        x = feats.flatten(0, 1)
        x = self.pe(x, generator) if use_pe else x
        return F.relu(self.temporal_atte_before(x, generator)).reshape(feats.shape[:2] + x.shape[1:])

    def class_logits(self, sup: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        """[E, S, T, D], [E, Q, T, D] -> per-frame class logits [E, (S+Q)*T, C]."""
        e = sup.shape[0]
        return self.classification_layer(torch.cat([sup, tgt], dim=1)).float().reshape(e, -1, self.num_class)

    def relate(self, support: torch.Tensor, target: torch.Tensor, generator):
        """support [E, S, T, D], target [E, Q, T, D] -> the query-conditioned
        support [E, Q, S, T, D] and the fused target [E, Q, T, D]."""
        (e, s, t, d), q = support.shape, target.shape[1]
        sup_ext = support[:, None].expand(e, q, s, t, d)
        feature_in = torch.cat([sup_ext.mean(dim=3), target[:, :, None].mean(dim=3)], dim=2).reshape(e * q, s + 1, d)
        feature_in = F.relu(self.temporal_atte(feature_in, feature_in, feature_in, generator)).to(support.dtype).reshape(e, q, s + 1, d)
        sup_fused = self.layer2(torch.cat([sup_ext, feature_in[:, :, :-1, None, :].expand(e, q, s, t, d)], dim=4))
        tgt_fused = self.layer2(torch.cat([target, feature_in[:, :, -1:, :].expand(e, q, t, d)], dim=3))
        return sup_fused.float(), tgt_fused.float()


def bi_mhm(sup: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Set-matching metric (reference :1770-1776): bidirectional min-pooled
    cosine distance.  sup [E, Q, S, T, D], tgt [E, Q, T, D] -> [E, Q, S]."""
    dists = 1.0 - torch.einsum("eqstd,equd->eqstu", _normalized(sup), _normalized(tgt))  # [E, Q, S, Ts, Tq]
    return dists.amin(dim=4).sum(dim=3) + dists.amin(dim=3).sum(dim=3)


class CNNHyRSMHead(ClassicHead):
    """CNN_HyRSM_{1,5}shot: ``five_shot`` averages the class prototypes
    before the relation step (reference :1790-1900)."""

    def __init__(self, *args, five_shot: bool = False, num_class: int = 64, heads: int = 8, position_a: float = 10.0,
                 position_b: float = 1.0, **kw):
        super().__init__(*args, **kw)
        self.features = HyRSMFeatures(self.dim, self.num_frames, num_class, heads, self.dtype, position_a, position_b)
        self.five_shot = five_shot

    def _temporal(self, sup, tgt, generator, use_pe: bool = True):
        """Both sets through the temporal attention in one call (per clip)."""
        both = self.features.temporal(torch.cat([sup, tgt], dim=1), generator, use_pe)
        return both[:, : sup.shape[1]], both[:, sup.shape[1]:]

    def _distances(self, sup, tgt, labels, generator):
        """(class distances [E, Q, WAY], fused support, fused target)."""
        if self.five_shot:
            sup = class_mean(sup, labels, self.way)  # [E, WAY, T, D]
        sup_fused, tgt_fused = self.features.relate(sup, tgt, generator)
        cum = bi_mhm(sup_fused, tgt_fused)  # [E, Q, S or WAY]
        dists = cum if self.five_shot else class_mean(cum.transpose(-1, -2), labels, self.way).transpose(-1, -2)
        return dists, sup_fused, tgt_fused

    def forward(self, ep: Episode, *unused, train: bool = False, generator=None) -> Dict[str, Any]:
        g = generator if train else None
        sup, tgt = self._temporal(*self.encode(ep.support_images, ep.target_images), g)
        class_logits = self.features.class_logits(sup, tgt)
        dists, _, _ = self._distances(sup, tgt, ep.support_labels, g)
        return {"logits": -dists, "class_logits": class_logits}


def temporal_regular_masks(t: int, window_size: int, temporal_balance: float):
    """HyRSM++ temporal-coherence masks (reference :1939-1956): inside the
    window weight 1/((i-j)^2+1) and label 1; outside weight
    1-exp(-(|i-j|-w)^2/balance) and label 0."""
    reg = np.zeros((t, t), dtype=np.float32)
    lab = np.zeros((t, t), dtype=np.float32)
    for i in range(t):
        for j in range(t):
            d = abs(i - j)
            if d <= window_size:
                reg[i, j] = 1.0 / ((i - j) ** 2 + 1.0)
                lab[i, j] = 1.0
            else:
                reg[i, j] = 1.0 - np.exp(-((d - window_size) ** 2) / temporal_balance)
    return torch.from_numpy(reg), torch.from_numpy(lab)


class CNNHyRSMPlusPlusHead(CNNHyRSMHead):
    """CNN_HyRSM_plusplus_{1,5}shot (reference :1902-2190): HyRSM plus the
    temporal-coherence regularizer over each fused clip's frame distances
    (``loss_temporal_regular``, one value per episode)."""

    def __init__(self, *args, window_size: int = 3, temporal_balance: float = 1.0, balance_coefficient: float = 1.0,
                 use_classification: bool = True, use_pe: bool = True, **kw):
        super().__init__(*args, **kw)
        reg, lab = temporal_regular_masks(self.num_frames, window_size, temporal_balance)
        self.register_buffer("reg", reg, persistent=False)
        self.register_buffer("lab", lab, persistent=False)
        self.window_size, self.temporal_balance, self.balance_coefficient = window_size, temporal_balance, balance_coefficient
        self.use_classification, self.use_pe = use_classification, use_pe

    def intra(self, feats: torch.Tensor) -> torch.Tensor:
        """[E, ..., T, D] -> the mean regularized intra-clip distance per episode [E]."""
        fn = _normalized(feats)
        d = 1.0 - torch.matmul(fn, fn.transpose(-1, -2))
        v = d * self.lab * self.reg + self.balance_coefficient * (1.0 - self.lab) * F.relu(self.reg - d)
        return v.reshape(v.shape[0], -1).mean(dim=1)

    def forward(self, ep: Episode, *unused, train: bool = False, generator=None) -> Dict[str, Any]:
        g = generator if train else None
        sup, tgt = self._temporal(*self.encode(ep.support_images, ep.target_images), g, self.use_pe)
        class_logits = self.features.class_logits(sup, tgt) if self.use_classification else None
        dists, sup_fused, tgt_fused = self._distances(sup, tgt, ep.support_labels, g)
        return {"logits": -dists, "class_logits": class_logits, "loss_temporal_regular": self.intra(sup_fused) + self.intra(tgt_fused)}


class CNNHyRSMPlusPlusSemiHead(CNNHyRSMPlusPlusHead):
    """CNN_HyRSM_plusplus_semi (reference few_shot.py:2193-2390): HyRSM++ on
    class prototypes, which the episode's unlabeled clips (``unlabeled_images``
    [E, U, T, H, W, 3], optional) extend where their pseudo-label is
    confident: each accepted clip joins its pseudo-class's mean with weight 1,
    the JAX package's static-shape form of the reference's concat.  The
    pseudo-label logits carry no gradient; the accepted clips' features do."""

    def __init__(self, *args, semi_temporal: float = 1.0, semi_threshold: float = 0.8, **kw):
        super().__init__(*args, five_shot=True, **kw)
        self.semi_temporal, self.semi_threshold = semi_temporal, semi_threshold

    def forward(self, ep: Episode, *unused, train: bool = False, generator=None) -> Dict[str, Any]:
        g = generator if train else None
        sets = [ep.support_images, ep.target_images] + ([] if ep.unlabeled_images is None else [ep.unlabeled_images])
        feats = self.encode(*sets)
        both = self.features.temporal(torch.cat(feats, dim=1), g, self.use_pe).split([f.shape[1] for f in feats], dim=1)
        sup, tgt = both[0], both[1]
        class_logits = self.features.class_logits(sup, tgt) if self.use_classification else None

        onehot_s = (ep.support_labels[..., None] == torch.arange(self.way, device=sup.device)).float()  # [E, S, WAY]
        counts = onehot_s.sum(dim=1)  # [E, WAY]
        proto_sum = torch.einsum("esc,estd->ectd", onehot_s, sup)
        if ep.unlabeled_images is not None:
            unl = both[2]
            sup_fused_u, unl_fused = self.features.relate(proto_sum / counts[..., None, None], unl, g)
            pseudo = torch.softmax(-bi_mhm(sup_fused_u, unl_fused).detach() / self.semi_temporal, dim=-1)  # [E, U, WAY]
            conf, pick = pseudo.max(dim=-1)
            onehot_u = F.one_hot(pick, self.way).float() * (conf >= self.semi_threshold).float()[..., None]
            counts = counts + onehot_u.sum(dim=1)
            proto_sum = proto_sum + torch.einsum("euc,eutd->ectd", onehot_u, unl)
        sup_fused, tgt_fused = self.features.relate(proto_sum / counts[..., None, None], tgt, g)
        dists = bi_mhm(sup_fused, tgt_fused)  # [E, Q, WAY]
        return {"logits": -dists, "class_logits": class_logits, "loss_temporal_regular": self.intra(sup_fused) + self.intra(tgt_fused)}


# ---------------------------------------------------------------------------
# registry factories, the JAX package's config gates (fsheads.py:533-619)
# ---------------------------------------------------------------------------


def _common(cfg, arch=None, dtype=torch.float32) -> dict:
    return dict(backbone_name=cfg.VIDEO.HEAD.BACKBONE_NAME, way=int(cfg.TRAIN.WAY), num_frames=int(cfg.DATA.NUM_INPUT_FRAMES),
                dtype=dtype, arch=arch)


def _hyrsm_kw(cfg) -> dict:
    """POSITION_A / B are hasattr-gated (an explicit 0.0 holds,
    few_shot.py:1705-1706); TRAIN.HEAD is truthiness-gated (0 falls back,
    :1709); NUM_CLASS is hasattr-gated (:1718)."""
    t = cfg.TRAIN
    return dict(num_class=int(t.get("NUM_CLASS", 64)), heads=int(t.get("HEAD", 8) or 8),
                position_a=float(t.get("POSITION_A", 10.0)), position_b=float(t.get("POSITION_B", 1.0)))


def _hyrsm_pp_kw(cfg) -> dict:
    """WINDOW_SIZE / TEMPORAL_BALANCE are read as they are (an explicit 0
    holds, few_shot.py:1943-1946); BALANCE_COEFFICIENT is truthiness-gated
    (:2024).  The positional encoding (:1918-1923): on with the given scales
    when POSITION_A and POSITION_B are both set (NO_POSITION ignored), else
    off when NO_POSITION is present at all, else on."""
    t = cfg.TRAIN
    return dict(
        **_hyrsm_kw(cfg),
        window_size=int(t.get("WINDOW_SIZE", 3)),
        temporal_balance=float(t.get("TEMPORAL_BALANCE", 1.0)),
        balance_coefficient=float(t.get("BALANCE_COEFFICIENT", 1.0) or 1.0),
        use_classification=bool(t.get("USE_CLASSIFICATION", False)),
        use_pe=("POSITION_A" in t and "POSITION_B" in t) or ("NO_POSITION" not in t),
    )


@HEAD_REGISTRY.register(name="CNN_TSN")
def build_tsn(cfg, arch=None, dtype=torch.float32, **kw):
    return CNNTSNHead(**_common(cfg, arch, dtype))


@HEAD_REGISTRY.register(name="CNN_OTAM")
def build_otam(cfg, arch=None, dtype=torch.float32, **kw):
    return CNNOTAMHead(**_common(cfg, arch, dtype))


@HEAD_REGISTRY.register(name="CNN_TRX")
def build_trx(cfg, arch=None, dtype=torch.float32, **kw):
    return CNNTRXHead(**_common(cfg, arch, dtype))


@HEAD_REGISTRY.register(name="CNN_CrossTransformer")
def build_cross_transformer(cfg, arch=None, dtype=torch.float32, **kw):
    return CNNCrossTransformerHead(**_common(cfg, arch, dtype), shot=int(cfg.TRAIN.SHOT))


@HEAD_REGISTRY.register(name="CNN_HyRSM_1shot")
def build_hyrsm_1shot(cfg, arch=None, dtype=torch.float32, **kw):
    return CNNHyRSMHead(**_common(cfg, arch, dtype), five_shot=False, **_hyrsm_kw(cfg))


@HEAD_REGISTRY.register(name="CNN_HyRSM_5shot")
def build_hyrsm_5shot(cfg, arch=None, dtype=torch.float32, **kw):
    return CNNHyRSMHead(**_common(cfg, arch, dtype), five_shot=True, **_hyrsm_kw(cfg))


@HEAD_REGISTRY.register(name="CNN_HyRSM_plusplus_1shot")
def build_hyrsm_pp_1shot(cfg, arch=None, dtype=torch.float32, **kw):
    return CNNHyRSMPlusPlusHead(**_common(cfg, arch, dtype), five_shot=False, **_hyrsm_pp_kw(cfg))


@HEAD_REGISTRY.register(name="CNN_HyRSM_plusplus_5shot")
def build_hyrsm_pp_5shot(cfg, arch=None, dtype=torch.float32, **kw):
    return CNNHyRSMPlusPlusHead(**_common(cfg, arch, dtype), five_shot=True, **_hyrsm_pp_kw(cfg))


@HEAD_REGISTRY.register(name="CNN_HyRSM_plusplus_semi")
def build_hyrsm_pp_semi(cfg, arch=None, dtype=torch.float32, **kw):
    t = cfg.TRAIN
    # the semi head makes class logits whatever USE_CLASSIFICATION says (reference few_shot.py:2275-2278)
    return CNNHyRSMPlusPlusSemiHead(
        **_common(cfg, arch, dtype), **{**_hyrsm_pp_kw(cfg), "use_classification": True},
        semi_temporal=float(t.get("SEMI_TEMPORAL", 1.0) or 1.0), semi_threshold=float(t.get("SEMI_THRESHOLD", 0.8) or 0.8),
    )
