"""Operations and bytes of the clipfsar_vitb16 cells: CLIP ViT-B/16 (width 768, 12 layers, 12 heads
of 64, patch 16 at 224 px: N = 197 tokens, output 512) under the CLIP-FSAR head."""

from __future__ import annotations

from portbench import flops

WIDTH, LAYERS, HEADS, PATCH, RES, OUT = 768, 12, 12, 16, 224, 512
TOKENS = (RES // PATCH) ** 2 + 1


def model_flops(cfg: dict, kind: str, episodes: int) -> float:
    """Model FLOPs of one step."""
    return flops.step_flops(cfg, kind, episodes, flops.vit_forward(WIDTH, LAYERS, HEADS, PATCH, RES, OUT), OUT)


def attention_work(cfg: dict, kind: str, episodes: int) -> list:
    """(bytes, operations) of every attention kernel launch of one step: K1 (clip_mha) on each
    tower call's frames at every layer, and in a train step K2 (clip_mha_bwd) on the same shapes.
    A train step runs one tower call per episode chunk (TPU.EPISODE_CHUNKS)."""
    s = flops.episode_shapes(cfg, kind)
    chunks = int(cfg["TPU"].get("EPISODE_CHUNKS", 1)) if kind == "train" else 1
    frames = episodes // chunks * (s["support"] + s["query"]) * s["frames"]
    fwd = flops.attention_bound(frames, TOKENS, HEADS, WIDTH // HEADS, tensors_in=3, tensors_out=1, rows_fp32=1, products=2)
    launches = [fwd] * (LAYERS * chunks)
    if kind == "train":  # q, k, v, o, do and the lse in; dq, dk, dv out; five products
        bwd = flops.attention_bound(frames, TOKENS, HEADS, WIDTH // HEADS, tensors_in=5, tensors_out=3, rows_fp32=1, products=5)
        launches += [bwd] * (LAYERS * chunks)
    return launches
