"""Operations and bytes from shapes: the arithmetic that ``portbench/counts/<config>.py`` uses.

Model FLOPs count the products (linear layers, convolutions, the attention's two products,
the head's similarities) at 2 operations a multiply-add.  A train step counts the forward,
and the backward of what trains: twice the forward's products, less the input gradient of
the first layer, which nothing needs.  Nothing recomputed is counted.
"""

from __future__ import annotations

from typing import Sequence


def vit_forward(width: int, layers: int, heads: int, patch: int, resolution: int, out: int) -> dict:
    """FLOPs of one frame through a CLIP ViT: {"total", "first"} (first: the patch product)."""
    tokens = (resolution // patch) ** 2 + 1
    first = 2 * (tokens - 1) * (3 * patch * patch) * width
    per_layer = 2 * tokens * width * (3 * width + width + 8 * width)  # q|k|v, out, the 4x MLP both ways
    per_layer += 2 * 2 * tokens * tokens * width  # q k^T and p v over all heads
    total = first + layers * per_layer + 2 * width * out
    return {"total": float(total), "first": float(first)}


def resnet_forward(layers: Sequence[int], width: int, resolution: int, out: int, heads: int) -> dict:
    """FLOPs of one frame through CLIP's ModifiedResNet: {"total", "first"} (first: the stem's first conv)."""
    flops = 0.0
    r = resolution // 2
    half = width // 2
    first = 2.0 * r * r * half * 3 * 9
    flops += first + 2.0 * r * r * half * half * 9 + 2.0 * r * r * width * half * 9
    r //= 2  # the stem's average pool
    inplanes = width
    for stage, (blocks, planes) in enumerate(zip(layers, (width, width * 2, width * 4, width * 8))):
        for i in range(blocks):
            stride = 2 if (stage > 0 and i == 0) else 1
            outp = planes * 4
            flops += 2.0 * r * r * inplanes * planes  # 1x1 at the input size
            flops += 2.0 * r * r * planes * planes * 9  # 3x3, then the pool if strided
            r2 = r // stride
            flops += 2.0 * r2 * r2 * planes * outp  # 1x1 after the pool
            if stride > 1 or inplanes != outp:
                flops += 2.0 * r2 * r2 * inplanes * outp
            inplanes, r = outp, r2
    c = width * 32
    tokens = r * r + 1
    flops += 2.0 * c * c * (1 + 2 * tokens)  # q of the mean token, k and v of every token
    flops += 2.0 * 2 * tokens * c  # one query's products over all heads
    flops += 2.0 * c * out
    return {"total": flops, "first": first}


def tv_resnet_forward(layers: Sequence[int], bottleneck: bool, resolution: int) -> dict:
    """FLOPs of one frame through a torchvision ResNet trunk (``reference/tv_resnet.py``: basic
    blocks for resnet18 / 34, v1.5 bottlenecks for resnet50), pooled: {"total", "first"} (first:
    the stem's 7x7 conv).  Every stride-2 step gives ceil(r / 2) rows, as the padded convs and pool do."""
    half = lambda r: -(-r // 2)  # noqa: E731
    r = half(resolution)
    first = 2.0 * r * r * 64 * 3 * 49
    flops = first
    r = half(r)  # the max pool
    inplanes = 64
    expansion = 4 if bottleneck else 1
    for stage, (blocks, planes) in enumerate(zip(layers, (64, 128, 256, 512))):
        for i in range(blocks):
            stride = 2 if (stage > 0 and i == 0) else 1
            r2 = half(r) if stride > 1 else r
            outp = planes * expansion
            if bottleneck:
                flops += 2.0 * r * r * inplanes * planes + 2.0 * r2 * r2 * planes * planes * 9 + 2.0 * r2 * r2 * planes * outp
            else:
                flops += 2.0 * r2 * r2 * inplanes * planes * 9 + 2.0 * r2 * r2 * planes * planes * 9
            if stride > 1 or inplanes != outp:
                flops += 2.0 * r2 * r2 * inplanes * outp
            inplanes, r = outp, r2
    return {"total": flops, "first": first}


def clipfsar_head(dim: int, way: int, shot_clips: int, query_clips: int, frames: int, classes: int, mlp: int = 2048) -> float:
    """FLOPs of one episode through the CLIP-FSAR head after the tower."""
    def modulate(seqs: int, n: int) -> float:
        proj = 2.0 * seqs * n * dim * (4 * dim + 2 * mlp)
        return proj + 2.0 * 2 * seqs * n * n * dim
    flops = modulate(query_clips, frames) + modulate(shot_clips, frames + 1)
    flops += 2.0 * (shot_clips + query_clips) * classes * dim  # video-text class logits
    flops += 2.0 * query_clips * frames * way * frames * dim  # frame distances to the prototypes
    return flops


def attention_bound(frames: int, tokens: int, heads: int, head_dim: int, tensors_in: float, tensors_out: float, rows_fp32: int,
                    products: int) -> tuple:
    """(bytes, operations) of an attention kernel on bf16 [frames, tokens, heads * head_dim] tensors:
    ``tensors_in`` read and ``tensors_out`` written in units of one such tensor, ``rows_fp32``
    [frames, heads, tokens] fp32 vectors moved, ``products`` [tokens x tokens x head_dim] products
    a head (chip_smoke.py's bound arithmetic)."""
    bytes_moved = (tensors_in + tensors_out) * frames * tokens * heads * head_dim * 2 + rows_fp32 * frames * heads * tokens * 4
    return float(bytes_moved), float(products * 2 * frames * heads * tokens * tokens * head_dim)


def episode_shapes(cfg: dict, kind: str) -> dict:
    """Clips and frames of one episode of a ``kind`` ("train" or "test") step of the configuration."""
    t = cfg["TRAIN"]
    way, shot = int(t["WAY"]), int(t["SHOT"] if kind == "train" else t.get("SHOT_TEST") or t["SHOT"])
    query = int(t["QUERY_PER_CLASS"] if kind == "train" else t.get("QUERY_PER_CLASS_TEST", 1))
    classes = len(t["CLASS_NAME"] if kind == "train" else cfg["TEST"]["CLASS_NAME"])
    return {"way": way, "support": way * shot, "query": way * query, "frames": int(cfg["DATA"]["NUM_INPUT_FRAMES"]),
            "classes": classes}


def step_flops(cfg: dict, kind: str, episodes: int, tower: dict, dim: int) -> float:
    """Model FLOPs of one step of ``episodes`` episodes: forward, and for "train" the backward."""
    s = episode_shapes(cfg, kind)
    frames = episodes * (s["support"] + s["query"]) * s["frames"]
    head = episodes * clipfsar_head(dim, s["way"], s["support"], s["query"], s["frames"], len(cfg["TRAIN"]["CLASS_NAME"]))
    forward = frames * tower["total"] + head
    if kind == "test":
        return forward
    return 3.0 * forward - 2.0 * frames * tower["first"]
