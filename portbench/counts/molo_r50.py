"""Operations of the molo_r50 cells: a torchvision ResNet-50 ((3, 4, 6, 3) bottlenecks, D = 2048, the
last map 7 x 7 at 224 px) under the MoLo head: the motion Conv3d to D/8, its 3x3 conv and 1x1
up-projection, the decoder (three bilinear upsamplings as products with fixed matrices, three 3x3
convolutions, a 1x1 to RGB; train steps only, as the port runs it), two TransformerV2 streams of
8 heads and MLP 2048, the Bi-MHM and contrastive similarities and the class logits.  Of the port's
kernels the step runs the BatchNorm's; no attention kernel."""

from __future__ import annotations

from portbench import flops

LAYERS, DIM, MOTION, DECODER, MLP, CLASSES, RES = (3, 4, 6, 3), 2048, 256, (128, 32, 16), 2048, 31, 224


def _shapes(cfg: dict, kind: str) -> dict:
    t = cfg["TRAIN"]
    way, shot = int(t["WAY"]), int(t["SHOT"] if kind == "train" else t.get("SHOT_TEST") or t["SHOT"])
    query = int(t["QUERY_PER_CLASS"] if kind == "train" else t.get("QUERY_PER_CLASS_TEST", 1))
    return {"way": way, "support": way * shot, "query": way * query, "frames": int(cfg["DATA"]["NUM_INPUT_FRAMES"])}


def resize_products(n_in: int, n_out: int, channels: int) -> float:
    """FLOPs of one map's bilinear upsampling [C, n_in, n_in] -> [C, n_out, n_out] as two matrix products, rows then columns."""
    return 2.0 * channels * (n_out * n_in * n_in + n_out * n_out * n_in)


def decoder(grid: int, res: int) -> dict:
    """FLOPs of one motion map through the decoder: {"weighted": the convolutions, "resize": the upsamplings}."""
    conv = resize = 0.0
    r, cin = grid, MOTION
    for cout, scale in zip(DECODER, (2, 4, max(res // grid // 8, 1))):
        resize += resize_products(r, r * scale, cin)
        r *= scale
        conv += 2.0 * r * r * cout * cin * 9
        cin = cout
    conv += 2.0 * r * r * 3 * cin
    return {"weighted": conv, "resize": resize}


def stream(tokens: int) -> float:
    """FLOPs of one clip's TransformerV2 block: q|k|v, the output projection, the feed-forward, the two attention products."""
    return 2.0 * tokens * DIM * (3 * DIM + DIM + 2 * MLP) + 2.0 * 2 * tokens * tokens * DIM


def model_flops(cfg: dict, kind: str, episodes: int) -> float:
    """Model FLOPs of one step: the forward, and for "train" the backward (twice the weighted products, less the
    trunk stem's input gradient; once the upsamplings, whose matrices do not train)."""
    s = _shapes(cfg, kind)
    t, n = s["frames"], s["support"] + s["query"]
    crop = int(cfg["DATA"]["TRAIN_CROP_SIZE" if kind == "train" else "TEST_CROP_SIZE"])
    grid = -(-crop // 32)
    trunk = flops.tv_resnet_forward(LAYERS, True, crop)
    clips, frames, maps = episodes * n, episodes * n * t, episodes * n * (t - 1)
    area = grid * grid
    weighted = frames * trunk["total"]
    weighted += clips * 2.0 * t * area * MOTION * DIM * 27  # the Conv3d over (T, h, w)
    weighted += frames * 2.0 * area * MOTION * MOTION * 9  # the 3x3 conv of each frame's reduction
    weighted += maps * 2.0 * area * DIM * MOTION  # the 1x1 up-projection
    weighted += clips * (stream(t) + stream(t + 1) + 2.0 * DIM * CLASSES)
    sims = 2.0 * s["query"] * s["way"] * DIM * (t * t + (t - 1) * (t - 1))  # Bi-MHM of both streams
    sims += 2.0 * 2 * s["query"] * s["way"] * DIM * ((t - 1) + t)  # the four global-local logits
    weighted += episodes * sims
    if kind == "test":
        return weighted
    dec = decoder(grid, crop)
    weighted += maps * dec["weighted"]
    return 3.0 * weighted - 2.0 * frames * trunk["first"] + 2.0 * maps * dec["resize"]


def attention_work(cfg: dict, kind: str, episodes: int) -> list:
    """No attention kernel: the streams run plain attention over 8 or 9 tokens."""
    return []
