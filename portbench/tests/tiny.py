"""The benchmark's cells at a size the CPU holds: CLIP's test towers (ViT-Tiny-Test, RN-Tiny-Test)
at 64 px over split lists of 3 videos a class, the rest of each configuration as it is."""

from __future__ import annotations

import json
import os

from portbench import inputs as inp

ARCH = {
    "ViT-Tiny-Test": {"tower": "ViT", "width": 64, "layers": 2, "heads": 2, "patch": 16, "resolution": 64, "embed_dim": 32},
    "RN-Tiny-Test": {"tower": "ModifiedResNet", "width": 8, "layers": [1, 1, 1, 1], "heads": 4, "resolution": 64, "embed_dim": 32},
}
BACKBONE = {"clipfsar_vitb16": "ViT-Tiny-Test", "clipfsar_rn50": "RN-Tiny-Test"}


def write_splits(d: str) -> str:
    """Split lists of 3 videos for each of the configuration's 31 train and 10 test classes."""
    os.makedirs(d, exist_ok=True)
    for kind, classes in (("train", 31), ("test", 10)):
        with open(os.path.join(d, f"{kind}_few_shot.txt"), "w") as f:
            for c in range(classes):
                for i in range(3):
                    f.write(f"{kind}{c}//videos/{kind}{c}/v{i}.avi\n")
    return d


def config(name: str, splits: str, fp32: bool = False) -> dict:
    """Configuration ``name``'s file at the tiny size; ``fp32`` computes in float32."""
    cf = json.loads(json.dumps(inp.load_json("configs", name)))
    c = cf["config"]
    backbone = BACKBONE[name]
    c["VIDEO"]["HEAD"]["BACKBONE_NAME"] = backbone
    c["DATA"].update({"TRAIN_CROP_SIZE": 64, "TEST_CROP_SIZE": 64, "TEST_SCALE": 72, "TRAIN_JITTER_SCALES": [72, 72], "ANNO_DIR": splits})
    c["DATA_LOADER"]["NUM_WORKERS"] = 2
    if fp32:
        c["TPU"]["COMPUTE_DTYPE"] = "float32"
    cf["arch"] = ARCH[backbone]
    return cf
