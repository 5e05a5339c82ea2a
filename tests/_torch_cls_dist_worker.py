"""One rank of tests/test_torch_classification_dist.py (and, with ``--task
pretrain``, of tests/test_torch_pretrain_cli.py): the port's classification
trainer and test (clip_fsar_torch.train.classification) on the CPU under a
gloo process group of ``--world`` ranks (rendezvous through a FileStore) or,
with ``--world 1``, under none, on the tiny TAda2D config (or MoSI
pretraining of a tiny R-2D3D, whose run ends with its SSL validation and has
no test); saves the train stats, the model's state dict after training, the
gradient every optimizer step saw, and the test's per-video scores to
``--out``.

    python tests/_torch_cls_dist_worker.py --world 2 --rank 1 --store store --anno lists --run run --out rank1.pt [--task pretrain]

Imports nothing of JAX.
"""

import argparse
import datetime
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from clip_fsar_torch.config.config import load_config  # noqa: E402
from clip_fsar_torch.train import classification  # noqa: E402
from clip_fsar_torch.train.optimizer import Optimizer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "classification", "TAda2D_K400.yaml")
# jitter, erasing and elem-mode mixup / cutmix on: drawn for the global batch, so the ranks' slices are one process's
OPTS = ["VIDEO.BACKBONE.DEPTH", "26", "VIDEO.BACKBONE.NUM_FILTERS", "[8, 16, 16, 32, 32]", "VIDEO.HEAD.NUM_CLASSES", "4",
        "DATA.NUM_INPUT_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32", "DATA.TEST_SCALE", "36",
        "DATA.TRAIN_JITTER_SCALES", "[36, 44]", "DATA.DECODER", "synthetic", "TPU.COMPUTE_DTYPE", "float32", "SOLVER.MAX_EPOCH", "1",
        "SOLVER.WARMUP_EPOCHS", "0", "SOLVER.BASE_LR", "0.001", "TRAIN.EVAL_PERIOD", "1", "TRAIN.BATCH_SIZE", "4", "TEST.BATCH_SIZE", "4",
        "DATA_LOADER.NUM_WORKERS", "2", "LOG_PERIOD", "1", "AUGMENTATION.COLOR_AUG", "True", "AUGMENTATION.RANDOM_ERASING.ENABLE", "True",
        "AUGMENTATION.MIXUP.ENABLE", "True", "AUGMENTATION.MIXUP.ALPHA", "0.8", "AUGMENTATION.MIXUP.MODE", "elem",
        "AUGMENTATION.CUTMIX.ENABLE", "True", "AUGMENTATION.CUTMIX.ALPHA", "1.0", "AUGMENTATION.LABEL_SMOOTHING", "0.1",
        "TEST.NUM_ENSEMBLE_VIEWS", "2"]
# MoSI pretraining: 3 speeds per axis (5 clips of 4 frames at 32 px a video), the preset's per-frame colour jitter drawn for the
# global batch, dropout off (each rank draws its own masks)
PRETRAIN_CONFIG = os.path.join(REPO, "configs", "pretrain", "MoSI_R2D3D_HMDB51.yaml")
PRETRAIN_OPTS = ["VIDEO.BACKBONE.DEPTH", "10", "VIDEO.BACKBONE.NUM_FILTERS", "[8, 16, 16, 32, 32]", "VIDEO.HEAD.NUM_CLASSES", "3",
                 "VIDEO.HEAD.DROPOUT_RATE", "0.0", "PRETRAIN.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32", "DATA.DECODER", "synthetic",
                 "TPU.COMPUTE_DTYPE", "float32", "SOLVER.MAX_EPOCH", "1", "SOLVER.WARMUP_EPOCHS", "0", "TRAIN.EVAL_PERIOD", "1",
                 "TRAIN.BATCH_SIZE", "4", "TEST.BATCH_SIZE", "4", "DATA_LOADER.NUM_WORKERS", "2", "LOG_PERIOD", "1"]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--store", default=None)
    ap.add_argument("--anno", required=True)
    ap.add_argument("--run", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--task", default="classification", choices=("classification", "pretrain"))
    args = ap.parse_args()
    torch.set_num_threads(2)
    if args.world > 1:
        dist.init_process_group("gloo", store=dist.FileStore(args.store, args.world), rank=args.rank, world_size=args.world,
                                timeout=datetime.timedelta(seconds=240))
    pretrain = args.task == "pretrain"
    cfg = load_config(PRETRAIN_CONFIG if pretrain else CONFIG, (PRETRAIN_OPTS if pretrain else OPTS) + ["DATA.ANNO_DIR", args.anno, "OUTPUT_DIR", args.run])
    grads, models = [], []
    step, build = Optimizer.step, classification.build_video_model

    def capture(self, lr, ok=None):
        grads.append({id(p): p.grad.detach().clone() for p in self.params})
        return step(self, lr, ok)

    def capture_build(*a, **k):
        models.append(build(*a, **k))
        return models[-1]

    Optimizer.step = capture
    classification.build_video_model = capture_build
    stats = classification.train(cfg, device="cpu")
    names = {id(p): n for n, p in models[0].named_parameters()}
    out = {"stats": stats, "state": {k: v.clone() for k, v in models[0].state_dict().items()},
           "grads": [{names[i]: g for i, g in step_grads.items()} for step_grads in grads]}
    if not pretrain:
        result = classification.test(cfg, device="cpu")
        out["test"] = {"video_preds": result["meter"].video_preds, "clip_count": result["meter"].clip_count,
                       "top1_acc": result["top1_acc"], "weights": result["weights"]}
    out["stats"].pop("seconds"), out["stats"].pop("clips_per_s")
    torch.save(out, args.out)
    if args.world > 1:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
