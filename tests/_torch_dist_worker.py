"""One rank of tests/test_torch_distributed.py: runs the port's few-shot
entry points on the CPU, under a gloo process group of ``--world`` ranks
(rendezvous through a FileStore) or, with ``--world 1``, under none, and
saves what they did to ``--out``.

    python tests/_torch_dist_worker.py --spec spec.json --world 2 --rank 1 --store store --out rank1.pt

The spec is a JSON list of runs, each ``{"name", "runner": "train" | "test",
"opts": [...], "jitter": bool, "cfg": path}``, run in order on ``cfg`` (the
HMDB51 1-shot config by default).
Dropout is off in every run (each rank draws its own masks); ``jitter``
false also turns the train step's jitter draws off (no generator), as the
tests that hold the port to the JAX package do.  Per run the output holds
the runner's stats, the head's state dict after it, the gradient and the
parameters the optimizer saw at each of its steps, and the checkpoint files
this rank wrote.  Imports nothing of JAX.
"""

import argparse
import datetime
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from clip_fsar_torch.config.config import load_config  # noqa: E402
from clip_fsar_torch.models.heads import common  # noqa: E402
from clip_fsar_torch.train import checkpoint, loop  # noqa: E402
from clip_fsar_torch.train.optimizer import Optimizer  # noqa: E402

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "projects", "CLIPFSAR", "hmdb51",
                      "CLIPFSAR_HMDB51_1shot_v1.yaml")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spec", required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--store", default=None)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    torch.set_num_threads(2)
    if args.world > 1:
        dist.init_process_group("gloo", store=dist.FileStore(args.store, args.world), rank=args.rank, world_size=args.world,
                                timeout=datetime.timedelta(seconds=240))
    with open(args.spec) as f:
        spec = json.load(f)

    common.dropout = lambda x, *_args: x
    built, steps, saves = [], [], []
    build, make_generator, atomic_save, opt_step = loop.build_few_shot_model, loop.step_generator, checkpoint._atomic_save, Optimizer.step

    def capture_build(*a, **k):
        built.append(build(*a, **k))
        return built[-1]

    def capture_step(self, lr, ok=None):
        names = [n for n, p in built[0].head.named_parameters() if p.requires_grad]
        steps.append({"grads": {n: p.grad.detach().clone() for n, p in zip(names, self.params) if p.grad is not None},
                      "params": {n: p.detach().clone() for n, p in zip(names, self.params)}})
        return opt_step(self, lr, ok)

    def capture_save(obj, path):
        saves.append(os.path.basename(path))
        return atomic_save(obj, path)

    loop.build_few_shot_model, Optimizer.step, checkpoint._atomic_save = capture_build, capture_step, capture_save
    out = {}
    for run in spec:
        built.clear(), steps.clear(), saves.clear()
        loop.step_generator = make_generator if run.get("jitter", True) else (lambda *a, **k: None)
        cfg = load_config(run.get("cfg", CONFIG), run["opts"])
        runner = loop.train_few_shot if run["runner"] == "train" else loop.test_few_shot
        stats = runner(cfg, device="cpu")
        out[run["name"]] = {"stats": stats, "state": {k: v.clone() for k, v in built[0].head.state_dict().items()},
                            "steps": list(steps), "saves": list(saves)}
    torch.save(out, args.out)
    if args.world > 1:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
