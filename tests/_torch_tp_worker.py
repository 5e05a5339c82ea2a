"""One rank of the tensor-parallel tests (tests/test_torch_tensor_parallel*.py):
runs jobs of the port on the CPU, under a gloo process group of ``--world``
ranks (rendezvous through a FileStore) or, with ``--world 1``, under none,
and saves what they did to ``--out``.

    python tests/_torch_tp_worker.py --spec spec.json --world 2 --rank 1 --store store --out rank1.pt

The spec is a JSON list of jobs, run in order; each names its ``kind``:

- ``fewshot``: ``train_few_shot`` or ``test_few_shot`` (``runner``) on ``cfg``
  with ``opts``; ``jitter`` and ``dropout`` false turn the step's jitter
  draws (no generator) or the heads' dropout off;
- ``hyrsm``: one few-shot train step of the head that ``cfg`` and ``opts``
  build, from the state dict and batch in ``data`` (a torch file);
- ``video_grad``: the forward and backward of the video model of the config
  dict in ``data`` on its input, the loss sum(logits * w);
- ``classification``: ``classification.train`` or ``classification.test``
  (``runner``) on ``cfg`` with ``opts``.

Every job runs on the mesh its config's TPU.MESH asks for, and under
``wait_for`` it first waits for that file (a checkpoint another process
writes).  Per job the output holds the runner's stats, the model's full
state dict after it (a tensor-parallel rank gathers its slices), the full
gradient and parameters each optimizer step saw, the gradients of the
replicated parameters as this rank holds them, and the checkpoint files
this rank wrote.  Imports nothing of JAX.
"""

import argparse
import datetime
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from clip_fsar_torch.config.config import Config, load_config  # noqa: E402
from clip_fsar_torch.data.types import Episode  # noqa: E402
from clip_fsar_torch.models import builder  # noqa: E402
from clip_fsar_torch.models.heads import common  # noqa: E402
from clip_fsar_torch.models.video import model as video_model  # noqa: E402
from clip_fsar_torch.parallel import mesh, tensor  # noqa: E402
from clip_fsar_torch.train import checkpoint, classification, loop  # noqa: E402
from clip_fsar_torch.train.optimizer import Optimizer  # noqa: E402
from clip_fsar_torch.train.state import TrainState  # noqa: E402
from clip_fsar_torch.train.step import make_train_step  # noqa: E402

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "projects", "CLIPFSAR", "hmdb51",
                      "CLIPFSAR_HMDB51_1shot_v1.yaml")


def _full(module: torch.nn.Module) -> dict:
    """The module's state dict in full tensors (a collective of the model group when it is sharded)."""
    return {k: v.detach().clone() for k, v in tensor.gather_named(module.state_dict(), tensor.specs(module)).items()}


class Capture:
    """What the optimizer steps and the builders see during one job."""

    def __init__(self):
        self.built, self.steps, self.saves = [], [], []
        self._step, self._init, self._save = Optimizer.step, Optimizer.__init__, checkpoint._atomic_save
        self._fewshot, self._video = loop.build_few_shot_model, classification.build_video_model
        capture = self  # the patched functions below are plain functions, not methods of this object

        def init(opt, cfg, module, name_prefix="head"):
            capture._init(opt, cfg, module, name_prefix)
            opt.names = [n for n, p in module.named_parameters() if p.requires_grad]

        def step(opt, lr, ok=None):
            full = lambda t, p: tensor.spec(p).gather(t) if tensor.spec(p) is not None else t.detach().clone()  # noqa: E731
            capture.steps.append({
                "grads": {n: full(p.grad, p) for n, p in zip(opt.names, opt.params) if p.grad is not None},
                "params": {n: full(p.data, p) for n, p in zip(opt.names, opt.params)},
                "replicated_grads": {n: p.grad.detach().clone() for n, p in zip(opt.names, opt.params)
                                     if p.grad is not None and tensor.spec(p) is None},
            })
            return capture._step(opt, lr, ok)

        def save(obj, path):
            capture.saves.append(os.path.basename(path))
            return capture._save(obj, path)

        Optimizer.__init__, Optimizer.step, checkpoint._atomic_save = init, step, save
        loop.build_few_shot_model = lambda *a, **k: _remember(capture, capture._fewshot(*a, **k), lambda m: m.head)
        classification.build_video_model = lambda *a, **k: _remember(capture, capture._video(*a, **k), lambda m: m)


def _remember(capture, built, module_of):
    capture.built.append(module_of(built))
    return built


def _wait(path: str, seconds: float = 240.0) -> None:
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > seconds:
            raise TimeoutError(f"waited {seconds} s for {path}")
        time.sleep(0.2)


def _fewshot(job, cap: Capture) -> dict:
    cfg = load_config(job.get("cfg", CONFIG), job["opts"])
    runner = loop.train_few_shot if job["runner"] == "train" else loop.test_few_shot
    return runner(cfg, device="cpu")


def _hyrsm(job, cap: Capture) -> dict:
    """One train step of the head from the given weights on the given batch (no generator: no jitter, no dropout)."""
    data = torch.load(job["data"], weights_only=False)
    cfg = load_config(job["cfg"], job["opts"])
    grid = mesh.build_mesh(cfg, "cpu")
    model = builder.build_few_shot_model(cfg, flow="train", device="cpu")
    model.head.load_state_dict(data["state"])
    cap.built.append(model.head)
    state = TrainState.create(cfg, model.head, Optimizer(cfg, model.head))
    state.shard_(grid.model_shard)
    step = make_train_step(model.head, cfg, model.text_train, model.text_test)
    metrics = step(state, Episode(**data["batch"]), float(job.get("lr", 0.0)), None)
    return {"losses": [float(metrics["loss"])]}


def _video_grad(job, cap: Capture) -> dict:
    """sum(logits * w) and its gradient through the video model on the given input (train mode, no generator)."""
    data = torch.load(job["data"], weights_only=False)
    cfg = Config(data["cfg"])
    grid = mesh.build_mesh(cfg, "cpu")
    model = video_model.build_video_model(cfg)
    model.load_state_dict(data["state"])
    cap.built.append(model)
    tensor.shard_module(model, grid.model_shard)
    logits = model(data["x"], train=True)[0]
    (logits * data["w"]).sum().backward()
    grads = {n: tensor.spec(p).gather(p.grad) if tensor.spec(p) is not None else p.grad.clone() for n, p in model.named_parameters()}
    return {"logits": logits.detach().clone(), "grads": grads}


def _classification(job, cap: Capture) -> dict:
    cfg = load_config(job["cfg"], job["opts"])
    runner = classification.train if job["runner"] == "train" else classification.test
    stats = runner(cfg, device="cpu")
    stats.pop("meter", None)
    return stats


JOBS = {"fewshot": _fewshot, "hyrsm": _hyrsm, "video_grad": _video_grad, "classification": _classification}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spec", required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--store", default=None)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)
    if args.world > 1:
        dist.init_process_group("gloo", store=dist.FileStore(args.store, args.world), rank=args.rank, world_size=args.world,
                                timeout=datetime.timedelta(seconds=240))
    with open(args.spec) as f:
        spec = json.load(f)
    cap = Capture()
    dropout, make_generator = common.dropout, loop.step_generator
    out = {}
    for job in spec:
        cap.built.clear(), cap.steps.clear(), cap.saves.clear()
        if job.get("wait_for"):
            _wait(job["wait_for"])
        common.dropout = dropout if job.get("dropout", False) else (lambda x, *_args: x)
        loop.step_generator = make_generator if job.get("jitter", True) else (lambda *a, **k: None)
        stats = JOBS[job["kind"]](job, cap)
        out[job["name"]] = {"stats": stats, "state": _full(cap.built[0]) if cap.built else None, "steps": list(cap.steps),
                            "saves": list(cap.saves)}
    torch.save(out, args.out)
    if args.world > 1:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
