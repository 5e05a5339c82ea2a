"""A model of another family dropped in as files and entries: the port's classic CNN_OTAM head on a
torchvision ResNet-18, its family (``dropin/family_otam.py``, on ``reference/tv_resnet.py``) and
its counts copied into a copy of the benchmark, with a configuration, a train cell and a test cell,
and no existing file edited.  Whole runs of both cells on the CPU through ``harness.run_cell``: the
float32 program agrees with the family's reference, both cells read correct, and a fault planted
in each timed path reads not correct."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench import inputs as inp
from portbench.reference import tv_resnet
from portbench.reference.ops import Precision
from portbench.tests import tiny

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG, TRAIN, TEST = "otam_resnet18", "otam_resnet18.train_bank", "otam_resnet18.test_bank"
SEED = 2**31 + 977
RUNS = [(TRAIN, None), (TEST, None), (TRAIN, "half_batch"), (TEST, "answer_altered")]

# float32 program against the float32 reference: the same function, summed in another order (the
# program runs one trunk call over every clip of a chunk, the reference one an episode)
FP32_TOLERANCE = {"loss_gap": 1e-5, "grad_gap": 1e-4, "moment_gap": 1e-4, "moment2_gap": 1e-4, "change_gap": 1e-4,
                  "descent_gap": 1e-5, "logit_gap": 1e-5}
# the cells' limits, as a cell file of the benchmark holds them
TRAIN_LIMITS = {"loss_gap": 4e-4, "grad_gap": 0.035, "moment_gap": 0.03, "moment2_gap": 0.07, "change_gap": 0.06,
                "descent_gap": 3e-3, "bad_rows": 0}
TEST_LIMITS = {"logit_gap": 0.015, "bad_rows": 0}


def _config(splits: str) -> dict:
    """The CPU-sized configuration: the shipped few-shot loop of clipfsar_rn50's file under CNN_OTAM on
    resnet18, 4 frames at 32 px, E = 2 episodes of 5 support and 10 query clips, float32."""
    cf = json.loads(json.dumps(tiny.config("clipfsar_rn50", splits, fp32=True)))
    c = cf["config"]
    c["VIDEO"]["HEAD"].update({"NAME": "CNN_OTAM", "BACKBONE_NAME": "resnet18"})
    c["TRAIN"].update({"USE_CLASSIFICATION": False, "QUERY_PER_CLASS": 2})
    c["DATA"].update({"NUM_INPUT_FRAMES": 4, "TRAIN_CROP_SIZE": 32, "TEST_CROP_SIZE": 32, "TEST_SCALE": 36,
                      "TRAIN_JITTER_SCALES": [40, 40]})
    c["TPU"].update({"EPISODES_PER_STEP": 2, "EVAL_FRAME_BANK_FRAMES": 8})
    cf.update(name=CONFIG, family="otam", source="https://arxiv.org/abs/1906.11415 (OTAM, CVPR 2020)",
              why="a second family for the drop-in test", arch={"layers": [2, 2, 2, 2], "feature_dim": 512})
    return cf


def dropin_checkout(root: str, splits: str) -> None:
    """A copy of the benchmark with the family, its counts, its configuration and two cells added
    as files and entries; the port beside it as a link."""
    pb = os.path.join(root, "portbench")
    shutil.copytree(harness.ROOT, pb, ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(harness.CHECKOUT, "clip_fsar_torch"), os.path.join(root, "clip_fsar_torch"))
    shutil.copy(os.path.join(HERE, "dropin", "family_otam.py"), os.path.join(pb, "families", "otam.py"))
    shutil.copy(os.path.join(HERE, "dropin", "counts_otam_resnet18.py"), os.path.join(pb, "counts", CONFIG + ".py"))
    cf = _config(splits)
    with open(os.path.join(pb, "configs", CONFIG + ".json"), "w") as f:
        json.dump(cf, f, indent=1)
    cells = {TRAIN: {"kind": "train", "check_steps": 4, "trace_steps": 2, "limits": TRAIN_LIMITS},
             TEST: {"kind": "test", "warmup_episodes": 4, "chunk_episodes": 8, "trace_episodes": 8, "check_episodes": 4,
                    "limits": TEST_LIMITS}}
    for name, spec in cells.items():
        with open(os.path.join(pb, "workloads", name + ".json"), "w") as f:
            json.dump(spec, f, indent=1)
    bench = harness.benchmark()
    bench["configs"].append({"name": CONFIG, "source": cf["source"], "file": f"portbench/configs/{CONFIG}.json",
                             "reduced": cf["reduced"], "why": cf["why"]})
    for name in cells:
        traffic = name.split(".", 1)[1]
        bench["workloads"].append({"name": name, "config": CONFIG, "traffic": traffic, "chips": 1, "why": "x"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if f"clipfsar_rn50.{traffic}" in m.get("workloads", []):
                m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    """Each run of ``RUNS`` in the dropped-in copy, in one fresh process."""
    root = str(tmp_path_factory.mktemp("checkout"))
    dropin_checkout(root, tiny.write_splits(os.path.join(root, "splits")))
    probe = (
        "import json, sys; sys.path.insert(0, %r)\n"
        "from portbench import faults, harness\n"
        "out = []\n"
        "for cell, fault in %r:\n"
        "    kinds = faults.TRAIN if cell.endswith('train_bank') else faults.TEST\n"
        "    got = {}\n"
        "    r = harness.run_cell(cell, %d, 0.05, False, 'cpu', fault=kinds[fault] if fault else None, readings_out=got)\n"
        "    got.pop('raw')\n"
        "    out.append({'correct': r['correct'], 'attempted': r['attempted'], 'metrics': sorted(r['metrics']), **got})\n"
        "print(json.dumps(out))\n" % (root, RUNS, SEED))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, cwd=root, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(zip(RUNS, json.loads(out.stdout.strip().splitlines()[-1])))


@pytest.mark.parametrize("cell", [TRAIN, TEST])
def test_the_dropped_in_family_agrees_with_its_reference(cell, readings):
    got = readings[(cell, None)]
    assert got["correct"] is True and got["attempted"] > 0 and got["bad_rows"] == 0
    assert {"setup_s", "peak_gib", f"{cell.split('.')[1].split('_')[0]}_samples_per_s"} <= set(got["metrics"])
    for key, limit in FP32_TOLERANCE.items():
        if key in got:
            assert got[key] <= limit, (key, got[key])


@pytest.mark.parametrize("cell,fault", [r for r in RUNS if r[1]])
def test_a_fault_in_the_dropped_in_family_is_not_correct(cell, fault, readings):
    limits = TRAIN_LIMITS if cell == TRAIN else TEST_LIMITS
    sound, broken = readings[(cell, None)], readings[(cell, fault)]
    assert broken["correct"] is False
    assert [k for k, lim in limits.items() if sound[k] <= lim < broken[k]]


@pytest.mark.parametrize("name", ["resnet18", "resnet34", "resnet50"])
def test_tv_resnet_is_the_port_trunk(name):
    """The reference trunk against the port's ``TorchResNet`` in float32 on running statistics away
    from 0 and 1: the pooled features and the gradient of each leaf."""
    from clip_fsar_torch.models.resnet import TorchResNet

    net = TorchResNet(name, dtype=torch.float32)
    w = inp.make_weights({k: tuple(v.shape) for k, v in net.state_dict().items()}, 5, "cpu")
    g = torch.Generator().manual_seed(6)
    for k in w:
        if k.endswith("running_mean"):
            w[k] = 0.1 * torch.randn(w[k].shape, generator=g)
        elif k.endswith("running_var"):
            w[k] = 0.5 + torch.rand(w[k].shape, generator=g)
    net.load_state_dict(w)
    x = torch.randn(2, 36, 36, 3, generator=g)
    params = dict(net.named_parameters())
    # float32 on both sides; the port's BatchNorm is x * a + b with a and b folded first, and its
    # convolutions run channels_last: rounding apart, the same numbers
    want, mine = net(x), tv_resnet.resnet(x, {**w, **params}, Precision())
    assert float((want - mine).detach().abs().max()) <= 1e-4 * float(want.detach().abs().mean())
    probe = torch.randn(want.shape, generator=g)
    grads = [torch.autograd.grad((f * probe).sum(), list(params.values())) for f in (want, mine)]
    for n, a, b in zip(params, *grads):
        assert (a - b).norm() <= 1e-4 * a.norm() + 1e-12, n
