"""MoLo on the benchmark, on the CPU: the configuration molo_r50 (family ``portbench/families/molo.py``,
reference ``portbench/reference/molo.py``) at a tiny size, resnet18 at 64 px, 4 frames, E = 2 episodes of 3-way
1-shot with 2 queries a class, float32, through ``harness.run_cell``.  The program's four set-up steps and its
test logits agree with the reference; half a batch, the reconstruction loss left out, the decoder's statistics
over the whole batch and the trunk's running statistics ignored each break that agreement.  Beside it: the
reference's trunk map against ``tv_resnet``, the family's draw of the trunk's BatchNorm leaves, the step's
operation count at the published widths, the port's new spans (``fsar.tower`` in every classic head,
``fsar.molo.motion``, ``fsar.molo.decode``) and their readers."""

from __future__ import annotations

import collections
import contextlib
import json
import os
from unittest import mock

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from clip_fsar_torch.config.config import load_config
from clip_fsar_torch.data.loader import build_few_shot_loader
from clip_fsar_torch.models.builder import build_few_shot_model
from clip_fsar_torch.models.clip.model import BatchNorm
from clip_fsar_torch.train.loop import step_generator
from clip_fsar_torch.train.optimizer import Optimizer
from clip_fsar_torch.train.state import TrainState
from clip_fsar_torch.train.step import make_grad_fn, make_train_step
from clip_fsar_torch.utils import tracing
from clip_fsar_torch.utils.tracing import Span
from portbench import faults, flops, harness
from portbench import inputs as inp
from portbench.reference import molo as ref
from portbench.reference import tv_resnet
from portbench.reference.ops import Precision
from portbench.tests import tiny

torch.set_num_threads(2)

CONFIG, TRAIN, TEST = "molo_r50", "molo_r50.train_bank", "molo_r50.test_bank"
SEED = 2**31 + 977
REPO = harness.CHECKOUT
MOLO_1SHOT = os.path.join(REPO, "configs", "projects", "MoLo", "hmdb51", "MoLo_HMDB51_1shot_v1.yaml")
TEST_SPEC = {"kind": "test", "warmup_episodes": 4, "chunk_episodes": 8, "trace_episodes": 8, "check_episodes": 4,
             "limits": {"logit_gap": 0.015, "bad_rows": 0}}

# float32 program against the float32 reference: the same function, its sums in other orders (the program runs
# one trunk call over both episodes' clips and its BatchNorm as x * a + b with a and b folded first, the reference
# one episode at a time).  Read on this tree: loss 6e-8, the worst leaf's gradient 2e-5, Adam's moments 1.7e-4 and
# 3.6e-4 (the stem's conv and a BatchNorm gain, whose gradients sum over every pixel), the change 1.5e-5.
FP32_TOLERANCE = {"loss_gap": 1e-6, "grad_gap": 2e-4, "moment_gap": 2e-3, "moment2_gap": 4e-3, "change_gap": 2e-4,
                  "descent_gap": 1e-5, "logit_gap": 1e-5}


def tiny_config(splits: str) -> dict:
    """molo_r50's file at the CPU's size: resnet18 (512 channels, motion 64), 4 frames of 64 px, E = 2 episodes in
    one chunk (so one decoder call holds both episodes' maps), 3-way 1-shot with 2 queries a class, float32."""
    cf = json.loads(json.dumps(inp.load_json("configs", CONFIG)))
    c = cf["config"]
    c["VIDEO"]["HEAD"]["BACKBONE_NAME"] = "resnet18"
    c["DATA"].update({"NUM_INPUT_FRAMES": 4, "TRAIN_CROP_SIZE": 64, "TEST_CROP_SIZE": 64, "TEST_SCALE": 72,
                      "TRAIN_JITTER_SCALES": [72, 72], "ANNO_DIR": splits})
    c["DATA_LOADER"]["NUM_WORKERS"] = 2
    c["TPU"].update({"COMPUTE_DTYPE": "float32", "EPISODES_PER_STEP": 2, "EPISODE_CHUNKS": 1, "EVAL_FRAME_BANK_FRAMES": 8})
    c["TRAIN"].update({"WAY": 3, "SHOT": 1, "QUERY_PER_CLASS": 2})
    c["TEST"]["BATCH_SIZE"] = 2
    cf["arch"].update({"trunk": "resnet18", "layers": [2, 2, 2, 2], "feature_dim": 512, "motion_dim": 64, "resolution": 64,
                       "frames": 4})
    return cf


def recons_left_out(run) -> None:
    """The head's reconstruction loss dropped from the step's loss."""
    head = run.model.head
    forward = head.forward
    head.forward = lambda *a, **k: {**forward(*a, **k), "loss_recons": None}


def decoder_stats_whole_batch(run) -> None:
    """The decoder's BatchNorms on the statistics of the whole call (both episodes) instead of each episode's."""
    head = run.model.head
    decode = head._decode
    head._decode = lambda motion, size, groups: decode(motion, size, 1)


def running_stats_ignored(run) -> None:
    """The trunk's BatchNorm on mean 0 and variance 1 whatever its running statistics hold."""
    for m in run.model.head.backbone.modules():
        if isinstance(m, BatchNorm):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)


FAULTS = {"half_batch": faults.TRAIN["half_batch"], "recons_left_out": recons_left_out,
          "decoder_stats_whole_batch": decoder_stats_whole_batch, "running_stats_ignored": running_stats_ignored}
RUNS = [(TRAIN, None), (TEST, None)] + [(TRAIN, name) for name in FAULTS]


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    """Each run of ``RUNS`` at the tiny size; the test cell is added to the benchmark for the test alone."""
    cf = tiny_config(tiny.write_splits(str(tmp_path_factory.mktemp("splits"))))
    bench = json.loads(json.dumps(harness.benchmark()))
    bench["workloads"].append({"name": TEST, "config": CONFIG, "traffic": "test_bank", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "test_samples_per_s":
            m["workloads"].append(TEST)
    load_json = inp.load_json
    out, cache = {}, {}
    with mock.patch.object(inp, "load_json", lambda kind, name: TEST_SPEC if (kind, name) == ("workloads", TEST) else load_json(kind, name)):
        for cell, fault in RUNS:
            got = {}
            r = harness.run_cell(cell, SEED, 0.05, False, "cpu", bench=bench, config_file=cf, fault=FAULTS.get(fault),
                                 readings_out=got, ref_cache=cache)
            got.pop("raw")
            out[(cell, fault)] = {"correct": r["correct"], "attempted": r["attempted"], "metrics": sorted(r["metrics"]), **got}
    return out


@pytest.mark.parametrize("cell", [TRAIN, TEST])
def test_molo_agrees_with_its_reference(cell, readings):
    got = readings[(cell, None)]
    assert got["correct"] is True and got["attempted"] > 0 and got["bad_rows"] == 0
    assert {"setup_s", "peak_gib", f"{cell.split('.')[1].split('_')[0]}_samples_per_s"} <= set(got["metrics"])
    for key, tolerance in FP32_TOLERANCE.items():
        if key in got:
            assert got[key] <= tolerance, (key, got[key])


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_breaks_the_agreement(fault, readings):
    """Every fault takes some number from within its float32 tolerance to above it."""
    sound, broken = readings[(TRAIN, None)], readings[(TRAIN, fault)]
    assert [k for k, tolerance in FP32_TOLERANCE.items() if k in broken and sound[k] <= tolerance < broken[k]], broken


@pytest.mark.parametrize("fault", ["half_batch", "recons_left_out", "running_stats_ignored"])
def test_the_cells_limits_catch_the_faults_that_move_the_loss(fault, readings):
    """Under the cell's own limits (set for bf16 on the card) the faults that move the loss or the whole gradient
    read not correct; the decoder's statistics taken over both episodes move only the decoder's leaves, by a few
    thousandths at this size, which the cell's whole-norm limits do not see."""
    limits = inp.load_json("workloads", TRAIN)["limits"]
    sound, broken = readings[(TRAIN, None)], readings[(TRAIN, fault)]
    assert broken["correct"] is False
    assert [k for k, lim in limits.items() if sound[k] <= lim < broken[k]]


def test_the_family_draws_the_trunks_batch_norm_leaves():
    """The trunk's BatchNorm leaves come from the seed, away from 0 and 1, the same for the same seed; the decoder's
    and every other leaf are the inputs' own; the temperatures are 1."""
    family = harness.load_module("families", "molo")
    shapes = {"backbone.bn1.running_mean": (8,), "backbone.bn1.running_var": (8,), "backbone.bn1.weight": (8,),
              "backbone.bn1.bias": (8,), "up1.bn.running_mean": (4,), "up1.bn.running_var": (4,), "up1.bn.weight": (4,),
              "scale": (1,), "scale_motion": (1,), "motion_up.weight": (4, 2, 1, 1)}
    drawn, made = [], []
    for seed in (SEED, SEED, SEED + 1):
        w = inp.make_weights(shapes, seed, "cpu")
        made.append({k: v.clone() for k, v in w.items()})
        family.text_banks({}, w, seed, "cpu")
        drawn.append(w)
    w, before = drawn[0], made[0]
    assert 0.5 <= float(w["backbone.bn1.running_var"].min()) and float(w["backbone.bn1.running_var"].max()) <= 1.5
    assert float(w["backbone.bn1.running_mean"].abs().max()) > 0 and float(w["backbone.bn1.bias"].abs().max()) > 0
    assert not torch.equal(w["backbone.bn1.weight"], torch.ones(8))
    assert all(torch.equal(w[k], before[k]) for k in shapes if not k.startswith("backbone.") and not k.startswith("scale"))
    assert torch.equal(w["scale_motion"], torch.ones(1)) and torch.equal(w["scale"], torch.ones(1))
    assert all(torch.equal(drawn[0][k], drawn[1][k]) for k in shapes)
    assert not torch.equal(drawn[0]["backbone.bn1.running_mean"], drawn[2]["backbone.bn1.running_mean"])


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_the_reference_map_pools_to_tv_resnet(name):
    """``reference/molo.py``'s trunk map, averaged over space, is ``tv_resnet.resnet``'s output to the bit."""
    from clip_fsar_torch.models.resnet import TorchResNet

    net = TorchResNet(name, dtype=torch.float32)
    w = {"backbone." + k: v for k, v in inp.make_weights({k: tuple(v.shape) for k, v in net.state_dict().items()}, 5, "cpu").items()}
    harness.load_module("families", "molo").draw_trunk_statistics(w, 5)
    w = ref.trunk_part(w)
    x = torch.randn(2, 36, 36, 3, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        assert torch.equal(ref.trunk_map(x, w, Precision()).mean(dim=(2, 3)), tv_resnet.resnet(x, w, Precision()))


def _published():
    return inp.load_json("configs", CONFIG)["config"]


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_the_step_counts_at_the_published_widths():
    """A train step of 4 episodes (35 clips of 8 frames each) is about 35.6 TFLOP, within 5 %: the trunk 27.4, the
    Conv3d 4.7, the decoder 3.1 (less the upsamplings' second backward product), the rest under 0.5; a test step runs
    no decoder and no backward."""
    counts = harness.load_module("counts", CONFIG)
    cfg = _published()
    train = counts.model_flops(cfg, "train", 4)
    assert train == pytest.approx(35.6e12, rel=0.05)
    trunk = flops.tv_resnet_forward((3, 4, 6, 3), True, 224)
    assert 3 * 1120 * trunk["total"] - 2 * 1120 * trunk["first"] == pytest.approx(27.4e12, rel=0.05)
    assert 3 * 140 * 2.0 * 256 * (8 * 7 * 7) * 2048 * 27 == pytest.approx(4.7e12, rel=0.05)
    dec = counts.decoder(7, 224)  # 3.1 at three times the forward; the upsamplings' fixed matrices take no gradient
    assert 980 * 3 * (dec["weighted"] + dec["resize"]) == pytest.approx(3.1e12, rel=0.05)
    test = counts.model_flops(cfg, "test", 4)
    assert test < train / 3 and counts.attention_work(cfg, "train", 4) == []


def test_the_decoder_and_stream_counts_match_torchs_flop_counter():
    """torch's FlopCounterMode over the reference's decoder on one motion map and over one clip's stream block (meta
    tensors, nothing computed) against the counts' functions."""
    counts = harness.load_module("counts", CONFIG)
    meta = lambda *shape: torch.zeros(shape, device="meta")  # noqa: E731
    w = {"outc.weight": meta(3, 16, 1, 1), "outc.bias": meta(3)}
    for name, cin, cout in zip(ref.DECODER, (256, 128, 32), (128, 32, 16)):
        w[name + ".conv.weight"] = meta(cout, cin, 3, 3)
        w.update({name + ".bn." + k: meta(cout) for k in ("weight", "bias", "running_mean", "running_var")})
    dec = counts.decoder(7, 224)
    assert _counted(lambda: ref.decode(meta(1, 256, 7, 7), w, Precision(), (224, 224))) == dec["weighted"] + dec["resize"]
    p = "temporal_atte_before."
    s = {p + "attn.norm.weight": meta(2048), p + "attn.norm.bias": meta(2048), p + "attn.to_qkv.weight": meta(3 * 2048, 2048),
         p + "attn.to_out.weight": meta(2048, 2048), p + "attn.to_out.bias": meta(2048), p + "ff_fc1.weight": meta(2048, 2048),
         p + "ff_fc1.bias": meta(2048), p + "ff_fc2.weight": meta(2048, 2048), p + "ff_fc2.bias": meta(2048)}
    assert _counted(lambda: ref.stream(meta(1, 8, 2048), meta(1, 1, 2048), s, p, Precision(), 8, None)) == counts.stream(9)


# ---------------------------------------------------------------------------- the port's spans

SPAN_OPTS = [
    "TRAIN.ENABLE", "True", "DATA.DECODER", "synthetic", "DATA.NUM_INPUT_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "64",
    "DATA.TEST_CROP_SIZE", "64", "DATA.TEST_SCALE", "72", "DATA.TRAIN_JITTER_SCALES", "[72, 80]",
    "DATA_LOADER.NUM_WORKERS", "2", "TPU.COMPUTE_DTYPE", "float32", "TPU.EPISODES_PER_STEP", "2", "TPU.EPISODE_CHUNKS", "2",
    "TRAIN.BATCH_SIZE_PER_TASK", "1", "TRAIN.QUERY_PER_CLASS", "1", "VIDEO.HEAD.BACKBONE_NAME", "resnet18",
]
HYRSM_5SHOT = os.path.join(REPO, "configs", "projects", "hyrsmplusplus", "hmdb51", "HyRSMplusplus_HMDB51_5shot_v1.yaml")


def _step_spans(yaml: str, opts: list, traced: bool = True):
    """One train step of the tiny configuration, recorded (or not): (the spans, the step's metrics, the gradient)."""
    cfg = load_config(yaml, SPAN_OPTS + ["DATA.ANNO_DIR", os.path.dirname(yaml) + "/"] + opts)
    model = build_few_shot_model(cfg, flow="train", device="cpu")
    grad_fn = make_grad_fn(model.head, cfg, model.text_train, model.text_test)
    with build_few_shot_loader(cfg, "train", num_steps=1, episodes_per_step=2) as loader:
        batch = next(iter(loader)).to("cpu")
    tracing.reset()
    with tracing.recording() if traced else contextlib.nullcontext():
        metrics = grad_fn(batch, step_generator(cfg, 0, "cpu"))
    spans = tracing.collect()["spans"]
    tracing.reset()
    return spans, metrics, {n: p.grad.clone() for n, p in model.head.named_parameters() if p.grad is not None}


def test_molos_spans_nest_in_each_chunks_forward():
    """MoLo in two episode chunks of one episode (5 support and 5 query clips of 4 frames): the trunk, the motion
    stream and the decoder each once a chunk, inside that chunk's forward, with the motion's clips and the
    decoder's maps and pixels."""
    spans, _, _ = _step_spans(MOLO_1SHOT, [])
    by_id = {s.id: s for s in spans}
    for name in ("fsar.tower", "fsar.molo.motion", "fsar.molo.decode"):
        mine = [s for s in spans if s.name == name]
        assert len(mine) == 2, name
        parents = [by_id[s.parent] for s in mine]
        assert [p.name for p in parents] == ["fsar.forward"] * 2 and len({p.id for p in parents}) == 2
    assert [s.attrs for s in spans if s.name == "fsar.molo.motion"] == [{"clips": 10}] * 2
    assert [s.attrs for s in spans if s.name == "fsar.molo.decode"] == [{"maps": 30, "pixels": 30 * 64 * 64}] * 2


def test_a_classic_head_emits_the_tower_span():
    """HyRSM++ 5-shot on resnet18 (``ClassicHead.encode``): one tower span a chunk, inside its forward."""
    spans, _, _ = _step_spans(HYRSM_5SHOT, ["TRAIN.WAY", "3", "TRAIN.SHOT", "2"])
    by_id = {s.id: s for s in spans}
    tower = [s for s in spans if s.name == "fsar.tower"]
    assert len(tower) == 2 and all(by_id[s.parent].name == "fsar.forward" for s in tower)


def test_recording_leaves_molos_step_bitwise_unchanged():
    """The metrics and gradient of MoLo's forward and backward with the spans recording and with tracing off."""
    spans, m0, g0 = _step_spans(MOLO_1SHOT, [], traced=True)
    none, m1, g1 = _step_spans(MOLO_1SHOT, [], traced=False)
    assert spans and not none
    assert m0.keys() == m1.keys() and all(torch.equal(m0[k], m1[k]) for k in m0)
    assert g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k]) for k in g0)


CLIPFSAR_CONFIG = os.path.join(REPO, "configs", "projects", "CLIPFSAR", "hmdb51", "CLIPFSAR_HMDB51_1shot_v1.yaml")
# the spans of one tiny CLIP-FSAR train step (two chunks), recorded on the tree before MoLo's spans were added
CLIPFSAR_SPANS = {
    "ViT-Tiny-Test": {"fsar.augment": 3, "fsar.backward": 3, "fsar.forward": 2, "fsar.h2d": 1, "fsar.ln": 24, "fsar.optimizer": 1,
                      "fsar.step": 1, "fsar.tower": 2},
    "RN-Tiny-Test": {"fsar.augment": 3, "fsar.backward": 3, "fsar.bn": 76, "fsar.forward": 2, "fsar.h2d": 1, "fsar.ln": 12,
                     "fsar.optimizer": 1, "fsar.step": 1, "fsar.tower": 4},
}


@pytest.mark.parametrize("backbone", sorted(CLIPFSAR_SPANS))
def test_clipfsars_spans_are_unchanged(backbone):
    opts = [o for o in SPAN_OPTS if o not in ("VIDEO.HEAD.BACKBONE_NAME", "resnet18")]
    cfg = load_config(CLIPFSAR_CONFIG, opts + ["DATA.ANNO_DIR", os.path.dirname(CLIPFSAR_CONFIG) + "/", "TEST.BATCH_SIZE", "2",
                                               "VIDEO.HEAD.BACKBONE_NAME", backbone])
    model = build_few_shot_model(cfg, flow="train", device="cpu")
    state = TrainState.create(cfg, model.head, Optimizer(cfg, model.head))
    step = make_train_step(model.head, cfg, model.text_train, model.text_test)
    with build_few_shot_loader(cfg, "train", num_steps=1, episodes_per_step=2) as loader:
        batch = next(iter(loader))
    tracing.reset()
    with tracing.recording():
        step(state, batch.to("cpu"), 1e-3, step_generator(cfg, 0, "cpu"))
    got = collections.Counter(s.name for s in tracing.collect()["spans"])
    tracing.reset()
    assert dict(got) == CLIPFSAR_SPANS[backbone]


@pytest.mark.parametrize("metric, span", [("motion_issue_ms.train", "fsar.molo.motion"), ("decode_issue_ms.train", "fsar.molo.decode")])
def test_each_molo_span_metric_reads_its_spans(metric, span, monkeypatch):
    """The reader against a hand-built store of two steps (its span's total over the steps, in ms) and an empty one."""
    names = {m["name"]: m for m in harness.benchmark()["per_layer"]}
    assert names[metric]["workloads"] == [TRAIN] and names[metric]["moves"] == "train_samples_per_s"
    read = harness.load_module("metrics", metric).read
    store = [Span("fsar.step", 1, None, 0, 0, 100_000_000, 0, {}), Span("fsar.step", 2, None, 1, 0, 120_000_000, 0, {}),
             Span(span, 3, 1, 0, 0, 7_000_000, 0, {}), Span(span, 4, 1, 0, 0, 5_000_000, 0, {}),
             Span(span, 5, 2, 1, 0, 9_000_000, 0, {}), Span("fsar.tower", 6, 2, 1, 0, 40_000_000, 0, {})]
    monkeypatch.setattr(tracing, "_spans", store)
    assert read({"kind": "train"}) == pytest.approx(10.5, rel=1e-12)
    monkeypatch.setattr(tracing, "_spans", [])
    assert read({"kind": "train"}) is None
