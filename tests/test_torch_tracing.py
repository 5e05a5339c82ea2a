"""The port's tracer (clip_fsar_torch/utils/tracing.py) on the tiny towers (ViT-Tiny-Test, RN-Tiny-Test: 64 px,
4 frames, float32, synthetic decoder, E = 2 in two episode chunks): each span lies on the profiler's clock
beside the range of its name, the spans nest and share their step's id, nothing records with the profiler off,
tracing changes no bit of a step, the card's idle gaps take the name of the innermost span, and each per-layer
metric reader of the benchmark reads the spans it names."""

from __future__ import annotations

import collections
import contextlib
import os
import statistics
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from clip_fsar_torch.config.config import load_config
from clip_fsar_torch.data.loader import build_few_shot_loader
from clip_fsar_torch.models.builder import build_few_shot_model
from clip_fsar_torch.train.loop import evaluate, step_generator
from clip_fsar_torch.train.optimizer import Optimizer
from clip_fsar_torch.train.state import TrainState
from clip_fsar_torch.train.step import make_grad_fn, make_train_step
from clip_fsar_torch.utils import tracing
from clip_fsar_torch.utils.tracing import Span

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "projects", "CLIPFSAR", "hmdb51", "CLIPFSAR_HMDB51_1shot_v1.yaml")
OPTS = [
    "TRAIN.ENABLE", "True",
    "DATA.DECODER", "synthetic",
    "DATA.NUM_INPUT_FRAMES", "4",
    "DATA.TRAIN_CROP_SIZE", "64",
    "DATA.TEST_CROP_SIZE", "64",
    "DATA.TEST_SCALE", "72",
    "DATA.TRAIN_JITTER_SCALES", "[72, 80]",
    "DATA.ANNO_DIR", os.path.join(REPO, "configs", "projects", "CLIPFSAR", "hmdb51") + "/",
    "DATA_LOADER.NUM_WORKERS", "2",
    "TPU.COMPUTE_DTYPE", "float32",
    "TPU.EPISODES_PER_STEP", "2",
    "TPU.EPISODE_CHUNKS", "2",
    "TRAIN.BATCH_SIZE_PER_TASK", "1",
    "TRAIN.QUERY_PER_CLASS", "1",
    "TRAIN.NUM_TEST_TASKS", "4",
    "TEST.BATCH_SIZE", "2",
]
TOWERS = ["ViT-Tiny-Test", "RN-Tiny-Test"]
CLOCK_NS = 100_000  # a span's stamps and its profiler range: 100 us apart at each end (the median)
SLACK_NS = 5_000  # the profiler converts its own clock to the wall clock's: a few microseconds of play


def _cfg(backbone: str):
    return load_config(CONFIG, OPTS + ["VIDEO.HEAD.BACKBONE_NAME", backbone])


def _run(backbone: str):
    """The model, train state, step and one host batch of ``backbone``'s tiny configuration."""
    cfg = _cfg(backbone)
    model = build_few_shot_model(cfg, flow="train", device="cpu")
    state = TrainState.create(cfg, model.head, Optimizer(cfg, model.head))
    step = make_train_step(model.head, cfg, model.text_train, model.text_test)
    with build_few_shot_loader(cfg, "train", num_steps=1, episodes_per_step=2) as loader:
        batch = next(iter(loader))
    return cfg, model, state, step, batch


def _ranges(prof) -> dict:
    """The profiler's ``fsar.`` ranges by name: (start, end) ns on the clock of ``time.time_ns()``."""
    base = prof.profiler.kineto_results.trace_start_ns()
    out = collections.defaultdict(list)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(tracing.PREFIX):
            out[e.name].append((base + round(e.time_range.start * 1000), base + round(e.time_range.end * 1000)))
    return out


@pytest.mark.parametrize("backbone", TOWERS)
def test_spans_lie_on_the_profilers_clock_and_nest_by_step(backbone):
    """A train step (the loader's wait, the copy, the step) and an ``evaluate`` of 2 steps under the profiler:
    each span has one profiler range of its name, which its stamps bracket on the one clock, within 100 us at
    each end (the median over the spans: a thread held up between a stamp and the range's own, by the
    interpreter's lock or the host, parts them by up to milliseconds); the tower sits in the forward, the
    forward in the step, and every span inside a step carries that step's id."""
    cfg, model, state, step, batch = _run(backbone)
    step(state, batch.to("cpu"), 1e-3, step_generator(cfg, 0, "cpu"))  # the first call's one-time costs, untraced
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with build_few_shot_loader(cfg, "train", num_steps=1, episodes_per_step=2, start_step=5) as loader:
            for host in loader:
                step(state, host.to("cpu"), 1e-3, step_generator(cfg, 5, "cpu"))
        evaluate(cfg, model, 4, 2, device="cpu")
    spans = tracing.collect()["spans"]
    tracing.reset()

    names = {s.name for s in spans}
    norm = "fsar.ln" if backbone.startswith("ViT") else "fsar.bn"
    assert {"fsar.loader.wait", "fsar.h2d", "fsar.step", "fsar.augment", "fsar.forward", "fsar.tower", norm, "fsar.backward",
            "fsar.optimizer", "fsar.eval.fetch", "fsar.eval.account"} <= names
    assert not any(n == "bn_chain" or n.startswith("pb.") for n in names)

    ranges = _ranges(prof)
    lead, lag = [], []  # stamp to range at the start, range to stamp at the end
    for name in names:
        mine = sorted((s.start_ns, s.end_ns) for s in spans if s.name == name)
        theirs = sorted(ranges[name])
        assert len(mine) == len(theirs), name
        for (a, b), (c, d) in zip(mine, theirs):
            assert a - SLACK_NS <= c and d <= b + SLACK_NS, (name, c - a, b - d)
            lead.append(c - a)
            lag.append(b - d)
    assert statistics.median(lead) <= CLOCK_NS and statistics.median(lag) <= CLOCK_NS, (statistics.median(lead), statistics.median(lag))

    by_id = {s.id: s for s in spans}

    def root(s: Span) -> Span:
        while s.parent is not None:
            s = by_id[s.parent]
        return s

    for s in spans:
        if s.name == "fsar.tower":
            forward = by_id[s.parent]
            assert forward.name == "fsar.forward" and by_id[forward.parent].name == "fsar.step"
        if root(s).name == "fsar.step":
            assert s.step == root(s).step, (s.name, s.step, root(s).step)
    train_steps = [s for s in spans if s.name == "fsar.step" and s.parent is None and any(
        c.name == "fsar.optimizer" and root(c) is s for c in spans)]
    assert [s.step for s in train_steps] == [1]  # state.step after the untraced first call
    assert [s.step for s in spans if s.name == "fsar.loader.wait"][0] == 5  # the train loader's step index
    eval_steps = sorted(s.step for s in spans if s.name == "fsar.step" and s not in train_steps)
    assert eval_steps == [0, 1] and sorted({s.step for s in spans if s.name == "fsar.eval.fetch"}) == [0, 1]


def test_nothing_records_without_a_profiler_but_set_up_does():
    """With the profiler off and no ``recording()`` a step records no span; inside ``recording()`` it does, and
    the set-up spans (the model, the train state and its optimizer) record either way."""
    tracing.reset()
    cfg, model, state, step, batch = _run("ViT-Tiny-Test")
    setup = collections.Counter(s.name for s in tracing.collect()["spans"])
    assert setup == {"fsar.setup.model": 1, "fsar.setup.state": 2}
    tracing.reset()
    step(state, batch.to("cpu"), 1e-3, None)
    assert tracing.collect()["spans"] == []
    with tracing.recording():
        step(state, batch.to("cpu"), 1e-3, None)
    recorded = tracing.collect()
    assert recorded["by_name"]["fsar.step"]["calls"] == 1 and recorded["by_name"]["fsar.tower"]["calls"] == 2
    tracing.reset()
    step(state, batch.to("cpu"), 1e-3, None)
    assert tracing.collect()["spans"] == []


@pytest.mark.parametrize("backbone", TOWERS)
def test_tracing_leaves_the_step_bitwise_unchanged(backbone):
    """The gradient and metrics of a step's forward and backward, and the parameters after a whole train step,
    with the spans recording under the profiler and with tracing off: the same bits."""
    cfg = _cfg(backbone)
    with build_few_shot_loader(cfg, "train", num_steps=1, episodes_per_step=2) as loader:
        batch = next(iter(loader)).to("cpu")
    out = {}
    for traced in (False, True):
        model = build_few_shot_model(cfg, flow="train", device="cpu")
        state = TrainState.create(cfg, model.head, Optimizer(cfg, model.head))
        grad_fn = make_grad_fn(model.head, cfg, model.text_train, model.text_test)
        step = make_train_step(model.head, cfg, model.text_train, model.text_test)
        tracing.reset()
        with profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext():
            metrics = grad_fn(batch, step_generator(cfg, 0, "cpu"))
            grads = {n: p.grad.clone() for n, p in model.head.named_parameters() if p.grad is not None}
            step(state, batch, 1e-3, step_generator(cfg, 1, "cpu"))
        assert bool(tracing.collect()["spans"]) == traced
        tracing.reset()
        out[traced] = (metrics, grads, {n: p.detach().clone() for n, p in model.head.named_parameters()})
    (m0, g0, p0), (m1, g1, p1) = out[False], out[True]
    assert m0.keys() == m1.keys() and all(torch.equal(m0[k], m1[k]) for k in m0)
    assert g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_name_gaps_names_a_gap_by_its_innermost_span():
    """Busy intervals around an outer span [0, 100) with an inner one [20, 60): each gap takes the name of
    the innermost span open at its start, a gap outside both ``OUTSIDE``, the longest first."""
    spans = [Span("fsar.inner", 2, 1, 0, 20, 60, 0, {}), Span("fsar.outer", 1, None, 0, 0, 100, 0, {})]
    busy = [(120, 130), (0, 10), (30, 35), (50, 55), (90, 95), (32, 34), (160, 170)]
    gaps = tracing.name_gaps(busy, spans)
    assert gaps == [("fsar.inner", 55, 35), (tracing.OUTSIDE, 130, 30), ("fsar.outer", 95, 25), ("fsar.outer", 10, 20),
                    ("fsar.inner", 35, 15)]
    assert tracing.name_gaps(busy, spans, top=1) == gaps[:1]
    assert tracing.name_gaps([(0, 5)], spans) == []


def test_spans_from_many_threads_keep_their_parents_and_steps():
    """16 threads (more than the cores) each open 200 outer spans with an inner one under a short switch
    interval: every span is kept once, every inner span's parent is its own thread's outer span, and it
    carries that span's step."""
    threads, rounds = 16, 200
    old = sys.getswitchinterval()
    tracing.reset()
    barrier = threading.Barrier(threads)

    def work(k: int) -> None:
        barrier.wait(timeout=30)
        for i in range(rounds):
            with tracing.span("fsar.outer", step=k * rounds + i):
                with tracing.span("fsar.inner", worker=k):
                    pass

    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording():
            pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    spans = tracing.collect()["spans"]
    tracing.reset()
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans) == 2 * threads * rounds
    inner = [s for s in spans if s.name == "fsar.inner"]
    assert len(inner) == threads * rounds
    for s in inner:
        outer = by_id[s.parent]
        assert outer.name == "fsar.outer" and outer.thread == s.thread and s.step == outer.step
        assert outer.step // rounds == s.attrs["worker"]


def test_span_names_are_the_programs():
    with pytest.raises(ValueError):
        tracing.setup_span("bn_chain")
    with tracing.recording(), pytest.raises(ValueError):
        tracing.span("pb.step")
    assert tracing.span("pb.step") is tracing.span("fsar.step")  # off: one shared object, nothing checked


def _store(step_ns: dict) -> list:
    """A hand-built store: spans of the given lengths by name, end to end on one thread, and the two set-up spans."""
    spans, ids = [], iter(range(1, 10_000))
    t = 0
    for name, totals in step_ns.items():
        for ns in totals:
            spans.append(Span(name, next(ids), None, 0, t, t + ns, 0, {}))
            t += ns
    return spans + [Span("fsar.setup.model", next(ids), None, None, 0, 2_000_000_000, 0, {}),
                    Span("fsar.setup.state", next(ids), None, None, 0, 500_000_000, 0, {})]


STORE = {
    "fsar.step": [100_000_000, 120_000_000],
    "fsar.tower": [30_000_000, 20_000_000, 40_000_000, 10_000_000],
    "fsar.forward": [50_000_000, 40_000_000, 60_000_000, 30_000_000],
    "fsar.backward": [7_000_000, 9_000_000, 4_000_000],
    "fsar.optimizer": [3_000_000, 5_000_000],
    "fsar.eval.fetch": [6_000_000, 2_000_000],
    "fsar.eval.account": [1_000_000, 1_500_000],
}
EXPECTED = {  # per step of the two: totals / 2, in ms; set-up in s
    "tower_issue_ms.train": 50.0, "tower_issue_ms.test": 50.0,
    "head_issue_ms.train": 40.0, "head_issue_ms.test": 40.0,
    "backward_issue_ms.train": 10.0, "optimizer_issue_ms.train": 4.0,
    "eval_fetch_ms.test": 4.0, "eval_account_ms.test": 1.25,
    "model_build_s": 2.5,
}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_each_span_metric_reads_the_store(metric, monkeypatch):
    """The benchmark's reader of each span metric against a hand-built store, and against an empty one (None)."""
    from portbench import harness

    names = {m["name"] for m in harness.benchmark()["per_layer"]}
    assert metric in names
    read = harness.load_module("metrics", metric).read
    ctx = {"kind": "test" if metric.endswith(".test") else "train"}
    monkeypatch.setattr(tracing, "_spans", _store(STORE))
    assert read(ctx) == pytest.approx(EXPECTED[metric], rel=1e-12)
    monkeypatch.setattr(tracing, "_spans", [])
    assert read(ctx) is None
