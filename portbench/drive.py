"""The system under test, assembled from the benchmark's inputs and driven over the window.

The port (``clip_fsar_torch``) is imported here, in ``trace.bn_ranges``, in ``faults`` and in each
family's ``build_head`` (``portbench/families/<family>.py``), which builds the configuration's head
at its widths; the head takes the benchmark's weights, and its frame banks are the benchmark's
pixels under a ``FrameBankTable`` of the benchmark's table.

Train cells drive the loop body of ``train.loop.train_few_shot`` (validation and checkpoints
left out): the loader with ``TrainIndexEpisodeSampler``, ``Episode.to``, ``make_train_step``'s
step with ``step_generator`` and ``get_lr_at_epoch``, the metrics fetched every LOG_PERIOD
steps in one read.  The same loader, step and state serve set-up and window: set-up runs the
first steps (one optimizer window), reads what the correctness check needs, and the window
goes on from there.  ``train_few_shot`` builds its own model and bank and runs a fixed number of
steps, so it cannot be handed the benchmark's inputs or timed over a window.

Test cells call ``train.loop.evaluate`` with the bank, in chunks of a fixed number of episodes,
until the window has passed; each chunk's episodes are drawn from their own sampler seed.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.inputs import Inputs
from portbench.judge import norms, unpacked

BIG = 1 << 30  # loader steps: the window decides how many are taken


def _config(cfg: dict):
    from clip_fsar_torch.config.config import Config

    return Config(cfg)


def frame_bank(inputs: Inputs):
    """The benchmark's pixels and table as the port's ``FrameBank``."""
    from clip_fsar_torch.data.frame_bank import FrameBank, FrameBankTable

    t = inputs.table
    table = FrameBankTable(orig_idx=t["orig_idx"], nframes=t["nframes"], length=t["length"], fps=t["fps"],
                           row_of_path={p: i for i, p in enumerate(t["paths"])}, frames_per_video=t["frames"])
    return FrameBank(pixels=inputs.bank, table=table, build_seconds=0.0, upload_seconds=0.0)


def head_shapes(cfg: dict, device, family) -> Dict[str, tuple]:
    """Names and shapes of the port's head state dict at the configuration's widths."""
    with torch.device("meta"):
        head = family.build_head(_config(cfg), torch.device(device))
    return {k: tuple(v.shape) for k, v in head.state_dict().items()}


def build_model(inputs: Inputs, flow: str, device, family):
    """The port's FewShotModel holding the benchmark's weights and text banks."""
    from clip_fsar_torch.models.builder import FewShotModel

    from clip_fsar_torch import runtime

    cfg = _config(inputs.cfg)
    device = runtime.device(str(device))  # as the port's entry takes it: float32 products in float32 (TF32 off)
    with torch.device(device):
        head = family.build_head(cfg, device)
    head.load_state_dict(inputs.weights)
    head.to(device).train(flow == "train")
    return FewShotModel(head=head, text_train=inputs.text_train, text_test=inputs.text_test)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Host-clock spans by name, and the same spans as profiler ranges while one records."""

    def __init__(self):
        self.ms: Dict[str, List[float]] = {}
        self.on = True

    @contextlib.contextmanager
    def __call__(self, name: str):
        with torch.profiler.record_function("pb." + name):
            t0 = time.perf_counter()
            yield
            dt = time.perf_counter() - t0
        if self.on:
            self.ms.setdefault(name, []).append(dt * 1e3)


# ---------------------------------------------------------------------------- training


class TrainRun:
    """The train loop's body over one loader, step and state (see the module docstring)."""

    def __init__(self, inputs: Inputs, device, spans: Spans, family):
        from clip_fsar_torch.data.frame_bank import TrainIndexEpisodeSampler
        from clip_fsar_torch.data.loader import build_few_shot_loader
        from clip_fsar_torch.train.optimizer import Optimizer
        from clip_fsar_torch.train.state import TrainState
        from clip_fsar_torch.train.step import make_train_step

        self.cfg = _config(inputs.cfg)
        self.device = torch.device(device)
        self.spans = spans
        self.e = int(self.cfg.TPU.EPISODES_PER_STEP)
        self.model = build_model(inputs, "train", device, family)
        self.state = TrainState.create(self.cfg, self.model.head, Optimizer(self.cfg, self.model.head))
        self.bank = bank = frame_bank(inputs)
        self.step_fn = make_train_step(self.model.head, self.cfg, self.model.text_train, self.model.text_test, bank.pixels)
        self.loader = build_few_shot_loader(self.cfg, "train", num_steps=BIG, episodes_per_step=self.e,
                                            sampler_wrap=lambda s: TrainIndexEpisodeSampler(s, bank.table))
        self.batches = iter(self.loader)
        self.cur = 0
        self.pending: List[Dict[str, torch.Tensor]] = []
        self.losses: List[float] = []
        self.log_period = int(self.cfg.get("LOG_PERIOD", 10))

    def step(self):
        """One iteration of the loop body; returns the host batch it trained on."""
        from clip_fsar_torch.train.loop import step_generator
        from clip_fsar_torch.train.optimizer import epoch_for_iter, get_lr_at_epoch

        with self.spans("loader_wait"):
            batch = next(self.batches)
        lr = get_lr_at_epoch(self.cfg, epoch_for_iter(self.cfg, self.cur))
        with self.spans("h2d"):
            on_device = batch.to(self.device, non_blocking=True)
        with self.spans("issue"):
            self.pending.append(self.step_fn(self.state, on_device, lr, step_generator(self.cfg, self.cur, self.device)))
        self.cur += 1
        if self.cur % self.log_period == 0:
            self.fetch()
        return batch

    def fetch(self) -> None:
        """The pending steps' metrics in one read, as the loop's ``fetch`` does."""
        if not self.pending:
            return
        with self.spans("fetch"):
            rows = torch.stack([torch.stack([m["loss"], m["top1"], m["updated"].to(m["loss"].dtype)]) for m in self.pending]).tolist()
        self.pending.clear()
        self.losses.extend(r[0] for r in rows)

    def close(self) -> None:
        self.loader.close()


def train_setup(run: TrainRun, warm_steps: int, w0: Dict[str, torch.Tensor]) -> dict:
    """The first ``warm_steps`` steps through the loop body: every shape the window uses, one
    whole optimizer window.  Returns what the correctness check reads of them: the host
    batches, each step's loss, the first gradient as the optimizer holds it after one step,
    Adam's moments after the last, and each leaf's change after the last (its norm, and the
    tensor on the host)."""
    named = [(n, p) for n, p in run.model.head.named_parameters() if p.requires_grad]
    batches, first_grad = [], None
    for i in range(warm_steps):
        batches.append(run.step())
        if i == 0:
            acc = run.state.optimizer.acc  # the accumulation window's sums: the first gradient after one step
            grads = {n: a for (n, _), a in zip(named, acc)} if acc is not None else {n: p.grad for n, p in named if p.grad is not None}
            never = {n: torch.zeros_like(p) for n, p in named}  # a leaf the optimizer never got reads 0
            first_grad = norms(unpacked(never | grads))
    run.fetch()
    _sync(run.device)
    state = run.state.optimizer.inner.state  # torch's Adam: exp_avg, exp_avg_sq by parameter; none where it never stepped
    moment = {key: norms(unpacked({n: state[p][key] if key in state.get(p, {}) else torch.zeros_like(p) for n, p in named}))
              for key in ("exp_avg", "exp_avg_sq")}
    change = unpacked({n: p.detach().cpu() - w0[n] for n, p in named})
    return {"batches": batches, "losses": list(run.losses), "first_grad": first_grad, "moment": moment["exp_avg"],
            "moment2": moment["exp_avg_sq"], "change": norms(change), "change_t": change}


def train_window(run: TrainRun, seconds: float, profile_steps: int = 0, profiler_factory=None) -> dict:
    """Steps until ``seconds`` have passed, then the last fetch, which waits for the card.
    With ``profile_steps`` the first that many steps run under ``profiler_factory()`` (a
    traced run); the window's remainder is then timed from the card's idle point after them."""
    prof = None
    t0 = time.perf_counter()
    steps = 0
    if profile_steps:
        run.spans.on = False
        with profiler_factory() as prof:
            for _ in range(profile_steps):
                with torch.profiler.record_function("pb.step"):
                    run.step()
                steps += 1
            run.fetch()
            _sync(run.device)
        run.spans.on = True
    t_rest, steps_rest = time.perf_counter(), steps
    while time.perf_counter() - t0 < seconds:
        run.step()
        steps += 1
    run.fetch()
    _sync(run.device)
    t1 = time.perf_counter()
    return {"seconds": t1 - t0, "steps": steps, "samples": steps * run.e, "prof": prof,
            "rest_seconds": t1 - t_rest, "rest_samples": (steps - steps_rest) * run.e}


# ---------------------------------------------------------------------------- test protocol


def chunk_seed(seed: int, chunk: int) -> int:
    """The sampler seed (RANDOM_SEED) of a window's ``chunk``-th evaluate call."""
    return int(seed) * 1000 + chunk


class TestRun:
    """``evaluate`` over the benchmark's bank, in chunks of episodes."""

    def __init__(self, inputs: Inputs, device, spans: Spans, family):
        self.inputs = inputs
        self.device = torch.device(device)
        self.spans = spans
        self.e = int(inputs.cfg["TEST"]["BATCH_SIZE"])
        self.model = build_model(inputs, "test", device, family)
        self.bank = frame_bank(inputs)
        self.seed = int(inputs.cfg["RANDOM_SEED"])
        self.logits: List[np.ndarray] = []  # per chunk [n, Q, WAY]
        self.step_wrap = None  # the CPU tests' faults: a function of the eval step

    def chunk(self, index: int, episodes: int, keep: bool = True) -> int:
        """One ``evaluate`` call of ``episodes`` episodes with chunk ``index``'s sampler seed;
        returns the episodes it counted."""
        from clip_fsar_torch.train.loop import evaluate

        cfg = dict(self.inputs.cfg, RANDOM_SEED=chunk_seed(self.seed, index))
        with _step_spans(self.spans, self.step_wrap):
            out = evaluate(_config(cfg), self.model, episodes, self.e, split="test", device=self.device, bank=self.bank)
        if keep:
            self.logits.append(out["episode_logits"])
        return int(out["episodes"])

    def close(self) -> None:
        pass


@contextlib.contextmanager
def _step_spans(spans: Spans, wrap=None):
    """Inside ``evaluate``: the wait for each batch of its loader (``loader_wait``) and each
    call of its eval step (``issue``), timed from outside the port; ``wrap`` (the CPU tests'
    faults) wraps the eval step."""
    from unittest import mock

    from clip_fsar_torch.train import loop

    build_loader, make_step = loop.build_few_shot_loader, loop.make_eval_step

    class Timed:
        def __init__(self, inner):
            self.inner = inner

        def __enter__(self):
            self.inner.__enter__()
            return self

        def __exit__(self, *exc):
            return self.inner.__exit__(*exc)

        def __iter__(self):
            it = iter(self.inner)
            while True:
                with spans("loader_wait"):
                    batch = next(it, None)
                if batch is None:
                    return
                yield batch

    def timed_loader(*args, **kwargs):
        return Timed(build_loader(*args, **kwargs))

    def timed_step(*args, **kwargs):
        step = make_step(*args, **kwargs)
        step = wrap(step) if wrap is not None else step

        def call(batch):
            with spans("issue"):
                return step(batch)

        return call

    with mock.patch.object(loop, "build_few_shot_loader", timed_loader), mock.patch.object(loop, "make_eval_step", timed_step):
        yield


def test_window(run: TestRun, seconds: float, chunk_episodes: int, profile_episodes: int = 0, profiler_factory=None) -> dict:
    """``evaluate`` chunks until ``seconds`` have passed: every episode of every call over all
    their time.  With ``profile_episodes`` a first call of that many episodes runs under the
    profiler (a traced run)."""
    prof = None
    t0 = time.perf_counter()
    episodes, index = 0, 0
    if profile_episodes:
        run.spans.on = False
        with profiler_factory() as prof:
            with torch.profiler.record_function("pb.step"):
                episodes += run.chunk(index, profile_episodes)
            _sync(run.device)
        run.spans.on = True
        index += 1
    t_rest, eps_rest = time.perf_counter(), episodes
    while time.perf_counter() - t0 < seconds:
        episodes += run.chunk(index, chunk_episodes)
        index += 1
    _sync(run.device)
    t1 = time.perf_counter()
    return {"seconds": t1 - t0, "samples": episodes, "chunks": index, "prof": prof,
            "rest_seconds": t1 - t_rest, "rest_samples": episodes - eps_rest}


def redraw_test_episodes(inputs: Inputs, e: int, picks: List[tuple]) -> List[dict]:
    """The episodes (chunk, episode) that a chunk's sampler drew, drawn again by a fresh
    sampler of that chunk's seed: bank rows [N, T] and labels, as host arrays."""
    from clip_fsar_torch.data.datasets import DATASET_REGISTRY
    from clip_fsar_torch.data.frame_bank import IndexEpisodeSampler

    bank = frame_bank(inputs)
    out = []
    for chunk, i in picks:
        cfg = _config(dict(inputs.cfg, RANDOM_SEED=chunk_seed(int(inputs.cfg["RANDOM_SEED"]), chunk)))
        name = cfg.TEST.get("DATASET", cfg.TRAIN.DATASET)
        sampler = IndexEpisodeSampler(DATASET_REGISTRY.get(name)(cfg, "test").make_sampler(0), bank.table)
        sampler.reseed_for_slot(i // e, i % e)
        epi = sampler.sample_episode()
        out.append({"support": epi.support_images, "target": epi.target_images, "support_labels": epi.support_labels,
                    "target_labels": epi.target_labels, "real_support": epi.real_support_labels,
                    "real_target": epi.real_target_labels})
    return out


def host_batch(batch) -> dict:
    """A train batch's host arrays under the reference's names."""
    return {"support": batch.support_images, "target": batch.target_images, "support_labels": batch.support_labels,
            "target_labels": batch.target_labels, "real_support": batch.real_support_labels, "real_target": batch.real_target_labels}


def free() -> None:
    """Give the memory of the program's dropped objects back to the card."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def pick_logits(logits: List[np.ndarray], picks: List[tuple]) -> List[np.ndarray]:
    return [logits[c][i] for c, i in picks]


def pick_episodes(logits: List[np.ndarray], n: int, seed: int) -> List[tuple]:
    """``n`` (chunk, episode) pairs of the window's, drawn from ``seed``."""
    flat = [(c, i) for c, chunk in enumerate(logits) for i in range(len(chunk))]
    rng = np.random.default_rng((int(seed), 7))
    take = rng.choice(len(flat), size=min(n, len(flat)), replace=False)
    return [flat[k] for k in sorted(take)]

