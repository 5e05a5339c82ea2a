"""The few-shot train step of clip_fsar_torch against clip_fsar_tpu, on
ViT-Tiny-Test (64 px, 4 frames, float32): three train steps from the same
converted weights and batches, the lr schedule, the parameter groups, and
the step's own invariants (episode chunks, accumulation, the NaN guard)."""

import contextlib
import copy
import dataclasses
import functools
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clip_fsar_torch.data.loader import build_few_shot_loader
from clip_fsar_torch.data.types import Episode
from clip_fsar_torch.models.builder import build_few_shot_model
from clip_fsar_torch.models.clip.convert import params_from_jax
from clip_fsar_torch.models.heads.clipfsar import CLIPFSARConfig, CLIPFSARHead
from clip_fsar_torch.train import optimizer as topt
from clip_fsar_torch.train.state import TrainState
from clip_fsar_torch.train.step import make_train_step
from tests.torch_parity import host_reads, jax_tiny_clip, pallas_interpret, port_head_state, tiny_cfg

torch.set_num_threads(2)

# lr 1e-3 from the first step (no warmup), one update per step, E = 2
TRAIN_OPTS = ["TRAIN.ENABLE", "True", "SOLVER.BASE_LR", "1e-3", "SOLVER.WARMUP_EPOCHS", "0", "TPU.EPISODES_PER_STEP", "2",
              "TRAIN.BATCH_SIZE_PER_TASK", "1"]


def train_cfg(*extra):
    return tiny_cfg(*TRAIN_OPTS, *extra)


def _port_batch(batch) -> Episode:
    return Episode(**{f.name: torch.from_numpy(np.array(getattr(batch, f.name))) for f in dataclasses.fields(Episode)})


@functools.lru_cache(maxsize=None)
def _jax_three_steps(pallas: bool = False):
    """Three JAX make_train_step steps (split attention layout, or flash_mha
    in Pallas interpret mode with ``pallas``) on three train batches from the
    JAX loader, with flax Dropout and the color jitter patched to identity.
    The optimizer is wrapped so that its state also carries the gradients it
    was given.  Returns (cfg, arch, clip_vars, model, batches, losses, grads
    per step, final params)."""
    with pallas_interpret() if pallas else contextlib.nullcontext():
        return _jax_steps(train_cfg("TPU.ATTENTION_LAYOUT", "split", "TPU.PALLAS_ATTENTION", str(pallas)))


def _jax_steps(cfg, steps: int = 3):
    from clip_fsar_tpu.data.loader import build_few_shot_loader as jloader
    from clip_fsar_tpu.models import builder as jbuilder
    from clip_fsar_tpu.train import step as jstep
    from clip_fsar_tpu.train.loop import build_state
    from clip_fsar_tpu.train.optimizer import build_optimizer, epoch_for_iter, get_lr_at_epoch

    _, arch, clip_vars = jax_tiny_clip()
    with mock.patch.object(jbuilder, "load_or_init_clip", return_value=(arch, clip_vars)):
        model = jbuilder.build_few_shot_model(cfg, jax.random.PRNGKey(0), flow="train")
    inner = build_optimizer(cfg, model.variables["params"], name_prefix="head")
    tx = optax.GradientTransformation(
        lambda p: (inner.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)),
        lambda g, s, p=None: (lambda u, s0: (u, (s0, g)))(*inner.update(g, s[0], p)),
    )
    state = build_state(cfg, model, tx)
    with jloader(cfg, "train", num_steps=steps, episodes_per_step=2) as loader:
        batches = list(loader)
    losses, grads = [], []
    with mock.patch.object(fnn.Dropout, "__call__", lambda self, x, *a, **k: x), \
            mock.patch("clip_fsar_tpu.data.augment.color_jitter_batch", lambda key, x, **kw: x):
        step = jax.jit(jstep.make_train_step(model.head, tx, cfg, model.text_train, model.text_test))
        for i, batch in enumerate(batches):
            state, metrics = step(state, batch, jnp.float32(get_lr_at_epoch(cfg, epoch_for_iter(cfg, i))), jax.random.PRNGKey(i))
            losses.append(float(metrics["loss"]))
            grads.append(params_from_jax({"params": jax.device_get(state.opt_state[1])}))
    return cfg, arch, clip_vars, model, batches, losses, grads, params_from_jax({"params": jax.device_get(state.params)})


@pytest.mark.parametrize("backend", ["fused", "plain", "pallas"])
def test_three_train_steps_match_jax(backend):
    """Three port train steps (attention through clip_mha's plain forward and
    backward, the plain mha, or flash_mha's plain forward and backward)
    against three JAX steps from the same converted weights and batches (the
    JAX steps with TPU.PALLAS_ATTENTION for ``pallas``, flash_mha's Pallas
    kernels in interpret mode), jitter and dropout off on both sides.
    Losses at 1e-4 and gradients at 2e-4 (fp32; measured 5e-7 and 2e-7).
    Parameters after the steps at atol 5e-4, half of one step at lr 1e-3:
    Adam divides each gradient by its own running RMS, so a gradient at
    rounding-noise level moves its parameter by up to lr either way on
    each side (the key bias's gradient is zero in exact arithmetic, since
    softmax ignores a shift of a whole row; measured worst 1.6e-4)."""
    cfg, arch, clip_vars, model, batches, want_losses, want_grads, want_params = _jax_three_steps(backend == "pallas")
    head = CLIPFSARHead(arch, CLIPFSARConfig.from_cfg(cfg), attention_backend=backend)
    assert_steps_match_jax(head, cfg, clip_vars, model, batches, want_losses, want_grads, want_params)


def port_steps(head, cfg, clip_vars, model, batches) -> tuple:
    """Port train steps on the JAX run's converted weights and batches (jitter and dropout off).
    Returns (start state, losses, gradients per step)."""
    start = {k: v for k, v in port_head_state(model, clip_vars).items() if not k.startswith("text.")}
    head.load_state_dict(start)
    state = TrainState.create(cfg, head, topt.Optimizer(cfg, head))
    grads = []
    inner_step = state.optimizer.inner.step

    def capture(*a, **k):
        grads.append({n: p.grad.clone() for n, p in head.named_parameters()})
        return inner_step(*a, **k)

    state.optimizer.inner.step = capture
    text = [torch.from_numpy(np.array(t)) for t in (model.text_train, model.text_test)]
    step = make_train_step(head, cfg, *text)
    losses = [step(state, _port_batch(b), topt.get_lr_at_epoch(cfg, topt.epoch_for_iter(cfg, i)), None)["loss"]
              for i, b in enumerate(batches)]
    return start, losses, grads


def assert_steps_match_jax(head, cfg, clip_vars, model, batches, want_losses, want_grads, want_params) -> tuple:
    """``port_steps`` held to the JAX run's losses (1e-4), gradients (2e-4) and final parameters (atol 5e-4,
    see test_three_train_steps_match_jax); returns the port's losses and gradients."""
    start, losses, grads = port_steps(head, cfg, clip_vars, model, batches)
    np.testing.assert_allclose(losses, want_losses, atol=1e-4, rtol=1e-4)
    for got, want in zip(grads, want_grads):
        for name, g in got.items():
            torch.testing.assert_close(g, want[name], atol=2e-4, rtol=2e-4, msg=lambda m, name=name: f"grad {name}: {m}")
    moved = 0.0
    for name, p in head.named_parameters():
        torch.testing.assert_close(p.detach(), want_params[name], atol=5e-4, rtol=0, msg=lambda m, name=name: f"param {name}: {m}")
        moved = max(moved, (p.detach() - start[name]).abs().max().item())
    assert moved > 1e-3  # the parameters did move
    return losses, grads


def test_lr_schedule_matches_jax():
    """get_lr_at_epoch and epoch_for_iter (the reference's quirk included)
    against the JAX functions, for the flagship's stepped schedule with
    warmup and for a cosine one; same arithmetic, so equal."""
    from clip_fsar_tpu.train import optimizer as jopt

    for extra in ([], ["SOLVER.LR_POLICY", "cosine", "SOLVER.MAX_EPOCH", "7", "SOLVER.WARMUP_EPOCHS", "2"], ["TRAIN.NUM_FOLDS", "2"]):
        cfg = tiny_cfg("TRAIN.ENABLE", "True", *extra)
        for it in (0, 1, 7, 349, 350, 351, 700, 1400, 2099, 2100, 3499, 4999):
            assert topt.epoch_for_iter(cfg, it) == jopt.epoch_for_iter(cfg, it)
            epoch = topt.epoch_for_iter(cfg, it)
            assert topt.get_lr_at_epoch(cfg, epoch) == jopt.get_lr_at_epoch(cfg, epoch)


def test_param_groups_match_jax():
    """Every parameter's group (and frozen flag) against the JAX
    param_groups(params, "head") / make_fixed_mask: each JAX leaf is filled
    with a constant coding its label and converted to the port's names (the
    converter only transposes and reshapes, so the constants survive)."""
    from clip_fsar_tpu.train import optimizer as jopt

    cfg, arch, _, model, *_ = _jax_three_steps(False)
    params = jax.device_get(model.variables["params"])
    head = CLIPFSARHead(arch, CLIPFSARConfig.from_cfg(cfg))
    names = [n for n, _ in head.named_parameters()]
    code = {"no_decay": 1.0, "bn": 2.0, "head": 3.0, "rest": 4.0}
    coded = params_from_jax({"params": jax.tree_util.tree_map(
        lambda p, g: np.full(np.shape(p), code[g], np.float32), params, jopt.param_groups(params, "head"))})
    groups = topt.param_groups(names, "head")
    assert set(coded) == set(names)
    for name in names:
        assert (coded[name] == code[groups[name]]).all(), name
    assert groups["backbone.transformer.resblocks.0.ln_1.weight"] == "head"  # CLIP LayerNorms are decayed
    assert groups["context2.norm_0.weight"] == "bn"  # the head's norm is not
    for key, value in (("FIXED_WEIGHTS", ["backbone"]), ("ONLY_LINEAR", True), ("FIXED_WEIGHTS", ["context2", "scale"])):
        fcfg = tiny_cfg()
        fcfg.TRAIN[key] = value
        flags = params_from_jax({"params": jax.tree_util.tree_map(
            lambda p, f: np.full(np.shape(p), float(f), np.float32), params, jopt.make_fixed_mask(params, fcfg, "head"))})
        frozen = topt.fixed_params(fcfg, names, "head")
        for name in names:
            assert (flags[name] == float(name in frozen)).all(), (key, name)
    opt = topt.Optimizer(train_cfg("BN.WEIGHT_DECAY", "0.5"), head)
    decay = {g["group"]: g["weight_decay"] for g in opt.inner.param_groups}
    assert decay == {"head": 5e-5, "bn": 0.5}


def _port_train(cfg):
    """Port model from the seed, a train step, and the state."""
    model = build_few_shot_model(cfg, flow="train", device="cpu")
    state = TrainState.create(cfg, model.head, topt.Optimizer(cfg, model.head))
    return model, state, make_train_step(model.head, cfg, model.text_train, model.text_test)


@functools.lru_cache(maxsize=None)
def _train_batch():
    """One train batch of E = 2 episodes (the port's loader)."""
    with build_few_shot_loader(train_cfg(), "train", num_steps=1, episodes_per_step=2) as loader:
        return _port_batch(next(iter(loader)))


def test_episode_chunks_and_accumulation_match_unchunked():
    """One update on two episodes three ways: in one pass; as
    TPU.EPISODE_CHUNKS 2 micro-batches; and as TRAIN.BATCH_SIZE_PER_TASK 2
    accumulation over two one-episode steps (no update after the first).
    SGD with momentum, so the update is linear in the gradient and the
    parameters compare at fp32 summation order (1e-6)."""
    batch = _train_batch()
    sgd = ["SOLVER.OPTIM_METHOD", "sgd"]
    one = lambda b, i: b.map(lambda x: x[i : i + 1])  # noqa: E731

    _, whole, step = _port_train(train_cfg(*sgd))
    assert step(whole, batch, 1e-3, None)["updated"]
    _, chunked, step = _port_train(train_cfg(*sgd, "TPU.EPISODE_CHUNKS", "2"))
    assert step(chunked, batch, 1e-3, None)["updated"]
    _, accum, step = _port_train(train_cfg(*sgd, "TRAIN.BATCH_SIZE_PER_TASK", "2", "TPU.EPISODES_PER_STEP", "1"))
    start = copy.deepcopy(accum.head.state_dict())
    assert not step(accum, one(batch, 0), 1e-3, None)["updated"]
    for name, v in accum.head.state_dict().items():
        assert torch.equal(v, start[name]), name  # the window is open: nothing moved
    assert step(accum, one(batch, 1), 1e-3, None)["updated"]

    want = whole.head.state_dict()
    for other in (chunked, accum):
        for name, v in other.head.state_dict().items():
            torch.testing.assert_close(v, want[name], atol=1e-6, rtol=1e-5, msg=lambda m, name=name: f"{name}: {m}")
    assert accum.step == 2 and accum.optimizer.mini_step == 0


def test_nan_guard_leaves_params_moments_and_window_untouched():
    """A step whose loss is not finite changes neither the parameters nor
    the Adam moments nor the open accumulation window; the step counter
    still advances."""
    batch = _train_batch()
    cfg = train_cfg("TRAIN.BATCH_SIZE_PER_TASK", "2")
    model, state, step = _port_train(cfg)
    nan_step = make_train_step(model.head, cfg, model.text_train * float("nan"), model.text_test)
    step(state, batch, 1e-3, None)
    assert step(state, batch, 1e-3, None)["updated"]  # moments are set
    step(state, batch, 1e-3, None)  # the window is open again
    before = copy.deepcopy((model.head.state_dict(), state.optimizer.state_dict()))
    metrics = nan_step(state, batch, 1e-3, None)
    assert metrics["nan_skipped"] == 1.0 and not metrics["updated"]
    after = (model.head.state_dict(), state.optimizer.state_dict())
    for name, v in after[0].items():
        assert torch.equal(v, before[0][name]), name
    assert after[1]["mini_step"] == before[1]["mini_step"] == 1
    for a, b in zip(after[1]["acc"], before[1]["acc"]):
        assert torch.equal(a, b)
    for key, moments in after[1]["inner"]["state"].items():
        for m in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(moments[m], before[1]["inner"]["state"][key][m]), (key, m)
    assert state.step == 4


def test_nan_step_on_the_closing_micro_step_keeps_the_window_open():
    """BATCH_SIZE_PER_TASK 2 with steps finite, NaN, finite: the NaN step
    would have closed the window by count, and must not.  Exactly one update
    happens, after the third step, and it is the update of a run that saw
    the two finite batches alone: parameters, moments and their step count
    are the same bits, and the window is closed with nothing in it."""
    batch = _train_batch()
    one = lambda i: batch.map(lambda x: x[i : i + 1])  # noqa: E731
    cfg = train_cfg("TRAIN.BATCH_SIZE_PER_TASK", "2", "TPU.EPISODES_PER_STEP", "1")
    model, state, step = _port_train(cfg)
    nan_step = make_train_step(model.head, cfg, model.text_train * float("nan"), model.text_test)
    updated = [bool(step(state, one(0), 1e-3, None)["updated"])]
    skipped = nan_step(state, one(1), 1e-3, None)
    updated.append(bool(skipped["updated"]))
    assert skipped["nan_skipped"] == 1.0 and int(state.optimizer.mini_step) == 1
    updated.append(bool(step(state, one(1), 1e-3, None)["updated"]))
    assert updated == [False, False, True]

    _, clean, clean_step = _port_train(cfg)
    assert [bool(clean_step(clean, one(i), 1e-3, None)["updated"]) for i in (0, 1)] == [False, True]
    for name, v in state.head.state_dict().items():
        assert torch.equal(v, clean.head.state_dict()[name]), name
    got, want = state.optimizer.state_dict(), clean.optimizer.state_dict()
    assert got["mini_step"] == want["mini_step"] == 0 and isinstance(got["mini_step"], int)
    for a, b in zip(got["acc"], want["acc"]):
        assert torch.equal(a, b) and not a.any()
    for key, moments in got["inner"]["state"].items():
        for m in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(moments[m], want["inner"]["state"][key][m]), (key, m)
        assert moments["step"] == 1
    assert (state.step, clean.step) == (3, 2)


@pytest.mark.parametrize("method", ["adam", "adamw", "sgd"])
def test_skipped_first_step_leaves_every_optimizer_untouched(method):
    """A NaN step before any update (no moments yet) with each optimizer:
    nothing moves, and the next finite step gives the update of a run that
    never saw the NaN step (SGD's momentum buffer included)."""
    batch = _train_batch()
    cfg = train_cfg("SOLVER.OPTIM_METHOD", method)
    model, state, step = _port_train(cfg)
    nan_step = make_train_step(model.head, cfg, model.text_train * float("nan"), model.text_test)
    start = copy.deepcopy(model.head.state_dict())
    assert not nan_step(state, batch, 1e-3, None)["updated"]
    for name, v in model.head.state_dict().items():
        assert torch.equal(v, start[name]), name
    assert step(state, batch, 1e-3, None)["updated"]
    _, clean, clean_step = _port_train(cfg)
    assert clean_step(clean, batch, 1e-3, None)["updated"]
    moved = 0.0
    for name, v in state.head.state_dict().items():
        assert torch.equal(v, clean.head.state_dict()[name]), name
        moved = max(moved, (v - start[name]).abs().max().item())
    assert moved > 1e-4


@pytest.mark.parametrize("k", [1, 2])
def test_train_step_reads_nothing_back_from_the_device(k):
    """Two train steps (jitter and dropout on, so the generator's draws are
    taken too), with and without an accumulation window: no value of any
    tensor is read from python inside them -- the metrics, the NaN guard's
    flag and the window's count stay tensors -- and the metrics come back as
    0-dim tensors the caller may fetch when it logs."""
    batch = _train_batch()
    model, state, step = _port_train(train_cfg("TRAIN.BATCH_SIZE_PER_TASK", str(k)))
    with host_reads() as reads:
        for i in range(2):
            metrics = step(state, batch, 1e-3, torch.Generator().manual_seed(i))
    assert reads == []
    assert set(metrics) == {"loss", "ce", "top1", "updated", "nan_skipped"}
    for name, v in metrics.items():
        assert isinstance(v, torch.Tensor) and v.dim() == 0, name
    assert metrics["updated"].dtype == torch.bool and bool(metrics["updated"]) and metrics["nan_skipped"] == 0.0
    assert isinstance(state.optimizer.mini_step, torch.Tensor) and state.step == 2


def test_optimizer_clipping_lr_reduce_and_wb_lock():
    """The chain's other stages on a two-parameter module, with plain SGD so
    the update is -lr * scale * clipped gradient: TRAIN.CLIP_GRAD_NORM
    scales by clip / global norm (optax.clip_by_global_norm), LR_REDUCE
    with FINE_TUNE gives the 'bn' group 1/10 of the lr and leaves 'head'
    alone, and BN.WB_LOCK freezes the 'bn' group."""

    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.backbone = torch.nn.Linear(2, 1, bias=False)  # "head.backbone.weight": group 'head'
            self.norm_0 = torch.nn.Linear(1, 1, bias=False)  # "head.norm_0.weight": group 'bn'

    for wb_lock in (False, True):
        cfg = train_cfg("SOLVER.OPTIM_METHOD", "sgd", "SOLVER.MOMENTUM", "0.0", "SOLVER.NESTEROV", "False", "SOLVER.WEIGHT_DECAY", "0.0",
                        "TRAIN.LR_REDUCE", "True", "TRAIN.FINE_TUNE", "True", "BN.WB_LOCK", str(wb_lock))
        cfg.TRAIN["CLIP_GRAD_NORM"] = 1.0
        mod = Tiny()
        before = {n: p.detach().clone() for n, p in mod.named_parameters()}
        grads = {"backbone.weight": torch.tensor([[3.0, 0.0]]), "norm_0.weight": torch.tensor([[4.0]])}  # global norm 5
        for n, p in mod.named_parameters():
            p.grad = grads[n].clone()
        opt = topt.Optimizer(cfg, mod)
        assert opt.step(0.5)
        for n, p in mod.named_parameters():
            scale = 0.0 if (wb_lock and n.startswith("norm")) else (0.1 if n.startswith("norm") else 1.0)
            torch.testing.assert_close(p.detach(), before[n] - 0.5 * scale * grads[n] / 5.0, atol=1e-7, rtol=0)
