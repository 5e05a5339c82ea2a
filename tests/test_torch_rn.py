"""The RN CLIP towers of clip_fsar_torch against clip_fsar_tpu, on
RN-Tiny-Test (64 px, 4 frames, float32) with random BatchNorm running stats:
the tower in eval and in train mode, the head, three BN-live train steps in
two episode chunks with the running stats after each, the NaN guard and
BN.FREEZE, the parameter groups, the converters and checkpoints, the CLI
on the flagship config, and the names and shapes of every RN arch."""

import contextlib
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

from clip_fsar_torch.data.types import Episode
from clip_fsar_torch.models.clip import convert
from clip_fsar_torch.models.clip.arch import ARCHS
from clip_fsar_torch.models.clip.model import BatchNorm, ModifiedResNet, build_vision_tower
from clip_fsar_torch.models.heads.clipfsar import CLIPFSARConfig, CLIPFSARHead
from clip_fsar_torch.train import optimizer as topt
from clip_fsar_torch.train.state import TrainState
from clip_fsar_torch.train.step import make_train_step
from tests.torch_parity import (
    CONFIG,
    host_reads,
    jax_tiny_clip,
    jax_tiny_model,
    openai_state_dict,
    port_clip_state,
    port_head_state,
    tiny_cfg,
)

torch.set_num_threads(2)

RN = "RN-Tiny-Test"
# lr 1e-3 from the first step, one update per step, E = 2 in two chunks of one episode; SGD with the
# flagship's Nesterov momentum, whose update is linear in the gradient (Adam turns a gradient element at
# rounding-noise level into a step of lr either way, and the next step's batch statistics see it)
TRAIN_OPTS = ["VIDEO.HEAD.BACKBONE_NAME", RN, "TRAIN.ENABLE", "True", "SOLVER.BASE_LR", "1e-3", "SOLVER.WARMUP_EPOCHS", "0",
              "TPU.EPISODES_PER_STEP", "2", "TPU.EPISODE_CHUNKS", "2", "TRAIN.BATCH_SIZE_PER_TASK", "1", "SOLVER.OPTIM_METHOD", "sgd",
              "TRAIN.QUERY_PER_CLASS", "1"]


def _rn_cfg(*extra):
    return tiny_cfg(*TRAIN_OPTS, *extra)


def _jax_tower(arch):
    from clip_fsar_tpu.models.clip.model import ModifiedResNet as JRN

    return JRN(layers=arch.vision_layers, output_dim=arch.embed_dim, heads=arch.vision_heads, input_resolution=arch.image_resolution,
               width=arch.vision_width)


def _port_tower(arch, clip_vars) -> ModifiedResNet:
    tower = build_vision_tower(arch)
    tower.load_state_dict({k[len("backbone."):]: v for k, v in port_clip_state(clip_vars).items() if k.startswith("backbone.")})
    return tower


def _stats(sd):
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


def test_tower_eval_matches_jax():
    """ModifiedResNet on the running stats (random, not 0 and 1), NHWC
    input, fp32 at 1e-4."""
    _, arch, clip_vars = jax_tiny_clip(RN)
    imgs = np.random.RandomState(1).randn(3, 64, 64, 3).astype(np.float32)
    variables = {"params": clip_vars["params"]["visual"], "batch_stats": clip_vars["batch_stats"]["visual"]}
    want = np.asarray(jax.jit(_jax_tower(arch).apply)(variables, imgs))
    with torch.no_grad():
        got = _port_tower(arch, clip_vars)(torch.from_numpy(imgs)).numpy()
    assert got.shape == (3, arch.embed_dim)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_tower_train_mode_matches_jax():
    """Batch-stat BatchNorm against ``apply(..., train=True,
    mutable=["batch_stats"])``: two groups in one port call against two JAX
    calls of one episode each, outputs at 1e-4 and each group's updated
    running stats at 1e-5; a second call continues from the first's stats,
    as a flax target call does from its support call."""
    _, arch, clip_vars = jax_tiny_clip(RN)
    imgs = np.random.RandomState(2).randn(4, 64, 64, 3).astype(np.float32)
    more = np.random.RandomState(3).randn(4, 64, 64, 3).astype(np.float32)
    variables = {"params": clip_vars["params"]["visual"], "batch_stats": clip_vars["batch_stats"]["visual"]}
    tower = _port_tower(arch, clip_vars)
    got = tower(torch.from_numpy(imgs), bn_groups=2)
    got_again = tower(torch.from_numpy(more), bn_groups=2)
    run = jax.jit(lambda v, x: _jax_tower(arch).apply(v, x, train=True, mutable=["batch_stats"]))
    for g in range(2):
        want, mutated = run(variables, imgs[2 * g : 2 * g + 2])
        want_again, mutated_again = run({**variables, **mutated}, more[2 * g : 2 * g + 2])
        np.testing.assert_allclose(got[2 * g : 2 * g + 2].detach().numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got_again[2 * g : 2 * g + 2].detach().numpy(), np.asarray(want_again), atol=1e-4, rtol=1e-4)
        new = _stats(convert.params_from_jax({"params": {"backbone": variables["params"], "context2": {}, "scale": np.ones(1)},
                                              "batch_stats": {"backbone": jax.device_get(mutated_again["batch_stats"])}}))
        for name, m in tower.named_modules():
            if isinstance(m, BatchNorm):
                for i, key in enumerate(("running_mean", "running_var")):
                    np.testing.assert_allclose(m.step_stats[g, i].numpy(), new[f"backbone.{name}.{key}"].numpy(), atol=1e-5, rtol=1e-5,
                                               err_msg=f"{name}.{key} group {g}")
    # the buffers themselves are written only by the train step
    assert all(torch.equal(v, _port_tower(arch, clip_vars).state_dict()[k]) for k, v in _stats(tower.state_dict()).items())


def _episodes(num=2, way=5, frames=4, res=64, text_rows=10, seed=0):
    from tests.test_torch_head import _episodes as make

    return make(num, way, frames, res, text_rows, seed)


def test_head_eval_matches_jax():
    """Head logits and class logits of two episodes on the running stats,
    against the JAX head vmapped over them, fp32 at 1e-4."""
    from clip_fsar_tpu.data.types import Episode as JEpisode

    cfg, arch, clip_vars, model = jax_tiny_model(backbone=RN)
    batch = _episodes()
    run = jax.jit(jax.vmap(lambda ep: model.head.apply(model.variables, ep, model.text_train, model.text_test, train=False)))
    want = run(JEpisode(**{k: jnp.asarray(v) for k, v in batch.items()}))
    head = CLIPFSARHead(arch, CLIPFSARConfig.from_cfg(cfg), train_backbone_bn=True)
    head.load_state_dict({k: v for k, v in port_head_state(model, clip_vars).items() if not k.startswith("text.")})
    text = [torch.from_numpy(np.array(t)) for t in (model.text_train, model.text_test)]
    with torch.no_grad():
        got = head(Episode(**{k: torch.from_numpy(v) for k, v in batch.items()}), *text)
    for key in ("logits", "class_logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4, rtol=1e-4)


def _port_batch(batch) -> Episode:
    return Episode(**{f.name: torch.from_numpy(np.array(getattr(batch, f.name))) for f in dataclasses.fields(Episode)})


@contextlib.contextmanager
def _smooth_relu():
    """ReLU -> x * sigmoid(4x) in both packages' towers.  With ReLU, an
    activation that lies within the two packages' float32 rounding of 0
    (their BatchNorm reductions sum in different orders) takes the other
    branch on one side and moves a gradient by its whole upstream value; a
    train step of the tiny RN has millions of activations and a few of them
    are that close to 0.  A smooth activation leaves every gradient
    continuous in the roundings, so the comparison sees the rest of the
    step: both BatchNorm modes, the two tower calls, the chunks, the
    running-stat update."""
    with mock.patch.object(fnn, "relu", lambda x: x * jax.nn.sigmoid(4.0 * x)), \
            mock.patch.object(torch.nn.functional, "relu", lambda x, inplace=False: x * torch.sigmoid(4.0 * x)):
        yield


@functools.lru_cache(maxsize=None)
def _jax_three_steps(freeze: bool):
    """Three JAX make_train_step steps on RN-Tiny-Test (E = 2 in two chunks,
    BatchNorm live unless ``freeze``) with dropout and the color jitter off.
    Returns (cfg, arch, clip_vars, model, batches, losses, grads per step,
    running stats per step as port entries), the steps under
    ``_smooth_relu``."""
    from clip_fsar_tpu.data.loader import build_few_shot_loader as jloader
    from clip_fsar_tpu.models import builder as jbuilder
    from clip_fsar_tpu.train import step as jstep
    from clip_fsar_tpu.train.loop import build_state
    from clip_fsar_tpu.train.optimizer import build_optimizer, epoch_for_iter, get_lr_at_epoch

    cfg = _rn_cfg("BN.FREEZE", str(freeze))
    _, arch, clip_vars = jax_tiny_clip(RN)
    with mock.patch.object(jbuilder, "load_or_init_clip", return_value=(arch, clip_vars)):
        model = jbuilder.build_few_shot_model(cfg, jax.random.PRNGKey(0), flow="train")
    inner = build_optimizer(cfg, model.variables["params"], name_prefix="head")
    tx = optax.GradientTransformation(
        lambda p: (inner.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)),
        lambda g, s, p=None: (lambda u, s0: (u, (s0, g)))(*inner.update(g, s[0], p)),
    )
    state = build_state(cfg, model, tx)
    with jloader(cfg, "train", num_steps=3, episodes_per_step=2) as loader:
        batches = list(loader)
    losses, grads, stats = [], [], []
    with mock.patch.object(fnn.Dropout, "__call__", lambda self, x, *a, **k: x), \
            mock.patch("clip_fsar_tpu.data.augment.color_jitter_batch", lambda key, x, **kw: x), _smooth_relu():
        step = jax.jit(jstep.make_train_step(model.head, tx, cfg, model.text_train, model.text_test))
        for i, batch in enumerate(batches):
            state, metrics = step(state, batch, jnp.float32(get_lr_at_epoch(cfg, epoch_for_iter(cfg, i))), jax.random.PRNGKey(i))
            losses.append(float(metrics["loss"]))
            grads.append(convert.params_from_jax({"params": jax.device_get(state.opt_state[1])}))
            stats.append(_stats(convert.params_from_jax({"params": jax.device_get(state.params), "batch_stats": jax.device_get(state.batch_stats)})))
    return cfg, arch, clip_vars, model, batches, losses, grads, stats


def _port_state(cfg, arch, clip_vars, model, freeze: bool):
    head = CLIPFSARHead(arch, CLIPFSARConfig.from_cfg(cfg), train_backbone_bn=not freeze)
    head.load_state_dict({k: v for k, v in port_head_state(model, clip_vars).items() if not k.startswith("text.")})
    state = TrainState.create(cfg, head, topt.Optimizer(cfg, head))
    text = [torch.from_numpy(np.array(t)) for t in (model.text_train, model.text_test)]
    return head, state, text


@pytest.mark.parametrize("freeze", [False, True], ids=["bn_live", "bn_freeze"])
def test_three_train_steps_match_jax(freeze):
    """Three port train steps against three JAX steps from the same weights
    and batches, E = 2 in EPISODE_CHUNKS 2: losses at 1e-4, gradients at
    2e-4 and the running stats after every step at 1e-5.  BN live, each
    episode's support and target calls move the stats from the step's start
    (0.81 r0 + 0.09 m_s + 0.1 m_t, averaged over the episodes); under
    BN.FREEZE the towers run on the running stats, which never move.  Both
    packages' towers run a smooth activation in place of ReLU here
    (``_smooth_relu``); the tower tests and the CLI drive run ReLU."""
    cfg, arch, clip_vars, model, batches, want_losses, want_grads, want_stats = _jax_three_steps(freeze)
    head, state, text = _port_state(cfg, arch, clip_vars, model, freeze)
    start = _stats({k: v.clone() for k, v in head.state_dict().items()})
    grads = []
    inner_step = state.optimizer.inner.step

    def capture(*a, **k):
        grads.append({n: p.grad.clone() for n, p in head.named_parameters()})
        return inner_step(*a, **k)

    state.optimizer.inner.step = capture
    step = make_train_step(head, cfg, *text)
    losses = []
    for i, batch in enumerate(batches):
        with _smooth_relu():
            losses.append(step(state, _port_batch(batch), topt.get_lr_at_epoch(cfg, topt.epoch_for_iter(cfg, i)), None)["loss"])
        got = _stats(head.state_dict())
        assert set(got) == set(want_stats[i]) and len(got) == 2 * 19  # 3 stem, 3 x 4 blocks, 4 shortcuts
        for name, v in got.items():
            torch.testing.assert_close(v, want_stats[i][name], atol=1e-5, rtol=1e-5, msg=lambda m, name=name, i=i: f"step {i} {name}: {m}")
            assert torch.equal(v, start[name]) == freeze, name
    np.testing.assert_allclose(losses, want_losses, atol=1e-4, rtol=1e-4)
    for got, want in zip(grads, want_grads):
        for name, g in got.items():
            torch.testing.assert_close(g, want[name], atol=2e-4, rtol=2e-4, msg=lambda m, name=name: f"grad {name}: {m}")


@pytest.mark.parametrize("freeze", [False, True])
def test_bn_freeze_reaches_the_head_through_the_builder(freeze):
    """BN.FREEZE as the JAX builder reads it (builder.py:341-352): off, the head's train branch runs the
    RN tower on batch statistics; on, on the running stats."""
    from clip_fsar_torch.models.builder import build_few_shot_model

    head = build_few_shot_model(_rn_cfg("BN.FREEZE", str(freeze)), flow="train", device="cpu").head
    assert head.train_backbone_bn is not freeze and isinstance(head.backbone, ModifiedResNet)


def test_non_finite_step_keeps_the_running_stats():
    """A finite step moves the running stats; a step whose loss is not
    finite (a NaN text bank) leaves them, and the parameters, as they were."""
    cfg, arch, clip_vars, model, batches, *_ = _jax_three_steps(False)
    head, state, text = _port_state(cfg, arch, clip_vars, model, freeze=False)
    start = _stats({k: v.clone() for k, v in head.state_dict().items()})
    make_train_step(head, cfg, *text)(state, _port_batch(batches[0]), 1e-3, None)
    before = {k: v.clone() for k, v in head.state_dict().items()}
    assert all(not torch.equal(before[k], v) for k, v in start.items())
    metrics = make_train_step(head, cfg, text[0] * float("nan"), text[1])(state, _port_batch(batches[1]), 1e-3, None)
    assert metrics["nan_skipped"] == 1.0
    for name, v in head.state_dict().items():
        assert torch.equal(v, before[name]), name
    assert all(m.step_stats is None for m in head.modules() if isinstance(m, BatchNorm))


@pytest.mark.parametrize("k", [1, 2])
def test_bn_live_train_step_reads_nothing_back(k):
    """Two BN-live train steps with jitter and dropout on, with and without
    an accumulation window: no tensor value is read from python, the
    running-stat update included."""
    cfg, arch, clip_vars, model, batches, *_ = _jax_three_steps(False)
    cfg = _rn_cfg("TRAIN.BATCH_SIZE_PER_TASK", str(k))
    head, state, text = _port_state(cfg, arch, clip_vars, model, freeze=False)
    step = make_train_step(head, cfg, *text)
    batch = _port_batch(batches[0])
    with host_reads() as reads:
        for i in range(2):
            step(state, batch, 1e-3, torch.Generator().manual_seed(i))
    assert reads == []


def test_param_groups_match_jax():
    """Every RN parameter's group against the JAX param_groups(params,
    "head") leaf by leaf (a constant coding each label, through the
    converter), the shortcut's BatchNorm (OpenAI's ``downsample.1``) in
    'bn' with BN.WEIGHT_DECAY, its conv in 'head'."""
    from clip_fsar_tpu.train import optimizer as jopt

    cfg, arch, _, model = jax_tiny_model(backbone=RN)
    params = jax.device_get(model.variables["params"])
    head = CLIPFSARHead(arch, CLIPFSARConfig.from_cfg(cfg))
    names = [n for n, _ in head.named_parameters()]
    code = {"no_decay": 1.0, "bn": 2.0, "head": 3.0, "rest": 4.0}
    coded = convert.params_from_jax({"params": jax.tree_util.tree_map(
        lambda p, g: np.full(np.shape(p), code[g], np.float32), params, jopt.param_groups(params, "head"))})
    decay = convert.params_from_jax({"params": jax.tree_util.tree_map(
        lambda p, d: np.full(np.shape(p), float(d), np.float32), params, jopt.make_decay_mask(params, "head"))})
    groups = topt.param_groups(names, "head")
    assert set(coded) == set(names)
    for name in names:
        assert (coded[name] == code[groups[name]]).all(), name
        assert (decay[name] == float(groups[name] in ("rest", "head"))).all(), name
    assert groups["backbone.layer1.0.downsample.1.weight"] == "bn" and groups["backbone.layer1.0.downsample.0.weight"] == "head"
    opt = topt.Optimizer(_rn_cfg(), head)
    wd = {n: g["weight_decay"] for g in opt.inner.param_groups for n, p in head.named_parameters() if any(p is q for q in g["params"])}
    assert wd["backbone.layer1.0.downsample.1.bias"] == 0.0 and wd["backbone.layer1.0.conv1.weight"] == 5e-5


def test_openai_rn_checkpoint_gives_the_jax_logits(tmp_path):
    """A synthetic OpenAI-format RN file (the JAX weights under OpenAI's
    names, with BatchNorm2d's num_batches_tracked) through both packages'
    loaders: the strict tower load accepts it, infer_arch finds the arch,
    and the two heads' eval logits agree at 1e-4 (the port's head takes the
    JAX head's context2 and scale, which neither file holds)."""
    from clip_fsar_tpu.data.types import Episode as JEpisode
    from clip_fsar_tpu.models import builder as jbuilder

    from clip_fsar_torch.models.builder import build_few_shot_model

    _, arch, clip_vars = jax_tiny_clip(RN)
    sd = openai_state_dict(port_clip_state(clip_vars), clip_vars["params"]["logit_scale"])
    sd.update({k.replace("running_mean", "num_batches_tracked"): torch.tensor(7) for k in list(sd) if k.endswith("running_mean")})
    path = tmp_path / "RN-Tiny-Test.pt"
    torch.save(sd, str(path))
    assert convert.load_openai_checkpoint(str(path))[0] == ARCHS[RN]

    cfg = tiny_cfg("VIDEO.HEAD.BACKBONE_NAME", RN)
    cfg.TRAIN["CLIP_WEIGHTS"] = str(path)  # both builders read it; base.yaml does not declare it
    jmodel = jbuilder.build_few_shot_model(cfg, jax.random.PRNGKey(0), flow="test")
    port = build_few_shot_model(cfg, flow="test", device="cpu")
    jax_head = convert.params_from_jax(jax.device_get(jmodel.variables))
    port.head.load_state_dict({k: v for k, v in jax_head.items() if k.startswith(("context2.", "scale"))}, strict=False)
    for k, v in jax_head.items():
        if k.startswith("backbone."):
            assert torch.equal(port.head.state_dict()[k], v), k

    batch = _episodes(seed=3)
    want = jax.jit(jax.vmap(lambda ep: jmodel.head.apply(jmodel.variables, ep, jmodel.text_train, jmodel.text_test, train=False)))(
        JEpisode(**{k: jnp.asarray(v) for k, v in batch.items()}))
    # the JAX text banks: the JAX converter gives the tiny text tower width / 64 = 1 head where the port's
    # infer_arch returns the named arch's 2 (at OpenAI's widths the rule and the names agree)
    text = [torch.from_numpy(np.array(t)) for t in (jmodel.text_train, jmodel.text_test)]
    with torch.no_grad():
        got = port.head(Episode(**{k: torch.from_numpy(v) for k, v in batch.items()}), *text)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("grid_new", [3, 1])
def test_attnpool_pos_embed_resize_matches_jax(grid_new):
    """The RN towers' positional table on the stride-32 grid, resampled up
    (2 -> 3) and down (2 -> 1) as the JAX converter does, fp32 at 1e-5."""
    from clip_fsar_tpu.models.clip.convert import resize_vision_pos_embed as jresize

    pos = np.random.RandomState(5).randn(5, 8).astype(np.float32)
    arch = dataclasses.replace(ARCHS[RN], image_resolution=32 * grid_new)
    want = np.asarray(jresize({"params": {"visual": {"attnpool": {"positional_embedding": pos}}}}, arch)
                      ["params"]["visual"]["attnpool"]["positional_embedding"])
    got = convert.resize_vision_pos_embed({"visual.attnpool.positional_embedding": torch.from_numpy(pos)}, arch)
    np.testing.assert_allclose(got["visual.attnpool.positional_embedding"].numpy(), want, atol=1e-5, rtol=1e-5)


def test_npz_archive_with_batch_stats_loads_every_entry(tmp_path):
    """The JAX package's ``save_weights_npz`` archive of the RN head, with
    its ``batch_stats/`` collection: every head entry, the running stats
    included, comes back bit for bit."""
    from clip_fsar_tpu.train.pretrain import save_weights_npz

    from clip_fsar_torch.train.checkpoint import load_checkpoint_file

    cfg, arch, clip_vars, model = jax_tiny_model(backbone=RN)
    path = str(tmp_path / "rn.npz")
    save_weights_npz(path, jax.device_get(model.variables))
    with np.load(path) as archive:
        assert any(k.startswith("batch_stats/") for k in archive.files)
    want = {k: v for k, v in port_head_state(model, clip_vars).items() if not k.startswith("text.")}
    head = CLIPFSARHead(arch, CLIPFSARConfig.from_cfg(cfg))
    assert set(head.state_dict()) == set(want)
    assert load_checkpoint_file(path, head)
    for key, value in head.state_dict().items():
        assert torch.equal(value, want[key]), key


def test_checkpoint_round_trip_keeps_the_running_stats(tmp_path):
    """A train checkpoint holds the running stats as trained (the EMA covers
    the parameters only), and auto-resume and the test-time search bring
    them back."""
    from clip_fsar_torch.train.checkpoint import Checkpointer, load_test_weights

    cfg, arch, clip_vars, model, batches, *_ = _jax_three_steps(False)
    cfg = _rn_cfg("MODEL.EMA.ENABLE", "True", "OUTPUT_DIR", str(tmp_path))
    head, state, text = _port_state(cfg, arch, clip_vars, model, freeze=False)
    make_train_step(head, cfg, *text)(state, _port_batch(batches[0]), 1e-3, None)
    trained = _stats({k: v.clone() for k, v in head.state_dict().items()})
    assert set(state.ema) == {n for n, _ in head.named_parameters()}
    assert all(torch.equal(state.ema_variables()[k], v) for k, v in trained.items())
    Checkpointer(str(tmp_path)).save(1, state)

    other, other_state, _ = _port_state(cfg, arch, clip_vars, model, freeze=False)
    assert Checkpointer(str(tmp_path)).restore(other_state) == 1
    fresh = CLIPFSARHead(arch, CLIPFSARConfig.from_cfg(cfg))
    assert load_test_weights(cfg, fresh).endswith("1.pt")
    for key, value in trained.items():
        assert torch.equal(other.state_dict()[key], value) and torch.equal(fresh.state_dict()[key], value), key


def test_flagship_config_trains_and_tests_through_the_cli(tmp_path):
    """The flagship config as written (RN50 is its backbone; here the tiny
    RN at 64 px, 4 frames) through the port's CLI on the CPU: 4 train steps
    with validation and a checkpoint, then the test of that checkpoint; the
    running stats in the checkpoint moved from their fresh values."""
    from clip_fsar_torch.runs.run import main

    opts = ["VIDEO.HEAD.BACKBONE_NAME", RN, "TRAIN.ENABLE", "True", "DATA.DECODER", "synthetic", "TRAIN.NUM_TRAIN_TASKS", "4",
            "TRAIN.VAL_FRE_ITER", "2", "TRAIN.NUM_VAL_TASKS", "2", "TRAIN.NUM_TEST_TASKS", "4", "TEST.BATCH_SIZE", "2",
            "TPU.EPISODES_PER_STEP", "2", "TPU.EVAL_EPISODES_PER_STEP", "2", "DATA.NUM_INPUT_FRAMES", "4", "DATA.TEST_CROP_SIZE", "64",
            "DATA.TRAIN_CROP_SIZE", "64", "DATA.TEST_SCALE", "72", "DATA.TRAIN_JITTER_SCALES", "[72, 80]", "DATA_LOADER.NUM_WORKERS", "2",
            "OUTPUT_DIR", str(tmp_path)]
    results = main(["--cfg", CONFIG, "--device", "cpu", *opts])
    train, test = results["train_few_shot"], results["test_few_shot"]
    assert len(train["losses"]) == 4 and np.isfinite(train["losses"]).all() and train["updates"] == 1
    assert test["weights"].endswith("4.pt") and test["episodes"] == 4 and np.isfinite(test["episode_logits"]).all()
    saved = torch.load(test["weights"], map_location="cpu", weights_only=True)["head"]
    means = [v for k, v in saved.items() if k.endswith("running_mean")]
    assert means and all(torch.isfinite(v).all() for v in means) and any(v.abs().max() > 0 for v in means)


@pytest.mark.parametrize("name", ["RN50", "RN101", "RN50x4", "RN50x16", "RN50x64"])
def test_rn_arch_state_dict_matches_jax(name):
    """Each RN arch's tower, built on the meta device (no memory), has the
    names and shapes of ``params_from_jax`` of the JAX tower's abstract
    init (``jax.eval_shape``), running stats included."""
    from clip_fsar_tpu.models.clip.model import ARCHS as JARCHS

    jarch = JARCHS[name]
    shapes = jax.eval_shape(_jax_tower(jarch).init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, jarch.image_resolution, jarch.image_resolution, 3), jnp.float32))
    with mock.patch.object(convert, "_t", lambda x: torch.empty(tuple(np.shape(x)), device="meta")):
        want = convert.params_from_jax({"params": {"backbone": shapes["params"], "context2": {}, "scale": np.ones(1)},
                                        "batch_stats": {"backbone": shapes["batch_stats"]}})
    with torch.device("meta"):
        tower = build_vision_tower(ARCHS[name])
    got = {f"backbone.{k}": tuple(v.shape) for k, v in tower.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in want.items() if k != "scale"}
