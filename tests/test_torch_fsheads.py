"""The classic few-shot heads of clip_fsar_torch against clip_fsar_tpu: the
torchvision ResNet trunk (and its torchvision state-dict loader), every head
registered in fsheads.py built through the port's builder from a shipped
HyRSM++ config at a tiny size, its forward against the JAX head vmapped over
two episodes, the config gates, the parameter groups, and three HyRSM++
5-shot train steps against the JAX make_train_step.

Everything runs in float32 with the JAX weights carried over by
``params_from_jax``, inputs from a numpy seed and dropout off; WAY 3, T 4 at
64 px (tests/test_clipfsar_head.py's sizes), 2 shots, 2 queries a class."""

import dataclasses
import functools
import os
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clip_fsar_torch.data.types import Episode
from clip_fsar_torch.models.clip.convert import params_from_jax
from clip_fsar_torch.train import optimizer as topt
from tests.torch_parity import REPO, random_batch_stats

torch.set_num_threads(2)

HYRSM_DIR = os.path.join(REPO, "configs", "projects", "hyrsmplusplus", "hmdb51")
HYRSM_5SHOT = os.path.join(HYRSM_DIR, "HyRSMplusplus_HMDB51_5shot_v1.yaml")
WAY, SHOT, QPC, T, RES = 3, 2, 2, 4, 64
# the shipped configs at a tiny size: the tiny CLIP tower, 4 frames of 64 px, float32, the synthetic decoder
TINY = ["VIDEO.HEAD.BACKBONE_NAME", "ViT-Tiny-Test", "DATA.NUM_INPUT_FRAMES", str(T), "DATA.TRAIN_CROP_SIZE", str(RES),
        "DATA.TEST_CROP_SIZE", str(RES), "DATA.TEST_SCALE", "72", "DATA.TRAIN_JITTER_SCALES", "[72, 80]", "TRAIN.WAY", str(WAY),
        "TRAIN.SHOT", str(SHOT), "TRAIN.QUERY_PER_CLASS", str(QPC), "TRAIN.QUERY_PER_CLASS_TEST", str(QPC), "TPU.COMPUTE_DTYPE", "float32",
        "DATA.DECODER", "synthetic", "DATA_LOADER.NUM_WORKERS", "2"]
FSHEADS = ["CNN_TSN", "CNN_OTAM", "CNN_TRX", "CNN_CrossTransformer", "CNN_HyRSM_1shot", "CNN_HyRSM_5shot", "CNN_HyRSM_plusplus_1shot",
           "CNN_HyRSM_plusplus_5shot", "CNN_HyRSM_plusplus_semi"]


def head_cfg(path, name=None, *extra, package="torch"):
    """A shipped config at the tiny size (``name`` replaces its head), loaded by either package."""
    if package == "torch":
        from clip_fsar_torch.config.config import load_config
    else:
        from clip_fsar_tpu.config.config import load_config
    opts = TINY + ["DATA.ANNO_DIR", os.path.dirname(path) + "/"] + (["VIDEO.HEAD.NAME", name] if name else []) + list(extra)
    return load_config(path, opts)


def episodes(num=2, way=WAY, shot=SHOT, qpc=QPC, frames=T, res=RES, unlabeled=0, seed=0) -> dict:
    """E normalized-image episodes (support in shuffled order), numpy."""
    rng = np.random.RandomState(seed)
    eps = []
    for _ in range(num):
        classes = rng.choice(31, size=way, replace=False)
        s_lab, q_lab = rng.permutation(np.repeat(np.arange(way), shot)), rng.permutation(np.repeat(np.arange(way), qpc))
        ep = dict(
            support_images=rng.randn(way * shot, frames, res, res, 3).astype(np.float32), support_labels=s_lab.astype(np.int32),
            real_support_labels=classes[s_lab].astype(np.int32), target_images=rng.randn(way * qpc, frames, res, res, 3).astype(np.float32),
            target_labels=q_lab.astype(np.int32), real_target_labels=classes[q_lab].astype(np.int32), batch_class_list=classes.astype(np.int32),
        )
        if unlabeled:
            ep["unlabeled_images"] = rng.randn(unlabeled, frames, res, res, 3).astype(np.float32)
        eps.append(ep)
    return {k: np.stack([e[k] for e in eps]) for k in eps[0]}


def jax_episode(batch, index=None):
    from clip_fsar_tpu.data.types import Episode as JEpisode

    return JEpisode(**{k: jnp.asarray(v if index is None else v[index]) for k, v in batch.items()})


def port_episode(batch) -> Episode:
    return Episode(**{k: torch.from_numpy(v) for k, v in batch.items()})


@functools.lru_cache(maxsize=None)
def jax_head(path, name, backbone="ViT-Tiny-Test", semi_unlabeled=0):
    """(JAX head from its registry factory on the tiny config, variables
    from its init, with random BatchNorm running stats)."""
    import clip_fsar_tpu.models.builder  # noqa: F401  (registers the heads)
    from clip_fsar_tpu.utils.registry import HEAD_REGISTRY as JREG

    cfg = head_cfg(path, name, "VIDEO.HEAD.BACKBONE_NAME", backbone, package="jax")
    head = JREG.get(name)(cfg)
    variables = jax.device_get(jax.jit(lambda ep: head.init(jax.random.PRNGKey(0), ep, train=False))(jax_episode(episodes(unlabeled=semi_unlabeled), 0)))
    if "batch_stats" in variables:
        variables = {**variables, "batch_stats": random_batch_stats(variables["batch_stats"])}
    return head, variables


@functools.lru_cache(maxsize=None)
def jax_outputs(path, name, backbone="ViT-Tiny-Test", unlabeled=0, seed=0):
    """The JAX head vmapped over two episodes in the eval branch, numpy leaves."""
    head, variables = jax_head(path, name, backbone, unlabeled)
    run = jax.jit(jax.vmap(lambda ep: head.apply(variables, ep, train=False)))
    return jax.device_get(run(jax_episode(episodes(unlabeled=unlabeled, seed=seed))))


def port_head(path, name, backbone="ViT-Tiny-Test", unlabeled=0):
    """The port's head built through build_few_shot_model from the same config, with the JAX weights."""
    from clip_fsar_torch.models.builder import build_few_shot_model

    model = build_few_shot_model(head_cfg(path, name, "VIDEO.HEAD.BACKBONE_NAME", backbone), flow="test", device="cpu")
    model.head.load_state_dict(params_from_jax(jax_head(path, name, backbone, unlabeled)[1]))  # strict: every entry
    return model


def assert_outputs_match(got: dict, want: dict, atol=1e-4) -> None:
    for key, value in want.items():
        if value is None:
            assert got[key] is None, key
            continue
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(value), atol=atol, rtol=atol, err_msg=key)


# ---------------------------------------------------------------------------
# the torchvision ResNet trunk
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_resnet(depth):
    from clip_fsar_tpu.models.resnet import TorchResNet as JResNet

    module = JResNet(depth=depth)
    variables = jax.device_get(module.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3))))
    return module, {**variables, "batch_stats": random_batch_stats(variables["batch_stats"], seed=3)}


def _port_resnet(depth, variables):
    from clip_fsar_torch.models.resnet import TorchResNet

    module = TorchResNet(depth)
    sd = params_from_jax({"params": {"backbone": variables["params"]}, "batch_stats": {"backbone": variables["batch_stats"]}})
    module.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()})
    return module


@pytest.mark.parametrize("depth, res", [("resnet18", 64), ("resnet18", 48), ("resnet50", 32)])
@pytest.mark.parametrize("pool", [True, False], ids=["pool", "map"])
def test_torch_resnet_matches_jax(depth, res, pool):
    """The trunk on random running stats, NHWC in, pooled [B, D] or the
    NHWC map [B, h, w, D] out, fp32 at 1e-4."""
    module, variables = _jax_resnet(depth)
    imgs = np.random.RandomState(res).randn(2, res, res, 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: module.apply(v, x, pool=pool))(variables, imgs))
    with torch.no_grad():
        got = _port_resnet(depth, variables)(torch.from_numpy(imgs), pool=pool).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


RESNET_DIM = {"resnet18": 512, "resnet50": 2048}


@pytest.mark.parametrize("depth", ["resnet18", "resnet50"])
def test_torchvision_state_dict_loads_as_in_jax(tmp_path, depth):
    """A synthetic state dict under torchvision's names (fc and
    num_batches_tracked included) through ``torch.save``, then through the
    JAX converter and the port's loader: the same features."""
    from clip_fsar_tpu.models.resnet import TorchResNet as JResNet
    from clip_fsar_tpu.models.resnet import convert_torchvision_resnet

    from clip_fsar_torch.models.resnet import TorchResNet, load_torchvision_resnet

    rng = np.random.RandomState(7)
    shapes = TorchResNet(depth).state_dict()
    sd = {k: torch.from_numpy((rng.uniform(0.5, 1.5, v.shape) if k.endswith("running_var") else 0.1 * rng.randn(*v.shape)).astype(np.float32))
          for k, v in shapes.items()}
    sd.update({k.replace("running_mean", "num_batches_tracked"): torch.tensor(9) for k in list(sd) if k.endswith("running_mean")})
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, RESNET_DIM[depth]), torch.zeros(1000)
    path = tmp_path / f"{depth}-0000.pth"
    torch.save(sd, str(path))

    loaded = torch.load(str(path), map_location="cpu", weights_only=True)
    jvars = convert_torchvision_resnet(loaded, depth=depth)
    port = TorchResNet(depth)
    load_torchvision_resnet(port, loaded)
    imgs = np.random.RandomState(8).randn(2, 64, 64, 3).astype(np.float32)
    want = np.asarray(jax.jit(JResNet(depth=depth).apply)(jvars, imgs))
    with torch.no_grad():
        got = port(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_builder_takes_torchvision_weights(tmp_path):
    """TRAIN.BACKBONE_WEIGHTS names a torchvision file: the builder's trunk
    holds its entries; without it the first ``{name}*.pth`` under ./weights
    is taken, as the JAX builder searches."""
    from clip_fsar_torch.models.builder import build_few_shot_model
    from clip_fsar_torch.models.resnet import TorchResNet

    sd = {k: torch.full_like(v, 0.5) for k, v in TorchResNet("resnet18").state_dict().items()}
    path = tmp_path / "resnet18-test.pth"
    torch.save(sd, str(path))
    cfg = head_cfg(HYRSM_5SHOT, None, "VIDEO.HEAD.BACKBONE_NAME", "resnet18")
    cfg.TRAIN["BACKBONE_WEIGHTS"] = str(path)
    head = build_few_shot_model(cfg, device="cpu").head
    assert all(torch.equal(head.backbone.state_dict()[k], v) for k, v in sd.items())
    (tmp_path / "weights").mkdir()
    torch.save(sd, str(tmp_path / "weights" / "resnet18-found.pth"))
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        head = build_few_shot_model(head_cfg(HYRSM_5SHOT, None, "VIDEO.HEAD.BACKBONE_NAME", "resnet18"), device="cpu").head
    finally:
        os.chdir(cwd)
    assert torch.equal(head.backbone.conv1.weight, sd["conv1.weight"])


# ---------------------------------------------------------------------------
# the heads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", FSHEADS)
def test_head_matches_jax(name):
    """Each head registered in fsheads.py, built through the port's
    build_few_shot_model from the shipped HyRSM++ 5-shot config on the tiny
    ViT, loads every JAX entry and gives the JAX head's outputs (vmapped over
    the two episodes) at 1e-4: logits, class logits and, for HyRSM++,
    loss_temporal_regular."""
    model = port_head(HYRSM_5SHOT, name)
    want = jax_outputs(HYRSM_5SHOT, name)
    with torch.no_grad():
        got = model.head(port_episode(episodes()), model.text_train, model.text_test, train=False)
    assert got["logits"].shape == (2, WAY * QPC, WAY)
    assert_outputs_match(got, want)


@pytest.mark.parametrize("name, backbone", [("CNN_HyRSM_plusplus_5shot", "resnet18"), ("CNN_OTAM", "RN-Tiny-Test")])
def test_head_on_other_trunks_matches_jax(name, backbone):
    """A head on the torchvision resnet18 trunk and one on the tiny RN CLIP
    tower, both on random running stats, fp32 at 1e-4."""
    model = port_head(HYRSM_5SHOT, name, backbone)
    with torch.no_grad():
        got = model.head(port_episode(episodes()), model.text_train, model.text_test, train=False)
    assert_outputs_match(got, jax_outputs(HYRSM_5SHOT, name, backbone))


@pytest.mark.parametrize("threshold", [0.0, 0.5, 1.5], ids=["accept_all", "some", "accept_none"])
def test_semi_head_with_unlabeled_clips_matches_jax(threshold):
    """CNN_HyRSM_plusplus_semi with 4 unlabeled clips an episode: threshold
    0 accepts every clip into its pseudo-class, 1.5 none; fp32 at 1e-4."""
    name = "CNN_HyRSM_plusplus_semi"
    head, variables = jax_head(HYRSM_5SHOT, name, semi_unlabeled=4)
    head = head.clone(semi_threshold=threshold)
    batch = episodes(unlabeled=4, seed=2)
    want = jax.device_get(jax.jit(jax.vmap(lambda ep: head.apply(variables, ep, train=False)))(jax_episode(batch)))
    model = port_head(HYRSM_5SHOT, name, unlabeled=4)
    model.head.semi_threshold = threshold
    with torch.no_grad():
        got = model.head(port_episode(batch), model.text_train, model.text_test, train=False)
    assert_outputs_match(got, want)


def test_heads_register_the_jax_names():
    """The port's registry holds every few-shot head the JAX package
    registers (its builder, fsheads.py and molo.py; other JAX modules that a
    test process imports register the classification heads too)."""
    import clip_fsar_tpu.models.builder  # noqa: F401
    from clip_fsar_tpu.utils.registry import HEAD_REGISTRY as JREG

    import clip_fsar_torch.models.builder  # noqa: F401
    from clip_fsar_torch.utils.registry import HEAD_REGISTRY

    few_shot = ("clip_fsar_tpu.models.builder", "clip_fsar_tpu.models.heads.fsheads", "clip_fsar_tpu.models.heads.molo")
    want = {name for name in JREG.keys() if JREG.get(name).__module__ in few_shot}
    assert want == set(HEAD_REGISTRY.keys()) and len(want) == 11


_GATED = ("way", "num_frames", "five_shot", "window_size", "temporal_balance", "balance_coefficient", "use_classification", "use_pe",
          "semi_temporal", "semi_threshold", "shot")


def _edited(cfg, edits: dict):
    """The config with TRAIN keys set (a value) or removed (None)."""
    for key, value in edits.items():
        if value is None:  # a Config keeps its keys in _data and has no __delitem__
            del object.__getattribute__(cfg.TRAIN, "_data")[key]
        else:
            cfg.TRAIN[key] = value
    return cfg


@pytest.mark.parametrize("edits", [{}, {"POSITION_A": 0.0, "BALANCE_COEFFICIENT": 0, "WINDOW_SIZE": 0, "SEMI_THRESHOLD": 0.3},
                                   {"USE_CLASSIFICATION": False, "HEAD": 0, "SEMI_TEMPORAL": 0, "NO_POSITION": False},
                                   {"POSITION_B": None, "NO_POSITION": False, "HEAD": 4}],
                         ids=["shipped", "zeros", "off", "no_position"])
@pytest.mark.parametrize("name", FSHEADS)
def test_config_gates_match_jax(name, edits):
    """Every hyperparameter the factories read, against the JAX factory on
    the same config: hasattr-gated keys keep an explicit 0, truthiness-gated
    ones fall back, HyRSM++'s positional-encoding rule (NO_POSITION counts
    only without both POSITION_A and POSITION_B, whatever its value)."""
    import clip_fsar_tpu.models.builder  # noqa: F401
    from clip_fsar_tpu.utils.registry import HEAD_REGISTRY as JREG

    import clip_fsar_torch.models.builder  # noqa: F401
    from clip_fsar_torch.utils.registry import HEAD_REGISTRY

    jhead = JREG.get(name)(_edited(head_cfg(HYRSM_5SHOT, name, package="jax"), edits))
    with torch.device("meta"):
        head = HEAD_REGISTRY.get(name)(_edited(head_cfg(HYRSM_5SHOT, name), edits))
    for attr in _GATED:
        if hasattr(jhead, attr):
            assert getattr(head, attr) == getattr(jhead, attr), attr
    if hasattr(jhead, "position_a"):
        feats = head.features
        with np.errstate(divide="ignore"):
            assert feats.pe.scale == pytest.approx(float(np.sqrt(np.float32(head.dim) / np.float32(jhead.position_a))), rel=1e-7)
        assert feats.pe.position_b == jhead.position_b and feats.num_class == jhead.num_class
        assert feats.temporal_atte.n_head == jhead.heads


def _code_groups(params, prefix="head"):
    """Each JAX parameter's group (param_groups) and decay flag (make_decay_mask) as constant arrays, converted to port names."""
    from clip_fsar_tpu.train import optimizer as jopt

    code = {"no_decay": 1.0, "bn": 2.0, "head": 3.0, "rest": 4.0}
    coded = params_from_jax({"params": jax.tree_util.tree_map(lambda p, g: np.full(np.shape(p), code[g], np.float32), params,
                                                              jopt.param_groups(params, prefix))})
    decay = params_from_jax({"params": jax.tree_util.tree_map(lambda p, d: np.full(np.shape(p), float(d), np.float32), params,
                                                              jopt.make_decay_mask(params, prefix))})
    return code, coded, decay


@pytest.mark.parametrize("name, backbone", [(n, "ViT-Tiny-Test") for n in FSHEADS] + [("CNN_HyRSM_plusplus_5shot", "resnet18")])
def test_param_groups_match_jax(name, backbone):
    """Every parameter of every head in the group its JAX counterpart gets
    (optimizer.py:113-125: bn / norm, embd / cls_token, head) and with its
    decay, leaf by leaf; and the optimizer puts HyRSM++'s WEIGHT_DECAY on
    exactly the decayed ones."""
    model = port_head(HYRSM_5SHOT, name, backbone)
    code, coded, decay = _code_groups(jax_head(HYRSM_5SHOT, name, backbone)[1]["params"])
    names = [n for n, _ in model.head.named_parameters()]
    groups = topt.param_groups(names, "head")
    assert set(coded) == set(names)
    for n in names:
        assert (coded[n] == code[groups[n]]).all(), n
        assert (decay[n] == float(groups[n] in ("rest", "head"))).all(), n
    opt = topt.Optimizer(head_cfg(HYRSM_5SHOT, name, "VIDEO.HEAD.BACKBONE_NAME", backbone), model.head)
    wd = {n: g["weight_decay"] for g in opt.inner.param_groups for n, p in model.head.named_parameters() if any(p is q for q in g["params"])}
    assert {n for n, w in wd.items() if w == 5e-4} == {n for n in names if decay[n].all()}


# ---------------------------------------------------------------------------
# three HyRSM++ 5-shot train steps against the JAX make_train_step
# ---------------------------------------------------------------------------

# lr 1e-3 from the first step, one update per step, E = 2 in two chunks; no random erasing (the port's step with
# no generator draws nothing); every loss term of the config on (USE_LOCAL class logits, the temporal regularizer)
TRAIN_OPTS = ["TRAIN.ENABLE", "True", "SOLVER.BASE_LR", "1e-3", "SOLVER.WARMUP_EPOCHS", "0", "TPU.EPISODES_PER_STEP", "2",
              "TPU.EPISODE_CHUNKS", "2", "TRAIN.BATCH_SIZE_PER_TASK", "1", "AUGMENTATION.NO_RANDOM_ERASE", "True"]


def port_batch(batch) -> Episode:
    return Episode(**{f.name: torch.from_numpy(np.array(getattr(batch, f.name))) for f in dataclasses.fields(Episode)
                      if getattr(batch, f.name) is not None})


def jax_train_steps(path, name, backbone="ViT-Tiny-Test", steps=3, extra=()):
    """Three JAX make_train_step steps of the head on the tiny config from
    its init weights, on batches of the JAX loader, dropout and jitter off.
    Returns (cfg, variables, batches, losses, gradients per step (port
    names), running stats after each step (port names))."""
    from clip_fsar_tpu.data.loader import build_few_shot_loader as jloader
    from clip_fsar_tpu.models.builder import FewShotModel
    from clip_fsar_tpu.train import step as jstep
    from clip_fsar_tpu.train.loop import build_state
    from clip_fsar_tpu.train.optimizer import build_optimizer, epoch_for_iter, get_lr_at_epoch

    cfg = head_cfg(path, name, "VIDEO.HEAD.BACKBONE_NAME", backbone, *TRAIN_OPTS, *extra, package="jax")
    head, variables = jax_head(path, name, backbone)
    model = FewShotModel(head=head, variables=variables, text_train=jnp.zeros((1, 1)), text_test=jnp.zeros((1, 1)))
    inner = build_optimizer(cfg, variables["params"], name_prefix="head")
    tx = optax.GradientTransformation(
        lambda p: (inner.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)),
        lambda g, s, p=None: (lambda u, s0: (u, (s0, g)))(*inner.update(g, s[0], p)),
    )
    state = build_state(cfg, model, tx)
    with jloader(cfg, "train", num_steps=steps, episodes_per_step=2) as loader:
        batches = list(loader)
    losses, grads, stats = [], [], []
    with mock.patch.object(fnn.Dropout, "__call__", lambda self, x, *a, **k: x), \
            mock.patch("clip_fsar_tpu.data.augment.color_jitter_batch", lambda key, x, **kw: x):
        step = jax.jit(jstep.make_train_step(head, tx, cfg, model.text_train, model.text_test))
        for i, batch in enumerate(batches):
            state, metrics = step(state, batch, jnp.float32(get_lr_at_epoch(cfg, epoch_for_iter(cfg, i))), jax.random.PRNGKey(i))
            losses.append(float(metrics["loss"]))
            grads.append(params_from_jax({"params": jax.device_get(state.opt_state[1])}))
            if state.batch_stats is not None:
                sd = params_from_jax({"params": jax.device_get(state.params), "batch_stats": jax.device_get(state.batch_stats)})
                stats.append({k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))})
    return cfg, variables, batches, losses, grads, stats


def port_train_steps(path, name, variables, batches, backbone="ViT-Tiny-Test", extra=()):
    """The port's train steps on the same weights and batches (no generator: no dropout, no jitter).
    Returns (head, losses, gradients per step, running stats after each step)."""
    from clip_fsar_torch.models.builder import build_few_shot_model
    from clip_fsar_torch.train.state import TrainState
    from clip_fsar_torch.train.step import make_train_step

    cfg = head_cfg(path, name, "VIDEO.HEAD.BACKBONE_NAME", backbone, *TRAIN_OPTS, *extra)
    model = build_few_shot_model(cfg, flow="train", device="cpu")
    model.head.load_state_dict(params_from_jax(variables))
    state = TrainState.create(cfg, model.head, topt.Optimizer(cfg, model.head))
    grads, stats = [], []
    inner_step = state.optimizer.inner.step

    def capture(*a, **k):
        grads.append({n: p.grad.clone() for n, p in model.head.named_parameters()})
        return inner_step(*a, **k)

    state.optimizer.inner.step = capture
    step = make_train_step(model.head, cfg, model.text_train, model.text_test)
    losses = []
    for i, batch in enumerate(batches):
        losses.append(step(state, port_batch(batch), topt.get_lr_at_epoch(cfg, topt.epoch_for_iter(cfg, i)), None)["loss"].item())
        stats.append({k: v.clone() for k, v in model.head.state_dict().items() if k.endswith(("running_mean", "running_var"))})
    return model.head, losses, grads, stats


def assert_train_steps_match(want_losses, want_grads, losses, grads) -> None:
    np.testing.assert_allclose(losses, want_losses, atol=1e-4, rtol=1e-4)
    for got, want in zip(grads, want_grads):
        assert set(got) == set(want)
        for n, g in got.items():
            torch.testing.assert_close(g, want[n], atol=2e-4, rtol=2e-4, msg=lambda m, n=n: f"grad {n}: {m}")


def test_hyrsm_pp_5shot_three_train_steps_match_jax():
    """Three HyRSM++ 5-shot train steps (E = 2 in two episode chunks) with
    every loss term of the shipped config: CE, USE_LOCAL per-frame class CE
    at USE_CLASSIFICATION_VALUE 0.15, TEMPORAL_LOSS_WEIGHT 0.2 * the
    temporal regularizer; losses at 1e-4, gradients at 2e-4 (fp32)."""
    name = "CNN_HyRSM_plusplus_5shot"
    cfg, variables, batches, want_losses, want_grads, _ = jax_train_steps(HYRSM_5SHOT, name)
    assert cfg.TRAIN.USE_LOCAL and cfg.TRAIN.TEMPORAL_LOSS_WEIGHT == 0.2 and cfg.TRAIN.USE_CLASSIFICATION
    _, losses, grads, _ = port_train_steps(HYRSM_5SHOT, name, variables, batches)
    assert_train_steps_match(want_losses, want_grads, losses, grads)
