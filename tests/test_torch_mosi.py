"""MoSI self-supervised pretraining of clip_fsar_torch against clip_fsar_tpu
on the CPU: the speed sets and the pseudo-motion generator byte for byte,
the four MoSI heads and MoSINet on a tiny R-2D3D (fp32, converted random
weights), the SSL loss composition, LARS against ``scale_by_lars``, two
pretrain train steps with colour jitter fed the JAX step's draws, the SSL
loader and validation, and a step that reads nothing back."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_classification import jax_jitter_draws
from tests.torch_video_parity import SMALL_RESNET, cfg_dict, randomize

torch.set_num_threads(2)

SPEEDS = 3  # speeds per axis: 5 decoupled (x, y) clips per video
FRAMES, CROP = 4, 32
TINY = SMALL_RESNET + (("VIDEO.BACKBONE.DEPTH", 10),)


def mosi_dict(tmp_path=None, head: str = "MoSIHeadJoint", label_mode: str = "joint", loss: str = "MoSIJoint", weights=(1.0,),
              overrides=()) -> dict:
    """A tiny MoSI pretraining config for both packages: R-2D3D-10 of narrow
    widths, 3 speeds per axis, 4 frames of 32 px, dropout off (the two
    packages draw different masks)."""
    pre = (("MODEL.NAME", "MoSINet"), ("VIDEO.HEAD.NAME", head), ("VIDEO.HEAD.NUM_CLASSES", SPEEDS), ("VIDEO.HEAD.DROPOUT_RATE", 0.0),
           ("PRETRAIN.ENABLE", True), ("PRETRAIN.GENERATOR", "MoSIGenerator"), ("PRETRAIN.NUM_FRAMES", FRAMES), ("PRETRAIN.DECOUPLE", True),
           ("PRETRAIN.DATA_MODE", "xy"), ("PRETRAIN.ZERO_OUT", False), ("PRETRAIN.LABEL_MODE", label_mode), ("PRETRAIN.STATIC_MASK", True),
           ("PRETRAIN.DISTANCE_JITTER", (0.8, 1.2)), ("PRETRAIN.MASK_SIZE_RATIO", (0.3, 0.5)), ("PRETRAIN.LOSS", loss),
           ("PRETRAIN.LOSS_WEIGHTS", tuple(weights)), ("TASK_TYPE", "pretrain"), ("DATA.NUM_INPUT_FRAMES", 2), ("DATA.TRAIN_CROP_SIZE", CROP),
           ("TEST.NUM_ENSEMBLE_VIEWS", 1), ("TEST.NUM_SPATIAL_CROPS", 1), ("BN.EPS", 1e-3), ("TRAIN.BATCH_SIZE_PER_TASK", 1))
    if tmp_path is not None:
        pre += (("TRAIN.DATASET", "HMDB51"), ("TEST.DATASET", "HMDB51"), ("DATA.DECODER", "synthetic"), ("DATA.ANNO_DIR", str(tmp_path)),
                ("OUTPUT_DIR", str(tmp_path / "out")), ("DATA_LOADER.NUM_WORKERS", 2))
    d = cfg_dict("r2d3ds", FRAMES, TINY + pre + tuple(overrides))
    return d


def configs(d: dict):
    import copy

    from clip_fsar_tpu.config import Config as JaxConfig
    from clip_fsar_torch.config.config import Config

    return JaxConfig(copy.deepcopy(d)), Config(copy.deepcopy(d))


def clips_per_video() -> int:
    from clip_fsar_torch.data.mosi import build_speed_set

    return len(build_speed_set(SPEEDS, True, "xy", False))


@functools.lru_cache(maxsize=None)
def jax_variables(head: str = "MoSIHeadJoint", label_mode: str = "joint"):
    """The JAX MoSINet's variables, every kernel perturbed and random BatchNorm statistics."""
    from clip_fsar_tpu.models.video.model import build_video_model

    jcfg, _ = configs(mosi_dict(None, head, label_mode))
    x = jnp.zeros((1, clips_per_video(), FRAMES, CROP, CROP, 3))
    v = jax.device_get(build_video_model(jcfg, dtype=jnp.float32).init(jax.random.PRNGKey(0), x, train=False))
    rng = np.random.default_rng(0)
    return {"params": randomize(v["params"], rng), "batch_stats": randomize(v["batch_stats"], rng, True)}


def port_model(d: dict, variables):
    from clip_fsar_torch.models.video.convert import params_from_jax
    from clip_fsar_torch.models.video.model import build_video_model

    model = build_video_model(configs(d)[1])
    model.load_state_dict(params_from_jax(variables))
    return model


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_speeds", [3, 5])
def test_speed_sets_match_jax(num_speeds):
    from clip_fsar_tpu.data.mosi import build_speed_set as jax_set
    from clip_fsar_torch.data.mosi import build_speed_set

    for decouple in (True, False):
        for mode in ("xy", "x", "y"):
            for zero_out in (True, False):
                if not decouple and mode != "xy":
                    with pytest.raises(NotImplementedError):
                        build_speed_set(num_speeds, decouple, mode, zero_out)
                    continue
                assert build_speed_set(num_speeds, decouple, mode, zero_out) == jax_set(num_speeds, decouple, mode, zero_out)


@pytest.mark.parametrize("split, label_mode, zero_out, static_mask", [("train", "joint", False, True), ("train", "separate", True, False),
                                                                     ("test", "joint", False, True), ("test", "separate", False, False)])
def test_generator_matches_jax_byte_for_byte(split, label_mode, zero_out, static_mask):
    """MoSIGenerator's clips and labels from the same np.random.Generator,
    and the generator's state after: the JAX package's, byte for byte."""
    from clip_fsar_tpu.data.mosi import MoSIGenerator as JaxGenerator
    from clip_fsar_torch.data.mosi import MoSIGenerator

    d = mosi_dict(None, overrides=(("PRETRAIN.LABEL_MODE", label_mode), ("PRETRAIN.ZERO_OUT", zero_out), ("PRETRAIN.STATIC_MASK", static_mask),
                                   ("VIDEO.HEAD.NUM_CLASSES", 5)))
    jcfg, cfg = configs(d)
    frames = np.random.default_rng(1).integers(0, 256, (6, 64, 80, 3), dtype=np.uint8)
    for seed in range(3):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        (clips, labels), (want, want_labels) = MoSIGenerator(cfg, split)(frames, r1), JaxGenerator(jcfg, split)(frames, r2)
        assert clips.dtype == want.dtype and clips.shape == want.shape and clips.tobytes() == want.tobytes()
        assert labels.keys() == want_labels.keys() and all(np.array_equal(labels[k], want_labels[k]) for k in labels)
        assert r1.bit_generator.state == r2.bit_generator.state


# ---------------------------------------------------------------------------
# the model and the losses
# ---------------------------------------------------------------------------


HEADS = [("MoSIHeadJoint", "joint"), ("MoSIHeadOnlyX", "separate"), ("MoSIHeadOnlyY", "separate"), ("MoSIHeadXY", "separate")]


@pytest.mark.parametrize("head, label_mode", HEADS)
def test_mosinet_matches_jax(head, label_mode):
    """MoSINet with each MoSI head on [B, S, F, H, W, 3]: eval predictions and
    train-mode logits per axis at 1e-4 (fp32), and the gradient of a fixed
    linear function of them at 2e-4."""
    from clip_fsar_tpu.models.video.model import build_video_model as jax_build
    from clip_fsar_torch.models.video.convert import params_from_jax

    d = mosi_dict(None, head, label_mode)
    jcfg, _ = configs(d)
    variables = jax_variables(head, label_mode)
    model = jax_build(jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(4)
    x = rng.random((2, clips_per_video(), FRAMES, CROP, CROP, 3)).astype(np.float32)
    want_eval = jax.device_get(jax.jit(lambda v, x_: model.apply(v, x_, train=False)[0])(variables, jnp.asarray(x)))
    w = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in want_eval.items()}

    def loss(params, x_):
        out = model.apply({**variables, "params": params}, x_, train=True)[0]
        return sum((out[k] * w[k]).sum() for k in out), out

    (_, want_train), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"], jnp.asarray(x))
    port = port_model(d, variables)
    with torch.no_grad():
        got_eval = port(torch.from_numpy(x), train=False)[0]
    assert got_eval.keys() == want_eval.keys()
    for k in want_eval:
        np.testing.assert_allclose(got_eval[k].numpy(), want_eval[k], atol=1e-4, rtol=1e-4, err_msg=f"eval {k}")
    got_train = port(torch.from_numpy(x), train=True)[0]
    for k in want_train:
        np.testing.assert_allclose(got_train[k].detach().numpy(), np.asarray(want_train[k]), atol=1e-4, rtol=1e-4, err_msg=f"train {k}")
    sum((got_train[k] * torch.from_numpy(w[k])).sum() for k in got_train).backward()
    want_grads = params_from_jax({"params": jax.device_get(grads)})
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), atol=2e-4, rtol=2e-4, err_msg=f"grad {name}")


@pytest.mark.parametrize("loss, weights, label_mode", [("MoSIJoint", (1.0,), "joint"), ("MoSIX+MoSIY", (1.0, 0.5), "separate"),
                                                       ("MoSIX+MoSIY", (0.3, 1.0), "joint")])
def test_ssl_loss_composition_matches_jax(loss, weights, label_mode):
    """calculate_loss's '+'-composition of the SSL terms (the per-axis
    losses falling back to the joint labels where there are no per-axis
    ones, as in the JAX package) on the same predictions: 1e-6."""
    from clip_fsar_tpu.train.losses import calculate_loss as jax_loss
    from clip_fsar_torch.train.losses import calculate_loss

    jcfg, cfg = configs(mosi_dict(None, "MoSIHeadXY", label_mode, loss, weights))
    rng = np.random.default_rng(5)
    preds = {k: rng.normal(size=(10, 3)).astype(np.float32) for k in ("move_x", "move_y", "move_joint")}
    labels = ({"move_joint": np.tile(np.arange(5) % 3, (2, 1)).astype(np.int32)} if label_mode == "joint"
              else {"move_x": rng.integers(0, 3, (2, 5)).astype(np.int32), "move_y": rng.integers(0, 3, (2, 5)).astype(np.int32)})
    want, want_parts = jax_loss(jcfg, {k: jnp.asarray(v) for k, v in preds.items()}, None, {"self-supervised": {k: jnp.asarray(v) for k, v in labels.items()}})
    got, parts = calculate_loss(cfg, {k: torch.from_numpy(v) for k, v in preds.items()}, None,
                                {"self-supervised": {k: torch.from_numpy(v) for k, v in labels.items()}})
    assert parts.keys() == want_parts.keys()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("nesterov", [True, False])
def test_lars_matches_scale_by_lars(nesterov):
    """SOLVER.OPTIM_METHOD lars: three steps of the port's optimizer on
    MoSINet's parameters (the 'rest', 'bn' and 'head' groups, with weight
    decay 1e-3 and BN.WEIGHT_DECAY 1e-4, the trust ratio on the raw gradient
    norm) against the JAX build_optimizer's scale_by_lars and apply_lr, on
    the same random gradients and lr: every parameter at 1e-6."""
    import optax

    from clip_fsar_tpu.train.optimizer import apply_lr, build_optimizer
    from clip_fsar_torch.models.video.convert import params_from_jax
    from clip_fsar_torch.train.optimizer import Optimizer

    d = mosi_dict(None, overrides=(("SOLVER.OPTIM_METHOD", "lars"), ("SOLVER.NESTEROV", nesterov), ("SOLVER.MOMENTUM", 0.9),
                                   ("SOLVER.WEIGHT_DECAY", 1e-3), ("BN.WEIGHT_DECAY", 1e-4)))
    jcfg, cfg = configs(d)
    variables = jax_variables()
    params = variables["params"]
    tx = build_optimizer(jcfg, params)
    opt_state = tx.init(params)
    model = port_model(d, variables)
    opt = Optimizer(cfg, model, name_prefix="")
    assert {g["group"] for g in opt.inner.param_groups} == {"rest", "bn", "head"}
    rng = np.random.default_rng(6)
    for i, lr in enumerate((0.1, 0.05, 0.02)):
        grads = jax.tree_util.tree_map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        if i == 0:  # a zero gradient takes local lr 1
            grads["net"]["head"]["out_move_joint"]["bias"] = np.zeros_like(grads["net"]["head"]["out_move_joint"]["bias"])
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, apply_lr(updates, lr))
        torch_grads = params_from_jax({"params": grads})
        for name, p in model.named_parameters():
            p.grad = torch_grads[name].clone()
        assert bool(opt.step(lr))
    want = params_from_jax({"params": jax.device_get(params)})
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), want[name], atol=1e-6, rtol=1e-6, msg=lambda m, name=name: f"{name}: {m}")


# ---------------------------------------------------------------------------
# the train step, the loader and the validation
# ---------------------------------------------------------------------------


JITTER = (("AUGMENTATION.COLOR_AUG", True), ("AUGMENTATION.BRIGHTNESS", 0.5), ("AUGMENTATION.CONTRAST", 0.5), ("AUGMENTATION.SATURATION", 0.5),
          ("AUGMENTATION.HUE", 0.25), ("AUGMENTATION.GRAYSCALE", 0.3), ("AUGMENTATION.CONSISTENT", False), ("SOLVER.BASE_LR", 1e-3),
          ("DATA.MEAN", (0.45, 0.45, 0.45)), ("DATA.STD", (0.225, 0.225, 0.225)))


def test_two_pretrain_steps_match_jax():
    """Two port pretrain steps (colour jitter per frame of the S*F
    flattened frames, as the mosi preset's CONSISTENT false has it, fed the
    draws the JAX step makes from its key; Adam) against two jitted JAX
    make_classification_train_step steps under PRETRAIN.ENABLE from the same
    converted weights: losses, top-1 and the parameters after at 1e-4.
    The port's step reads nothing back from a tensor."""
    from tests.torch_parity import host_reads

    from clip_fsar_tpu.models.video.model import build_video_model as jax_build
    from clip_fsar_tpu.train import optimizer as jopt
    from clip_fsar_tpu.train.classification import make_classification_train_step as jax_step
    from clip_fsar_tpu.train.state import TrainState as JaxState
    from clip_fsar_torch.data import augment
    from clip_fsar_torch.models.video.convert import params_from_jax
    from clip_fsar_torch.train.classification import make_classification_train_step
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.state import TrainState

    d = mosi_dict(None, overrides=JITTER)
    jcfg, cfg = configs(d)
    variables = jax_variables()
    s = clips_per_video()
    rng = np.random.default_rng(7)
    labels = {"move_joint": np.tile(np.arange(s), (2, 1)).astype(np.int32)}
    batches = [rng.integers(0, 256, (2, s, FRAMES, CROP, CROP, 3), dtype=np.uint8) for _ in range(2)]
    tx = jopt.build_optimizer(jcfg, variables["params"])
    state = JaxState(step=jnp.zeros((), jnp.int32), params=variables["params"], opt_state=tx.init(variables["params"]),
                     batch_stats=variables["batch_stats"])
    step = jax.jit(jax_step(jax_build(jcfg, dtype=jnp.float32), tx, jcfg))
    want = []
    for i, videos in enumerate(batches):
        state, metrics = step(state, jnp.asarray(videos), {k: jnp.asarray(v) for k, v in labels.items()}, jnp.float32(1e-3), jax.random.PRNGKey(i))
        want.append((float(metrics["loss"]), float(metrics["top1"])))

    model = port_model(d, variables)
    pstate = TrainState.create(cfg, model, Optimizer(cfg, model, name_prefix=""))
    train_step = make_classification_train_step(model, cfg)
    got = []
    for i, videos in enumerate(batches):
        _, aug_key = jax.random.split(jax.random.PRNGKey(i))
        k1, _ = jax.random.split(aug_key)
        draws = (augment.AugmentDraws(jax_jitter_draws(k1, 2, s * FRAMES, augment.JitterConfig.from_cfg(cfg)), None, 2), None)
        with host_reads() as reads:
            metrics = train_step(pstate, torch.from_numpy(videos), {k: torch.from_numpy(v) for k, v in labels.items()}, 1e-3, None, draws)
        assert reads == [], reads
        got.append((float(metrics["loss"]), float(metrics["top1"])))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    trained = params_from_jax({"params": jax.device_get(state.params)})
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), trained[name], atol=1e-4, rtol=0, msg=lambda m, name=name: f"{name}: {m}")
    # with a generator the step draws its own jitter and reads nothing back either
    with host_reads() as reads:
        train_step(pstate, torch.from_numpy(batches[0]), {k: torch.from_numpy(v) for k, v in labels.items()}, 1e-3, torch.Generator().manual_seed(0))
    assert reads == [], reads


def _lists(tmp_path, train: int = 6, test: int = 10) -> None:
    for split, n in (("train", train), ("test", test)):
        with open(tmp_path / f"hmdb51_{split}_list.txt", "w") as f:
            for i in range(n):
                f.write(f"videos/c{i % 3}/{split}_{i:03d}.avi {i % 3}\n")


def test_ssl_loader_matches_jax(tmp_path):
    """The classification loader under PRETRAIN.ENABLE: the generator's clips
    [b, S, F, H, W, 3] and per-axis labels [b, S] of every batch, the JAX
    loader's byte for byte (shuffled train epoch; test split with its padded
    tail), and a rank's rows equal to those rows of the whole batch."""
    from clip_fsar_tpu.data.classification import build_classification_loader as jax_loader
    from clip_fsar_torch.data.classification import build_classification_loader

    _lists(tmp_path)
    jcfg, cfg = configs(mosi_dict(tmp_path, overrides=(("TRAIN.BATCH_SIZE", 4), ("TEST.BATCH_SIZE", 4))))
    for split in ("train", "test"):
        want = list(jax_loader(jcfg, split))
        got = list(build_classification_loader(cfg, split))
        half = list(build_classification_loader(cfg, split, row_range=(2, 4)))
        assert len(got) == len(want) > 0
        for (v, lab, c), (wv, wlab, wc), (hv, hlab, hc) in zip(got, want, half):
            assert v.shape == (4, clips_per_video(), FRAMES, CROP, CROP, 3) and v.tobytes() == wv.tobytes()
            assert lab.keys() == wlab.keys() and all(np.array_equal(lab[k], wlab[k]) for k in lab)
            np.testing.assert_array_equal(c, wc)
            assert hv.tobytes() == v[2:].tobytes() and np.array_equal(hc, c[2:]) and np.array_equal(hlab["move_joint"], lab["move_joint"][2:])
    assert (want[-1][2] == -1).sum() == 2  # 10 test videos in batches of 4: the tail padded


def test_ssl_validation_matches_jax(tmp_path):
    """The pretraining validation (_eval_epoch_ssl) of the same weights over
    the same test split (10 videos in batches of 8, the padded tail masked):
    the mean SSL cross-entropy at 1e-5 and the per-axis accuracy."""
    from clip_fsar_tpu.models.video.model import build_video_model as jax_build
    from clip_fsar_tpu.parallel.mesh import build_mesh as jax_mesh
    from clip_fsar_tpu.train.classification import _eval_epoch_ssl as jax_eval
    from clip_fsar_torch.parallel import mesh
    from clip_fsar_torch.train.classification import _eval_epoch_ssl

    _lists(tmp_path)
    jcfg, cfg = configs(mosi_dict(tmp_path, overrides=(("TEST.BATCH_SIZE", 8),)))
    variables = jax_variables()
    want = jax_eval(jcfg, jax_build(jcfg, dtype=jnp.float32), variables, jax_mesh(jcfg))
    got = _eval_epoch_ssl(cfg, port_model(mosi_dict(None), variables).eval(), mesh.build_mesh(cfg, "cpu"))
    assert got.keys() == want.keys() == {"loss", "acc_move_joint"}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["acc_move_joint"] == want["acc_move_joint"]
