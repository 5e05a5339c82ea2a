"""The classification task of clip_fsar_torch against clip_fsar_tpu on the
CPU: three train steps of a tiny TAda2D (colour jitter, random erasing,
mixup / cutmix and label smoothing with the JAX step's own draws fed to the
port, EMA on), the classification loader byte for byte (train, the
multi-view test with its padded tail, NUM_FOLDS, a rank's rows), the meters
and top-k metrics on the same arrays, mixup / cutmix in every mode with
injected draws, the checkpoint surgery on the same trees, and what
self-supervised pretraining still refuses."""

import math
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_fsar_torch.data import augment
from clip_fsar_torch.data.mixup import MixupConfig, MixupDraws, mixup_batch
from clip_fsar_torch.models.video.convert import params_from_jax
from tests.test_torch_data import _jax_erasing_draws
from tests.torch_video_parity import SMALL_RESNET, cfg_dict, jax_case, port_model

torch.set_num_threads(2)

TADA = SMALL_RESNET + (("VIDEO.BACKBONE.DEPTH", "26"),)


def cls_configs(tmp_path, overrides=(), train_videos: int = 24, test_videos: int = 8):
    """(JAX Config, port Config) of the tiny TAda2D classification run on
    HMDB51-style synthetic lists written into ``tmp_path``."""
    from clip_fsar_tpu.config import Config as JaxConfig
    from clip_fsar_torch.config.config import Config

    for split, n in (("train", train_videos), ("test", test_videos)):
        with open(os.path.join(tmp_path, f"hmdb51_{split}_list.txt"), "w") as f:
            for i in range(n):
                f.write(f"videos/class{i % 3}/{split}_{i:03d}.avi {i % 3}\n")
    base = (("TRAIN.DATASET", "HMDB51"), ("TEST.DATASET", "HMDB51"), ("TRAIN.BATCH_SIZE", 6), ("TEST.BATCH_SIZE", 6),
            ("TEST.NUM_ENSEMBLE_VIEWS", 2), ("TEST.NUM_SPATIAL_CROPS", 1), ("DATA.TEST_CROP_SIZE", 32), ("DATA.TRAIN_JITTER_SCALES", (36, 44)),
            ("DATA.TEST_SCALE", 36), ("DATA.SAMPLING_RATE", 50), ("DATA.DECODER", "synthetic"), ("DATA.ANNO_DIR", str(tmp_path)),
            ("SOLVER.MAX_EPOCH", 1), ("SOLVER.WARMUP_EPOCHS", 0), ("TRAIN.EVAL_PERIOD", 1), ("OUTPUT_DIR", str(tmp_path / "out")),
            ("DATA_LOADER.NUM_WORKERS", 2), ("TRAIN.BATCH_SIZE_PER_TASK", 1))
    d = cfg_dict("tada2d", 4, TADA + base + tuple(overrides))
    return JaxConfig(d), Config(d)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

STEP_OPTS = (("AUGMENTATION.COLOR_AUG", True), ("AUGMENTATION.RANDOM_ERASING.ENABLE", True), ("AUGMENTATION.RANDOM_ERASING.PROB", 1.0),
             ("AUGMENTATION.MIXUP.ENABLE", True), ("AUGMENTATION.MIXUP.ALPHA", 0.8), ("AUGMENTATION.MIXUP.MODE", "elem"),
             ("AUGMENTATION.CUTMIX.ENABLE", True), ("AUGMENTATION.CUTMIX.ALPHA", 1.0), ("AUGMENTATION.LABEL_SMOOTHING", 0.1),
             ("MODEL.EMA.ENABLE", True), ("MODEL.EMA.DECAY", 0.9), ("SOLVER.BASE_LR", 1e-3), ("TRAIN.BATCH_SIZE", 4))


def jax_jitter_draws(key, n: int, t: int, jc) -> augment.JitterDraws:
    """color_jitter_batch's draws from ``key`` (JAX augment.py:347-390)."""
    shape = (n, 1, 1, 1, 1) if jc.consistent else (n, t, 1, 1, 1)
    k = jax.random.split(key, 6)
    unif = lambda i, lo, hi, size: torch.from_numpy(np.array(jax.random.uniform(k[i], size, jnp.float32, lo, hi)))  # noqa: E731
    return augment.JitterDraws(
        brightness=unif(0, max(0.0, 1.0 - jc.brightness), 1.0 + jc.brightness, shape),
        contrast=unif(1, max(0.0, 1.0 - jc.contrast), 1.0 + jc.contrast, shape),
        saturation=unif(2, max(0.0, 1.0 - jc.saturation), 1.0 + jc.saturation, shape),
        hue=unif(3, -jc.hue, jc.hue, shape[:-1]),
        order=int(jax.random.randint(k[4], (), 0, math.factorial(len(jc.active())))),
        gray=torch.from_numpy(np.array(jax.random.uniform(k[5], (n, 1, 1, 1, 1)) < jc.grayscale)),
    )


def jax_mixup_draws(key, b: int, h: int, w: int, mc: MixupConfig) -> MixupDraws:
    """mixup_batch's draws from ``key`` (JAX mixup.py:116-181), per element."""
    from clip_fsar_tpu.data import mixup as jmix

    has_mix, has_cut = mc.mixup_alpha > 0.0, mc.cutmix_alpha > 0.0
    lam_shape = () if mc.mode == "batch" else ((b // 2,) if mc.mode == "pair" else (b,))

    def box(r_box, lam):
        if mc.cutmix_minmax is not None:
            return jmix._rand_bbox_minmax(r_box, h, w, mc.cutmix_minmax, lam_shape)
        return jmix._rand_bbox(r_box, h, w, lam)

    if mc.mode == "batch":
        r_apply, r_switch, r_lam, r_box = jax.random.split(key, 4)
        use = jax.random.uniform(r_apply) < mc.prob
        cut = (has_cut & (jax.random.uniform(r_switch) < mc.switch_prob)) if has_mix else jnp.asarray(has_cut)
        alpha = jnp.where(cut, mc.cutmix_alpha, mc.mixup_alpha)
        safe = jnp.maximum(alpha, 1e-8)
        lam = jnp.where(use & (alpha > 0), jax.random.beta(r_lam, safe, safe), 1.0)
        applied = use | (cut & (mc.cutmix_minmax is not None))
    else:
        r_apply, r_switch, r_lam_m, r_lam_c, r_box = jax.random.split(key, 5)
        cut = jax.random.uniform(r_switch, lam_shape) < mc.switch_prob if (has_mix and has_cut) else jnp.full(lam_shape, has_cut)
        lam_mix = jnp.where(cut, jax.random.beta(r_lam_c, max(mc.cutmix_alpha, 1e-8), max(mc.cutmix_alpha, 1e-8), lam_shape),
                            jax.random.beta(r_lam_m, max(mc.mixup_alpha, 1e-8), max(mc.mixup_alpha, 1e-8), lam_shape))
        applied = (jax.random.uniform(r_apply, lam_shape) < mc.prob) & (has_mix | has_cut)
        lam = jnp.where(applied, lam_mix, 1.0)
    y1, y2, x1, x2 = (np.asarray(v) for v in box(r_box, lam))

    def full(x):
        x = np.asarray(x)
        if mc.mode == "batch":
            return np.repeat(x.reshape(1), b)
        return np.concatenate([x, x[::-1]]) if mc.mode == "pair" else x

    return MixupDraws(full(applied), full(cut), full(np.asarray(lam, np.float32)), full(y1), full(y2), full(x1), full(x2))


def port_draws(key, cfg, shape):
    """The port's draws of one classification step from the JAX step's key
    (classification.py:82-117: aug key, then the mixup key)."""
    rng, aug_key = jax.random.split(key)
    k1, k2 = jax.random.split(aug_key)
    _, mix_key = jax.random.split(rng)
    jitter = jax_jitter_draws(k1, shape[0], shape[1], augment.JitterConfig.from_cfg(cfg))
    erasing = _jax_erasing_draws(k2, shape, augment.ErasingConfig.from_cfg(cfg))
    mix = jax_mixup_draws(mix_key, shape[0], shape[2], shape[3], MixupConfig.from_cfg(cfg))
    return augment.AugmentDraws(jitter, erasing, shape[0]), mix


def test_three_train_steps_match_jax(tmp_path):
    """Three port steps fed the draws of three jitted JAX
    make_classification_train_step steps (jitter, erasing, elem-mode mixup and
    cutmix, label smoothing 0.1), from the same converted random weights:
    losses at 1e-4; parameters and EMA after the steps at atol 5e-4, half a
    step at lr 1e-3 (Adam moves a parameter whose gradient is rounding noise
    by up to lr either way, ROADMAP "Not faults")."""
    from clip_fsar_tpu.train import optimizer as jopt
    from clip_fsar_tpu.train.classification import make_classification_train_step as jax_step
    from clip_fsar_tpu.train.state import TrainState as JaxState
    from clip_fsar_tpu.models.video.model import build_video_model as jax_build
    from clip_fsar_torch.train.classification import make_classification_train_step
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.state import TrainState

    jcfg, cfg = cls_configs(tmp_path, STEP_OPTS)
    variables = jax_case("tada2d", 4, TADA, 0, 32)["variables"]
    rng = np.random.default_rng(3)
    batches = [(rng.integers(0, 256, (4, 4, 32, 32, 3), dtype=np.uint8), rng.integers(0, 5, 4).astype(np.int32)) for _ in range(3)]

    tx = jopt.build_optimizer(jcfg, variables["params"])
    state = JaxState(step=jnp.zeros((), jnp.int32), params=variables["params"], opt_state=tx.init(variables["params"]),
                     batch_stats=variables["batch_stats"], ema_params=variables["params"])
    step = jax.jit(jax_step(jax_build(jcfg, dtype=jnp.float32), tx, jcfg))
    want_losses = []
    for i, (videos, labels) in enumerate(batches):
        state, metrics = step(state, jnp.asarray(videos), jnp.asarray(labels), jnp.float32(1e-3), jax.random.PRNGKey(i))
        want_losses.append(float(metrics["loss"]))

    model = port_model("tada2d", 4, TADA, variables)
    pstate = TrainState.create(cfg, model, Optimizer(cfg, model, name_prefix=""))
    train_step = make_classification_train_step(model, cfg)
    losses = [float(train_step(pstate, torch.from_numpy(v), torch.from_numpy(lab), 1e-3, None,
                               port_draws(jax.random.PRNGKey(i), cfg, v.shape))["loss"]) for i, (v, lab) in enumerate(batches)]
    np.testing.assert_allclose(losses, want_losses, atol=1e-4, rtol=1e-4)
    want = params_from_jax({"params": jax.device_get(state.params)})
    want_ema = params_from_jax({"params": jax.device_get(state.ema_params)})
    start = params_from_jax({"params": variables["params"]})
    moved = 0.0
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), want[name], atol=5e-4, rtol=0, msg=lambda m, name=name: f"param {name}: {m}")
        torch.testing.assert_close(pstate.ema[name], want_ema[name], atol=5e-4, rtol=0, msg=lambda m, name=name: f"ema {name}: {m}")
        moved = max(moved, float((p.detach() - start[name]).abs().max()))
    assert moved > 1e-3


def test_nan_step_leaves_the_weights_and_reads_nothing_back(tmp_path):
    """A non-finite loss skips the update on the device (the JAX step's
    lax.cond, classification.py:156-166), and the step reads nothing back
    from a tensor: no .item(), .tolist() or bool() of one."""
    from tests.torch_parity import host_reads

    from clip_fsar_torch.train.classification import make_classification_train_step
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.state import TrainState

    _, cfg = cls_configs(tmp_path, STEP_OPTS)
    model = port_model("tada2d", 4, TADA, jax_case("tada2d", 4, TADA, 0, 32)["variables"])
    state = TrainState.create(cfg, model, Optimizer(cfg, model, name_prefix=""))
    step = make_classification_train_step(model, cfg)
    videos, labels = torch.randint(0, 256, (4, 4, 32, 32, 3), dtype=torch.uint8), torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    g = torch.Generator().manual_seed(0)
    with host_reads() as reads:
        metrics = step(state, videos, labels, 1e-3, g)
    assert reads == [], reads
    assert bool(metrics["updated"]) and np.isfinite(float(metrics["loss"]))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    with mock.patch.object(torch.nn.functional, "log_softmax", lambda x, dim: x * float("nan")):
        metrics = step(state, videos, labels, 1e-3, g)
    assert not bool(metrics["updated"]) and float(metrics["nan_skipped"]) == 1.0
    assert all(torch.equal(p.detach(), before[n]) for n, p in model.named_parameters())


# ---------------------------------------------------------------------------
# mixup / cutmix
# ---------------------------------------------------------------------------

MIX_CASES = {
    "batch_mixup": MixupConfig(0.8, 0.0, 1.0, 0.5, "batch"),
    "batch_cutmix": MixupConfig(0.0, 1.0, 1.0, 0.5, "batch"),
    "batch_both": MixupConfig(0.8, 1.0, 1.0, 0.5, "batch"),
    "batch_minmax": MixupConfig(0.8, 1.0, 0.7, 0.5, "batch", (0.2, 0.8)),
    "elem_both": MixupConfig(0.8, 1.0, 0.8, 0.5, "elem"),
    "elem_minmax": MixupConfig(0.0, 1.0, 1.0, 0.5, "elem", (0.2, 0.8)),
    "pair_both": MixupConfig(0.8, 1.0, 0.8, 0.5, "pair"),
    "pair_mixup": MixupConfig(0.4, 0.0, 1.0, 0.5, "pair"),
}


@pytest.mark.parametrize("case", list(MIX_CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_mixup_matches_jax_with_its_draws(case, seed):
    """The JAX mixup_batch against the port's fed the draws it made from the
    same key: videos and soft targets equal (fp32; 1e-6)."""
    from clip_fsar_tpu.data.mixup import mixup_batch as jax_mixup

    mc = MIX_CASES[case]
    rng = np.random.default_rng(seed)
    videos = rng.random((6, 2, 16, 20, 3)).astype(np.float32)
    labels = rng.integers(0, 7, 6).astype(np.int32)
    key = jax.random.PRNGKey(seed + 7)
    want_x, want_t = jax_mixup(key, jnp.asarray(videos), jnp.asarray(labels), 7, mixup_alpha=mc.mixup_alpha, cutmix_alpha=mc.cutmix_alpha,
                               prob=mc.prob, switch_prob=mc.switch_prob, smoothing=0.1, mode=mc.mode, cutmix_minmax=mc.cutmix_minmax)
    draws = jax_mixup_draws(key, 6, 16, 20, mc)
    x, lab = torch.from_numpy(videos), torch.from_numpy(labels)
    got_x, got_t = mixup_batch(x, x.flip(0), lab, lab.flip(0), 7, draws, 0.1)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=1e-6, rtol=1e-6)


def test_cutmix_minmax_boxes_stay_in_range():
    """The port's own draws: CUTMIX.MINMAX sides within [min, max] of the image and fully inside it."""
    from clip_fsar_torch.data.mixup import draw_mixup

    d = draw_mixup(np.random.default_rng(0), 4000, 32, 40, MIX_CASES["elem_minmax"])
    h, w = d.y2 - d.y1, d.x2 - d.x1
    assert (h >= int(32 * 0.2)).all() and (h <= int(32 * 0.8)).all() and (w >= int(40 * 0.2)).all() and (w <= int(40 * 0.8)).all()
    assert (d.y1 >= 0).all() and (d.y2 <= 32).all() and (d.x1 >= 0).all() and (d.x2 <= 40).all()


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------


def _batches(loader, epoch=0):
    loader.set_epoch(epoch)
    return [(v.copy(), lab.copy(), c.copy()) for v, lab, c in loader]


@pytest.mark.parametrize("split, folds", [("train", 1), ("train", 2), ("test", 1)])
def test_loader_is_the_jax_loader_byte_for_byte(tmp_path, split, folds):
    """At the same NUM_WORKERS and seed: the same videos, labels and clip ids
    in the same order (train: shuffled and jittered, NUM_FOLDS shuffles; test:
    2 views a video, the padded tail batch with clip_id -1)."""
    from clip_fsar_tpu.data.classification import build_classification_loader as jax_loader
    from clip_fsar_torch.data.classification import build_classification_loader

    jcfg, cfg = cls_configs(tmp_path, (("TRAIN.NUM_FOLDS", folds), ("TEST.BATCH_SIZE", 5)), train_videos=20, test_videos=7)
    want, got = _batches(jax_loader(jcfg, split), 1), _batches(build_classification_loader(cfg, split), 1)
    assert len(got) == len(want) > 1
    for (v, lab, c), (wv, wl, wc) in zip(got, want):
        assert v.dtype == wv.dtype == np.uint8 and np.array_equal(v, wv) and np.array_equal(lab, wl) and np.array_equal(c, wc)
    if split == "test":
        ids = np.concatenate([c for _, _, c in got])
        assert (ids == -1).sum() == 1 and sorted(ids[ids >= 0].tolist()) == list(range(14))


@pytest.mark.parametrize("split", ["train", "test"])
def test_rank_rows_put_together_are_the_global_batches(tmp_path, split):
    """Two ranks' ``row_range`` loaders (rows [0, 3) and [3, 6) of every batch of
    6) give the one-process batches, padded rows included: a rank draws the
    other rank's random numbers without decoding its clips."""
    from clip_fsar_torch.data.classification import build_classification_loader

    _, cfg = cls_configs(tmp_path, (("TEST.BATCH_SIZE", 6),), train_videos=18, test_videos=5)
    whole = _batches(build_classification_loader(cfg, split))
    parts = [_batches(build_classification_loader(cfg, split, row_range=r)) for r in ((0, 3), (3, 6))]
    for i, (v, lab, c) in enumerate(whole):
        assert np.array_equal(np.concatenate([p[i][0] for p in parts]), v)
        assert np.array_equal(np.concatenate([p[i][1] for p in parts]), lab)
        assert np.array_equal(np.concatenate([p[i][2] for p in parts]), c)


# ---------------------------------------------------------------------------
# meters and metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["sum", "max"])
def test_test_meter_equals_jax(method):
    from clip_fsar_tpu.utils.meters import TestMeter as JaxMeter
    from clip_fsar_torch.utils.meters import TestMeter

    rng = np.random.default_rng(0)
    preds, labels = rng.random((24, 9)), np.repeat(rng.integers(0, 9, 8), 3)
    clip_ids = rng.permutation(24)
    labels = labels[clip_ids]
    meters = [JaxMeter(8, 3, 9, method), TestMeter(8, 3, 9, method)]
    for m in meters:
        for lo in range(0, 24, 5):
            m.update_stats(preds[lo : lo + 5], labels[lo : lo + 5], clip_ids[lo : lo + 5])
    assert np.array_equal(meters[0].video_preds, meters[1].video_preds)
    assert meters[0].finalize_metrics() == meters[1].finalize_metrics()


@pytest.mark.parametrize("method", ["sum", "max"])
def test_epic_kitchen_meter_equals_jax(method):
    from clip_fsar_tpu.utils.meters import EpicKitchenMeter as JaxMeter
    from clip_fsar_torch.utils.meters import EpicKitchenMeter

    rng = np.random.default_rng(1)
    pv, pn = rng.random((12, 4)), rng.random((12, 6))
    lv, ln = np.repeat(rng.integers(0, 4, 6), 2), np.repeat(rng.integers(0, 6, 6), 2)
    meters = [JaxMeter(6, 2, (4, 6), method), EpicKitchenMeter(6, 2, (4, 6), method)]
    for m in meters:
        m.update_stats(pv, pn, lv, ln, np.arange(12))
    assert meters[0].finalize_metrics() == meters[1].finalize_metrics()
    for k, v in meters[0].get_video_preds().items():
        assert np.array_equal(v, meters[1].get_video_preds()[k])


def test_topk_metrics_equal_jax():
    from clip_fsar_tpu.utils import metrics as jm
    from clip_fsar_torch.utils import metrics as pm

    rng = np.random.default_rng(2)
    preds = np.round(rng.random((40, 10)), 1).astype(np.float32)  # ties included
    labels = rng.integers(0, 10, 40)
    got = [float(v) for v in pm.topk_correct(torch.from_numpy(preds), torch.from_numpy(labels), (1, 5))]
    assert got == [float(v) for v in jm.topk_correct(jnp.asarray(preds), jnp.asarray(labels), (1, 5))]
    assert [float(v) for v in pm.topk_errors(torch.from_numpy(preds), torch.from_numpy(labels), (1, 5))] == pytest.approx(
        [float(v) for v in jm.topk_errors(jnp.asarray(preds), jnp.asarray(labels), (1, 5))])
    pb, lb = rng.random((40, 6)).astype(np.float32), rng.integers(0, 6, 40)
    got = pm.joint_topk_correct(torch.from_numpy(preds), torch.from_numpy(pb), torch.from_numpy(labels), torch.from_numpy(lb), (1, 5))
    want = jm.joint_topk_correct(jnp.asarray(preds), jnp.asarray(pb), jnp.asarray(labels), jnp.asarray(lb), (1, 5))
    assert [[float(v) for v in g] for g in got] == [[float(v) for v in w] for w in want]


def test_eval_and_checkpoint_cadence_equals_jax(tmp_path):
    from clip_fsar_tpu.utils import misc as jm
    from clip_fsar_torch.utils import misc as pm

    for opts in ((("SOLVER.MAX_EPOCH", 30), ("TRAIN.EVAL_PERIOD", 5), ("TRAIN.CHECKPOINT_PERIOD", 4)),
                 (("SOLVER.MAX_EPOCH", 12), ("TRAIN.EVAL_PERIOD", 0)), (("SOLVER.MAX_EPOCH", 30), ("PRETRAIN.ENABLE", True))):
        jcfg, cfg = cls_configs(tmp_path, opts)
        for e in range(int(cfg.SOLVER.MAX_EPOCH)):
            assert pm.is_eval_epoch(cfg, e) == jm.is_eval_epoch(jcfg, e)
            assert pm.is_checkpoint_epoch(cfg, e) == jm.is_checkpoint_epoch(jcfg, e)


# ---------------------------------------------------------------------------
# checkpoint surgery
# ---------------------------------------------------------------------------


def _jax_flat_to_port(tree):
    return params_from_jax({"params": tree})


def test_inflate_2d_to_3d_equals_jax(tmp_path):
    """A 2D source (every 3-D kernel's first frame, as a [kh, kw, in, out]
    kernel) inflated into the 3D model: the JAX result, converted, is the
    port's inflation of the converted source."""
    from clip_fsar_tpu.train.pretrain import inflate_2d_to_3d as jax_inflate
    from clip_fsar_torch.train.pretrain import inflate_2d_to_3d

    variables = jax_case("tada2d", 4, TADA, 0, 32)["variables"]
    template = variables["params"]
    src = jax.tree_util.tree_map(lambda k: np.asarray(k)[0] * 2.0 if np.ndim(k) == 5 else np.asarray(k) * 3.0, template)
    want = _jax_flat_to_port(jax_inflate(src, jax.tree_util.tree_map(np.zeros_like, template)))
    port_template = {k: torch.zeros_like(v) for k, v in _jax_flat_to_port(template).items()}
    got = inflate_2d_to_3d(_jax_flat_to_port(src), port_template)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=1e-7, rtol=0, msg=k)
    assert any(v.dim() == 5 and v.shape[2] == 3 for v in got.values())  # a temporal kernel was inflated


VIVIT = (("VIDEO.BACKBONE.DEPTH", 1), ("VIDEO.BACKBONE.NUM_FEATURES", 8), ("VIDEO.BACKBONE.NUM_HEADS", 2), ("VIDEO.BACKBONE.DEPTH_TEMP", 1),
         ("VIDEO.BACKBONE.ATTN_DROPOUT", 0.0), ("VIDEO.BACKBONE.FF_DROPOUT", 0.0), ("VIDEO.BACKBONE.DROP_PATH", 0.0))
SURGERY = {
    "repeat_central_frame_pop_head": ("vivit", (("TRAIN.FINE_TUNE", True), ("TRAIN.CHECKPOINT_PRE_PROCESS.POP_HEAD", True),
                                                 ("TRAIN.CHECKPOINT_PRE_PROCESS.POS_EMBED", "repeat"),
                                                 ("TRAIN.CHECKPOINT_PRE_PROCESS.PATCH_EMBD", "central_frame"))),
    "super_resolution_average": ("vivit_fac_enc", (("TRAIN.CHECKPOINT_PRE_PROCESS.POS_EMBED", "super-resolution"),
                                                    ("TRAIN.CHECKPOINT_PRE_PROCESS.PATCH_EMBD", "average"), ("DATA.TRAIN_CROP_SIZE", 48),
                                                    ("DATA.NUM_INPUT_FRAMES", 8))),
}


@pytest.mark.parametrize("case", list(SURGERY))
def test_preprocess_checkpoint_equals_jax(case):
    """The JAX preprocess_checkpoint on a ViViT-shaped tree (a one-frame patch
    kernel, a 2x2 position grid, a 2-frame temporal table), converted,
    against the port's on the converted tree."""
    from clip_fsar_tpu.config import Config as JaxConfig
    from clip_fsar_tpu.models.video.model import build_video_model as jax_build
    from clip_fsar_tpu.train.pretrain import preprocess_checkpoint as jax_pre
    from clip_fsar_torch.config.config import Config
    from clip_fsar_torch.train.pretrain import preprocess_checkpoint

    preset, opts = SURGERY[case]
    d_src = cfg_dict(preset, 4, VIVIT + (("VIDEO.BACKBONE.TUBELET_SIZE", 1),))  # the checkpoint's model: one-frame tubelets
    shapes = jax.eval_shape(lambda: jax_build(JaxConfig(d_src), dtype=jnp.float32).init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 32, 32, 3)), train=False))
    rng = np.random.default_rng(4)
    src = jax.tree_util.tree_map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes["params"])
    d = cfg_dict(preset, 4, VIVIT + opts)
    want = _jax_flat_to_port(jax_pre(JaxConfig(d), src))
    got = preprocess_checkpoint(Config(d), _jax_flat_to_port(src))
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=1e-6, msg=k)
    assert got["backbone.stem.conv1.weight"].shape[2] == 2
    if case.startswith("repeat"):
        assert not any("head" in k for k in got) and got["backbone.pos_embd"].shape[1] == 2 * 16 + 1  # 16 patches once per tubelet frame
    else:
        assert got["backbone.pos_embd"].shape[1] == 9 + 1 and got["backbone.temp_embd"].shape[1] == 4 + 1


def test_test_weights_search_order_equals_jax(tmp_path):
    """TEST.CHECKPOINT_FILE_PATH -> the last OUTPUT_DIR checkpoint ->
    TRAIN.CHECKPOINT_FILE_PATH -> fresh: with JAX ``.npz`` archives at both
    paths (a missing one passed over), the port tests what the JAX package's
    load_test_variables returns; a checkpoint in OUTPUT_DIR comes before the
    train path."""
    from clip_fsar_tpu.config import Config as JaxConfig
    from clip_fsar_tpu.train.pretrain import load_test_variables as jax_load, save_weights_npz
    from clip_fsar_torch.config.config import Config
    from clip_fsar_torch.models.video.model import build_video_model
    from clip_fsar_torch.train.checkpoint import Checkpointer
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.pretrain import load_test_variables
    from clip_fsar_torch.train.state import TrainState

    variables = jax_case("tada2d", 4, TADA, 0, 32)["variables"]
    scaled = {"params": jax.tree_util.tree_map(lambda v: v * 2.0, variables["params"]), "batch_stats": variables["batch_stats"]}
    save_weights_npz(str(tmp_path / "a.npz"), variables)
    save_weights_npz(str(tmp_path / "b.npz"), scaled)
    fresh_stats = jax.tree_util.tree_map_with_path(lambda path, v: np.full_like(v, 1.0 if path[-1].key == "var" else 0.0), variables["batch_stats"])
    template = {"params": jax.tree_util.tree_map(np.zeros_like, variables["params"]), "batch_stats": fresh_stats}
    scenarios = [(str(tmp_path / "a.npz"), str(tmp_path / "b.npz")), (str(tmp_path / "missing.npz"), str(tmp_path / "b.npz")),
                 ("", ""), ("", str(tmp_path / "a.npz"))]
    for test_path, train_path in scenarios:
        d = cfg_dict("tada2d", 4, TADA + (("TEST.CHECKPOINT_FILE_PATH", test_path), ("TRAIN.CHECKPOINT_FILE_PATH", train_path),
                                           ("OUTPUT_DIR", str(tmp_path / "none"))))
        want = params_from_jax(jax_load(JaxConfig(d), None, None, template))
        model = build_video_model(Config(d))
        with torch.no_grad():
            for p in model.parameters():
                p.zero_()
        load_test_variables(Config(d), Checkpointer(str(tmp_path / "none")), model)
        got = model.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want), (test_path, train_path)
    d = cfg_dict("tada2d", 4, TADA + (("TRAIN.CHECKPOINT_FILE_PATH", str(tmp_path / "a.npz")), ("OUTPUT_DIR", str(tmp_path / "run"))))
    model = build_video_model(Config(d))
    Checkpointer(str(tmp_path / "run")).save(3, TrainState.create(Config(d), model, Optimizer(Config(d), model, name_prefix="")))
    assert load_test_variables(Config(d), Checkpointer(str(tmp_path / "run")), model).endswith(os.path.join("checkpoints", "3.pt"))


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_pretraining_and_mosi_raise_before_any_work(tmp_path):
    """Self-supervised pretraining is ported (MoSINet and the MoSI heads
    build; PRETRAIN.ENABLE trains them); a mesh it cannot run on still
    raises before any model or loader is made: TPU.MESH.MODEL 2 on one
    process (the JAX package's ValueError: the model axis must divide the
    devices) through the trainer and through TASK_TYPE pretrain on the CLI."""
    from clip_fsar_torch.models.video import model as vmodel
    from clip_fsar_torch.runs import run
    from clip_fsar_torch.train import classification

    _, cfg = cls_configs(tmp_path, (("PRETRAIN.ENABLE", True), ("TPU.MESH.MODEL", 2)))
    with mock.patch.object(classification, "build_video_model", side_effect=AssertionError("built")):
        with pytest.raises(ValueError, match="TPU.MESH.MODEL=2 must divide the device count 1"):
            classification.train(cfg, device="cpu")
    _, cfg = cls_configs(tmp_path, (("MODEL.NAME", "MoSINet"), ("VIDEO.HEAD.NAME", "MoSIHeadJoint"), ("PRETRAIN.ENABLE", True),
                                    ("VIDEO.HEAD.NUM_CLASSES", 3)))
    model = vmodel.build_video_model(cfg)
    assert isinstance(model, vmodel.MoSINet) and isinstance(model.net.head, vmodel.MoSIHeadJoint)
    cfg_path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "pool", "run", "training", "mosi.yaml")
    with mock.patch.object(classification, "build_video_model", side_effect=AssertionError("built")):
        with pytest.raises(ValueError, match="TPU.MESH.MODEL=2 must divide the device count 1"):
            run.main(["--cfg", cfg_path, "--device", "cpu", "TASK_TYPE", "pretrain", "TPU.MESH", "{DATA: -1, MODEL: 2}", "OUTPUT_DIR", str(tmp_path / "p")])
    assert not os.path.exists(tmp_path / "p" / "checkpoints")
