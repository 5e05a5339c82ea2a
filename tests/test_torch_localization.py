"""The localization task of clip_fsar_torch against clip_fsar_tpu on the CPU,
at T = 32, N = 8 samples (3 per bin), 16 feature channels: the boundary
matching mask, SimpleLocalizationConv + BaseBMN with converted weights (with
and without the regression and verb/noun maps), the four BMN losses with the
JAX draws injected, three train steps against jitted JAX steps, the label
maps and the TAL post-processing and mAP on the same arrays, and the two
deliberate divergences (DATA.DURATION_SCALE <= 0, the submission's
weights)."""

import functools
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

T, N_SAMPLE, CHANNELS = 32, 8, 16


def tal_dict(out_dir: str, dscale: int = 0, regression: bool = False, classes=(3, 4), loss: str = "Tem+PemReg+PemCls",
             weights=(1, 10, 1)) -> dict:
    """One localization config for both packages (tests/test_localization.py's, at the sizes above)."""
    head = {"NAME": "BaseBMN", "NUM_SAMPLE": N_SAMPLE, "NUM_SAMPLE_PERBIN": 3, "BOUNDARY_RATIO": 0.5, "USE_BMN_REGRESSION": regression}
    if classes is not None:
        head["NUM_CLASSES"] = list(classes)
    return {
        "TASK_TYPE": "localization",
        "PRETRAIN": {"ENABLE": False},
        "LOCALIZATION": {"ENABLE": True, "LOSS": loss, "LOSS_WEIGHTS": list(weights), "POS_REG_THRES": 0.7, "NEG_REG_THRES": 0.3,
                         "POS_CLS_THRES": 0.9, "SOFT_NMS_ALPHA": 0.4, "SOFT_NMS_LOW_THRES": 0.5, "SOFT_NMS_HIGH_THRES": 0.9, "PROP_NUM": 50},
        "TRAIN": {"BATCH_SIZE": 4, "BATCH_SIZE_PER_TASK": 1, "AUTO_RESUME": False},
        "TEST": {"BATCH_SIZE": 4, "TEST_SET": "val"},
        "DATA": {"TEMPORAL_SCALE": T, "DURATION_SCALE": dscale, "NUM_INPUT_CHANNELS": CHANNELS, "DECODER": "synthetic"},
        "VIDEO": {"DIM1D": 32, "DIM2D": 16, "DIM3D": 16, "BACKBONE_LAYER": 2, "BACKBONE_GROUPS_NUM": 4, "HEAD": head},
        "SOLVER": {"BASE_LR": 1e-3, "LR_POLICY": "cosine", "MAX_EPOCH": 2, "WARMUP_EPOCHS": 0, "WARMUP_START_LR": 1e-6, "OPTIM_METHOD": "adam",
                   "WEIGHT_DECAY": 1e-4, "MOMENTUM": 0.9, "NESTEROV": False},
        "BN": {"WEIGHT_DECAY": 0.0},
        "AUGMENTATION": {"LABEL_SMOOTHING": 0.0},
        "RANDOM_SEED": 0,
        "OUTPUT_DIR": out_dir,
        "LOG_PERIOD": 1,
        "SUBMISSION": {"SAVE_RESULTS_PATH": "sub.json"},
    }


def configs(d: dict):
    from clip_fsar_tpu.config import Config as JaxConfig
    from clip_fsar_torch.config.config import Config

    return JaxConfig(json.loads(json.dumps(d))), Config(json.loads(json.dumps(d)))


@functools.lru_cache(maxsize=None)
def jax_variables(dscale: int = 0, regression: bool = False, classes=(3, 4)):
    """The JAX BMNModel's fresh variables (its runners' init, RANDOM_SEED 0) as numpy."""
    from clip_fsar_tpu.train.localization import BMNModel

    jcfg, _ = configs(tal_dict("/nonexistent", dscale, regression, classes))
    return jax.device_get(BMNModel(jcfg).init(jax.random.PRNGKey(0)))


def port_model(d: dict, variables):
    from clip_fsar_torch.models.video.convert import params_from_jax
    from clip_fsar_torch.train.localization import build_bmn_model

    _, cfg = configs(d)
    model = build_bmn_model(cfg)
    model.load_state_dict(params_from_jax(variables))
    return model


def window_batch(seed: int = 0, batch: int = 3):
    return np.random.default_rng(seed).normal(size=(batch, T, CHANNELS)).astype(np.float32)


def test_boundary_matching_mask_is_the_jax_mask():
    """The vectorized mask against the JAX package's loop, bit for bit, at the
    test sizes, at D < T, and at another per-bin count and ratio; a single
    proposal's column against ``interp1d_bin_mask``."""
    from clip_fsar_tpu.models.heads.bmn import boundary_matching_mask as jax_mask
    from clip_fsar_torch.models.heads.bmn import boundary_matching_mask, interp1d_bin_mask, mask_matrix

    for args in ((T, T, N_SAMPLE, 3, 0.5), (T, 12, N_SAMPLE, 3, 0.5), (20, 20, 5, 2, 0.25)):
        got, want = boundary_matching_mask(*args), jax_mask(*args)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    m = boundary_matching_mask(T, T, N_SAMPLE, 3, 0.5)
    np.testing.assert_array_equal(m[:, :, 4, 7], interp1d_bin_mask(7 - 5 * 0.5, 11 + 5 * 0.5, T, N_SAMPLE, 3).astype(np.float32))
    assert mask_matrix(T, T, N_SAMPLE, 3, 0.5).shape == (T, N_SAMPLE * T * T)


@pytest.mark.parametrize("regression, classes", [(False, None), (True, None), (False, (3, 4)), (True, (3, 4))])
def test_bmn_forward_matches_jax(tmp_path, regression, classes):
    """SimpleLocalizationConv + BaseBMN with the JAX weights converted: every
    output map at 1e-4 in fp32; the state dict has no mask (it is a buffer
    outside it, as the JAX mask is outside ``params``)."""
    from clip_fsar_tpu.train.localization import BMNModel

    d = tal_dict(str(tmp_path), 0, regression, classes)
    jcfg, _ = configs(d)
    variables = jax_variables(0, regression, classes)
    x = window_batch()
    want = jax.device_get(jax.jit(lambda v, x_: BMNModel(jcfg).module.apply(v, x_, train=False)[0])(variables, jnp.asarray(x)))
    model = port_model(d, variables)
    assert "head.bm_mask" not in model.state_dict()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for key in ("start", "end", "confidence_map", "reg_map", "verb_map", "noun_map"):
        if isinstance(want[key], dict):
            assert got[key] is None, key
            continue
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=1e-4, rtol=1e-4, err_msg=key)
    assert got["confidence_map"].shape == (3, 2, T, T)


def random_maps(seed: int = 0, batch: int = 3, classes=(3, 4)):
    rng = np.random.default_rng(seed)
    iou = rng.random((batch, T, T)).astype(np.float32)
    iou[:, :4, :4] = 0.95  # some cells above every threshold
    mask = np.triu(np.ones((T, T), np.float32))[::-1].copy()  # valid (duration, start) cells
    return {"start_map": (rng.random((batch, T)) > 0.8).astype(np.float32), "end_map": (rng.random((batch, T)) > 0.8).astype(np.float32),
            "iou_map": iou, "mask": np.broadcast_to(mask, (batch, T, T)).copy(),
            "label_map": np.stack([rng.integers(0, classes[0], (batch, T, T)), rng.integers(0, classes[1], (batch, T, T))], 1).astype(np.int32)}


def test_losses_match_jax_with_its_draws(tmp_path):
    """Loss_Tem, Loss_PemReg (fed the two uniform fields the JAX loss draws
    from its key), Loss_PemCls and Loss_BmnActionCls through both packages'
    calculate_loss on the same predictions and label maps: every part and the
    weighted sum at 1e-5."""
    from clip_fsar_tpu.train.losses import calculate_loss as jax_loss
    from clip_fsar_torch.train.losses import calculate_loss

    d = tal_dict(str(tmp_path), loss="Tem+PemReg+PemCls+BmnActionCls", weights=(1, 10, 1, 0.5))
    jcfg, cfg = configs(d)
    rng = np.random.default_rng(1)
    preds = {"start": rng.random((3, T)), "end": rng.random((3, T)), "confidence_map": rng.random((3, 2, T, T)),
             "verb_map": rng.normal(size=(3, 3, T, T)), "noun_map": rng.normal(size=(3, 4, T, T))}
    preds = {k: v.astype(np.float32) for k, v in preds.items()}
    maps = random_maps()
    key = jax.random.PRNGKey(5)
    want, want_parts = jax_loss(jcfg, {k: jnp.asarray(v) for k, v in preds.items()}, None, {"supervised": {k: jnp.asarray(v) for k, v in maps.items()}},
                                rng=key)
    r1, r2 = jax.random.split(key)
    draws = tuple(torch.from_numpy(np.array(jax.random.uniform(r, (3, T, T)))) for r in (r1, r2))
    got, parts = calculate_loss(cfg, {k: torch.from_numpy(v) for k, v in preds.items()}, None,
                                {"supervised": {k: torch.from_numpy(v) for k, v in maps.items()}}, draws=draws)
    assert set(parts) == set(want_parts) == {"tem", "pem_reg", "pem_cls", "verb_loss", "noun_loss"}
    for k in parts:
        np.testing.assert_allclose(float(parts[k]), float(want_parts[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)


def _jax_step(jcfg, variables):
    """The JAX train_localization's jitted step (localization.py:66-75) and its state."""
    import optax

    from clip_fsar_tpu.train.localization import BMNModel
    from clip_fsar_tpu.train.losses import calculate_loss
    from clip_fsar_tpu.train.optimizer import apply_lr, build_optimizer
    from clip_fsar_tpu.train.state import TrainState

    model = BMNModel(jcfg)
    tx = build_optimizer(jcfg, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"], opt_state=tx.init(variables["params"]))

    def loss_fn(params, feats, maps, rng):
        preds, _ = model.module.apply({"params": params}, feats, train=True)
        return calculate_loss(jcfg, preds, None, {"supervised": maps}, rng=rng)

    @jax.jit
    def step(state, feats, maps, lr, rng):
        (loss, parts), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params, feats, maps, rng)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        return state.replace(step=state.step + 1, params=optax.apply_updates(state.params, apply_lr(updates, lr)), opt_state=opt_state), loss

    return state, step


def test_three_train_steps_match_jax(tmp_path):
    """Three port train steps (Adam, weight decay 1e-4, the regression and
    verb/noun maps built, Loss_PemReg fed the JAX steps' draws) against
    three jitted JAX steps from the same converted weights: the losses at
    1e-4 and every parameter after the steps at 1e-4.  The step reads
    nothing back from a tensor."""
    from tests.torch_parity import host_reads

    from clip_fsar_torch.models.video.convert import params_from_jax
    from clip_fsar_torch.train.localization import make_localization_train_step
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.state import TrainState

    d = tal_dict(str(tmp_path), 0, True, (3, 4))
    jcfg, cfg = configs(d)
    variables = jax_variables(0, True, (3, 4))
    batches = [(window_batch(10 + i), random_maps(10 + i)) for i in range(3)]
    lrs = (1e-3, 8e-4, 5e-4)
    state, step = _jax_step(jcfg, variables)
    want = []
    for i, (x, maps) in enumerate(batches):
        state, loss = step(state, jnp.asarray(x), {k: jnp.asarray(v) for k, v in maps.items()}, jnp.float32(lrs[i]), jax.random.PRNGKey(i))
        want.append(float(loss))

    model = port_model(d, variables)
    pstate = TrainState.create(cfg, model, Optimizer(cfg, model, name_prefix=""))
    train_step = make_localization_train_step(model, cfg)
    got = []
    for i, (x, maps) in enumerate(batches):
        r1, r2 = jax.random.split(jax.random.PRNGKey(i))
        draws = tuple(torch.from_numpy(np.array(jax.random.uniform(r, (3, T, T)))) for r in (r1, r2))
        with host_reads() as reads:
            loss, _ = train_step(pstate, torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in maps.items()}, lrs[i], draws=draws)
        assert reads == [], reads
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    trained = params_from_jax({"params": jax.device_get(state.params)})
    start = params_from_jax(variables)
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), trained[name], atol=1e-4, rtol=0, msg=lambda m, name=name: f"{name}: {m}")
    assert max(float((p.detach() - start[n]).abs().max()) for n, p in model.named_parameters()) > 1e-4


def test_window_label_maps_and_dataset_match_jax(tmp_path):
    """window_label_maps on random segments and every window of the
    synthetic train split: the JAX package's arrays exactly."""
    from clip_fsar_tpu.data.tal_features import TalFeatureDataset as JaxDataset, window_label_maps as jax_maps
    from clip_fsar_torch.data.tal_features import TalFeatureDataset, window_label_maps

    rng = np.random.default_rng(2)
    for n in (0, 1, 3):
        segs = np.sort(rng.uniform(-0.2, 1.2, (n, 2)), axis=1).astype(np.float32)
        labs = rng.integers(0, 5, (n, 2)).astype(np.int32)
        for dscale in (T, 12):
            got, want = window_label_maps(T, dscale, segs, labs), jax_maps(T, dscale, segs, labs)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jcfg, cfg = configs(tal_dict(str(tmp_path)))
    ds, jds = TalFeatureDataset(cfg, "train"), JaxDataset(jcfg, "train")
    assert ds.windows == jds.windows and ds.annotations == jds.annotations
    for i in range(len(ds)):
        (f, m, meta), (jf, jm, jmeta) = ds.get_item(i), jds.get_item(i)
        assert meta == jmeta
        np.testing.assert_array_equal(f, jf)
        for k in jm:
            np.testing.assert_array_equal(m[k], jm[k], err_msg=k)


def test_post_processing_and_map_match_jax_exactly(tmp_path):
    """The JAX model's predictions on the synthetic val windows through both
    packages' proposal parsing (parse_bmn_proposals, fuse_verb_noun_map),
    soft-NMS, score fan-out and the three-stream mAP: the same proposals,
    detections and mAP numbers.  Also the utilities alone on random input."""
    from clip_fsar_tpu.data.tal_features import TalFeatureDataset as JaxDataset
    from clip_fsar_tpu.train import localization as jloc
    from clip_fsar_tpu.utils import tal as jtal
    from clip_fsar_torch.data.tal_features import TalFeatureDataset
    from clip_fsar_torch.train import localization as ploc
    from clip_fsar_torch.utils import tal

    d = tal_dict(str(tmp_path), 0, True, (3, 4))
    jcfg, cfg = configs(d)
    variables = jax_variables(0, True, (3, 4))
    apply = jax.jit(lambda v, x_: jloc.BMNModel(jcfg).module.apply(v, x_, train=False)[0])
    jds, ds = JaxDataset(jcfg, "val"), TalFeatureDataset(cfg, "val")
    jprops, props = {}, {}
    for feats, _maps, metas in jloc._batches(jds, 4, False, 0):
        preds = jax.device_get(apply(variables, jnp.asarray(feats)))
        for v, pl in jloc._window_proposals(jcfg, preds, metas, jds).items():
            jprops.setdefault(v, []).extend(pl)
        host = {k: (None if isinstance(p, dict) else np.asarray(p)) for k, p in preds.items()}
        for v, pl in ploc._window_proposals(cfg, host, metas, ds).items():
            props.setdefault(v, []).extend(pl)
    assert sum(len(p) for p in props.values()) > 0

    def plain(p):
        return {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in p.items()}

    assert {v: [plain(p) for p in pl] for v, pl in props.items()} == {v: [plain(p) for p in pl] for v, pl in jprops.items()}
    want_dets, dets = jloc._post_process(jcfg, jprops, jds), ploc._post_process(cfg, props, ds)
    assert dets == want_dets
    stats = ploc.evaluate_detections(dets, ds)
    tious = ploc.TIOUS
    for stream in ("action", "verb", "noun"):
        gt = {v: [(a["segment"][0], a["segment"][1], a["verb"] if stream == "verb" else (a["noun"] if stream == "noun" else (a["verb"], a["noun"])))
                  for a in info["annotations"]] for v, info in jds.annotations.items()}
        pred = {v: [(q["segment"][0], q["segment"][1], q["score"], q["verb"] if stream == "verb" else (q["noun"] if stream == "noun" else (q["verb"], q["noun"])))
                    for q in qs] for v, qs in want_dets.items()}
        for k, val in jtal.detection_map(gt, pred, tiou_thresholds=tious).items():
            assert stats[f"{stream}/{k}"] == val

    rng = np.random.default_rng(3)
    for _ in range(3):
        s, e, conf, reg = rng.random(T), rng.random(T), rng.random((2, T, T)), rng.normal(size=(2, T, T)) * 0.1
        assert tal.parse_bmn_proposals(s, e, conf, reg) == jtal.parse_bmn_proposals(s, e, conf, reg)
        vs, ns = rng.random(20), rng.random(40)
        for a, b in zip(tal.fuse_verb_noun_map(vs, ns), jtal.fuse_verb_noun_map(vs, ns)):
            np.testing.assert_array_equal(a, b)
        p = [{"xmin": float(a), "xmax": float(a + w), "score": float(sc)} for a, w, sc in zip(rng.random(30), rng.random(30) * 0.3, rng.random(30))]
        assert tal.soft_nms([dict(q) for q in p], 0.4, 0.2, 0.9, 10) == jtal.soft_nms([dict(q) for q in p], 0.4, 0.2, 0.9, 10)
        gt = {"a": [(0.0, 10.0, 0), (20.0, 30.0, 1)], "b": [(5.0, 9.0, 1)]}
        pr = {v: [(float(x), float(x + 8), float(sc), int(c)) for x, sc, c in zip(rng.random(6) * 25, rng.random(6), rng.integers(0, 3, 6))]
              for v in ("a", "b")}
        assert tal.detection_map(gt, pr) == jtal.detection_map(gt, pr)
        assert tal.detection_map(gt, pr, num_classes=3) == jtal.detection_map(gt, pr, num_classes=3)


def test_duration_scale_divergence(tmp_path):
    """DATA.DURATION_SCALE -1 (the shipped run preset's value): the JAX
    package reads it as a duration scale of -1 and cannot build its mask;
    the port reads it (and 0) as TEMPORAL_SCALE.  At 0 and at an explicit D
    the port's dataset and model match the JAX package's."""
    from clip_fsar_tpu.data.tal_features import TalFeatureDataset as JaxDataset
    from clip_fsar_tpu.models.heads.bmn import boundary_matching_mask as jax_mask
    from clip_fsar_tpu.train.localization import BMNModel as JaxBMN
    from clip_fsar_torch.data.tal_features import TalFeatureDataset, duration_scale

    jcfg, cfg = configs(tal_dict(str(tmp_path), -1))
    with pytest.raises(ValueError):
        jax_mask(T, int(jcfg.DATA.get("DURATION_SCALE", 0) or 0) or T, N_SAMPLE, 3, 0.5)
    with pytest.raises(ValueError):
        JaxBMN(jcfg).init(jax.random.PRNGKey(0))
    assert duration_scale(cfg) == T and TalFeatureDataset(cfg, "train").dscale == T
    x = window_batch(4)
    for dscale in (0, 12):
        d = tal_dict(str(tmp_path), dscale, False, None)
        jcfg, cfg = configs(d)
        assert TalFeatureDataset(cfg, "val").dscale == JaxDataset(jcfg, "val").dscale == (dscale or T)
        variables = jax_variables(dscale, False, None)
        want = jax.device_get(jax.jit(lambda v, x_: JaxBMN(jcfg).module.apply(v, x_, train=False)[0])(variables, jnp.asarray(x)))
        with torch.no_grad():
            got = port_model(d, variables)(torch.from_numpy(x))
        assert got["confidence_map"].shape == (len(x), 2, dscale or T, T)
        np.testing.assert_allclose(got["confidence_map"].numpy(), want["confidence_map"], atol=1e-4, rtol=1e-4)
    _, cfg = configs(tal_dict(str(tmp_path), -1, False, None))
    with torch.no_grad():
        got = port_model(tal_dict(str(tmp_path), -1, False, None), jax_variables(0, False, None))(torch.from_numpy(x))
    assert got["confidence_map"].shape == (len(x), 2, T, T)


def test_submission_divergence(tmp_path):
    """The JAX submission_test writes the predictions of fresh weights
    (PRNGKey(0)) and reads no checkpoint; the port's reads the newest
    OUTPUT_DIR checkpoint.  The JAX seed-0 weights, converted and saved as
    the port's checkpoint, give the JAX package's JSON: the same videos,
    detections, labels and segments, scores at 1e-5."""
    from clip_fsar_tpu.train.localization import submission_test as jax_submission
    from clip_fsar_torch.train.checkpoint import Checkpointer
    from clip_fsar_torch.train.localization import submission_test
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.state import TrainState

    d = tal_dict(str(tmp_path / "jax"), 0, True, (3, 4))
    jcfg, _ = configs(d)
    with open(jax_submission(jcfg)) as f:
        want = json.load(f)
    d["OUTPUT_DIR"] = str(tmp_path / "port")
    _, cfg = configs(d)
    model = port_model(d, jax_variables(0, True, (3, 4)))
    Checkpointer(cfg.OUTPUT_DIR).save(2, TrainState.create(cfg, model, Optimizer(cfg, model, name_prefix="")))
    result = submission_test(cfg, device="cpu")
    assert result["weights"].endswith(os.path.join("checkpoints", "2.pt"))
    with open(result["path"]) as f:
        got = json.load(f)
    assert {k: v for k, v in got.items() if k != "results"} == {k: v for k, v in want.items() if k != "results"}
    assert got["results"].keys() == want["results"].keys() and sum(len(v) for v in want["results"].values()) > 0
    for video, dets in want["results"].items():
        assert len(got["results"][video]) == len(dets), video
        for g, w in zip(got["results"][video], dets):
            assert {k: g[k] for k in ("label", "verb", "noun")} == {k: w[k] for k in ("label", "verb", "noun")}
            np.testing.assert_allclose(g["segment"], w["segment"], rtol=1e-6)
            np.testing.assert_allclose(g["score"], w["score"], rtol=1e-5, atol=1e-7)
    # without a checkpoint the port tests its fresh weights, and says so
    d["OUTPUT_DIR"] = str(tmp_path / "fresh")
    assert submission_test(configs(d)[1], device="cpu")["weights"] == "fresh"


def test_runners_refuse_a_process_group(tmp_path):
    """The three localization runners raise before any work under a process
    group of more than one rank (WORLD_SIZE from the launcher, or a group
    already joined)."""
    from clip_fsar_torch.parallel import mesh
    from clip_fsar_torch.train import localization

    _, cfg = configs(tal_dict(str(tmp_path)))
    for runner in (localization.train_localization, localization.test_epic_localization, localization.submission_test):
        with mock.patch.dict(os.environ, {"WORLD_SIZE": "2"}), pytest.raises(NotImplementedError, match="one process"):
            runner(cfg, device="cpu")
        with mock.patch.object(mesh, "world_size", return_value=2), pytest.raises(NotImplementedError, match="one process"):
            runner(cfg, device="cpu")
    assert not os.path.exists(tmp_path / "checkpoints") and not os.path.exists(tmp_path / "sub.json")
