"""The frame banks of clip_fsar_torch (data/frame_bank.py) against the port's
own pixel path and against the JAX package's banks, on cv2-written 72x56
videos through the cached_opencv decoder with FRAME_CACHE_FRAMES 8 (the bank
grid), ViT-Tiny-Test at 64 px, 4 frames, 3-way 1-shot, float32.

With the bank grid equal to the decoder's cache grid the bank must give the
pixel path's episodes bit for bit, so the port's bank-mode evaluation and
train steps equal its pixel path exactly; against the JAX package the index
samplers' draws and the banks' pixels are byte-equal, and the metrics and
losses agree at the tolerances of tests/test_torch_train.py."""

import functools
import os
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from clip_fsar_torch.config.config import load_config  # noqa: E402
from clip_fsar_torch.data import frame_bank  # noqa: E402
from clip_fsar_torch.data.datasets import DATASET_REGISTRY  # noqa: E402
from clip_fsar_torch.data.loader import build_few_shot_loader  # noqa: E402
from clip_fsar_torch.data.transforms import fewshot_train_stretch, fewshot_train_transform  # noqa: E402
from clip_fsar_torch.models.builder import FewShotModel  # noqa: E402
from clip_fsar_torch.models.heads.clipfsar import CLIPFSARConfig, CLIPFSARHead  # noqa: E402
from clip_fsar_torch.train import optimizer as topt  # noqa: E402
from clip_fsar_torch.train.loop import evaluate, train_few_shot  # noqa: E402
from clip_fsar_torch.train.state import TrainState  # noqa: E402
from clip_fsar_torch.train.step import make_train_step  # noqa: E402
from tests.torch_parity import CONFIG, host_reads, jax_tiny_clip, port_head_state  # noqa: E402

torch.set_num_threads(2)

WAYS, PER_CLASS, FRAMES, CROP = 3, 4, 4, 64
# the train step of tests/test_torch_train.py (lr 1e-3 from the first step, one update per step, E = 2), in 2 episode chunks
TRAIN_OPTS = ["TRAIN.ENABLE", "True", "SOLVER.BASE_LR", "1e-3", "SOLVER.WARMUP_EPOCHS", "0", "TPU.EPISODES_PER_STEP", "2",
              "TRAIN.BATCH_SIZE_PER_TASK", "1", "TPU.EPISODE_CHUNKS", "2"]


def _write_video(path, seed, n_frames=20, size=(72, 56)):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 255, (size[1], size[0], 3)).astype(np.uint8)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 12.0, size)
    assert writer.isOpened()
    for i in range(n_frames):
        writer.write(np.roll(base, i * 3, axis=1))
    writer.release()


@functools.lru_cache(maxsize=None)
def _root() -> str:
    """A train and a test split of WAYS classes x PER_CLASS videos, written once per process."""
    import tempfile

    root = tempfile.mkdtemp(prefix="torch_frame_bank_")
    for split in ("train", "test"):
        lines = []
        for c in range(WAYS):
            for v in range(PER_CLASS):
                rel = f"videos/{split}_c{c}_v{v}.mp4"
                _write_video(os.path.join(root, rel), seed=c * 31 + v + (0 if split == "test" else 500), n_frames=20 + 3 * v)
                lines.append(f"{split}{c}//{rel}")
        with open(os.path.join(root, f"{split}_few_shot.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return root


def _opts(*extra):
    root = _root()
    return ["DATA.DECODER", "cached_opencv", "DATA.ANNO_DIR", root, "DATA.DATA_ROOT_DIR", root,
            "DATA.FRAME_CACHE_DIR", os.path.join(root, "cache"), "DATA.FRAME_CACHE_FRAMES", "8", "TRAIN.DATASET_FEW", "HMDB_few_shot",
            "TRAIN.WAY", str(WAYS), "TRAIN.SHOT", "1", "TRAIN.QUERY_PER_CLASS", "1", "TRAIN.QUERY_PER_CLASS_TEST", "1",
            "DATA.NUM_INPUT_FRAMES", str(FRAMES), "DATA.TRAIN_CROP_SIZE", str(CROP), "DATA.TRAIN_JITTER_SCALES", "[96, 96]",
            "DATA.TEST_CROP_SIZE", str(CROP), "DATA.TEST_SCALE", str(CROP), "VIDEO.HEAD.BACKBONE_NAME", "ViT-Tiny-Test",
            "TPU.COMPUTE_DTYPE", "float32", "TPU.MESH.DATA", "1", "DATA_LOADER.NUM_WORKERS", "2", "LOG_PERIOD", "1",
            "OUTPUT_DIR", os.path.join(root, "out"), *extra]


def port_cfg(*extra):
    return load_config(CONFIG, _opts(*extra))


def jax_cfg(*extra):
    from clip_fsar_tpu.config.config import load_config as jax_load_config

    return jax_load_config(CONFIG, _opts(*extra))


@functools.lru_cache(maxsize=None)
def _jax_banks():
    """The JAX package's eval bank of the test split and train bank (numpy) with their tables."""
    from clip_fsar_tpu.data.frame_bank import build_eval_frame_bank, build_train_frame_bank

    return build_eval_frame_bank(jax_cfg(), "test"), build_train_frame_bank(jax_cfg())


def test_banks_equal_the_jax_banks_byte_for_byte():
    """Both banks hold the JAX banks' pixels and tables: the same videos in the same rows, the same grid."""
    (jax_eval, jax_eval_table), (jax_train, jax_train_table) = _jax_banks()
    for got, want, want_table in ((frame_bank.build_eval_frame_bank(port_cfg(), "test", "cpu"), jax_eval, jax_eval_table),
                                  (frame_bank.build_train_frame_bank(port_cfg(), "cpu"), jax_train, jax_train_table)):
        np.testing.assert_array_equal(got.pixels.numpy(), want)
        for field in ("orig_idx", "nframes", "length", "fps"):
            np.testing.assert_array_equal(getattr(got.table, field), getattr(want_table, field))
        assert got.table.row_of_path == want_table.row_of_path and got.table.frames_per_video == want_table.frames_per_video == 8
    assert got.pixels.shape == (WAYS * PER_CLASS * 8, 96, 96, 3) and got.nbytes == got.pixels.numel()


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_index_samplers_draw_what_the_jax_samplers_and_the_pixel_path_draw(mode):
    """For the same (seed, step, slot) the port's index sampler emits the JAX
    one's int32 rows (and, in train mode, (y, x, flip)) byte for byte, and
    gathering them from the port's bank (cropping and flipping in train mode)
    gives the port's pixel sampler's clips."""
    from clip_fsar_tpu.data import frame_bank as jax_bank
    from clip_fsar_tpu.data.loader import DATASET_REGISTRY as JAX_DATASETS

    split = "test" if mode == "eval" else "train"
    cfg, jcfg = port_cfg(), jax_cfg()
    if mode == "eval":
        bank = frame_bank.build_eval_frame_bank(cfg, split, "cpu")
        port_wrap, jax_wrap, jax_table = frame_bank.IndexEpisodeSampler, jax_bank.IndexEpisodeSampler, _jax_banks()[0][1]
        clips = lambda idx: frame_bank.gather_eval_clips(bank.pixels, torch.from_numpy(idx)).numpy()  # noqa: E731
    else:
        bank = frame_bank.build_train_frame_bank(cfg, "cpu")
        port_wrap, jax_wrap, jax_table = frame_bank.TrainIndexEpisodeSampler, jax_bank.TrainIndexEpisodeSampler, _jax_banks()[1][1]
        clips = lambda idx: frame_bank.assemble_train_clips(bank.pixels, torch.from_numpy(idx), FRAMES, CROP).numpy()  # noqa: E731
    dataset = DATASET_REGISTRY.get("HMDB_few_shot")(cfg, split)
    pixel, port = dataset.make_sampler(0), port_wrap(dataset.make_sampler(0), bank.table)
    jax_sampler = jax_wrap(JAX_DATASETS.get("HMDB_few_shot")(jcfg, split).make_sampler(0), jax_table)
    flips = 0
    for step in range(4):
        for sampler in (pixel, port, jax_sampler):
            sampler.reseed_for_slot(step, 0)
        want, got, ref = pixel.sample_episode(), port.sample_episode(), jax_sampler.sample_episode()
        for field in ("support_images", "target_images", "support_labels", "real_support_labels", "target_labels", "batch_class_list"):
            a, b = getattr(got, field), getattr(ref, field)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
        assert got.support_images.dtype == np.int32
        np.testing.assert_array_equal(clips(got.support_images), want.support_images)
        np.testing.assert_array_equal(clips(got.target_images), want.target_images)
        if mode == "train":
            assert got.target_images.shape[-1] == FRAMES + 3
            flips += int(got.target_images[:, -1].sum())
    assert mode == "eval" or flips > 0, "4 steps x 3 query clips should draw a flip"


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_train_stretch_equals_jax_and_its_crop_is_the_fused_transform(native):
    """``fewshot_train_stretch`` equals the JAX package's bit for bit (through
    the native pass and the numpy replica); cropping it at the (y, x) that
    ``fewshot_train_transform`` draws, and mirroring where it flips, gives
    that transform's fused resize + crop exactly."""
    from clip_fsar_tpu.data.transforms import fewshot_train_stretch as jax_stretch

    from clip_fsar_torch.native import frameops

    if native and not frameops.available():
        pytest.skip(f"the native resize is not built here: {frameops.failure()}")
    cfg = port_cfg("DATA.TRAIN_JITTER_SCALES", "[96, 112]")
    frames = np.random.RandomState(3).randint(0, 256, (3, 56, 72, 3), dtype=np.uint8)
    frameops.set_enabled(native)
    try:
        stretched = fewshot_train_stretch(frames, cfg)
        np.testing.assert_array_equal(stretched, jax_stretch(frames, jax_cfg("DATA.TRAIN_JITTER_SCALES", "[96, 112]")))
        assert stretched.shape == (3, 96, 112, 3)
        for seed in range(6):
            rng = np.random.default_rng(seed)
            want = fewshot_train_transform(frames, cfg, np.random.default_rng(seed), is_query=True)
            flip = bool(rng.random() < 0.5)
            y, x = int(rng.integers(0, 96 - CROP)), int(rng.integers(0, 112 - CROP))
            crop = stretched[:, y : y + CROP, x : x + CROP]
            np.testing.assert_array_equal(crop[:, :, ::-1] if flip else crop, want)
    finally:
        frameops.set_enabled(True)


def test_train_assembly_equals_jax():
    """``assemble_train_clips`` against JAX ``make_bank_train_assemble`` on the
    same bank and [E, N, T + 3] indices, with both flips and the crop's edge
    offsets, exactly."""
    from clip_fsar_tpu.data.frame_bank import make_bank_train_assemble

    bank = np.random.RandomState(0).randint(0, 256, (40, 96, 80, 3), dtype=np.uint8)
    rng = np.random.RandomState(1)
    idx = np.concatenate([rng.randint(0, 40, (2, 5, FRAMES)), rng.randint(0, 96 - CROP + 1, (2, 5, 1)),
                          rng.randint(0, 80 - CROP + 1, (2, 5, 1)), rng.randint(0, 2, (2, 5, 1))], axis=-1).astype(np.int32)
    idx[0, 0, FRAMES:] = (96 - CROP, 80 - CROP, 1)
    idx[0, 1, FRAMES:] = (0, 0, 0)
    want = np.asarray(jax.jit(make_bank_train_assemble(FRAMES, CROP))(jnp.asarray(bank), jnp.asarray(idx)))
    got = frame_bank.assemble_train_clips(torch.from_numpy(bank), torch.from_numpy(idx), FRAMES, CROP).numpy()
    assert got.shape == (2, 5, FRAMES, CROP, CROP, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@functools.lru_cache(maxsize=None)
def _jax_model(*extra):
    """(cfg, arch, clip_vars, FewShotModel) of the JAX package for the bank config, on the tiny CLIP weights."""
    from clip_fsar_tpu.models import builder

    _, arch, clip_vars = jax_tiny_clip()
    cfg = jax_cfg(*extra)
    with mock.patch.object(builder, "load_or_init_clip", return_value=(arch, clip_vars)):
        model = builder.build_few_shot_model(cfg, jax.random.PRNGKey(0), flow="train" if extra else "test")
    return cfg, arch, clip_vars, model


def _port_model(cfg, arch, clip_vars, model) -> FewShotModel:
    """The port's head on the JAX model's converted weights, with its text banks."""
    head = CLIPFSARHead(arch, CLIPFSARConfig.from_cfg(cfg))
    head.load_state_dict({k: v for k, v in port_head_state(model, clip_vars).items() if not k.startswith("text.")})
    return FewShotModel(head=head, text_train=torch.from_numpy(np.array(model.text_train)), text_test=torch.from_numpy(np.array(model.text_test)))


def test_bank_evaluate_equals_the_pixel_path_and_jax():
    """6 test episodes in steps of 2: the port's evaluate off the eval bank
    gives its pixel path's metrics and logits exactly, ships int32 rows
    instead of pixels, and agrees with the JAX package's bank evaluate at 1e-4."""
    from clip_fsar_tpu.parallel.mesh import build_mesh
    from clip_fsar_tpu.train.loop import evaluate as jax_evaluate

    jcfg, arch, clip_vars, jmodel = _jax_model()
    jcfg_bank = jax_cfg("TPU.EVAL_FRAME_BANK", "True")
    want = jax_evaluate(jcfg_bank, jmodel, jmodel.variables, build_mesh(jcfg_bank), num_tasks=6, episodes_per_step=2)
    model = _port_model(port_cfg(), arch, clip_vars, jmodel)
    pixel = evaluate(port_cfg(), model, 6, 2, device="cpu")
    bank = evaluate(port_cfg("TPU.EVAL_FRAME_BANK", "True"), model, 6, 2, device="cpu")
    for key in ("top1_acc", "top5_acc", "loss", "episodes"):
        assert bank[key] == pixel[key], key
        np.testing.assert_allclose(bank[key], want[key], atol=1e-4, rtol=1e-4, err_msg=key)
    np.testing.assert_array_equal(bank["episode_logits"], pixel["episode_logits"])
    assert bank["episodes"] == 6 and "frame_bank" not in pixel and bank["frame_bank"]["gb"] > 0
    queries = 2 * WAYS * 2  # support and query clips of 2 episodes
    assert pixel["h2d_bytes_per_step"] > queries * FRAMES * CROP * CROP * 3 > 100 * bank["h2d_bytes_per_step"]


def _jax_bank_steps(steps: int = 3):
    """Three JAX bank train steps (make_bank_train_context) with flax Dropout and the color jitter
    patched to identity; returns (losses, final params in the port's names)."""
    from clip_fsar_tpu.data.frame_bank import TrainIndexEpisodeSampler, make_bank_train_context
    from clip_fsar_tpu.data.loader import build_few_shot_loader as jloader
    from clip_fsar_tpu.parallel.mesh import build_mesh
    from clip_fsar_tpu.train.loop import build_state
    from clip_fsar_tpu.train.optimizer import build_optimizer, epoch_for_iter, get_lr_at_epoch

    from clip_fsar_torch.models.clip.convert import params_from_jax

    cfg, _, _, model = _jax_model(*TRAIN_OPTS)
    tx = build_optimizer(cfg, model.variables["params"], name_prefix="head")
    state = jax.tree_util.tree_map(jnp.copy, build_state(cfg, model, tx))  # the step donates its state: keep the model's own arrays
    losses = []
    with mock.patch.object(fnn.Dropout, "__call__", lambda self, x, *a, **k: x), \
            mock.patch("clip_fsar_tpu.data.augment.color_jitter_batch", lambda key, x, **kw: x):
        ctx = make_bank_train_context(cfg, model, build_mesh(cfg), tx)
        with jloader(cfg, "train", num_steps=steps, episodes_per_step=2, sampler_wrap=lambda s: TrainIndexEpisodeSampler(s, ctx.table)) as loader:
            for i, batch in enumerate(loader):
                state, metrics = ctx.train_step(state, batch, jnp.float32(get_lr_at_epoch(cfg, epoch_for_iter(cfg, i))), jax.random.PRNGKey(i), ctx.bank)
                losses.append(float(metrics["loss"]))
    return losses, params_from_jax({"params": jax.device_get(state.params)})


def _port_steps(cfg, model, bank, steps: int = 3):
    """Three port train steps from the model's weights (no jitter, no dropout) on the pixel path or off
    ``bank``; returns (losses, final state dict, host reads inside the steps)."""
    head = model.head
    state = TrainState.create(cfg, head, topt.Optimizer(cfg, head))
    step = make_train_step(head, cfg, model.text_train, model.text_test, None if bank is None else bank.pixels)
    wrap = None if bank is None else (lambda s: frame_bank.TrainIndexEpisodeSampler(s, bank.table))
    with build_few_shot_loader(cfg, "train", num_steps=steps, episodes_per_step=2, sampler_wrap=wrap) as loader:
        batches = [b.to("cpu") for b in loader]
    with host_reads() as reads:
        metrics = [step(state, batch, topt.get_lr_at_epoch(cfg, topt.epoch_for_iter(cfg, i)), None) for i, batch in enumerate(batches)]
    return [m["loss"].item() for m in metrics], {k: v.clone() for k, v in head.state_dict().items()}, reads


def test_three_bank_train_steps_equal_the_pixel_path_and_jax():
    """Three train steps (E = 2 in 2 episode chunks, one Adam update each) off
    the train bank against the pixel path from the same weights: the same
    loss bits and the same parameters bit for bit, and nothing read back from
    a tensor inside the steps; against three JAX bank train steps, losses at
    1e-4 and parameters at atol 5e-4 (tests/test_torch_train.py's tolerances:
    half of one Adam step at lr 1e-3)."""
    want_losses, want_params = _jax_bank_steps()
    jcfg, arch, clip_vars, jmodel = _jax_model(*TRAIN_OPTS)
    cfg = port_cfg(*TRAIN_OPTS)
    pixel = _port_steps(cfg, _port_model(cfg, arch, clip_vars, jmodel), None)
    bank = _port_steps(cfg, _port_model(cfg, arch, clip_vars, jmodel), frame_bank.build_train_frame_bank(cfg, "cpu"))
    assert bank[0] == pixel[0] and bank[2] == [] and pixel[2] == []
    for name, value in pixel[1].items():
        assert torch.equal(bank[1][name], value), name
    np.testing.assert_allclose(bank[0], want_losses, atol=1e-4, rtol=1e-4)
    for name, value in want_params.items():
        if name in bank[1]:
            torch.testing.assert_close(bank[1][name], value, atol=5e-4, rtol=0, msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.parametrize("k", [1, 2])
def test_bank_train_step_reads_nothing_back_from_the_device(k):
    """The bank twin of tests/test_torch_train.py::test_train_step_reads_nothing_back_from_the_device:
    two train steps off the train bank (jitter, dropout and random erasing on, 2 episode chunks, each
    assembled from the bank inside the chunk loop), with and without an accumulation window: no value of
    any tensor is read from python inside them, and the metrics come back as 0-dim tensors."""
    cfg = port_cfg(*TRAIN_OPTS, "TRAIN.BATCH_SIZE_PER_TASK", str(k), "AUGMENTATION.RANDOM_ERASING.ENABLE", "True")
    bank = frame_bank.build_train_frame_bank(cfg, "cpu")
    _, arch, clip_vars, jmodel = _jax_model(*TRAIN_OPTS)
    model = _port_model(cfg, arch, clip_vars, jmodel)
    state = TrainState.create(cfg, model.head, topt.Optimizer(cfg, model.head))
    step = make_train_step(model.head, cfg, model.text_train, model.text_test, bank.pixels)
    with build_few_shot_loader(cfg, "train", num_steps=1, episodes_per_step=2,
                               sampler_wrap=lambda s: frame_bank.TrainIndexEpisodeSampler(s, bank.table)) as loader:
        batch = next(iter(loader)).to("cpu")
    assert batch.support_images.dtype == torch.int32 and batch.support_images.shape[-1] == FRAMES + 3
    with host_reads() as reads:
        for i in range(2):
            metrics = step(state, batch, 1e-3, torch.Generator().manual_seed(i))
    assert reads == []
    assert set(metrics) == {"loss", "ce", "top1", "updated", "nan_skipped"}
    for name, v in metrics.items():
        assert isinstance(v, torch.Tensor) and v.dim() == 0, name
    assert bool(metrics["updated"]) and metrics["nan_skipped"] == 0.0 and state.step == 2


def test_train_loop_with_both_banks_equals_the_pixel_path(tmp_path):
    """train_few_shot with TPU.TRAIN_FRAME_BANK and TPU.EVAL_FRAME_BANK (jitter
    and dropout on, validation after steps 2 and 4 off one val bank built
    once) against the same run on pixels: the same losses bit for bit and the
    same validation top-1; the stats report both banks."""
    opts = [*TRAIN_OPTS, "TRAIN.NUM_TRAIN_TASKS", "4", "TRAIN.VAL_FRE_ITER", "2", "TRAIN.NUM_VAL_TASKS", "2"]
    pixel = train_few_shot(port_cfg(*opts, "OUTPUT_DIR", str(tmp_path / "pixel")), device="cpu")
    builds = []
    build = frame_bank.build_eval_frame_bank
    with mock.patch("clip_fsar_torch.train.loop.build_eval_frame_bank", lambda *a: builds.append(a[1]) or build(*a)):
        bank = train_few_shot(port_cfg(*opts, "TPU.TRAIN_FRAME_BANK", "True", "TPU.EVAL_FRAME_BANK", "True",
                                       "OUTPUT_DIR", str(tmp_path / "bank")), device="cpu")
    assert bank["losses"] == pixel["losses"] and len(bank["losses"]) == 4
    assert bank["best_val_top1"] == pixel["best_val_top1"] and builds == ["val"]
    assert set(bank["frame_banks"]) == {"train", "val"} and "frame_banks" not in pixel


@pytest.mark.parametrize("build", ["eval", "train"])
def test_exact_sampling_refuses_both_banks(build):
    cfg = port_cfg("DATA.EXACT_SAMPLING", "True", "DATA.DECODER", "opencv")
    with pytest.raises(ValueError, match=r"FRAME_BANK.*EXACT_SAMPLING"):
        if build == "eval":
            frame_bank.build_eval_frame_bank(cfg, "test", "cpu")
        else:
            frame_bank.build_train_frame_bank(cfg, "cpu")


def test_bank_grid_other_than_the_cache_grid_warns(caplog):
    """A bank grid other than the decoder's cache grid is built, with a warning that its
    results will differ from the pixel path's; F comes from TPU.EVAL_FRAME_BANK_FRAMES."""
    import logging

    package_logger = logging.getLogger("clip_fsar_torch")
    package_logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger="clip_fsar_torch"):
            bank = frame_bank.build_eval_frame_bank(port_cfg("TPU.EVAL_FRAME_BANK_FRAMES", "4"), "test", "cpu")
    finally:
        package_logger.removeHandler(caplog.handler)
    assert bank.table.frames_per_video == 4 and bank.pixels.shape[0] == WAYS * PER_CLASS * 4
    assert [r for r in caplog.records if "!= decoder cache grid" in r.getMessage()]
    assert [r for r in caplog.records if "frame bank on cpu" in r.getMessage()]


def test_augmentation_drawn_once_and_applied_by_chunk_equals_one_call():
    """The train step draws the augmentation for all its episodes and applies it one episode chunk at a
    time (inside the chunk loop, where the bank assembles the chunk's clips): jitter, and random erasing
    with NUM_SPLITS 2 (the first half of the call's clips stay clean, counted over the call), give the
    clips of one call over the whole batch bit for bit."""
    from clip_fsar_torch.data import augment

    cfg = port_cfg("AUGMENTATION.COLOR_AUG", "True", "AUGMENTATION.RANDOM_ERASING.ENABLE", "True", "AUGMENTATION.RANDOM_ERASING.PROB", "1.0",
                   "AUGMENTATION.RANDOM_ERASING.NUM_SPLITS", "2", "AUGMENTATION.RANDOM_ERASING.MODE", "pixel")
    clips = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (6, FRAMES, 16, 16, 3), dtype=np.uint8))
    mean, std = tuple(cfg.DATA.MEAN), tuple(cfg.DATA.STD)
    want = augment.fewshot_train_augment(clips, cfg, mean, std, False, torch.Generator().manual_seed(3))
    draws = augment.draw_train_augment(cfg, clips.shape, False, torch.Generator().manual_seed(3))
    got = torch.cat([augment.apply_train_augment(clips[lo:lo + 2], draws.take(lo, lo + 2), cfg, mean, std, lo, 6) for lo in (0, 2, 4)])
    assert torch.equal(got, want)
    assert torch.equal(want[:3], augment.apply_train_augment(clips[:3], draws.take(0, 3), cfg, mean, std, 0, 6))  # the clean half
    assert not torch.equal(want[3:], augment.apply_train_augment(clips[3:], None, cfg, mean, std))
