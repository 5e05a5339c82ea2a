"""Checkpoint paths and config keys the port must not drop without a word:
a named checkpoint that exists and cannot be read raises (it never ends in
fresh weights), a path that does not exist is passed over as in the JAX
package, the JAX package's ``.npz`` weight archives load, config keys that
would change the weights raise, and speed-only keys are reported in one log
line.  ViT-Tiny-Test, float32, on the CPU."""

import logging
import os

import numpy as np
import pytest
import torch

from clip_fsar_torch.models.builder import build_few_shot_model
from clip_fsar_torch.train.checkpoint import load_checkpoint_file, load_test_weights, save_checkpoint
from clip_fsar_torch.train.loop import check_run_cfg, test_few_shot as run_test_protocol, train_few_shot
from tests.torch_parity import CONFIG as CONFIG_PATH, tiny_cfg

torch.set_num_threads(2)

TRAIN_OPTS = ["TRAIN.ENABLE", "True", "TPU.EPISODES_PER_STEP", "2", "TRAIN.NUM_TRAIN_TASKS", "1", "TRAIN.VAL_FRE_ITER", "0"]


@pytest.fixture(scope="module")
def head():
    return build_few_shot_model(tiny_cfg(), flow="test", device="cpu").head


@pytest.fixture(scope="module")
def jax_archive(tmp_path_factory):
    """(path, want): the JAX tiny model's variables as its ``save_weights_npz`` writes them, and the
    same weights as the port's head entries."""
    import jax

    from clip_fsar_tpu.train.pretrain import save_weights_npz
    from tests.torch_parity import jax_tiny_model, port_head_state

    _, _, clip_vars, model = jax_tiny_model("split")
    path = str(tmp_path_factory.mktemp("npz") / "jax_head.npz")
    save_weights_npz(path, jax.device_get(model.variables))
    return path, {k: v for k, v in port_head_state(model, clip_vars).items() if not k.startswith("text.")}


@pytest.mark.parametrize("prefix", [True, False])
def test_npz_archive_loads_every_head_entry(tmp_path, head, jax_archive, prefix):
    """The JAX package's archive, with or without the ``params/`` collection
    prefix (the JAX loader takes both), fills every non-text entry of the
    head with the JAX weights bit for bit."""
    path, want = jax_archive
    if not prefix:
        with np.load(path) as archive:
            flat = {k[len("params/"):]: archive[k] for k in archive.files}
        path = str(tmp_path / "bare.npz")
        np.savez(path, **flat)
    own = {k: v.clone() for k, v in head.state_dict().items()}
    assert not torch.equal(own["context2.norm_0.weight"], want["context2.norm_0.weight"]) or not torch.equal(own["backbone.proj"], want["backbone.proj"])
    try:
        assert load_checkpoint_file(path, head)
        got = head.state_dict()
        assert set(want) == {k for k in got if not k.startswith("text.")}
        for key, value in want.items():
            assert torch.equal(got[key], value), key
    finally:
        head.load_state_dict(own)


def test_npz_archive_of_something_else_raises(tmp_path, head):
    path = str(tmp_path / "other.npz")
    np.savez(path, **{"params/backbone/stem/kernel": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="not a weight archive"):
        load_checkpoint_file(path, head)


@pytest.mark.parametrize("kind", ["directory", "pyth", "pth", "nothing_matches"])
def test_named_checkpoint_that_cannot_be_read_raises(tmp_path, head, kind):
    """TEST.CHECKPOINT_FILE_PATH names something that exists: an orbax-style
    directory, a reference-framework file that holds no CLIP tower, a torch
    file in which nothing matches the head.  The protocol must not go on to
    fresh weights."""
    if kind == "directory":
        path = tmp_path / "run" / "checkpoints" / "4" / "default"
        path.mkdir(parents=True)
        path, error, says = tmp_path / "run", ValueError, r"directory.*\.npz"
    elif kind == "nothing_matches":
        path, error, says = tmp_path / "other.pt", ValueError, "no entry that matches"
        torch.save({"head": {"backbone.no_such_layer.weight": torch.zeros(2)}}, str(path))
    else:
        path, error, says = tmp_path / f"checkpoint_epoch_00010.{kind}", ValueError, "not a CNN_OTAM_CLIPFSAR checkpoint"
        torch.save({"model_state": {}}, str(path))
    cfg = tiny_cfg("TEST.CHECKPOINT_FILE_PATH", str(path), "OUTPUT_DIR", str(tmp_path / "out"))
    with pytest.raises(error, match=says):
        load_test_weights(cfg, head)
    with pytest.raises(error, match=says):
        run_test_protocol(cfg, device="cpu")


def test_named_checkpoint_that_does_not_exist_is_passed_over(tmp_path, head):
    """As the JAX package's ``_load_raw``: a missing path is logged and the
    search goes on to the next candidate, here TRAIN.CHECKPOINT_FILE_PATH."""
    trained = tmp_path / "head.pt"
    save_checkpoint(str(trained), head)
    cfg = tiny_cfg("TEST.CHECKPOINT_FILE_PATH", str(tmp_path / "missing.pt"), "TRAIN.CHECKPOINT_FILE_PATH", str(trained),
                   "OUTPUT_DIR", str(tmp_path / "out"))
    assert load_test_weights(cfg, head) == str(trained)
    assert load_test_weights(tiny_cfg("TEST.CHECKPOINT_FILE_PATH", str(tmp_path / "missing.pt"), "OUTPUT_DIR", str(tmp_path / "out")), head) == "fresh"


def test_train_start_weights_come_from_the_named_checkpoint_or_raise(tmp_path, jax_archive):
    """TRAIN.CHECKPOINT_FILE_PATH in train_few_shot: an ``.npz`` archive gives
    the start weights (the stats name it), an unreadable path raises before
    the first step."""
    path, _ = jax_archive
    stats = train_few_shot(tiny_cfg(*TRAIN_OPTS, "TRAIN.CHECKPOINT_FILE_PATH", path, "OUTPUT_DIR", str(tmp_path / "a")), device="cpu")
    assert stats["init_weights"] == path and np.isfinite(stats["losses"]).all()
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match=r"directory.*\.npz"):
        train_few_shot(tiny_cfg(*TRAIN_OPTS, "TRAIN.CHECKPOINT_FILE_PATH", str(tmp_path / "orbax"), "OUTPUT_DIR", str(tmp_path / "b")), device="cpu")


@pytest.mark.parametrize("opts, key", [(["TRAIN.CHECKPOINT_PRE_PROCESS.ENABLE", "True"], "TRAIN.CHECKPOINT_PRE_PROCESS.ENABLE"),
                                       (["TRAIN.CHECKPOINT_INFLATE", "True"], "TRAIN.CHECKPOINT_INFLATE")])
def test_checkpoint_surgery_keys_raise_before_training(tmp_path, head, jax_archive, opts, key):
    """The two keys change the weights a run starts from, and the few-shot
    trainer applies them as the JAX package does (loop.py:216-218,
    load_train_checkpoint_file): from the JAX tiny model's archive the port's
    head takes the weights the JAX package's load gives (the few-shot model
    has no position table, tubelet kernel or 3-D kernel for the surgery to
    act on) and training starts from the archive.  A POS_EMBED mode then
    raises KeyError before the first step in both packages, as there is no
    backbone pos_embd entry to act on."""
    import jax

    from clip_fsar_tpu.config.config import load_config as jax_load_config
    from clip_fsar_tpu.train.pretrain import load_train_checkpoint_file as jax_load
    from clip_fsar_torch.models.clip.convert import params_from_jax
    from clip_fsar_torch.train.pretrain import surgery_flags
    from tests.torch_parity import TINY_OPTS, jax_tiny_model

    path, _ = jax_archive
    _, _, _, model = jax_tiny_model("split")
    cfg = tiny_cfg(*TRAIN_OPTS, *opts, "TRAIN.CHECKPOINT_FILE_PATH", path, "OUTPUT_DIR", str(tmp_path))
    jcfg = jax_load_config(CONFIG_PATH, TINY_OPTS + TRAIN_OPTS + opts + ["TRAIN.CHECKPOINT_FILE_PATH", path])
    template = jax.tree_util.tree_map(lambda v: np.zeros_like(np.asarray(v)), jax.device_get(model.variables))
    loaded, ok = jax_load(jcfg, template)
    want = params_from_jax(jax.device_get(loaded))
    assert ok and surgery_flags(cfg) == tuple(k == key for k in ("TRAIN.CHECKPOINT_PRE_PROCESS.ENABLE", "TRAIN.CHECKPOINT_INFLATE"))
    own = {k: v.clone() for k, v in head.state_dict().items()}
    try:
        assert load_checkpoint_file(path, head, cfg.VIDEO.HEAD.NAME, cfg, *surgery_flags(cfg))
        got = head.state_dict()
        for k, v in want.items():
            assert torch.equal(got[k], v), k
    finally:
        head.load_state_dict(own)
    assert train_few_shot(cfg, device="cpu")["init_weights"] == path
    mode = ["TRAIN.CHECKPOINT_PRE_PROCESS.ENABLE", "True", "TRAIN.CHECKPOINT_PRE_PROCESS.POS_EMBED", "repeat"]
    with pytest.raises(KeyError, match="pos_embd"):
        jax_load(jax_load_config(CONFIG_PATH, TINY_OPTS + TRAIN_OPTS + opts + mode + ["TRAIN.CHECKPOINT_FILE_PATH", path]), template)
    with pytest.raises(KeyError, match="pos_embd"):
        train_few_shot(tiny_cfg(*TRAIN_OPTS, *opts, *mode, "TRAIN.CHECKPOINT_FILE_PATH", path, "OUTPUT_DIR", str(tmp_path / "b")), device="cpu")
    assert not os.path.exists(tmp_path / "b" / "checkpoints")
    check_run_cfg(cfg, training=False)


@pytest.mark.parametrize("opts, key, in_test", [(["TPU.EVAL_FRAME_BANK", "True"], "TPU.EVAL_FRAME_BANK", True),
                                                (["TPU.TRAIN_FRAME_BANK", "True"], "TPU.TRAIN_FRAME_BANK", False),
                                                (["TPU.MESH.DATA", "4"], "TPU.MESH.DATA", True)])
def test_speed_only_keys_are_reported_in_one_log_line(caplog, opts, key, in_test):
    """No key of these is left aside any more, so no line reports one.  The
    frame banks are built (data/frame_bank.py).  The data mesh is the
    process group's ranks (parallel/mesh.py): TPU.MESH.DATA above them (one
    process: one rank) is refused before any work, in training and in the
    test protocol, as the JAX package refuses a mesh larger than its devices
    (mesh.py:86-87), where the port once ran on one card and said so."""
    package_logger = logging.getLogger("clip_fsar_torch")  # it does not propagate to the root logger caplog listens on
    package_logger.addHandler(caplog.handler)
    refused = key == "TPU.MESH.DATA"
    try:
        with caplog.at_level(logging.INFO, logger="clip_fsar_torch"):
            check_run_cfg(tiny_cfg(), training=True)
            for training in (True, False):
                caplog.clear()
                if refused:
                    with pytest.raises(ValueError, match="TPU.MESH.DATA=4 but only 1 devices present"):
                        check_run_cfg(tiny_cfg(*opts), training=training)
                else:
                    check_run_cfg(tiny_cfg(*opts), training=training)
                assert not [r for r in caplog.records if key in r.getMessage()]
    finally:
        package_logger.removeHandler(caplog.handler)


def test_protocol_with_a_frame_bank_key_runs_on_the_pixel_path_and_says_so(tmp_path, caplog):
    """TPU.EVAL_FRAME_BANK through test_few_shot itself: the protocol's 4
    episodes run off a frame bank of the test split, not on the pixel path,
    and the run says why its results are not the pixel path's: the synthetic
    decoder does not snap frame indices to the bank's grid."""
    package_logger = logging.getLogger("clip_fsar_torch")
    package_logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger="clip_fsar_torch"):
            stats = run_test_protocol(tiny_cfg("TPU.EVAL_FRAME_BANK", "True", "TPU.EVAL_FRAME_BANK_FRAMES", "8", "OUTPUT_DIR", str(tmp_path)),
                                      device="cpu")
    finally:
        package_logger.removeHandler(caplog.handler)
    assert stats["episodes"] == 4 and stats["weights"] == "fresh"
    assert stats["frame_bank"]["gb"] > 0 and stats["h2d_bytes_per_step"] < 4096
    assert [r for r in caplog.records if "DATA.DECODER=synthetic" in r.getMessage() and "NOT use" in r.getMessage()]
