"""Checkpoint paths and config keys the port must not drop without a word:
a named checkpoint that exists and cannot be read raises (it never ends in
fresh weights), a path that does not exist is passed over as in the JAX
package, the JAX package's ``.npz`` weight archives load, config keys that
would change the weights raise, and speed-only keys are reported in one log
line.  ViT-Tiny-Test, float32, on the CPU."""

import logging

import numpy as np
import pytest
import torch

from clip_fsar_torch.models.builder import build_few_shot_model
from clip_fsar_torch.train.checkpoint import load_checkpoint_file, load_test_weights, save_checkpoint
from clip_fsar_torch.train.loop import check_run_cfg, test_few_shot as run_test_protocol, train_few_shot
from tests.torch_parity import tiny_cfg

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
def test_checkpoint_surgery_keys_raise_before_training(tmp_path, opts, key):
    """The two keys change the weights a run starts from (JAX:
    load_train_checkpoint_file): the port has neither, so it refuses."""
    cfg = tiny_cfg(*TRAIN_OPTS, *opts, "OUTPUT_DIR", str(tmp_path))
    with pytest.raises(NotImplementedError, match=key):
        train_few_shot(cfg, device="cpu")
    check_run_cfg(cfg, training=False)  # the test protocol loads no such checkpoint


@pytest.mark.parametrize("opts, key, in_test", [(["TPU.EVAL_FRAME_BANK", "True"], "TPU.EVAL_FRAME_BANK", True),
                                                (["TPU.TRAIN_FRAME_BANK", "True"], "TPU.TRAIN_FRAME_BANK", False),
                                                (["TPU.MESH.DATA", "4"], "TPU.MESH.DATA", True)])
def test_speed_only_keys_are_reported_in_one_log_line(caplog, opts, key, in_test):
    """The data mesh changes speed and not results: the run goes on, on one
    card, and says so once (in the test protocol too).  The frame banks are
    no longer such keys: the port builds them (data/frame_bank.py), so no
    line reports them."""
    package_logger = logging.getLogger("clip_fsar_torch")  # it does not propagate to the root logger caplog listens on
    package_logger.addHandler(caplog.handler)
    reported = key == "TPU.MESH.DATA"
    try:
        with caplog.at_level(logging.INFO, logger="clip_fsar_torch"):
            check_run_cfg(tiny_cfg(), training=True)
            assert not [r for r in caplog.records if "takes one card" in r.getMessage()]
            check_run_cfg(tiny_cfg(*opts), training=True)
            lines = [r.getMessage() for r in caplog.records if key in r.getMessage()]
            assert len(lines) == int(reported) and all("takes one card" in line for line in lines)
            caplog.clear()
            check_run_cfg(tiny_cfg(*opts), training=False)
            assert bool([r for r in caplog.records if key in r.getMessage()]) == (in_test and reported)
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
