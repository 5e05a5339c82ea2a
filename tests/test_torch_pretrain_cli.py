"""MoSI pretraining through the port's CLI on the CPU, two gloo ranks against
one process (processes of tests/_torch_cls_dist_worker.py --task pretrain),
the storage layer (the counterparts of tests/test_storage.py, and a remote
checkpoint path through the port's loader) and the CLIP zoo's cache lookup,
which never reaches the network here."""

import hashlib
import importlib.util
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from clip_fsar_torch.utils import storage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_cls_dist_worker.py")
CONFIG = os.path.join(REPO, "configs", "pretrain", "MoSI_R2D3D_HMDB51.yaml")
TIMEOUT_S = 300


def _lists(root, train: int = 8, test: int = 6) -> str:
    os.makedirs(root, exist_ok=True)
    for split, n in (("train", train), ("test", test)):
        with open(os.path.join(root, f"hmdb51_{split}_list.txt"), "w") as f:
            for i in range(n):
                f.write(f"videos/c{i % 3}/{split}_{i:03d}.avi {i % 3}\n")
    return str(root)


def test_pretrain_through_the_cli(tmp_path):
    """TASK_TYPE pretrain (configs/pretrain/MoSI_R2D3D_HMDB51.yaml at a tiny
    size, the preset's colour jitter and dropout on) through the CLI on the
    CPU: one epoch of 2 steps with finite losses and updates, the SSL
    validation over the test split, and the checkpoint, which the loader
    reads back into MoSINet."""
    from clip_fsar_torch.config.config import load_config
    from clip_fsar_torch.models.video.model import MoSINet, build_video_model
    from clip_fsar_torch.runs.run import main
    from clip_fsar_torch.train.pretrain import load_checkpoint_file

    opts = ["VIDEO.BACKBONE.DEPTH", "10", "VIDEO.BACKBONE.NUM_FILTERS", "[8, 16, 16, 32, 32]", "VIDEO.HEAD.NUM_CLASSES", "3",
            "PRETRAIN.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32", "DATA.DECODER", "synthetic", "SOLVER.MAX_EPOCH", "1",
            "TRAIN.EVAL_PERIOD", "1", "TRAIN.BATCH_SIZE", "4", "TEST.BATCH_SIZE", "4", "DATA_LOADER.NUM_WORKERS", "2", "LOG_PERIOD", "1",
            "DATA.ANNO_DIR", _lists(tmp_path / "lists"), "OUTPUT_DIR", str(tmp_path / "run")]
    results = main(["--cfg", CONFIG, "--device", "cpu", *opts])
    train = results["train"]
    assert train["steps"] == 2 and train["updates"] == 2 and np.isfinite(train["losses"]).all()
    assert set(train["ssl_val"]) == {"loss", "acc_move_joint"} and np.isfinite(train["ssl_val"]["loss"])
    assert set(results) == {"train"}  # the pretrain task queues the trainer alone, as the JAX run list does
    cfg = load_config(CONFIG, opts)
    model = build_video_model(cfg)
    assert isinstance(model, MoSINet)
    assert load_checkpoint_file(cfg, str(tmp_path / "run" / "checkpoints" / "1.pt"), model)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pretrain_dist")
    anno = _lists(root / "lists")
    procs = {}
    for name, world, rank in (("world1", 1, 0), ("rank0", 2, 0), ("rank1", 2, 1)):
        procs[name] = subprocess.Popen(
            [sys.executable, WORKER, "--task", "pretrain", "--world", str(world), "--rank", str(rank), "--store", str(root / "store"),
             "--anno", anno, "--run", str(root / name), "--out", str(root / f"{name}.pt")],
            env={**os.environ, "OMP_NUM_THREADS": "2"}, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        logs = {name: p.communicate(timeout=TIMEOUT_S)[0] for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, p in procs.items():
        assert p.returncode == 0, f"{name} failed:\n{logs[name][-4000:]}"
    return {name: torch.load(str(root / f"{name}.pt"), weights_only=False) for name in procs}


def test_two_ranks_pretrain_as_one_process(runs):
    """Two gloo ranks, each loading half of every global batch of 4 videos
    (the generator's draws taken for the other half without decoding it)
    and jittering it with the global batch's draws, against one process:
    the losses at 1e-4, every step's all-reduced gradient and the
    parameters after at 2e-4 (fp32), both ranks the same bits, and the SSL
    validation (6 test videos, the tail padded) gathered to the same stats."""
    one, r0, r1 = runs["world1"], runs["rank0"], runs["rank1"]
    assert one["stats"]["steps"] == r0["stats"]["steps"] == 2 and r0["stats"]["updates"] == 2
    np.testing.assert_allclose(r0["stats"]["losses"], one["stats"]["losses"], atol=1e-4, rtol=1e-4)
    for g2, g1 in zip(r0["grads"], one["grads"]):
        for name, g in g1.items():
            torch.testing.assert_close(g2[name], g, atol=2e-4, rtol=2e-4, msg=lambda m, name=name: f"grad {name}: {m}")
    for key, v in one["state"].items():
        torch.testing.assert_close(r0["state"][key], v, atol=2e-4, rtol=2e-4, msg=lambda m, key=key: f"{key}: {m}")
        assert torch.equal(r0["state"][key], r1["state"][key]), key
    assert r0["stats"]["losses"] == r1["stats"]["losses"]
    for got in (r0, r1):
        np.testing.assert_allclose(got["stats"]["ssl_val"]["loss"], one["stats"]["ssl_val"]["loss"], rtol=1e-4)
        assert got["stats"]["ssl_val"]["acc_move_joint"] == one["stats"]["ssl_val"]["acc_move_joint"]


# ---------------------------------------------------------------------------
# storage (counterparts of tests/test_storage.py)
# ---------------------------------------------------------------------------


def test_local_paths_pass_through(tmp_path):
    p = tmp_path / "x.bin"
    p.write_bytes(b"abc")
    assert storage.fetch(str(p)) == str(p)
    assert storage.fetch(f"file://{p}") == str(p)
    assert not storage.is_remote(str(p)) and not storage.is_remote(f"file://{p}")
    assert storage.is_remote("oss://bucket/key") and storage.is_remote("gs://bucket/key")
    # a backend registers itself exactly when its SDK imports
    assert ("gs" in storage._FETCHERS) == _imports("google.cloud.storage") and ("oss" not in storage._FETCHERS or _imports("oss2"))


def _imports(module: str) -> bool:
    try:
        return importlib.util.find_spec(module) is not None
    except ModuleNotFoundError:
        return False


def test_unknown_scheme_raises():
    with pytest.raises(ValueError, match="no storage backend"):
        storage.fetch("weird://bucket/key")
    with pytest.raises(ValueError, match="no upload backend"):
        storage.upload(__file__, "weird://bucket/key")


def test_custom_scheme_with_retries(tmp_path, monkeypatch):
    """A registered backend is retried as the reference retries (bucket.py:26-35),
    lands in the cache directory, and clear_tmp_file removes it there."""
    calls = {"n": 0}

    def flaky_fetch(url, dst):
        calls["n"] += 1
        if calls["n"] < 2:
            raise IOError("transient")
        with open(dst, "wb") as f:
            f.write(b"payload")

    monkeypatch.setattr(storage, "CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(storage.time, "sleep", lambda s: None)
    storage.register_scheme("mock", flaky_fetch)
    try:
        local = storage.fetch("mock://bucket/key.bin")
        assert local == str(tmp_path / "cache" / "key.bin") and open(local, "rb").read() == b"payload" and calls["n"] == 2
        storage.clear_tmp_file(local)
        assert not os.path.exists(local)
        calls["n"] = -10  # every attempt fails
        with pytest.raises(RuntimeError, match="after 3 attempts"):
            storage.fetch("mock://bucket/key.bin")
    finally:
        storage._FETCHERS.pop("mock", None)


def test_upload(tmp_path, monkeypatch):
    src = tmp_path / "a.txt"
    src.write_text("hi")
    storage.upload(str(src), str(tmp_path / "sub" / "b.txt"))
    assert (tmp_path / "sub" / "b.txt").read_text() == "hi"
    sent = []
    storage.register_scheme("mock", lambda url, dst: None, upload=lambda s, url: sent.append((s, url)))
    try:
        storage.upload(str(src), "mock://bucket/a.txt")
    finally:
        storage._FETCHERS.pop("mock", None)
        storage._UPLOADERS.pop("mock", None)
    assert sent == [(str(src), "mock://bucket/a.txt")]


def test_remote_checkpoint_path_via_loader(tmp_path, monkeypatch):
    """The port's checkpoint loader (train/pretrain.py) fetches a remote path
    through the storage layer, then loads it into the model."""
    from clip_fsar_torch.config.config import Config
    from clip_fsar_torch.train.pretrain import load_checkpoint_file

    model = torch.nn.Linear(2, 2)
    real = tmp_path / "w.pt"
    torch.save({"weight": torch.full((2, 2), 3.0), "bias": torch.zeros(2)}, str(real))
    monkeypatch.setattr(storage, "CACHE_DIR", str(tmp_path / "cache"))
    storage.register_scheme("mock", lambda url, dst: __import__("shutil").copy2(str(real), dst))
    try:
        assert load_checkpoint_file(Config({"TRAIN": {}}), "mock://bucket/w.pt", model)
    finally:
        storage._FETCHERS.pop("mock", None)
    assert torch.equal(model.weight.detach(), torch.full((2, 2), 3.0))
    assert os.path.exists(tmp_path / "cache" / "w.pt")


# ---------------------------------------------------------------------------
# the CLIP zoo's cache lookup
# ---------------------------------------------------------------------------


def test_download_cache_hit_and_mismatch(tmp_path, monkeypatch):
    """download_clip_weights returns a cached file whose SHA256 is the one
    its URL pins, and raises on a cached file whose digest differs; neither
    case opens a URL.  The zoo lists the JAX package's names."""
    from clip_fsar_tpu.models.clip.download import available_models as jax_models
    from clip_fsar_torch.models.clip import download

    def no_network(*a, **k):
        raise AssertionError("the cache lookup opened a URL")

    monkeypatch.setattr(urllib.request, "urlopen", no_network)
    assert download.available_models() == jax_models()
    payload = b"not a real checkpoint"
    digest = hashlib.sha256(payload).hexdigest()
    monkeypatch.setitem(download.MODEL_URLS, "Tiny", f"https://models.invalid/clip/{digest}/Tiny.pt")
    (tmp_path / "Tiny.pt").write_bytes(payload)
    assert download._sha256_of(str(tmp_path / "Tiny.pt")) == digest
    assert download.download_clip_weights("Tiny", str(tmp_path)) == str(tmp_path / "Tiny.pt")
    (tmp_path / "RN50.pt").write_bytes(payload)
    with pytest.raises(RuntimeError, match="does not match"):
        download.download_clip_weights("RN50", str(tmp_path))
    with pytest.raises(KeyError, match="Unknown CLIP model"):
        download.download_clip_weights("ViT-Nope", str(tmp_path))
