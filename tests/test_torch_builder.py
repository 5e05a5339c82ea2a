"""The port's CLIP checkpoint search against the JAX builder's: the same
candidate files in the same order, and the same pick whichever one exists."""

import os
from unittest import mock

import pytest

from clip_fsar_torch.models import builder as tbuilder
from clip_fsar_tpu.models import builder as jbuilder
from tests.torch_parity import tiny_cfg


def _probed(search, cfg):
    """Every path ``search`` asks os.path.exists about, in order, when none exists."""
    probed = []
    with mock.patch("os.path.exists", side_effect=lambda p: probed.append(p) or False):
        assert search(cfg) is None
    return probed


@pytest.mark.parametrize("index", [0, 1, 2])
def test_clip_checkpoint_search_matches_jax(index, tmp_path, monkeypatch):
    """With a HOME of its own, the JAX builder probes three roots: the user's
    CLIP cache, the root user's and ./weights.  The port probes the same
    ones in the same order, and when only the ``index``-th holds the
    checkpoint, both return it."""
    monkeypatch.setenv("HOME", str(tmp_path))
    cfg = tiny_cfg("VIDEO.HEAD.BACKBONE_NAME", "ViT-B/16")
    want = _probed(jbuilder._clip_checkpoint_path, cfg)
    assert len(want) == 3 and all(os.path.basename(p) == "ViT-B-16.pt" for p in want)
    assert _probed(tbuilder._clip_checkpoint_path, cfg) == want
    only = want[index]
    with mock.patch("os.path.exists", side_effect=lambda p: p == only):
        assert tbuilder._clip_checkpoint_path(cfg) == jbuilder._clip_checkpoint_path(cfg) == only


def test_clip_weights_key_comes_first(tmp_path, monkeypatch):
    """TRAIN.CLIP_WEIGHTS wins over every cache root in both packages."""
    monkeypatch.setenv("HOME", str(tmp_path))
    cfg = tiny_cfg("VIDEO.HEAD.BACKBONE_NAME", "ViT-B/16")
    cfg.TRAIN["CLIP_WEIGHTS"] = "/weights/given.pt"
    with mock.patch("os.path.exists", return_value=True):
        assert tbuilder._clip_checkpoint_path(cfg) == jbuilder._clip_checkpoint_path(cfg) == "/weights/given.pt"
