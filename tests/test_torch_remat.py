"""Rematerialized towers of clip_fsar_torch against clip_fsar_tpu: how
TPU.REMAT, TPU.SCAN_LAYERS, TPU.REMAT_POLICY and TPU.FRAME_CHUNKS resolve,
train steps with remat (either policy) and frame chunks against the JAX
package's on ViT-Tiny-Test, remat against none in the port alone, how often a
block's forward runs, and RN towers ignoring both keys, as in JAX."""

import contextlib
import functools
import logging
from unittest import mock

import pytest
import torch

from clip_fsar_torch.data.loader import build_few_shot_loader
from clip_fsar_torch.models import builder
from clip_fsar_torch.models.clip.arch import ARCHS
from clip_fsar_torch.ops import fused_attention
from clip_fsar_torch.train.loop import check_run_cfg
from clip_fsar_torch.train.step import make_grad_fn
from clip_fsar_torch.utils.logging import setup_logging
from tests.test_torch_train import _jax_steps, _port_batch, assert_steps_match_jax, port_steps, train_cfg
from tests.torch_parity import tiny_cfg

torch.set_num_threads(2)

# the tower's execution in each case, and its JAX run's steps (two where a third adds nothing)
CASES = {"nothing": (["TPU.REMAT", "True"], 3), "dots": (["TPU.REMAT", "True", "TPU.REMAT_POLICY", "dots"], 2),
         "frame_chunks": (["TPU.REMAT", "True", "TPU.FRAME_CHUNKS", "2"], 2)}
# each port attention backend's keys
BACKENDS = {"fused": ["TPU.ATTENTION_LAYOUT", "fused"], "plain": ["TPU.ATTENTION_LAYOUT", "split"], "pallas": ["TPU.PALLAS_ATTENTION", "True"]}


@pytest.mark.parametrize("depth", [0, 12])
def test_tower_execution_resolves_as_in_jax(depth):
    """(remat, scan_layers) for every arch, TPU.REMAT and TPU.SCAN_LAYERS in
    auto / true / false, at the arch's depth and cut by TPU.VISION_DEPTH,
    against the JAX builder's _resolve_tower_execution on its own arch;
    ``tower_execution`` (no build) agrees, and the head takes it."""
    from clip_fsar_tpu.models import builder as jbuilder
    from clip_fsar_tpu.models.clip.model import ARCHS as JARCHS

    assert set(ARCHS) == set(JARCHS)
    cfg = tiny_cfg("TPU.VISION_DEPTH", str(depth))
    on = set()
    for name in ARCHS:
        cfg.VIDEO.HEAD["BACKBONE_NAME"] = name
        for remat in ("auto", True, False):
            for scan in ("auto", True, False):
                cfg.TPU["REMAT"], cfg.TPU["SCAN_LAYERS"] = remat, scan
                want = jbuilder._resolve_tower_execution(cfg, jbuilder._adapt_vision_depth(cfg, JARCHS[name]))
                arch = builder._adapt_vision_depth(cfg, ARCHS[name])
                assert builder._resolve_tower_execution(cfg, arch) == want == builder.tower_execution(cfg), (name, remat, scan)
                if remat == scan == "auto" and want[0]:
                    on.add(name)
        cfg.TPU["REMAT"] = "auto"
        with torch.device("meta"):
            head = builder.make_head(cfg, arch, torch.device("cpu"))
        if arch.is_vit:
            assert head.backbone.transformer.remat == (name in on)
    assert on == (set() if depth else {"ViT-L/14", "ViT-L/14@336px"})


def test_scan_layers_is_reported_with_the_speed_only_keys(caplog):
    """TPU.SCAN_LAYERS on (auto on a 24-layer tower) joins the one log line
    of speed-only keys; off (auto on a shallow or cut tower) it is not named."""
    package_logger = setup_logging()  # as a run configures it: the package logger does not propagate
    package_logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger="clip_fsar_torch"):
            for opts, named in ((["VIDEO.HEAD.BACKBONE_NAME", "ViT-L/14@336px"], True), ([], False),
                                (["VIDEO.HEAD.BACKBONE_NAME", "ViT-L/14", "TPU.VISION_DEPTH", "12"], False),
                                (["VIDEO.HEAD.BACKBONE_NAME", "ViT-L/14", "TPU.MESH.DATA", "4"], True)):
                caplog.clear()
                check_run_cfg(tiny_cfg(*opts), training=True)
                lines = [r.getMessage() for r in caplog.records if "TPU.SCAN_LAYERS" in r.getMessage()]
                assert len(lines) == int(named), opts
                if "TPU.MESH.DATA" in opts:  # one line for every speed-only key
                    assert "TPU.MESH.DATA" in lines[0] and "takes one card" in lines[0]
    finally:
        package_logger.removeHandler(caplog.handler)


@contextlib.contextmanager
def _attention_forwards():
    """Counts the fused attention forwards (the plain version on the CPU, which is what the kernel
    wrapper's launch count is on a card)."""
    calls = [0]
    orig = fused_attention.clip_mha_reference

    def counted(*args, **kwargs):
        calls[0] += 1
        return orig(*args, **kwargs)

    with mock.patch.object(fused_attention, "clip_mha_reference", counted):
        yield calls


@pytest.mark.parametrize("remat, chunks", [(False, 1), (True, 1), (False, 2), (True, 2), (True, 3), (True, 7)])
def test_block_forwards_per_step(remat, chunks):
    """How often each block's attention forward runs in one forward and
    backward of the tower call (what chip_smoke.py pins as launches): once
    plainly, twice per block under remat, and per frame chunk once more for
    the whole-chunk recompute, so three times with both; in eval once per
    block and chunk.  Chunks follow the JAX head's per-episode rule:
    (S+Q)*T = 10 * 4 frames split 2 ways, not 3 or 7 ways."""
    cfg = train_cfg("TPU.ATTENTION_LAYOUT", "fused", "TPU.REMAT", str(remat), "TPU.FRAME_CHUNKS", str(chunks))
    head = builder.build_few_shot_model(cfg, flow="train", device="cpu").head
    images = torch.randn(2, 10, 4, 64, 64, 3)  # E = 2 episodes of S + Q = 10 clips of 4 frames
    layers, c = head.arch.vision_layers, chunks if 40 % chunks == 0 else 1
    with _attention_forwards() as calls:
        head._encode(images).sum().backward()
    assert calls[0] == layers * c * (1 + remat + (c > 1))
    with _attention_forwards() as calls, torch.no_grad():
        head._encode(images)
    assert calls[0] == layers * c


@functools.lru_cache(maxsize=None)
def _jax_run(case: str):
    """The JAX steps of ``case`` (XLA attention), computed once per case."""
    opts, steps = CASES[case]
    return _jax_steps(train_cfg("TPU.ATTENTION_LAYOUT", "split", *opts), steps)


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("case", list(CASES))
def test_remat_train_steps_match_jax(case, backend):
    """Port train steps with the tower's execution of ``case`` (remat with
    policy nothing, with policy dots, or 2 frame chunks with remat) on each
    attention backend, against JAX steps with the same keys from the same
    converted weights and batches: losses at 1e-4, gradients at 2e-4 and
    parameters at 5e-4 (fp32), as test_torch_train holds the steps without
    remat.  The JAX side runs XLA attention for every backend: the port's
    attention paths are held to JAX's Pallas kernels without remat in
    test_torch_train and test_torch_flash, and a JAX run in interpret mode
    costs ~30 s of compile per case.  Remat on against off in the port
    alone: the same bits."""
    cfg, arch, clip_vars, model, batches, want_losses, want_grads, want_params = _jax_run(case)
    opts, _ = CASES[case]
    port_cfg = train_cfg(*BACKENDS[backend], *opts)
    head = builder.make_head(port_cfg, arch, torch.device("cpu"))
    assert head.backbone.transformer.remat and head.frame_chunks == (2 if case == "frame_chunks" else 1)
    losses, grads = assert_steps_match_jax(head, port_cfg, clip_vars, model, batches, want_losses, want_grads, want_params)
    if case == "frame_chunks":  # the chunks' weight gradients are summed in another order than one call's
        return
    plain_head = builder.make_head(train_cfg(*BACKENDS[backend]), arch, torch.device("cpu"))
    assert not plain_head.backbone.transformer.remat
    _, plain_losses, plain_grads = port_steps(plain_head, port_cfg, clip_vars, model, batches)
    assert [float(x) for x in losses] == [float(x) for x in plain_losses]
    for got, want in zip(grads, plain_grads):
        for name, g in got.items():
            assert torch.equal(g, want[name]), name


def test_rn_tower_ignores_remat_and_frame_chunks():
    """RN-Tiny-Test with live BatchNorm: a train step with TPU.REMAT True and
    TPU.FRAME_CHUNKS 2 gives the gradients and running stats of one without
    them, bit for bit, as the JAX head ignores both keys for RN towers."""
    rn = ["VIDEO.HEAD.BACKBONE_NAME", "RN-Tiny-Test"]
    with build_few_shot_loader(train_cfg(*rn), "train", num_steps=1, episodes_per_step=2) as loader:
        batch = _port_batch(next(iter(loader)))
    runs = []
    for extra in ([], ["TPU.REMAT", "True", "TPU.FRAME_CHUNKS", "2"]):
        cfg = train_cfg(*rn, *extra)
        model = builder.build_few_shot_model(cfg, flow="train", device="cpu")
        metrics = make_grad_fn(model.head, cfg, model.text_train, model.text_test)(batch, torch.Generator().manual_seed(0))
        stats = {n: m.step_stats for n, m in model.head.named_modules() if getattr(m, "step_stats", None) is not None}
        runs.append((metrics["loss"], {n: p.grad for n, p in model.head.named_parameters()}, stats))
    (loss, grads, stats), (loss2, grads2, stats2) = runs
    assert torch.equal(loss, loss2) and stats and stats.keys() == stats2.keys()
    for name, g in grads.items():
        assert torch.equal(g, grads2[name]), name
    for name, s in stats.items():
        assert torch.equal(s, stats2[name]), name
