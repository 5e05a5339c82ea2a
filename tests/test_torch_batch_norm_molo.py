"""The BatchNorm kernels' tile plan (clip_fsar_torch/ops/batch_norm.py) at the shapes of MoLo's train chunk as the
benchmark's molo_r50 cell runs it: the shipped HMDB51 1-shot config (5-way 1-shot, 6 queries a class, 8 frames of
224 px) on a torchvision ResNet-50, two episodes a chunk.  The decoder's BatchNorms on per-episode statistics, two
groups of 5 x 7 (the support call) or 30 x 7 (the query call) difference maps at 14, 56 and 224 px (C = 128, 32,
16), and the trunk's BatchNorms on running statistics over the chunk's 560 frames, whose backward is the sum pass
that writes dx, then the combine.  The shapes are traced through the port's head on the meta device.  Each plan
covers every row and channel once; a CPU rendering of the kernels' order of sums and per-channel arithmetic
(tests/test_torch_batch_norm.py's) under each call's own plan holds to the plain chain.  The groups and channels are
summed apart, so the rendering takes one group and as many channels as keep a float32 copy at 64 MB: every row of
the call in the plan's order.  The kernels themselves run only on a card."""

import os

import pytest
import torch

from clip_fsar_torch.config.config import load_config
from clip_fsar_torch.data.types import Episode
from clip_fsar_torch.models.builder import _dtype_from_cfg
from clip_fsar_torch.models.clip.model import BatchNorm
from clip_fsar_torch.ops import batch_norm
from clip_fsar_torch.ops.batch_norm import MIN_BLOCKS, THREADS, tile_plan
from clip_fsar_torch.utils.registry import HEAD_REGISTRY
from tests.test_torch_batch_norm import EPS, _inputs, _render, sum_like_kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOLO_1SHOT = os.path.join(REPO, "configs", "projects", "MoLo", "hmdb51", "MoLo_HMDB51_1shot_v1.yaml")
RENDER_ELEMENTS = 2**24  # rows x channels of a rendering: 64 MB a float32 copy


def _chunk_calls() -> dict:
    """{(G, M, C): "batch" or "running"} of every BatchNorm call of one train chunk of two episodes through MoLo's
    forward (the decoder on), traced on the meta device."""
    cfg = load_config(MOLO_1SHOT)
    with torch.device("meta"):
        head = HEAD_REGISTRY.get(cfg.VIDEO.HEAD.NAME)(cfg, arch=None, dtype=_dtype_from_cfg(cfg), device=torch.device("meta"))
    head.to("meta")  # the positional table, made from numpy on the host
    calls = {}

    def record(module, args):
        x, groups = args[0], (args[1] if len(args) > 1 else None)
        b, c, h, w = x.shape
        g = groups or 1
        calls[(g, b * h * w // g, c)] = "batch" if groups is not None else "running"

    for m in head.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_pre_hook(record)
    t, s, q = int(cfg.DATA.NUM_INPUT_FRAMES), int(cfg.TRAIN.WAY) * int(cfg.TRAIN.SHOT), int(cfg.TRAIN.WAY) * int(cfg.TRAIN.QUERY_PER_CLASS)
    clips = lambda n: torch.empty(2, n, t, 224, 224, 3, device="meta")  # noqa: E731
    labels = lambda n: torch.zeros(2, n, dtype=torch.long, device="meta")  # noqa: E731
    ep = Episode(support_images=clips(s), support_labels=labels(s), real_support_labels=labels(s), target_images=clips(q),
                 target_labels=labels(q), real_target_labels=labels(q))
    with torch.no_grad():
        head(ep, None, None, train=True)
    return calls


CALLS = _chunk_calls()
DECODER = sorted(k for k, kind in CALLS.items() if kind == "batch")
TRUNK = sorted(k for k, kind in CALLS.items() if kind == "running")


def test_the_traced_calls_are_molos():
    """The decoder's six calls at their published widths, two episodes a call, and the trunk over 560 frames."""
    maps = {"support": 5 * 7, "query": 30 * 7}
    assert DECODER == sorted((2, n * r * r, c) for n in maps.values() for r, c in ((14, 128), (56, 32), (224, 16)))
    assert (1, 560 * 112 * 112, 64) in TRUNK and (1, 560 * 7 * 7, 2048) in TRUNK and all(g == 1 for g, _, _ in TRUNK)


@pytest.mark.parametrize("g, m, c", DECODER + TRUNK)
def test_the_plan_covers_each_row_and_channel_once(g, m, c):
    """bf16 (the cell's compute dtype): 16-byte vectors, every channel in one (band, lane, element), the tiles' rows
    reaching past the last row by less than one tile, a block within THREADS threads, and at least MIN_BLOCKS blocks
    wherever one row a thread would give them.  Up to 210 x 224^2 rows a group at C = 16: every offset the kernels
    form (group, row, channel) lies below G * M * C, which passes 2^31 only at the query call's 224 px (int64 there)."""
    p = tile_plan(g, m, c, 2)
    assert p.vec == 8 and p.lanes * p.rows <= THREADS and p.lanes <= 32 and p.bands * p.lanes * p.vec >= c > (p.bands - 1) * p.lanes * p.vec
    assert p.tiles * p.rows * p.run >= m > (p.tiles - 1) * p.rows * p.run
    if g * p.bands * -(-m // p.rows) >= MIN_BLOCKS:
        assert p.blocks >= MIN_BLOCKS
    assert p.blocks < 2**31 and p.partials == 2 * g * p.tiles * c


def _slice(m: int, c: int) -> int:
    """Channels of a rendering of a call of ``m`` rows a group and ``c`` channels."""
    return max(1, min(c, RENDER_ELEMENTS // m))


@pytest.mark.parametrize("g, m, c", DECODER)
def test_the_decoders_calls_render_the_chain(g, m, c):
    """Batch statistics, forward and backward, in the kernels' order (the call's plan) against the plain chain in
    float32, to 2e-5 of each output's largest value (tests/test_torch_batch_norm.py's bound)."""
    k = _slice(m, c)
    x, dy, w, beta = _inputs(1, m, k, seed=m + c)
    y, dx, dw, db, _ = _render(x, dy, w, beta, tile_plan(g, m, c, 2))
    y_chain, _, saved = batch_norm.batch_norm_reference(x, w, beta, torch.zeros(k), torch.ones(k), None, True, EPS, 0.9)
    for got, want in zip((y, dx, dw, db), (y_chain, *batch_norm.batch_norm_bwd_reference(x, dy, w, saved, True, EPS))):
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5 * want.abs().max().item())


@pytest.mark.parametrize("g, m, c", TRUNK)
def test_the_trunks_running_statistics_backward_renders_the_chain(g, m, c):
    """Running statistics: dx = dy * a as the sum pass writes it (the same bits as the chain's), and dweight, dbias from
    the sums of dy and dy * x in the kernels' order (the call's plan), then the combine (d_a = sum(dy x) - d_b * mean,
    dweight = d_a * rstd), against the chain in float32 to 2e-5 of each one's largest value."""
    k = _slice(m, c)
    x, dy, w, beta = _inputs(1, m, k, seed=m + c)
    gen = torch.Generator().manual_seed(c)
    running_mean, running_var = 0.1 * torch.randn(k, generator=gen), 0.5 + torch.rand(k, generator=gen)
    plan = tile_plan(g, m, c, 2)
    rstd = torch.rsqrt(running_var + EPS)
    a = w * rstd
    d_b = sum_like_kernels(dy, plan)
    d_a = sum_like_kernels(dy * x, plan) - d_b * running_mean
    _, _, saved = batch_norm.batch_norm_reference(x, w, beta, running_mean, running_var, None, False, EPS, 0.9)
    dx_chain, dw_chain, db_chain = batch_norm.batch_norm_bwd_reference(x, dy, w, saved, False, EPS)
    assert torch.equal(dy * a[None, None], dx_chain)
    for got, want in (((d_a * rstd).sum(dim=0), dw_chain), (d_b.sum(dim=0), db_chain)):
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5 * want.abs().max().item())
