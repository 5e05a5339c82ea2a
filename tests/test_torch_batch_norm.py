"""The RN towers' BatchNorm op (clip_fsar_torch/ops/batch_norm.py) on the CPU: the kernels' tile plan at
every BatchNorm shape RN50, RN101 and RN50x64 reach at 224 px, a CPU rendering of the kernels' order of
sums and per-channel arithmetic against the plain chain and against float64 autograd of its expression,
the plain chain of ``_BatchNormFn`` bit for bit as it was, and the backward node's name, which the
benchmark's ``bn_chain_ms`` reads.  The kernels themselves run only on a card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from clip_fsar_torch.models.clip.arch import ARCHS
from clip_fsar_torch.models.clip.model import BatchNorm, ModifiedResNet
from clip_fsar_torch.ops import batch_norm
from clip_fsar_torch.ops.batch_norm import MAX_RUN, MIN_BLOCKS, THREADS, Plan, tile_plan

EPS = BatchNorm.EPS
# the flagship's train chunk (2 episodes of 5 support and 25 target clips of 8 frames), one episode a group,
# and its eval step (4 episodes of 10 clips of 8 frames), one group
CALLS = {"support": (2 * 5 * 8, 2), "target": (2 * 25 * 8, 2), "eval": (4 * 10 * 8, None)}


def _bn_shapes(name: str) -> set:
    """(G, M, C) of every BatchNorm call of the arch's tower at 224 px in the three calls, traced on the meta device."""
    arch = ARCHS[name]
    with torch.device("meta"):
        tower = ModifiedResNet(arch.vision_layers, arch.embed_dim, arch.vision_heads, 224, arch.vision_width)
    shapes = set()

    def record(module, args):
        x, groups = args
        b, c, h, w = x.shape
        g = groups or 1
        shapes.add((g, b * h * w // g, c))

    for m in tower.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_pre_hook(record)
    for frames, groups in CALLS.values():
        with torch.no_grad():
            tower(torch.empty(frames, 224, 224, 3, device="meta"), groups)
    return shapes


SHAPES = sorted(set().union(*(_bn_shapes(name) for name in ("RN50", "RN101", "RN50x64"))))


def test_the_traced_shapes_are_the_towers():
    """The meta trace sees the stem's 32 channels over 2.5 M rows a group in the target call, and stage 4's
    2048 channels over 1,960 rows a group in the support call, and RN50x64's widest (4096 channels)."""
    assert (2, 200 * 112 * 112, 32) in SHAPES and (2, 40 * 7 * 7, 2048) in SHAPES and (1, 320 * 7 * 7, 2048) in SHAPES
    assert max(c for _, _, c in SHAPES) == 4096 and len(SHAPES) > 40


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("g, m, c", SHAPES)
def test_tile_plan_covers_each_row_and_channel_once(g, m, c, itemsize):
    """Every row of a group in exactly one (tile, run step, row lane) and every channel in exactly one
    (band, lane, vector element), as the kernels index them; a block within THREADS threads and a thread
    within MAX_RUN rows; at least MIN_BLOCKS blocks wherever one row a thread would give them; the
    partials buffer holds exactly the (group, tile, channel) rows the sum pass writes."""
    p = tile_plan(g, m, c, itemsize)
    assert p.vec == 16 // itemsize and p.lanes * p.rows <= THREADS and 1 <= p.run <= MAX_RUN and p.lanes <= 32
    tile, k, r = np.meshgrid(np.arange(p.tiles), np.arange(p.run), np.arange(p.rows), indexing="ij")
    rows = (tile * p.rows * p.run + k * p.rows + r).ravel()
    assert np.array_equal(np.bincount(rows[rows < m], minlength=m), np.ones(m, dtype=np.int64))
    band, lane, e = np.meshgrid(np.arange(p.bands), np.arange(p.lanes), np.arange(p.vec), indexing="ij")
    chans = ((band * p.lanes + lane) * p.vec + e).ravel()
    assert np.array_equal(np.bincount(chans[chans < c], minlength=c), np.ones(c, dtype=np.int64))
    assert (p.bands - 1) * p.lanes * p.vec < c and (p.tiles - 1) * p.rows * p.run < m  # no band or tile left empty
    if g * p.bands * -(-m // p.rows) >= MIN_BLOCKS:
        assert p.blocks >= MIN_BLOCKS
    last = ((g - 1) * p.tiles + p.tiles - 1) * c + c - 1  # the last partial of the first sum; the second follows at G * tiles * C
    assert p.partials == 2 * g * p.tiles * c and last + g * p.tiles * c == p.partials - 1


@pytest.mark.parametrize("g, m, c, itemsize", [(3, 1, 8, 2), (1, 7, 5, 4), (2, 1000, 12, 2), (1, 5, 4096, 2)])
def test_tile_plan_at_small_and_odd_shapes(g, m, c, itemsize):
    """One row, channels no multiple of a 16-byte vector (one channel a thread), and fewer rows than one
    block's row lanes: still every row and channel once."""
    p = tile_plan(g, m, c, itemsize)
    assert p.vec == (16 // itemsize if c % (16 // itemsize) == 0 else 1)
    assert p.tiles * p.rows * p.run >= m > (p.tiles - 1) * p.rows * p.run
    assert p.bands * p.lanes * p.vec >= c > (p.bands - 1) * p.lanes * p.vec and p.lanes * p.rows <= THREADS


COMBINE = 32  # the combine's tile lanes (csrc/batch_norm.cu kCombine)


def sum_like_kernels(q: torch.Tensor, plan: Plan) -> torch.Tensor:
    """The sums over M of q [G, M, C] (float32) in the kernels' order: each thread's run of rows in turn,
    the block's row lanes as a tree, then each group's tiles in COMBINE strided runs and those as a
    tree (csrc/batch_norm.cu sum_kernel, combine_sums)."""
    g, m, c = q.shape
    rows, run, tiles = plan.rows, plan.run, plan.tiles
    q = torch.cat([q, q.new_zeros(g, tiles * rows * run - m, c)], dim=1).reshape(g, tiles, run, rows, c)
    acc = q[:, :, 0]
    for k in range(1, run):
        acc = acc + q[:, :, k]
    part = _tree(acc, dim=2)  # [G, tiles, C]
    lanes = -(-tiles // COMBINE) * COMBINE
    part = torch.cat([part, part.new_zeros(g, lanes - tiles, c)], dim=1).reshape(g, -1, COMBINE, c)
    acc = part[:, 0]
    for k in range(1, part.shape[1]):
        acc = acc + part[:, k]
    return _tree(acc, dim=1)


def _tree(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` as the kernels' tree: entry r takes r + h for h = half the next power of two, ..., 1."""
    n = t.shape[dim]
    half = 1
    while half < n:
        half <<= 1
    t = list(t.unbind(dim))
    half >>= 1
    while half:
        for r in range(min(half, n - half)):
            t[r] = t[r] + t[r + half]
        half >>= 1
    return t[0]


def _render(x, dy, w, beta, plan, eps=EPS):
    """The kernels' arithmetic on the CPU in float32: the sums in their order (``sum_like_kernels``), the
    forward's and the backward's combine per (group, channel), the affine and the dx pass; returns y, dx,
    dw, dbeta and the combine's (raw, var, live, d_var)."""
    xf, dyf = x.float(), dy.float()
    m = x.shape[1]
    count = torch.tensor(float(m))
    mean = sum_like_kernels(xf, plan) / count
    raw = sum_like_kernels(xf * xf, plan) / count - mean * mean
    var = torch.where(raw < 0, torch.zeros_like(raw), raw)
    live = (raw > 0).float()
    rstd = torch.rsqrt(var + eps)
    a = w * rstd
    b = beta - mean * a
    y = xf * a[:, None] + b[:, None]
    d_b = sum_like_kernels(dyf, plan)
    d_a = sum_like_kernels(dyf * xf, plan) - d_b * mean
    d_var = d_a * w * (-0.5) * rstd / (var + eps) * live
    d_mean = -d_b * a - (2.0 * mean) * d_var
    dx = dyf * a[:, None] + (d_mean[:, None] + (2.0 * d_var)[:, None] * xf) * (1.0 / count)
    return y, dx, (d_a * rstd).sum(dim=0), d_b.sum(dim=0), (raw, var, live, d_var)


def _inputs(g, m, c, seed, offset=0.5):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(g, m, c, generator=gen) * 1.5 + offset
    dy = torch.randn(g, m, c, generator=gen)
    w, beta = torch.rand(c, generator=gen) + 0.5, torch.randn(c, generator=gen)
    return x, dy, w, beta


# (G, M, C): a stem-like call (many tiles of 32-row runs and a ragged last tile), a stage-4-like call
# (bands of channels), one channel a thread, and fewer rows than a block has row lanes
RENDER_SHAPES = [(2, 70001, 32), (2, 1960, 2048), (1, 333, 12), (3, 5, 64)]


@pytest.mark.parametrize("g, m, c", RENDER_SHAPES)
def test_the_kernels_order_of_sums_matches_the_chain(g, m, c):
    """Mean and fast variance from the sums in the kernels' order against the plain chain's in float32 to
    1e-6 of the scale of their sums (E|x| for the mean, E[x^2] for the variance: both are float32 sums of
    the same terms in other orders), and both against float64 to the same."""
    x, dy, w, beta = _inputs(g, m, c, seed=m)
    plan = tile_plan(g, m, c, 2)
    _, _, (mean_chain, var_eps, _, _) = batch_norm.batch_norm_reference(x, w, beta, torch.zeros(c), torch.ones(c), None, True, EPS, 0.9)
    mean = sum_like_kernels(x, plan) / m
    var = (sum_like_kernels(x * x, plan) / m - mean * mean).clamp_min(0.0)
    x64 = x.double()
    mean_scale, var_scale = 1e-6 * x64.abs().mean(dim=1), 1e-6 * (x64 * x64).mean(dim=1)
    assert ((mean.double() - mean_chain.double()).abs() <= mean_scale).all()
    assert ((var.double() - (var_eps.double() - EPS)).abs() <= var_scale + 1e-9).all()  # + var_eps's own rounding
    assert ((mean.double() - x64.mean(dim=1)).abs() <= mean_scale).all()
    assert ((var.double() - x64.var(dim=1, unbiased=False)).abs() <= var_scale).all()


def _chain_autograd64(x, dy, w, beta):
    """dx, dw, dbeta by float64 autograd of the chain's expression (fast variance, its clamp at 0)."""
    x64, w64, b64 = (t.double().requires_grad_() for t in (x, w, beta))
    mean = x64.mean(dim=1)
    var = ((x64 * x64).mean(dim=1) - mean * mean).clamp_min(0.0)
    a = w64 * torch.rsqrt(var + EPS)
    y = x64 * a[:, None] + (b64 - mean * a)[:, None]
    dx, dw, db = torch.autograd.grad(y, (x64, w64, b64), dy.double())
    return y.detach(), dx, dw, db


@pytest.mark.parametrize("g, m, c", RENDER_SHAPES)
def test_the_kernels_arithmetic_matches_autograd_of_the_chain(g, m, c):
    """y, dx, dw and dbeta of the rendering against float64 autograd of the chain's expression, to 2e-5 of
    each one's largest value (float32 sums of up to 140,000 terms, and the backward's cancelling d_a), and
    against the plain chain's own forward and backward in float32."""
    x, dy, w, beta = _inputs(g, m, c, seed=m + 1)
    plan = tile_plan(g, m, c, 4)
    y, dx, dw, db, _ = _render(x, dy, w, beta, plan)
    for got, want in zip((y, dx, dw, db), _chain_autograd64(x, dy, w, beta)):
        scale = want.abs().max().item()
        torch.testing.assert_close(got.double(), want, rtol=0, atol=2e-5 * scale)
    y_chain, _, saved = batch_norm.batch_norm_reference(x, w, beta, torch.zeros(c), torch.ones(c), None, True, EPS, 0.9)
    dx_chain, dw_chain, db_chain = batch_norm.batch_norm_bwd_reference(x, dy, w, saved, True, EPS)
    for got, want in zip((y, dx, dw, db), (y_chain, dx_chain, dw_chain, db_chain)):
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5 * want.abs().max().item())


def test_where_raw_is_not_positive_the_clamp_passes_no_gradient():
    """A channel held at 0.5 (raw exactly 0: every sum exact) and one at 1000 plus noise of 1e-4 (float32's
    raw below 0 at this seed): var 0, the mask 0, d_var exactly 0, so dx there is dy * a + d_mean / M with no
    term in x; the other channels as autograd of the chain has them."""
    g, m, c = 2, 4099, 8
    x, dy, w, beta = _inputs(g, m, c, seed=7)
    x[:, :, 0] = 0.5
    x[:, :, 1] = 1000.0 + 1e-4 * torch.randn(g, m, generator=torch.Generator().manual_seed(3))
    plan = tile_plan(g, m, c, 4)
    y, dx, _, _, (raw, var, live, d_var) = _render(x, dy, w, beta, plan)
    assert (raw[:, :2] <= 0).all() and (raw[:, 2:] > 0).all()
    assert (var[:, :2] == 0).all() and (live[:, :2] == 0).all() and (d_var[:, :2] == 0).all()
    a = w * torch.rsqrt(var + EPS)
    d_b = sum_like_kernels(dy, plan)
    mean = sum_like_kernels(x, plan) / m
    d_mean = -d_b * a - 2.0 * mean * d_var
    no_x = dy * a[:, None] + (d_mean[:, None] + 0.0 * x) * (1.0 / torch.tensor(float(m)))
    assert torch.equal(dx[:, :, :2], no_x[:, :, :2])
    _, dx64, _, _ = _chain_autograd64(x, dy, w, beta)
    torch.testing.assert_close(dx[:, :, 2:].double(), dx64[:, :, 2:], rtol=0, atol=2e-5 * dx64[:, :, 2:].abs().max().item())


def _old_chain(xv, weight, bias, running_mean, running_var, prev, batch, eps, momentum):
    """``_BatchNormFn.forward`` and ``BatchNorm.forward``'s running update as they were written before the kernels."""
    xf = xv.float()
    g = xv.shape[0]
    if batch:
        mean = xf.mean(dim=1)
        raw = xf.square().mean(dim=1) - mean.square()
        var = raw.clamp_min(0.0)
        live = (raw > 0).float()
    else:
        mean, var, live = running_mean.expand(g, -1), running_var.expand(g, -1), None
    rstd = torch.rsqrt(var + eps)
    a = weight * rstd
    b = bias - mean * a
    y = (xf * a[:, None] + b[:, None]).to(xv.dtype)
    step = None
    if batch:
        prev = torch.stack([running_mean, running_var]) if prev is None else prev
        step = momentum * prev + (1.0 - momentum) * torch.stack([mean, var], dim=1)
    return y, step, (mean, var + eps, rstd, live)


def _old_backward(x, dy, weight, mean, var_eps, rstd, live, batch):
    """``_BatchNormFn.backward`` as it was written before the kernels."""
    xf, dyf = x.float(), dy.float()
    a = weight * rstd
    d_b = dyf.sum(dim=1)
    d_a = (dyf * xf).sum(dim=1) - d_b * mean
    dx = dyf * a[:, None]
    if batch:
        d_var = d_a * weight * (-0.5) * rstd / var_eps * live
        d_mean = -d_b * a - 2.0 * mean * d_var
        dx = dx + (d_mean[:, None] + 2.0 * d_var[:, None] * xf) / x.shape[1]
    return dx.to(x.dtype), (d_a * rstd).sum(dim=0), d_b.sum(dim=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [None, 2])
def test_the_cpu_chain_is_unchanged_bit_for_bit(groups, dtype):
    """BatchNorm on the CPU: output, gradients and two calls' running updates (the second from the first's)
    bit for bit those of the chain as it was, on running and on batch statistics, in float32 and bfloat16."""
    gen = torch.Generator().manual_seed(11)
    bn = BatchNorm(24)
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.copy_(torch.randn(24, generator=gen))
        bn.running_var.copy_(torch.rand(24, generator=gen) + 0.1)
    x = (torch.randn(4, 24, 5, 6, generator=gen) * 2 + 1).to(dtype).contiguous(memory_format=torch.channels_last).requires_grad_()
    dy = torch.randn(4, 24, 5, 6, generator=gen).to(dtype)
    y = bn(x, groups)
    y.backward(dy)
    step = bn.step_stats
    y2 = bn(x.detach(), groups)

    def view(t):  # NCHW-shaped channels_last -> [G, M, C], as BatchNorm.forward views it
        return t.detach().permute(0, 2, 3, 1).reshape(groups or 1, -1, 24)

    batch, w = groups is not None, bn.weight.detach()
    want, want_step, saved = _old_chain(view(x), w, bn.bias.detach(), bn.running_mean, bn.running_var, None, batch, bn.EPS, bn.MOMENTUM)
    dx, dw, db = _old_backward(view(x), view(dy), w, *saved, batch)
    assert torch.equal(view(y), want) and torch.equal(view(x.grad), dx)
    assert torch.equal(bn.weight.grad, dw) and torch.equal(bn.bias.grad, db)
    want2, want_step2, _ = _old_chain(view(x), w, bn.bias.detach(), bn.running_mean, bn.running_var, want_step, batch, bn.EPS, bn.MOMENTUM)
    assert torch.equal(view(y2), want2)
    if groups is None:
        assert step is None and bn.step_stats is None
    else:
        assert torch.equal(step, want_step) and torch.equal(bn.step_stats, want_step2) and not step.requires_grad


def test_the_backward_node_keeps_its_name():
    """The benchmark reads the BatchNorm backward's device time under the autograd node ``_BatchNormFnBackward``."""
    bn = BatchNorm(8)
    torch.nn.init.ones_(bn.weight), torch.nn.init.zeros_(bn.bias)
    y = bn(torch.randn(2, 8, 3, 3, requires_grad=True), 2)
    seen, todo = set(), [y.grad_fn]
    while todo:
        node = todo.pop()
        if node is not None and node not in seen:
            seen.add(node)
            todo.extend(n for n, _ in node.next_functions)
    assert "_BatchNormFnBackward" in {n.name() for n in seen}


def test_the_kernel_entries_refuse_cpu_tensors_and_bad_previous_stats():
    """The kernels' wrappers take CUDA tensors only (no fallback to the chain), and the previous running
    stats only as [2, C] or [G, 2, C] float32."""
    x, w = torch.randn(2, 10, 8), torch.ones(8)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        batch_norm.batch_norm_cuda(x, w, w, w, w, None, True, EPS, 0.9)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        batch_norm.batch_norm_bwd_cuda(x, x, w, (torch.zeros(6, 2, 8),), True, EPS)
    mean, var, stride = batch_norm._prev(torch.arange(48.0).reshape(3, 2, 8), w, w, 3)
    assert stride == 16 and mean[1, 0].item() == 16 and var[2, 0].item() == 40
    assert batch_norm._prev(None, w, w, 3)[2] == 0 and batch_norm._prev(torch.zeros(2, 8), w, w, 3)[2] == 0
    with pytest.raises(ValueError, match="prev must be"):
        batch_norm._prev(torch.zeros(2, 2, 8), w, w, 3)
