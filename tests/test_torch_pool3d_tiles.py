"""The tiled schedule of the pools' backward kernel (clip_fsar_torch/csrc/pool3d.cu, its tile picked on the host by
clip_fsar_torch/ops/pool3d.py ``tile_plan``), on the CPU.

The kernel's per-axis covering windows (``covering``, the formula the kernel evaluates once per tile position)
against the plain version's window offsets (``_offset_slices``), at every geometry the card tests run; the tile
plan's box holds any tile's covering windows and fits its shared-memory budget; and a numpy emulation of the
kernel's schedule (each tile's box of dy and argmax staged, the windows of each position read from the box in the
kernel's order, sums in fp32 rounded once) gives the plain version's bits, in fp32 and bf16, channels-last and
NCDHW, with channel counts that are and are not a multiple of the 16-byte vector, at the plan's own budget and at
small budgets that cut every axis into tiles with a partial tile at its end.
"""

import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from clip_fsar_torch.ops import pool3d

torch.set_num_threads(2)

# the geometries of tests/test_torch_cuda.py POOL_CASES: (kernel, stride, padding, mode)
GEOMETRIES = [((1, 3, 3), (1, 2, 2), (0, 1, 1), "max"), ((3, 3, 3), (1, 1, 1), (1, 1, 1), "max"), ((3, 3, 3), (2, 2, 2), (1, 1, 1), "max"),
              ((2, 2, 2), (2, 2, 2), (0, 0, 0), "max"), ((3, 1, 1), (1, 1, 1), (1, 0, 0), "avg")]
GEO_IDS = ["stem", "branch", "stage_s2", "stage_k2", "tada_avg"]
# the production budget, and budgets that leave a few positions a tile (min_blocks 1: the largest tile that fits)
BUDGETS = [(pool3d.SMEM_BUDGET, pool3d.MIN_BLOCKS), (6000, 1), (3000, 1)]


def covering(i: int, k: int, s: int, p: int, out: int) -> tuple:
    """The windows o along one axis that cover input i, as csrc/pool3d.cu computes them: (first, last)."""
    a = i + p - k + 1
    lo = 0 if a <= 0 else (a + s - 1) // s
    return lo, min((i + p) // s, out - 1)


@pytest.mark.parametrize("kernel, stride, padding, mode", GEOMETRIES, ids=GEO_IDS)
def test_covering_windows_match_the_plain_versions_offsets(kernel, stride, padding, mode):
    """For each axis and input position, the windows ``covering`` gives, last to first, are those the plain version's
    offset slices add into that position, offset by offset ascending."""
    for size, k, s, p in zip((9, 14, 15), kernel, stride, padding):
        out = pool3d._out_extent(size, k, s, p)
        want = {i: [] for i in range(size)}
        for off, sl, first in pool3d._offset_slices(k, s, out, p, size):
            if sl is None:
                continue
            for o in range(sl.start, sl.stop):
                want[first + (o - sl.start) * s].append(o)
        for i in range(size):
            lo, hi = covering(i, k, s, p, out)
            assert list(range(hi, lo - 1, -1)) == want[i]


def _plan_of(mode, view, out, kernel, stride, esize, vec, budget, min_blocks):
    plan = pool3d.tile_plan(view, out, kernel, stride, esize, mode == "max", vec, budget, min_blocks)
    td, th, tw, cb, bd, bh, bw = plan
    for t, k, s, o, b in zip((td, th, tw), kernel, stride, out, (bd, bh, bw)):
        assert b == pool3d.box_extent(t, k, s, o)
    box = bd * bh * bw * cb
    assert pool3d._smem_bytes(box, esize, mode == "max", td + th + tw) <= budget
    assert cb % vec == 0 and cb <= view[1]
    return plan


def tiled_pool_bwd(mode, dy, argmax, in_shape, kernel, stride, padding, channels_last, budget, min_blocks):
    """``pool3d_bwd`` as the kernel schedules it, in numpy: the channels-last view [N', D, H, W, C'] (NCDHW: N*C planes
    of one channel), the tile from ``tile_plan``; for each tile its box of dy and argmax staged, then each position's
    covering windows (relative to the box) read from it, (od, oh, ow) descending, in fp32; dx rounded once."""
    n, c, d, h, w = in_shape
    od_, oh_, ow_ = dy.shape[2:]
    perm = (0, 2, 3, 4, 1)
    if channels_last:
        view = (n, c, d, h, w)
        y = dy.float().permute(*perm).numpy()
        m = argmax.permute(*perm).numpy() if mode == "max" else None
    else:
        view = (n * c, 1, d, h, w)
        y = dy.float().reshape(n * c, 1, od_, oh_, ow_).permute(*perm).numpy()
        m = argmax.reshape(n * c, 1, od_, oh_, ow_).permute(*perm).numpy() if mode == "max" else None
    esize = dy.element_size()
    vec = 16 // esize if view[1] % (16 // esize) == 0 else 1
    td, th, tw, cb, bd_max, bh_max, bw_max = _plan_of(mode, view, (od_, oh_, ow_), kernel, stride, esize, vec, budget, min_blocks)
    volume = np.float32(kernel[0] * kernel[1] * kernel[2])
    dx = np.zeros((view[0], d, h, w, view[1]), np.float32)
    for nn, c0, d0, h0, w0 in itertools.product(range(view[0]), range(0, view[1], cb), range(0, d, td), range(0, h, th), range(0, w, tw)):
        nd, nh, nw, nc = min(td, d - d0), min(th, h - h0), min(tw, w - w0), min(cb, view[1] - c0)
        starts = (d0, h0, w0)
        box = []
        for axis, (t0, cnt) in enumerate(zip(starts, (nd, nh, nw))):
            lo, _ = covering(t0, kernel[axis], stride[axis], padding[axis], (od_, oh_, ow_)[axis])
            _, hi = covering(t0 + cnt - 1, kernel[axis], stride[axis], padding[axis], (od_, oh_, ow_)[axis])
            box.append((lo, hi - lo + 1))
        assert box[0][1] <= bd_max and box[1][1] <= bh_max and box[2][1] <= bw_max
        if min(b for _, b in box) <= 0:
            continue
        sl = tuple(slice(lo, lo + cnt) for lo, cnt in box)
        s_y = np.zeros((bd_max, bh_max, bw_max, cb), np.float32)
        s_y[:box[0][1], :box[1][1], :box[2][1], :nc] = y[(nn,) + sl + (slice(c0, c0 + nc),)]
        if mode == "max":
            s_m = np.full((bd_max, bh_max, bw_max, cb), -1, np.int64)
            s_m[:box[0][1], :box[1][1], :box[2][1], :nc] = m[(nn,) + sl + (slice(c0, c0 + nc),)]
        tables = [[covering(t0 + i, kernel[axis], stride[axis], padding[axis], (od_, oh_, ow_)[axis]) for i in range(cnt)]
                  for axis, (t0, cnt) in enumerate(zip(starts, (nd, nh, nw)))]
        for i, j, l in itertools.product(range(nd), range(nh), range(nw)):
            flat = ((d0 + i) * h + h0 + j) * w + w0 + l
            acc = np.zeros(nc, np.float32)
            (dlo, dhi), (hlo, hhi), (wlo, whi) = tables[0][i], tables[1][j], tables[2][l]
            for o_d, o_h, o_w in itertools.product(range(dhi, dlo - 1, -1), range(hhi, hlo - 1, -1), range(whi, wlo - 1, -1)):
                at = (o_d - box[0][0], o_h - box[1][0], o_w - box[2][0])
                assert all(0 <= a < b for a, (_, b) in zip(at, box))
                v = s_y[at][:nc]
                if mode == "max":
                    acc = acc + np.where(s_m[at][:nc].astype(np.int32) == flat, v, np.float32(0))
                else:
                    acc = acc + v / volume
            dx[nn, d0 + i, h0 + j, w0 + l, c0:c0 + nc] = acc
    out = torch.from_numpy(dx).permute(0, 4, 1, 2, 3)
    return out.reshape(in_shape).to(dy.dtype)


@pytest.mark.parametrize("budget, min_blocks", BUDGETS, ids=["plan", "small", "tiny"])
@pytest.mark.parametrize("channels", [8, 5], ids=["c_vec", "c_odd"])
@pytest.mark.parametrize("layout", ["channels_last", "ncdhw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kernel, stride, padding, mode", GEOMETRIES, ids=GEO_IDS)
def test_tiled_schedule_gives_the_plain_bits(kernel, stride, padding, mode, dtype, layout, channels, budget, min_blocks):
    shape = (2, channels, 5, 9, 7)  # odd extents: partial tiles, and positions no window covers at stride 2
    g = torch.Generator().manual_seed(sum(kernel) + channels)
    x = torch.randint(0, 3, shape, generator=g).to(dtype)  # ties: the first maximum in window order
    if mode == "max":
        y, argmax = F.max_pool3d(x.float(), kernel, stride, padding, return_indices=True)
    else:
        y, argmax = F.avg_pool3d(x.float(), kernel, stride, padding), None
    dy = torch.randn(y.shape, generator=g).to(dtype)
    if mode == "max":
        want = pool3d.max_pool3d_bwd_reference(dy, argmax, shape, kernel, stride, padding)
    else:
        want = pool3d.avg_pool3d_bwd_reference(dy, shape, kernel, stride, padding)
    got = tiled_pool_bwd(mode, dy, argmax, shape, kernel, stride, padding, layout == "channels_last", budget, min_blocks)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape, kernel, stride, padding, mode, esize", [
    ((90, 64, 16, 56, 56), (1, 3, 3), (1, 2, 2), (0, 1, 1), "max", 2),  # MoSI's stem
    ((2, 192, 8, 28, 28), (3, 3, 3), (1, 1, 1), (1, 1, 1), "max", 2),  # an S3D-G branch pool
    ((8, 64, 16, 56, 56), (3, 1, 1), (1, 1, 1), (1, 0, 0), "avg", 4),  # TAdaConv's pooled branch, fp32
], ids=["mosi_stem", "s3dg_branch", "tada2d_avg"])
def test_plan_at_the_paths_shapes(shape, kernel, stride, padding, mode, esize):
    """At the shapes the train paths give the kernel, the plan stages at least 32 bytes of channels a position, fits
    the budget, gives the card enough blocks and each block at least a thread an element, and stages each window
    fewer times than the positions it covers read it."""
    n, c, d, h, w = shape
    out = tuple(pool3d._out_extent(*a) for a in zip(shape[2:], kernel, stride, padding))
    vec = 16 // esize
    td, th, tw, cb, bd, bh, bw = _plan_of(mode, shape, out, kernel, stride, esize, vec, pool3d.SMEM_BUDGET, pool3d.MIN_BLOCKS)
    assert cb * esize in (32, 64, 128)
    assert n * -(-c // cb) * -(-d // td) * -(-h // th) * -(-w // tw) >= pool3d.MIN_BLOCKS
    assert td * th * tw * cb // vec >= pool3d.THREADS
    staged_per_window = bd * bh * bw / (td * th * tw) * (d * h * w) / (out[0] * out[1] * out[2])
    assert staged_per_window < kernel[0] * kernel[1] * kernel[2] / (stride[0] * stride[1] * stride[2])
