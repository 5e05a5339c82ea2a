"""3-D max and average pooling whose backward writes each input gradient once.

``max_pool3d(x, kernel, stride, padding)`` and ``avg_pool3d(x, kernel, stride,
padding)`` (count_include_pad) take x [N, C, D, H, W] in float32 or bfloat16,
in any memory format, and return what ``F.max_pool3d`` / ``F.avg_pool3d``
return: the forward is ATen's (deterministic; the max-pool keeps the first
maximum of each window, as XLA's select does).  Each is a
``torch.autograd.Function`` whose backward is a gather: on a CUDA tensor the
kernel ``pool3d_bwd`` (``csrc/pool3d.cu``), on a CPU tensor
``max_pool3d_bwd_reference`` / ``avg_pool3d_bwd_reference``, a sum over the
window's offsets in a fixed order of strided slices.  There is no fallback from
the kernel to its plain version.  The kernel takes a tile of the input gradient
a block, whose covering windows of dy and argmax it stages in shared memory;
``tile_plan`` picks the tile on the host.

Why: PyTorch's CUDA backwards of both pools add into the input gradient with
atomics, in an order that changes between runs wherever windows overlap, so a
train step through R-2D3D's stem, S3D-G or TAdaConv's pooled branch did not
repeat bit for bit.  The JAX package's pools (flax ``nn.max_pool`` /
``nn.avg_pool``) reach no Pallas kernel: this op replaces no TPU kernel.

The max-pool saves only the argmax (int64, the forward's flat index within the
(n, c) plane), not x.  The input gradient takes x's memory format.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from clip_fsar_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"max": 0, "avg": 1}
SMEM_BUDGET = 64 * 1024  # a block's staged box and tables: four blocks share an SM's 227 KB
MIN_BLOCKS = 4 * 132  # enough tiles to give each of the card's 132 SMs four blocks
THREADS = 256  # a block's threads (csrc/pool3d.cu kThreads)

# kernel launches since the last reset (a run shows it went through the kernel)
LAUNCHES = {"max_pool3d_bwd": 0, "avg_pool3d_bwd": 0}

Triple = Tuple[int, int, int]


def _triple(v) -> Triple:
    return tuple(int(x) for x in v) if isinstance(v, Sequence) else (int(v),) * 3


def _out_extent(size: int, k: int, s: int, p: int) -> int:
    return (size + 2 * p - k) // s + 1


def _offset_slices(k: int, s: int, out: int, p: int, size: int):
    """For each window offset i along one axis: the output positions o whose input o*s - p + i lies inside
    [0, size), as a slice of the outputs, and the first such input position."""
    for i in range(k):
        lo = max(0, -(-(p - i) // s))  # first o with o*s - p + i >= 0
        hi = min(out - 1, (size - 1 + p - i) // s)  # last o with o*s - p + i <= size - 1
        yield i, (slice(lo, hi + 1) if hi >= lo else None), lo * s - p + i


def _scatter_offsets(dy: torch.Tensor, in_shape, kernel: Triple, stride: Triple, padding: Triple, pick) -> torch.Tensor:
    """sum over window offsets (kd, kh, kw) ascending of pick(offset, output slices, input positions) added into
    the input gradient through strided slices, in fp32."""
    n, c, d, h, w = in_shape
    od, oh, ow = dy.shape[2:]
    dx = torch.zeros((n, c, d, h, w), dtype=torch.float32, device=dy.device)
    axes = [list(_offset_slices(k, s, o, p, size)) for k, s, o, p, size in zip(kernel, stride, (od, oh, ow), padding, (d, h, w))]
    for i, sd_, d0 in axes[0]:
        for j, sh_, h0 in axes[1]:
            for l, sw_, w0 in axes[2]:
                if sd_ is None or sh_ is None or sw_ is None:
                    continue
                counts = (sd_.stop - sd_.start, sh_.stop - sh_.start, sw_.stop - sw_.start)
                target = dx[:, :, d0:d0 + (counts[0] - 1) * stride[0] + 1:stride[0], h0:h0 + (counts[1] - 1) * stride[1] + 1:stride[1],
                            w0:w0 + (counts[2] - 1) * stride[2] + 1:stride[2]]
                target += pick((sd_, sh_, sw_), (d0, h0, w0), counts)
    return dx


def max_pool3d_bwd_reference(dy: torch.Tensor, argmax: torch.Tensor, in_shape, kernel, stride, padding) -> torch.Tensor:
    """Plain-torch ``pool3d_bwd`` (max): dx [N, C, D, H, W] contiguous in dy's dtype, the sum in fp32 over the
    window offsets in ascending order of dy where the window's argmax is that offset's input element."""
    kernel, stride, padding = _triple(kernel), _triple(stride), _triple(padding)
    _, _, _, h, w = in_shape
    g = dy.float()

    def pick(out_slices, first, counts):
        pos = [torch.arange(cnt, device=dy.device) * s + f for cnt, s, f in zip(counts, stride, first)]
        flat = (pos[0][:, None, None] * h + pos[1][None, :, None]) * w + pos[2][None, None, :]
        sel = argmax[(slice(None), slice(None)) + out_slices]
        return torch.where(sel == flat, g[(slice(None), slice(None)) + out_slices], 0.0)

    return _scatter_offsets(dy, in_shape, kernel, stride, padding, pick).to(dy.dtype)


def avg_pool3d_bwd_reference(dy: torch.Tensor, in_shape, kernel, stride, padding) -> torch.Tensor:
    """Plain-torch ``pool3d_bwd`` (average, count_include_pad): dx [N, C, D, H, W] contiguous in dy's dtype,
    the sum in fp32 over the window offsets in ascending order of dy / (kd * kh * kw).  The divisor is a tensor on
    dy's device: a CUDA tensor divided by a Python number is multiplied by its reciprocal instead, which is not the
    same bits as the division on the CPU or in the kernel."""
    kernel, stride, padding = _triple(kernel), _triple(stride), _triple(padding)
    g = dy.float() / torch.tensor(float(kernel[0] * kernel[1] * kernel[2]), device=dy.device)
    return _scatter_offsets(dy, in_shape, kernel, stride, padding,
                            lambda out_slices, first, counts: g[(slice(None), slice(None)) + out_slices]).to(dy.dtype)


def box_extent(t: int, k: int, s: int, out: int) -> int:
    """The most windows along one axis that cover t consecutive input positions, at kernel k and stride s."""
    return min(out, (t + k - 2) // s + 1)


def _smem_bytes(box: int, esize: int, with_argmax: bool, tables: int) -> int:
    """A block's shared memory (csrc/pool3d.cu): the int64 argmax box, the dy box (to 16 bytes), the tables."""
    return (8 * box if with_argmax else 0) + (box * esize + 15) // 16 * 16 + 8 * tables


def _candidates(extent: int) -> list:
    return sorted({min(extent, 1 << i) for i in range(max(1, extent).bit_length() + 1)})


@functools.lru_cache(maxsize=256)
def tile_plan(view: tuple, out: Triple, kernel: Triple, stride: Triple, esize: int, with_argmax: bool, vec: int,
              budget: int = SMEM_BUDGET, min_blocks: int = MIN_BLOCKS) -> tuple:
    """The tile of ``pool3d_bwd``'s blocks over the channels-last view ``view`` = (N', C', D, H, W) of dx (NCDHW is N*C
    planes of one channel): (TD, TH, TW, CB) positions and channels a block, and its box (BD, BH, BW), the most
    covering windows along each axis, which the block stages in shared memory.  CB is 128, 64 or 32 bytes of channels
    (a multiple of ``vec``; at most 64 channels where ``vec`` is 1).  Among the tiles whose box fits ``budget`` bytes:
    the most blocks up to ``min_blocks`` first, then at least THREADS elements a block, then the fewest staged windows
    per position owned, then the widest CB, then up to eight elements a thread, then the least shared memory.  Raises
    if no tile fits."""
    _, c, d, h, w = view
    widest = min(c, 128 // esize) if vec > 1 else min(c, 64)
    best = None
    for cb in sorted({widest} | {x for x in (64 // esize, 32 // esize) if vec > 1 and vec <= x < widest}):
        for tw, td, th in itertools.product(sorted({-(-w // (1 << i)) for i in range(w.bit_length() + 1)}), _candidates(d), _candidates(h)):
            boxes = tuple(box_extent(t, k, s, o) for t, k, s, o in zip((td, th, tw), kernel, stride, out))
            smem = _smem_bytes(boxes[0] * boxes[1] * boxes[2] * cb, esize, with_argmax, td + th + tw)
            if smem > budget:
                continue
            blocks = view[0] * -(-c // cb) * -(-d // td) * -(-h // th) * -(-w // tw)
            staged = boxes[0] * boxes[1] * boxes[2] / (td * th * tw)
            elems = td * th * tw * (cb // vec)
            key = (max(0, min_blocks - blocks), elems < THREADS, staged, -cb, -min(elems, 8 * THREADS), smem)
            if best is None or key < best[0]:
                best = (key, (td, th, tw, cb) + boxes)
    if best is None:
        raise ValueError(f"pool3d_bwd: no tile's covering windows fit {budget} bytes of shared memory at kernel {kernel}, "
                         f"stride {stride}, x {view}")
    return best[1]


def launch_tile(mode: str, dtype: torch.dtype, in_shape, kernel, stride, padding, channels_last: bool, aligned: bool = True) -> tuple:
    """What ``pool3d_bwd_cuda`` launches for these arguments: the channels-last view (N', C', D, H, W), the elements a
    thread owns (16 bytes' worth, or 1 where C' is not a multiple of that or a pointer is not ``aligned`` to 16 bytes),
    and ``tile_plan``'s tile and box."""
    kernel, stride, padding = _triple(kernel), _triple(stride), _triple(padding)
    n, c, d, h, w = in_shape
    view = (n, c, d, h, w) if channels_last else (n * c, 1, d, h, w)
    out = tuple(_out_extent(*a) for a in zip(in_shape[2:], kernel, stride, padding))
    vec = 16 // dtype.itemsize if aligned and view[1] % (16 // dtype.itemsize) == 0 else 1
    return view, vec, tile_plan(view, out, kernel, stride, dtype.itemsize, mode == "max", vec)


@functools.lru_cache(maxsize=256)
def _launch_args(mode: str, dtype: torch.dtype, in_shape: tuple, kernel: Triple, stride: Triple, padding: Triple, channels_last: bool,
                 aligned: bool) -> tuple:
    """``launch_tile``'s thread width and the kernel's plan as the C array it takes, once per geometry (the launch's
    host time counts where a step waits on its launch thread)."""
    view, vec, tile = launch_tile(mode, dtype, in_shape, kernel, stride, padding, channels_last, aligned)
    out = tuple(_out_extent(*a) for a in zip(in_shape[2:], kernel, stride, padding))
    plan = view + out + kernel + stride + padding + tile
    return vec, (ctypes.c_int * len(plan))(*plan)


def _channels_last(t: torch.Tensor) -> bool:
    return t.is_contiguous(memory_format=torch.channels_last_3d) and not t.is_contiguous()


def pool3d_bwd_cuda(mode: str, dy: torch.Tensor, argmax, in_shape, kernel, stride, padding, channels_last: bool) -> torch.Tensor:
    """Launch ``pool3d_bwd``: dx [N, C, D, H, W] in dy's dtype, in the channels_last_3d memory format if
    ``channels_last`` else contiguous.  dy (and argmax, int64, for ``mode`` "max") at any strides.  Raises
    on any input the kernel does not take."""
    kernel, stride, padding = _triple(kernel), _triple(stride), _triple(padding)
    if dy.device.type != "cuda":
        raise ValueError(f"pool3d_bwd_cuda needs a CUDA tensor, got {dy.device}")
    if dy.dtype not in _DTYPE_CODES:
        raise TypeError(f"pool3d_bwd takes float32 or bfloat16, got {dy.dtype}")
    if mode not in _MODES:
        raise ValueError(f"pool3d_bwd mode is 'max' or 'avg', got {mode!r}")
    if dy.dim() != 5 or len(in_shape) != 5 or tuple(dy.shape[:2]) != tuple(in_shape[:2]):
        raise ValueError(f"pool3d_bwd needs dy [N, C, OD, OH, OW] over x {tuple(in_shape)}, got {tuple(dy.shape)}")
    want = tuple(_out_extent(*a) for a in zip(in_shape[2:], kernel, stride, padding))
    if tuple(dy.shape[2:]) != want or any(p > k // 2 for k, p in zip(kernel, padding)):
        raise ValueError(f"dy {tuple(dy.shape)} is not the pool of x {tuple(in_shape)} at kernel {kernel}, stride {stride}, padding "
                         f"{padding} (outputs {want}; padding at most half the window)")
    if mode == "max" and (argmax is None or argmax.dtype != torch.int64 or argmax.shape != dy.shape or argmax.device != dy.device):
        raise ValueError("the max-pool backward needs the forward's int64 argmax, shaped like dy, on dy's device")
    n, c, d, h, w = in_shape
    if max(d * h * w, n * c) >= 2**31:
        raise ValueError(f"pool3d_bwd takes planes and N*C below 2^31 elements, got x {tuple(in_shape)}")
    fmt = torch.channels_last_3d if channels_last else torch.contiguous_format
    dx = torch.empty(tuple(in_shape), dtype=dy.dtype, device=dy.device, memory_format=fmt)
    if dx.numel() == 0:
        return dx
    # the kernel reads dy and argmax in dx's layout: a copy only where the caller's differs
    if not dy.is_contiguous(memory_format=fmt):
        dy = dy.contiguous(memory_format=fmt)
    if mode == "max" and not argmax.is_contiguous(memory_format=fmt):
        argmax = argmax.contiguous(memory_format=fmt)
    aligned = not any(t.data_ptr() % 16 for t in (dy, dx) + ((argmax,) if mode == "max" else ()))
    vec, plan = _launch_args(mode, dy.dtype, tuple(in_shape), kernel, stride, padding, bool(channels_last), aligned)
    lib = _build.library()
    with torch.cuda.device(dy.device):
        code = lib.pool3d_bwd(dy.data_ptr(), argmax.data_ptr() if mode == "max" else None, dx.data_ptr(), _MODES[mode], _DTYPE_CODES[dy.dtype],
                              vec, plan, torch.cuda.current_stream().cuda_stream)
    _build.check(code, "pool3d_bwd launch")
    LAUNCHES[f"{mode}_pool3d_bwd"] += 1
    return dx


class _MaxPool3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, kernel: Triple, stride: Triple, padding: Triple) -> torch.Tensor:
        y, argmax = F.max_pool3d(x, kernel, stride, padding, return_indices=True)
        ctx.geometry = (tuple(x.shape), kernel, stride, padding, _channels_last(x))
        ctx.save_for_backward(argmax)
        return y

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        (argmax,) = ctx.saved_tensors
        in_shape, kernel, stride, padding, channels_last = ctx.geometry
        if dy.device.type == "cpu":
            dx = max_pool3d_bwd_reference(dy, argmax, in_shape, kernel, stride, padding)
        else:
            dx = pool3d_bwd_cuda("max", dy, argmax, in_shape, kernel, stride, padding, channels_last)
        return dx, None, None, None


class _AvgPool3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, kernel: Triple, stride: Triple, padding: Triple) -> torch.Tensor:
        ctx.geometry = (tuple(x.shape), kernel, stride, padding, _channels_last(x))
        return F.avg_pool3d(x, kernel, stride, padding, count_include_pad=True)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        in_shape, kernel, stride, padding, channels_last = ctx.geometry
        if dy.device.type == "cpu":
            dx = avg_pool3d_bwd_reference(dy, in_shape, kernel, stride, padding)
        else:
            dx = pool3d_bwd_cuda("avg", dy, None, in_shape, kernel, stride, padding, channels_last)
        return dx, None, None, None


def max_pool3d(x: torch.Tensor, kernel, stride, padding=0) -> torch.Tensor:
    """``F.max_pool3d(x, kernel, stride, padding)`` (padding by -inf) with a gathered backward."""
    return _MaxPool3d.apply(x, _triple(kernel), _triple(stride), _triple(padding))


def avg_pool3d(x: torch.Tensor, kernel, stride, padding=0) -> torch.Tensor:
    """``F.avg_pool3d(x, kernel, stride, padding, count_include_pad=True)`` with a gathered backward."""
    return _AvgPool3d.apply(x, _triple(kernel), _triple(stride), _triple(padding))
