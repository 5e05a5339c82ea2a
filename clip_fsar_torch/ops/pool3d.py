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
the kernel to its plain version.

Why: PyTorch's CUDA backwards of both pools add into the input gradient with
atomics, in an order that changes between runs wherever windows overlap, so a
train step through R-2D3D's stem, S3D-G or TAdaConv's pooled branch did not
repeat bit for bit.  The JAX package's pools (flax ``nn.max_pool`` /
``nn.avg_pool``) reach no Pallas kernel: this op replaces no TPU kernel.

The max-pool saves only the argmax (int64, the forward's flat index within the
(n, c) plane), not x.  The input gradient takes x's memory format.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from clip_fsar_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"max": 0, "avg": 1}

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
    the sum in fp32 over the window offsets in ascending order of dy / (kd * kh * kw)."""
    kernel, stride, padding = _triple(kernel), _triple(stride), _triple(padding)
    g = dy.float() / float(kernel[0] * kernel[1] * kernel[2])
    return _scatter_offsets(dy, in_shape, kernel, stride, padding,
                            lambda out_slices, first, counts: g[(slice(None), slice(None)) + out_slices]).to(dy.dtype)


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
    if max(in_shape[2] * in_shape[3] * in_shape[4], *in_shape[1:]) >= 2**31 or max(want) >= 2**31:
        raise ValueError(f"pool3d_bwd takes planes and extents below 2^31 elements, got x {tuple(in_shape)}")
    fmt = torch.channels_last_3d if channels_last else torch.contiguous_format
    dx = torch.empty(tuple(in_shape), dtype=dy.dtype, device=dy.device, memory_format=fmt)
    if dx.numel() == 0:
        return dx
    lib = _build.library()
    strides = list(dy.stride()) + (list(argmax.stride()) if mode == "max" else [0] * 5) + list(dx.stride())
    with torch.cuda.device(dy.device):
        code = lib.pool3d_bwd(dy.data_ptr(), argmax.data_ptr() if mode == "max" else None, dx.data_ptr(), _MODES[mode], _DTYPE_CODES[dy.dtype],
                              *in_shape, *want, *kernel, *stride, *padding, *strides, int(channels_last),
                              torch.cuda.current_stream().cuda_stream)
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
