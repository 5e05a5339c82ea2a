"""LayerNorm over the last axis as one kernel each way (counterpart of
clip_fsar_tpu/ops/fused_layernorm.py).

``layer_norm(x, g, b, eps=1e-5)`` takes x [..., D] in float32 or bfloat16 and
g, b [D] (float32 in the towers) and returns y in x's dtype.  It is a
``torch.autograd.Function`` that keeps (x, g) and no statistics, as the JAX
``custom_vjp`` does; its backward returns dx in x's dtype and dg, db in g's.
On a CUDA tensor the forward launches K6 and the backward K7
(``csrc/layer_norm.cu``, ports of the TPU ``_fwd_kernel`` and ``_bwd_kernel``);
on a CPU tensor they run ``layer_norm_reference`` and
``layer_norm_bwd_reference``, the same functions in plain torch.  There is no
fallback from a kernel to its plain version.

The kernels take any number of rows (the TPU kernels' padding of the rows to
blocks of 512 is not carried over) and D a multiple of 8 up to 1024.  No model
of the port calls this op, as none of the JAX package calls its counterpart:
the CLIP ``LayerNorm`` module keeps its own chain.
"""

from __future__ import annotations

from typing import Tuple

import torch

from clip_fsar_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 1024  # the widest row the kernels keep in a warp's registers

# kernel launches since the last reset (a run shows it went through the kernels)
LAUNCHES = {"layer_norm_fwd": 0, "layer_norm_bwd": 0}


def _row_stats(xf: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 mean and 1/sqrt(var + eps) per row, with the fast-variance form
    clamped at 0 (fused_layernorm.py:45-47)."""
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return mu, torch.rsqrt(var + eps)


def layer_norm_reference(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain-torch K6: y = (x - mu) * inv * g + b in fp32, rounded once to
    x's dtype (fused_layernorm.py:43-48)."""
    xf = x.float()
    mu, inv = _row_stats(xf, eps)
    return ((xf - mu) * inv * g.float() + b.float()).to(x.dtype)


def layer_norm_bwd_reference(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-torch K7: (dx in x's dtype, dg [D] fp32, db [D] fp32) from the
    forward's input x, g and the output gradient dy (x's shape), with mu and
    inv recomputed from x (fused_layernorm.py:51-67)."""
    d = x.shape[-1]
    xf, dyf = x.float(), dy.float()
    mu, inv = _row_stats(xf, eps)
    xhat = (xf - mu) * inv
    gdy = g.float() * dyf
    m1 = gdy.mean(dim=-1, keepdim=True)
    m2 = (gdy * xhat).mean(dim=-1, keepdim=True)
    dx = (inv * (gdy - m1 - xhat * m2)).to(x.dtype)
    return dx, (dyf * xhat).reshape(-1, d).sum(dim=0), dyf.reshape(-1, d).sum(dim=0)


def _check(x: torch.Tensor, what: str, **vectors: torch.Tensor) -> Tuple[int, int]:
    """Validate what the kernels take: x (and tensors shaped like it, checked by the caller) and the
    [D] float32 ``vectors``; returns (rows, D)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"layer_norm kernels take float32 or bfloat16, got {x.dtype}")
    if x.dim() < 1:
        raise ValueError("layer_norm needs x [..., D]")
    d = x.shape[-1]
    if d % 8 or not 8 <= d <= MAX_D:
        raise ValueError(f"layer_norm kernels are built for D a multiple of 8 with 8 <= D <= {MAX_D}, got {d}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("layer_norm kernels need a contiguous x aligned to 16 bytes")
    for name, t in vectors.items():
        if t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != (d,) or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous float32 tensor of shape ({d},) on {x.device} aligned to 16 bytes, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    rows = x.numel() // d
    if rows >= 2**31:
        raise ValueError(f"layer_norm kernels take fewer than 2^31 rows, got {rows}")
    return rows, d


def layer_norm_cuda(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Launch K6: returns y like layer_norm_reference.  Raises on any input
    the kernel does not take."""
    rows, d = _check(x, "layer_norm_cuda", g=g, b=b)
    y = torch.empty_like(x)
    if rows == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(x.device):
        code = lib.layer_norm_fwd(x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(), rows, d, eps, _DTYPE_CODES[x.dtype],
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(code, "layer_norm_fwd launch")
    LAUNCHES["layer_norm_fwd"] += 1
    return y


def layer_norm_bwd_cuda(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K7 (the row kernel and the reduction of its per-block partial
    sums): returns (dx, dg, db) like layer_norm_bwd_reference.  Raises on any
    input the kernels do not take."""
    rows, d = _check(x, "layer_norm_bwd_cuda", g=g)
    if dy.device != x.device or dy.dtype != x.dtype or dy.shape != x.shape or not dy.is_contiguous() or dy.data_ptr() % 16:
        raise ValueError(f"dy must be a contiguous {x.dtype} tensor of shape {tuple(x.shape)} on {x.device} aligned to 16 bytes, "
                         f"got {dy.dtype} {tuple(dy.shape)} on {dy.device} (contiguous: {dy.is_contiguous()})")
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, g.new_zeros(d), g.new_zeros(d)
    dg, db = g.new_empty(d), g.new_empty(d)
    lib = _build.library()
    blocks = -(-rows // lib.layer_norm_bwd_block_rows())
    parts = g.new_empty((2, blocks, d))  # per-block sums of dy * xhat and of dy, reduced by the second kernel
    with torch.cuda.device(x.device):
        code = lib.layer_norm_bwd(x.data_ptr(), g.data_ptr(), dy.data_ptr(), dx.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(),
                                  dg.data_ptr(), db.data_ptr(), rows, d, eps, _DTYPE_CODES[x.dtype],
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(code, "layer_norm_bwd launch")
    LAUNCHES["layer_norm_bwd"] += 1
    return dx, dg, db


class _LayerNorm(torch.autograd.Function):
    """The forward keeps (x, g) and no statistics, as the JAX ``_ln_fwd`` does."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
        fwd = layer_norm_reference if x.device.type == "cpu" else layer_norm_cuda
        x = x.contiguous()  # a no-op for the towers' activations; a sliced view (ln_post's class token) is packed once
        ctx.eps = eps
        ctx.save_for_backward(x, g)
        return fwd(x, g.float(), b.float(), eps)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, g = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        bwd = layer_norm_bwd_reference if x.device.type == "cpu" else layer_norm_bwd_cuda
        dx, dg, db = bwd(x, g.float(), dy, ctx.eps)
        return dx, dg.to(g.dtype), db.to(g.dtype), None


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """y = (x - mean) / sqrt(var + eps) * g + b over the last axis,
    differentiable: x [..., D] in float32 or bfloat16, g, b [D]; y in x's
    dtype.  CUDA tensors launch the kernels, CPU tensors take the plain
    versions."""
    return _LayerNorm.apply(x, g, b, eps)
