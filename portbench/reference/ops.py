"""Plain float32 operations of the reference, and the precision they compute in.

The reference computes every product in float32 with TF32 off (``Precision("fp32")``).
The correctness control computes the same function one precision step below what the
configurations state (bf16 compute, every activation held in bf16): ``Precision("fp8")``
rounds both operands of every product (linear layers, convolutions, the attention's two
products) and every activation the program holds in its compute dtype (the products'
outputs, the norms' outputs) to float8 e4m3 with a per-tensor scale, and the gradient that
flows back through each of them to float8 e5m2, as an fp8 training recipe would.
``Precision("bf16")`` rounds the same tensors, forward and backward, to bfloat16: not the
control but a witness, the reference at the precision the configurations state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _round8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``x`` rounded to an 8-bit float under a per-tensor scale that maps its largest value to ``top``."""
    scale = top / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).float() / scale


class _Fp8(torch.autograd.Function):
    """Forward: e4m3; backward: the incoming gradient in e5m2 (the usual fp8 recipe's split)."""

    @staticmethod
    def forward(ctx, x):
        return _round8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, E5M2_MAX)


class _Bf16(torch.autograd.Function):
    """Forward and backward: bfloat16."""

    @staticmethod
    def forward(ctx, x):
        return x.bfloat16().float()

    @staticmethod
    def backward(ctx, g):
        return g.bfloat16().float()


ROUNDING = {"fp32": None, "fp8": _Fp8, "bf16": _Bf16}


def no_tf32() -> None:
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    """Where the reference rounds: ``fp32`` nowhere, ``fp8`` / ``bf16`` both operands of every product."""

    def __init__(self, name: str = "fp32"):
        if name not in ROUNDING:
            raise ValueError(f"precision {name!r}: one of {sorted(ROUNDING)}")
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the products see it: float32, rounded to e4m3 under a per-tensor scale for fp8, to bfloat16 for bf16."""
        x = x.float()
        rounding = ROUNDING[self.name]
        return x if rounding is None else rounding.apply(x)

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
        return self.q(F.linear(self.q(x), self.q(w), None if b is None else b.float()))

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(torch.matmul(self.q(a), self.q(b)))

    def conv2d(self, x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
        return self.q(F.conv2d(self.q(x), self.q(w), None, stride, w.shape[-1] // 2))


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)


def attention(prec: Precision, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Softmax attention of q [B, Nq, D] over k, v [B, Nk, D] in ``heads`` heads -> [B, Nq, D]."""
    b, nq, d = q.shape
    nk = k.shape[1]
    split = lambda t, n: t.reshape(b, n, heads, d // heads).transpose(1, 2)  # noqa: E731
    qh, kh, vh = split(q, nq), split(k, nk), split(v, nk)
    probs = torch.softmax(prec.matmul(qh, kh.transpose(-1, -2)) * (d // heads) ** -0.5, dim=-1)
    return prec.matmul(probs, vh).transpose(1, 2).reshape(b, nq, d)


def batch_norm_groups(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int | None, running_mean: torch.Tensor,
                      running_var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm of NCHW ``x``: with ``groups`` each of that many equal runs of the batch (one
    episode each) on its own biased batch statistics, else on the running statistics."""
    n, c = x.shape[:2]
    if groups is None:
        mean, var = running_mean.float()[None], running_var.float()[None]
        xg = x.reshape(1, n, c, -1)
    else:
        xg = x.reshape(groups, n // groups, c, -1)
        mean = xg.mean(dim=(1, 3))
        var = xg.var(dim=(1, 3), unbiased=False)
    y = (xg - mean[:, None, :, None]) * torch.rsqrt(var[:, None, :, None] + eps)
    return (y * weight.float()[None, None, :, None] + bias.float()[None, None, :, None]).reshape(x.shape)
