"""Whole-sequence attention on the packed QKV projection output, forward and
backward (counterpart of clip_fsar_tpu/ops/fused_attention.py).

``clip_mha(qkv, heads)`` takes qkv [B, N, 3*H*Dh] (q | k | v on the last
axis, self-attention) and returns [B, N, H*Dh]; it is a
``torch.autograd.Function`` whose backward returns the packed dqkv, as the
JAX ``custom_vjp`` does.  On a CUDA tensor both directions launch the
hand-written kernels (``csrc/clip_mha_fwd.cu``, a port of the TPU
``_fwd_kernel``, and ``csrc/clip_mha_bwd.cu``, a port of ``_bwd_kernel``); on a
CPU tensor they run ``clip_mha_reference`` and ``clip_mha_bwd_reference``,
the same functions in plain torch.  There is no fallback from a kernel to
its plain version.

The bf16 forward runs on the tensor cores (``csrc/attn_mma.cuh``): up to
``SINGLE_BLOCK_MAX`` keys a warp holds a query block's scores against the
whole sequence in registers and forms q.k^T once; longer sequences take two
passes over key tiles (``forward_branch``).  Both round p against the exact
row max, so the function is the same.  fp32 keeps an exact scalar kernel.

The bf16 backward runs on the tensor cores too (``csrc/attn_mma_bwd.cuh``):
a pass over query rows (delta and dq) and a pass over key rows (dk and dv),
each warp holding 16 rows' operands as fragments while the other side's
operands of the head sit in shared memory, P recomputed from the forward's
LSE with ``ex2.approx``, dS and P rounded to bf16 where the TPU kernel
rounds them.  Up to ``BWD_RESIDENT_MAX`` rows the head's operands stay in
shared memory; longer sequences stream through it in stages
(``backward_branch``).  No atomics: a second launch gives the same bits.
fp32 keeps exact scalar kernels (a delta, a dq and a dk/dv kernel).
"""

from __future__ import annotations

from typing import Tuple

import torch

from clip_fsar_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)
SINGLE_BLOCK_MAX = 256  # keys; csrc/attn_mma.cuh's kSingleBlockMax, the JAX flash kernels' largest single block
BWD_RESIDENT_MAX = 832  # rows; csrc/attn_mma_bwd.cuh's kBwdResidentMax: 2 operands x 832 rows x 64 x 2 bytes and their fp32 statistics fill a CTA's shared memory


def forward_branch(n: int) -> str:
    """Which branch of the bf16 forward kernels a sequence of ``n`` keys
    takes: ``"single"`` (one block of scores in registers, q.k^T once) up to
    SINGLE_BLOCK_MAX keys, ``"tiled"`` (key tiles of 128) above.  It
    follows from n alone, as the launcher reads it."""
    return "single" if n <= SINGLE_BLOCK_MAX else "tiled"


def backward_branch(n: int) -> str:
    """Which branch of the bf16 backward kernel a sequence of ``n`` rows
    takes: ``"resident"`` (one CTA per clip and head keeps the other side's
    operands of the whole head in shared memory) up to BWD_RESIDENT_MAX
    rows, ``"staged"`` (they stream through shared memory in stages of that
    many rows) above.  It follows from n alone, as the launcher reads it."""
    return "resident" if n <= BWD_RESIDENT_MAX else "staged"


def check_alignment(what: str, **tensors: torch.Tensor) -> None:
    """The bf16 tensor-core kernels copy rows of Dh values 16 bytes at a time:
    every tensor must start on a 16-byte boundary and keep every stride but
    the last a multiple of 8 elements.  Raises ValueError otherwise."""
    for name, t in tensors.items():
        if t.dtype == torch.bfloat16 and (t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:-1])):
            raise ValueError(f"{what} reads bf16 {name} in 16-byte pieces: it must start on a 16-byte boundary with strides that "
                             f"are multiples of 8 elements, got address % 16 = {t.data_ptr() % 16}, strides {t.stride()}")


def _heads_split(qkv: torch.Tensor, heads: int):
    """q, k, v of qkv [B, N, 3*H*Dh] as [B, H, N, Dh] views."""
    b, n, d3 = qkv.shape
    return qkv.reshape(b, n, 3, heads, d3 // 3 // heads).permute(2, 0, 3, 1, 4).unbind(0)


def clip_mha_reference(qkv: torch.Tensor, heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch K1: returns (o [B, N, H*Dh] in qkv's dtype, lse [B, H, N]
    fp32).  fp32 logits and softmax statistics; the unnormalized
    probabilities are rounded to the storage dtype before P.V and the sum
    is divided out at the end — the TPU kernel's rounding points
    (clip_fsar_tpu/ops/fused_attention.py:80-89)."""
    b, n, d3 = qkv.shape
    dh = d3 // 3 // heads
    q, k, v = _heads_split(qkv, heads)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * dh**-0.5
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(qkv.dtype).float(), v.float()) / l
    return o.to(qkv.dtype).transpose(1, 2).reshape(b, n, heads * dh), (m + torch.log(l)).squeeze(-1)


def clip_mha_bwd_reference(qkv: torch.Tensor, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain-torch K2: the packed dqkv [B, N, 3*H*Dh] in qkv's dtype from the
    forward's qkv, o, lse [B, H, N] and the output gradient do.  Products of
    storage-dtype values accumulate in fp32; dS is rounded to the storage
    dtype before both the dq and the dk products and P before dv — the TPU
    kernel's rounding points (clip_fsar_tpu/ops/fused_attention.py:110-129)."""
    b, n, d3 = qkv.shape
    dh = d3 // 3 // heads
    dt = qkv.dtype
    scale = dh**-0.5
    q, k, v = (t.float() for t in _heads_split(qkv, heads))
    oh, doh = (t.reshape(b, n, heads, dh).transpose(1, 2).float() for t in (o, do))
    p = torch.exp(torch.matmul(q, k.transpose(-1, -2)) * scale - lse[..., None])  # [B, H, N, N]
    delta = (doh * oh).sum(dim=-1, keepdim=True)
    dp = torch.matmul(doh, v.transpose(-1, -2))
    ds = (p * (dp - delta)).to(dt).float()
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), doh)
    return torch.stack([dq, dk, dv], dim=1).to(dt).permute(0, 3, 1, 2, 4).reshape(b, n, d3)


def _check_qkv(qkv: torch.Tensor, heads: int, what: str) -> int:
    """Validate what the kernels take; returns Dh."""
    if qkv.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {qkv.device}")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"clip_mha kernels take float32 or bfloat16, got {qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"qkv must be [B, N, 3*H*Dh] with H={heads}, got {tuple(qkv.shape)}")
    if not qkv.is_contiguous():
        raise ValueError("clip_mha kernels need a contiguous qkv")
    b, _, d3 = qkv.shape
    dh = d3 // 3 // heads
    if dh not in _HEAD_DIMS:
        raise ValueError(f"clip_mha kernels are built for Dh in {_HEAD_DIMS}, got {dh}")
    if b > 65535 or heads > 65535:
        raise ValueError(f"grid limit: B={b}, H={heads} must each be <= 65535")
    return dh


def clip_mha_cuda(qkv: torch.Tensor, heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel: returns (o, lse) like clip_mha_reference.
    Raises on any input the kernel does not take."""
    dh = _check_qkv(qkv, heads, "clip_mha_cuda")
    check_alignment("clip_mha_cuda", qkv=qkv)
    b, n, _ = qkv.shape
    out = torch.empty((b, n, heads * dh), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, heads, n), dtype=torch.float32, device=qkv.device)
    if qkv.numel() == 0:
        return out, lse
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.clip_mha_fwd(qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), b, n, heads, dh, _DTYPE_CODES[qkv.dtype], stream)
    _build.check(code, "clip_mha_fwd launch")
    clip_mha_cuda.launches += 1
    return out, lse


def clip_mha_bwd_cuda(qkv: torch.Tensor, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, heads: int) -> torch.Tensor:
    """Launch the backward kernels: returns dqkv like clip_mha_bwd_reference.
    Raises on any input the kernels do not take."""
    dh = _check_qkv(qkv, heads, "clip_mha_bwd_cuda")
    b, n, d3 = qkv.shape
    for name, t, shape, dtype in (("o", o, (b, n, d3 // 3), qkv.dtype), ("do", do, (b, n, d3 // 3), qkv.dtype),
                                  ("lse", lse, (b, heads, n), torch.float32)):
        if t.device != qkv.device or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {shape} on {qkv.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device} (contiguous: {t.is_contiguous()})")
    dqkv = torch.empty_like(qkv)
    check_alignment("clip_mha_bwd_cuda", qkv=qkv, o=o, do=do, dqkv=dqkv)
    if qkv.numel() == 0:
        return dqkv
    delta = torch.empty((b, heads, n), dtype=torch.float32, device=qkv.device)  # rowsum(dO * O) scratch
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.clip_mha_bwd(qkv.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(),
                                b, n, heads, dh, _DTYPE_CODES[qkv.dtype], stream)
    _build.check(code, "clip_mha_bwd launch")
    clip_mha_bwd_cuda.launches += 1
    return dqkv


# kernel launches since the last reset (a run shows it went through the kernels)
clip_mha_cuda.launches = 0
clip_mha_bwd_cuda.launches = 0


class _ClipMHA(torch.autograd.Function):
    """The forward keeps (qkv, o, lse), as the JAX ``_clip_mha_fwd`` does."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, heads: int) -> torch.Tensor:
        o, lse = clip_mha_reference(qkv, heads) if qkv.device.type == "cpu" else clip_mha_cuda(qkv, heads)
        ctx.heads = heads
        ctx.save_for_backward(qkv, o, lse)
        return o

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        qkv, o, lse = ctx.saved_tensors
        do = do.to(qkv.dtype).contiguous()
        bwd = clip_mha_bwd_reference if qkv.device.type == "cpu" else clip_mha_bwd_cuda
        return bwd(qkv, o, lse, do, ctx.heads), None


def clip_mha(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Fused multi-head self-attention on the packed projection output:
    qkv [B, N, 3*H*Dh] -> [B, N, H*Dh], differentiable.  CUDA tensors launch
    the kernels, CPU tensors take the plain versions."""
    return _ClipMHA.apply(qkv, heads)
