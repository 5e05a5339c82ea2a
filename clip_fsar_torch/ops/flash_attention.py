"""Online-softmax ("flash") attention on head-split tensors, forward and
backward (counterpart of clip_fsar_tpu/ops/flash_attention.py).

``flash_mha(q, k, v, mask=None, causal=False)`` takes q [B, H, Nq, Dh] and
k/v [B, H, Nk, Dh] (cross-attention allowed) and returns [B, H, Nq, Dh] in
q's dtype; ``causal`` masks key j for query i when j > i (top-left aligned).
It is a ``torch.autograd.Function`` that keeps (q, k, v, o, lse), as the JAX
``custom_vjp`` does.  On a CUDA tensor the forward launches K3
(``csrc/flash_mha_fwd.cu``, a port of the TPU ``_fwd_kernel``; in bf16 the
tensor-core kernel of ``csrc/attn_mma.cuh`` over the key blocks of
``_auto_block``: one block up to 256 keys, blocks of 128 above) and the
backward K4 then K5 (``csrc/flash_mha_bwd.cu``, ports of ``_bwd_dq_kernel``
and ``_bwd_dkv_kernel``; in bf16 the two passes of the tensor-core backward
``csrc/attn_mma_bwd.cuh``, the dQ pass forming delta itself, the causal mask
a template flag of its body; in fp32 a delta pass and two exact scalar
kernels); on a CPU tensor they run ``flash_mha_reference`` and
``flash_mha_bwd_reference``, the same functions in plain torch.  There is
no fallback from a kernel to its plain version.  An additive ``mask``
sends the call to the plain ``mha``, as the JAX function sends it to XLA.

The kernels read q, k and v by their batch, head and sequence strides (unit
stride on Dh), so the head split of the packed QKV projection costs no copy,
and they write o, dq, dk and dv in the [B, N, H, Dh] layout that
``merge_heads`` reads for free; the TPU's padding of Dh to 128 lanes and of
N to its block is not carried over.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from clip_fsar_torch.ops import _build
from clip_fsar_torch.ops import attention as _attention
from clip_fsar_torch.ops.fused_attention import check_alignment

_NEG_INF = -1e30  # the TPU kernels' mask value: exp(_NEG_INF - m) is 0 for any real row max m
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)

# kernel launches since the last reset (a run shows it went through the kernels)
LAUNCHES = {"flash_mha_fwd": 0, "flash_mha_bwd_dq": 0, "flash_mha_bwd_dkv": 0}


def _auto_block(n: int) -> int:
    """The JAX ``_auto_block``: one block of n rounded up to 32 when that is
    at most 256, else blocks of 128 (flash_attention.py:303-312)."""
    aligned = -(-n // 32) * 32
    return aligned if aligned <= 256 else 128


def _masked_scores(q: torch.Tensor, k: torch.Tensor, q0: int, k0: int, causal: bool) -> torch.Tensor:
    """fp32 logits of the query rows from q0 against the keys from k0, with
    the causal mask from the absolute indices (key j masked for query i when
    j > i) at the TPU kernels' -1e30."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if causal:
        q_ids = torch.arange(q0, q0 + q.shape[-2], device=q.device)[:, None]
        k_ids = torch.arange(k0, k0 + k.shape[-2], device=q.device)[None, :]
        s = s.masked_fill(k_ids > q_ids, _NEG_INF)
    return s


def flash_mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch K3: returns (o [B, H, Nq, Dh] in q's dtype, lse [B, H, Nq]
    fp32).  One pass over key blocks of the JAX ``_auto_block(Nk)`` size: the
    running max m and sum l and the accumulator are fp32; p = exp(s - m_new)
    is rounded to the storage dtype before P.V and the accumulator and l are
    rescaled by exp(m_prev - m_new); o = acc / max(l, 1e-30) and lse = m +
    log(max(l, 1e-30)) -- the TPU kernel's rounding points
    (clip_fsar_tpu/ops/flash_attention.py:63-90)."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    block = _auto_block(nk)
    acc = torch.zeros((b, h, nq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, nq, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, nq, 1), dtype=torch.float32, device=q.device)
    for k0 in range(0, nk, block):
        kb, vb = k[:, :, k0 : k0 + block], v[:, :, k0 : k0 + block]
        s = _masked_scores(q, kb, 0, k0, causal)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), vb.float())
        m = m_new
    l_safe = l.clamp_min(1e-30)
    return (acc / l_safe).to(q.dtype), (m + torch.log(l_safe)).squeeze(-1)


def _probabilities(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor, causal: bool) -> torch.Tensor:
    """P = exp(s - LSE) [B, H, Nq, Nk] in fp32, recomputed from the saved LSE."""
    return torch.exp(_masked_scores(q, k, 0, 0, causal) - lse[..., None])


def flash_mha_bwd_dq_reference(q, k, v, o, lse, do, causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch K4 with the delta pass before it: (dq in q's dtype, delta
    [B, H, Nq] fp32) from the forward's o and lse [B, H, Nq] and the output
    gradient do.  delta = rowsum(dO * O) in fp32 (:229); P is recomputed from
    the LSE; dS = P * (dO.V^T - delta) is rounded to k's dtype before dS.K,
    accumulated in fp32 (:114-117)."""
    dof = do.float()
    delta = (dof * o.float()).sum(dim=-1)
    ds = _probabilities(q, k, lse, causal) * (torch.matmul(dof, v.float().transpose(-1, -2)) - delta[..., None])
    return (torch.matmul(ds.to(k.dtype).float(), k.float()) * q.shape[-1] ** -0.5).to(q.dtype), delta


def flash_mha_bwd_dkv_reference(q, k, v, lse, delta, do, causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch K5: (dk, dv) in k's and v's dtypes.  P is recomputed from
    the LSE; P is rounded to dO's dtype before P^T.dO and dS to q's dtype
    before dS^T.Q, each accumulated in fp32 (:140-145)."""
    p = _probabilities(q, k, lse, causal)
    dof = do.float()
    ds = (p * (torch.matmul(dof, v.float().transpose(-1, -2)) - delta[..., None])).to(q.dtype).float()
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * q.shape[-1] ** -0.5
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_mha_bwd_reference(q, k, v, o, lse, do, causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-torch K4 + K5, delta included: (dq, dk, dv) in the inputs'
    dtypes, the TPU kernels' rounding points."""
    dq, delta = flash_mha_bwd_dq_reference(q, k, v, o, lse, do, causal)
    return (dq, *flash_mha_bwd_dkv_reference(q, k, v, lse, delta, do, causal))


def _strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """(batch, head, sequence) strides of a [B, H, N, Dh] tensor, in elements."""
    return t.stride(0), t.stride(1), t.stride(2)


def _heads_last(b: int, h: int, n: int, d: int, like: torch.Tensor) -> torch.Tensor:
    """An uninitialized [B, H, N, Dh] view of a [B, N, H, Dh] buffer: the
    layout merge_heads (and split_heads' backward) read without a copy."""
    return torch.empty((b, n, h, d), dtype=like.dtype, device=like.device).transpose(1, 2)


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, what: str) -> int:
    """Validate what the kernels take; returns Dh."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{what} needs CUDA tensors, got {name} on {t.device}")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"flash_mha kernels take float32 or bfloat16, got {name} {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, H, N, Dh], got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_mha kernels need a unit stride on Dh, got {name} strides {t.stride()}")
    if k.device != q.device or v.device != q.device or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share device and dtype, got {q.dtype}/{k.dtype}/{v.dtype} on {q.device}/{k.device}/{v.device}")
    b, h, _, dh = q.shape
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[3] != dh:
        raise ValueError(f"k and v must be [B, H, Nk, Dh] beside q [B, H, Nq, Dh], got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.stride() != v.stride():
        raise ValueError(f"flash_mha kernels read k and v with one set of strides, got {k.stride()} and {v.stride()}")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"flash_mha kernels are built for Dh in {_HEAD_DIMS}, got {dh}")
    if b > 65535 or h > 65535:
        raise ValueError(f"grid limit: B={b}, H={h} must each be <= 65535")
    return dh


def flash_mha_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3: returns (o, lse) like flash_mha_reference, o as a view of a
    [B, Nq, H, Dh] buffer.  Raises on any input the kernel does not take."""
    dh = _check_qkv(q, k, v, "flash_mha_cuda")
    check_alignment("flash_mha_cuda", q=q, k=k, v=v)
    b, h, nq, _ = q.shape
    nk = k.shape[2]
    o = _heads_last(b, h, nq, dh, q)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.flash_mha_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, nq, nk, dh,
                                 _DTYPE_CODES[q.dtype], int(causal), *_strides(q), *_strides(k), *_strides(o), stream)
    _build.check(code, "flash_mha_fwd launch")
    LAUNCHES["flash_mha_fwd"] += 1
    return o, lse


def _check_bwd(q, k, v, lse, do, o=None) -> int:
    """Validate what the backward kernels take besides q, k and v; returns Dh."""
    dh = _check_qkv(q, k, v, "the flash_mha backward kernels")
    b, h, nq, _ = q.shape
    for name, t, shape, dtype in (("do", do, q.shape, q.dtype), ("lse", lse, (b, h, nq), torch.float32), ("o", o, q.shape, q.dtype)):
        if t is not None and (t.device != q.device or t.dtype != dtype or t.shape != shape or t.stride(-1) != 1):
            raise ValueError(f"{name} must be a {dtype} tensor of shape {tuple(shape)} with a unit last stride on {q.device}, "
                             f"got {t.dtype} {tuple(t.shape)} strides {t.stride()} on {t.device}")
    if not lse.is_contiguous():
        raise ValueError("lse must be contiguous")
    if o is not None and o.stride() != do.stride():
        raise ValueError(f"flash_mha kernels read o and do with one set of strides, got {o.stride()} and {do.stride()}")
    return dh


def _bwd_args(q, k, v, do, dh: int, causal: bool) -> tuple:
    """(B, H, Nq, Nk, Dh, dtype, causal) and the strides of q, k (= v's) and do (= o's)."""
    b, h, nq, _ = q.shape
    return (b, h, nq, k.shape[2], dh, _DTYPE_CODES[q.dtype], int(causal), *_strides(q), *_strides(k), *_strides(do))


def flash_mha_bwd_dq_cuda(q, k, v, o, lse, do, causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4 (in bf16 it forms delta itself, in fp32 a delta pass runs
    before it): returns (dq, delta) like flash_mha_bwd_dq_reference, dq as a
    view of a [B, Nq, H, Dh] buffer.  Raises on any input the kernels do not
    take."""
    dh = _check_bwd(q, k, v, lse, do, o)
    b, h, nq, _ = q.shape
    dq = _heads_last(b, h, nq, dh, q)
    check_alignment("flash_mha_bwd_dq_cuda", q=q, k=k, v=v, o=o, do=do, dq=dq)
    delta = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    if dq.numel() == 0:
        return dq, delta
    lib = _build.library()
    with torch.cuda.device(q.device):
        code = lib.flash_mha_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                    delta.data_ptr(), dq.data_ptr(), *_bwd_args(q, k, v, do, dh, causal), *_strides(dq),
                                    torch.cuda.current_stream().cuda_stream)
    _build.check(code, "flash_mha_bwd_dq launch")
    LAUNCHES["flash_mha_bwd_dq"] += 1
    return dq, delta


def flash_mha_bwd_dkv_cuda(q, k, v, lse, delta, do, causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K5: returns (dk, dv) like flash_mha_bwd_dkv_reference, each a
    view of a [B, Nk, H, Dh] buffer.  Raises on any input the kernel does
    not take."""
    dh = _check_bwd(q, k, v, lse, do)
    if delta.device != q.device or delta.dtype != torch.float32 or delta.shape != lse.shape or not delta.is_contiguous():
        raise ValueError(f"delta must be a contiguous float32 tensor of shape {tuple(lse.shape)} on {q.device}")
    b, h, _, _ = q.shape
    dk, dv = _heads_last(b, h, k.shape[2], dh, k), _heads_last(b, h, k.shape[2], dh, v)
    check_alignment("flash_mha_bwd_dkv_cuda", q=q, k=k, v=v, do=do, dk=dk, dv=dv)
    if dk.numel() == 0 or q.shape[2] == 0:
        return dk.zero_(), dv.zero_()
    lib = _build.library()
    with torch.cuda.device(q.device):
        code = lib.flash_mha_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                     dk.data_ptr(), dv.data_ptr(), *_bwd_args(q, k, v, do, dh, causal), *_strides(dk),
                                     torch.cuda.current_stream().cuda_stream)
    _build.check(code, "flash_mha_bwd_dkv launch")
    LAUNCHES["flash_mha_bwd_dkv"] += 1
    return dk, dv


def flash_mha_bwd_cuda(q, k, v, o, lse, do, causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K4 (which leaves delta) and then K5: returns (dq, dk, dv)
    like flash_mha_bwd_reference."""
    dq, delta = flash_mha_bwd_dq_cuda(q, k, v, o, lse, do, causal)
    return (dq, *flash_mha_bwd_dkv_cuda(q, k, v, lse, delta, do, causal))


class _FlashMHA(torch.autograd.Function):
    """The forward keeps (q, k, v, o, lse), as the JAX ``_flash_fwd`` does;
    q, k and v are kept as the views they came in as."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
        o, lse = flash_mha_reference(q, k, v, causal) if q.device.type == "cpu" else flash_mha_cuda(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype)
        if do.stride() != o.stride():
            do = torch.empty_like(o).copy_(do)  # o's layout, which the kernels read both with
        bwd = flash_mha_bwd_reference if q.device.type == "cpu" else flash_mha_bwd_cuda
        return (*bwd(q, k, v, o, lse, do, ctx.causal), None)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None, causal: bool = False) -> torch.Tensor:
    """Multi-head attention on head-split tensors, differentiable: q
    [B, H, Nq, Dh], k/v [B, H, Nk, Dh] -> [B, H, Nq, Dh].  CUDA tensors launch
    the kernels, CPU tensors take the plain versions; an additive ``mask``
    goes to the plain ``mha`` (flash_attention.py:327-330)."""
    if mask is not None:
        return _attention.mha(q, k, v, mask=mask, backend="plain")
    return _FlashMHA.apply(q, k, v, causal)
