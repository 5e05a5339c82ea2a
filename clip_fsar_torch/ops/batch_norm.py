"""BatchNorm of the RN towers on [G, M, C] (``models/clip/model.py`` ``BatchNorm`` / ``_BatchNormFn``), as
hand-written kernels on a card and as the plain chain on the CPU.

``batch_norm_cuda`` / ``batch_norm_bwd_cuda`` launch ``csrc/batch_norm.cu``: on batch statistics a sum
pass, a combine of its per-tile sums and an affine pass each way (3 launches forward, 3 backward), on
running statistics the affine alone forward and a sum pass that also writes dx, then the combine,
backward (1 and 2).  ``batch_norm_reference`` / ``batch_norm_bwd_reference`` are the same functions as a
chain of plain torch ops, the port's BatchNorm as it ran before the kernels: the CPU runs them, bit for
bit what the JAX parity tests hold.  There is no fallback from a kernel to its plain version.

``tile_plan`` is the kernels' tile plan, read from the shape alone: which rows and channels each block
sums or scales, so that every call has at least ``MIN_BLOCKS`` blocks wherever its shape allows.  The
JAX package's BatchNorm is plain jnp, which XLA fuses: these kernels replace no TPU kernel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from clip_fsar_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256  # the most threads of a sum or affine block (csrc/batch_norm.cu kThreads)
MAX_RUN = 32  # rows a thread sums in registers before the block's tree (kMaxRun)
MIN_BLOCKS = 4 * 132  # four blocks for each of the card's 132 SMs

# kernel launches since the last reset (a run shows it went through the kernels)
LAUNCHES = {"batch_norm_stats": 0, "batch_norm_combine": 0, "batch_norm_apply": 0,
            "batch_norm_bwd_reduce": 0, "batch_norm_bwd_combine": 0, "batch_norm_bwd_dx": 0}


class Plan(NamedTuple):
    """A block takes ``lanes`` vector columns of ``vec`` channels (one band of the ``bands``) and ``rows``
    row lanes of one group's tile; thread (r, l) the rows ``tile * rows * run + k * rows + r``, k < run."""

    groups: int
    m: int
    c: int
    vec: int
    lanes: int
    bands: int
    rows: int
    run: int
    tiles: int

    @property
    def blocks(self) -> int:
        return self.groups * self.bands * self.tiles

    @property
    def partials(self) -> int:
        """fp32 values of the sum pass's partials: two sums per (group, tile, channel)."""
        return 2 * self.groups * self.tiles * self.c


@functools.lru_cache(maxsize=None)
def tile_plan(groups: int, m: int, c: int, itemsize: int) -> Plan:
    """The plan of x [groups, m, c] with elements of ``itemsize`` bytes: 16-byte vectors of channels where c
    allows them, bands of at most 32 vectors, then as many rows a thread (up to MAX_RUN) as leave the call
    at least MIN_BLOCKS blocks; one row a thread where even that leaves fewer."""
    vec = 16 // itemsize if c % (16 // itemsize) == 0 else 1
    cols = c // vec
    bands = -(-cols // 32)
    lanes = -(-cols // bands)
    rows = THREADS // lanes
    want_tiles = -(-MIN_BLOCKS // (groups * bands))
    run = max(1, min(MAX_RUN, m // (want_tiles * rows)))
    return Plan(groups, m, c, vec, lanes, bands, rows, run, -(-m // (rows * run)))


def batch_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor, running_var: torch.Tensor,
                         prev: Optional[torch.Tensor], batch: bool, eps: float, momentum: float) -> Tuple[torch.Tensor, Optional[torch.Tensor], tuple]:
    """The plain chain on x [G, M, C]: y = x * a + b in float32, a = w * rsqrt(var + eps), b = beta - mean * a,
    with each group's mean and fast variance E[x^2] - E[x]^2 clamped at 0 (``batch``) or the running ones.
    Returns y in x's dtype; on batch statistics the advanced running stats [G, 2, C], ``momentum * prev + (1 -
    momentum) * (mean, var)`` from ``prev`` (None: the running buffers), else None; and what
    ``batch_norm_bwd_reference`` takes: (mean, var + eps, rsqrt(var + eps), [raw > 0] or None)."""
    xf = x.float()
    g = x.shape[0]
    if batch:
        mean = xf.mean(dim=1)
        raw = xf.square().mean(dim=1) - mean.square()
        var = raw.clamp_min(0.0)
        live = (raw > 0).float()  # the clamp passes no gradient to the variance
    else:
        mean, var, live = running_mean.expand(g, -1), running_var.expand(g, -1), None
    rstd = torch.rsqrt(var + eps)
    a = weight * rstd
    b = bias - mean * a
    y = (xf * a[:, None] + b[:, None]).to(x.dtype)
    step = None
    if batch:
        prev = torch.stack([running_mean, running_var]) if prev is None else prev
        step = momentum * prev + (1.0 - momentum) * torch.stack([mean, var], dim=1)
    return y, step, (mean, var + eps, rstd, live)


def batch_norm_bwd_reference(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor, saved: tuple, batch: bool, eps: float):
    """The chain rule of ``batch_norm_reference``, step by step as autodiff takes it in the JAX package, from
    x in its own dtype and the [G, C] vectors ``saved``: (dx in x's dtype, dweight [C], dbias [C])."""
    mean, var_eps, rstd, live = saved
    xf, dyf = x.float(), dy.float()
    a = weight * rstd
    d_b = dyf.sum(dim=1)  # y = x * a + b
    d_a = (dyf * xf).sum(dim=1) - d_b * mean  # b = beta - mean * a
    dx = dyf * a[:, None]
    if batch:
        d_var = d_a * weight * (-0.5) * rstd / var_eps * live  # a = g * rsqrt(var + eps), var = max(E[x^2] - mean^2, 0)
        d_mean = -d_b * a - 2.0 * mean * d_var
        dx = dx + (d_mean[:, None] + 2.0 * d_var[:, None] * xf) / x.shape[1]
    return dx.to(x.dtype), (d_a * rstd).sum(dim=0), d_b.sum(dim=0)


def _check(x: torch.Tensor, what: str, **vectors: torch.Tensor) -> Plan:
    """Validate what the kernels take: x [G, M, C] contiguous in float32 or bfloat16 on a card, 16-byte
    aligned, and the float32 [C] ``vectors`` on its device; returns x's plan."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"batch_norm kernels take float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or 0 in x.shape:
        raise ValueError(f"{what} needs a non-empty x [G, M, C], got {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what} needs a contiguous x aligned to 16 bytes")
    c = x.shape[2]
    for name, t in vectors.items():
        if t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != (c,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor of shape ({c},) on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    plan = tile_plan(x.shape[0], x.shape[1], c, x.element_size())
    if plan.blocks >= 2**31:
        raise ValueError(f"{what}: {plan.blocks} blocks, more than a grid takes")
    return plan


def _prev(prev: Optional[torch.Tensor], running_mean: torch.Tensor, running_var: torch.Tensor, groups: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The previous running stats as (mean vector, var vector, group stride): the buffers (stride 0) when
    ``prev`` is None, a [2, C] pair for every group, or a [G, 2, C] stack."""
    c = running_mean.shape[0]
    if prev is None:
        return running_mean, running_var, 0
    if prev.dtype != torch.float32 or prev.device != running_mean.device or tuple(prev.shape) not in ((2, c), (groups, 2, c)):
        raise ValueError(f"prev must be float32 [2, {c}] or [{groups}, 2, {c}] on {running_mean.device}, got {prev.dtype} {tuple(prev.shape)}")
    prev = prev.contiguous()
    return prev[..., 0, :], prev[..., 1, :], (2 * c if prev.dim() == 3 else 0)


def batch_norm_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor, running_var: torch.Tensor,
                    prev: Optional[torch.Tensor], batch: bool, eps: float, momentum: float) -> Tuple[torch.Tensor, Optional[torch.Tensor], tuple]:
    """Launch the forward: (y, step, saved) like ``batch_norm_reference``, where saved is what
    ``batch_norm_bwd_cuda`` takes: (st,), st [6, G, C] = (mean, var, rstd, a, b, [raw > 0]), on batch
    statistics, else (running_mean, running_var).  Raises on any input the kernels do not take."""
    plan = _check(x, "batch_norm_cuda", weight=weight, bias=bias, running_mean=running_mean, running_var=running_var)
    y = torch.empty_like(x)
    g, c = plan.groups, plan.c
    if batch:
        prev_mean, prev_var, prev_stride = _prev(prev, running_mean, running_var, g)
        st, step, part = x.new_empty((6, g, c), dtype=torch.float32), x.new_empty((g, 2, c), dtype=torch.float32), x.new_empty(plan.partials, dtype=torch.float32)
        ptrs = (prev_mean.data_ptr(), prev_var.data_ptr(), prev_stride, st.data_ptr(), step.data_ptr(), part.data_ptr())
    else:
        st = step = None
        ptrs = (None, None, 0, None, None, None)
    lib = _build.library()
    with torch.cuda.device(x.device):
        code = lib.batch_norm_fwd(x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(),
                                  *ptrs, g, plan.m, c, plan.vec, plan.lanes, plan.bands, plan.rows, plan.run, plan.tiles, int(batch), eps,
                                  momentum, 1.0 - momentum, _DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(code, "batch_norm_fwd launch")
    if batch:
        for name in ("batch_norm_stats", "batch_norm_combine", "batch_norm_apply"):
            LAUNCHES[name] += 1
        return y, step, (st,)
    LAUNCHES["batch_norm_apply"] += 1
    return y, None, (running_mean, running_var)


def batch_norm_bwd_cuda(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor, saved: tuple, batch: bool, eps: float):
    """Launch the backward: (dx, dweight, dbias) like ``batch_norm_bwd_reference``, from the ``saved`` of
    ``batch_norm_cuda``.  Raises on any input the kernels do not take."""
    plan = _check(x, "batch_norm_bwd_cuda", weight=weight)
    if dy.dtype != x.dtype or dy.shape != x.shape or not dy.is_contiguous() or dy.data_ptr() % 16:
        raise ValueError(f"dy must be a contiguous {x.dtype} tensor of shape {tuple(x.shape)} aligned to 16 bytes, got {dy.dtype} {tuple(dy.shape)}")
    g, c = plan.groups, plan.c
    dx = torch.empty_like(x)
    dw, db, part = weight.new_empty(c), weight.new_empty(c), weight.new_empty(plan.partials)
    if batch:
        (st,) = saved
        co = weight.new_empty((3, g, c))
        vectors = (None, None, st.data_ptr(), co.data_ptr())
    else:
        running_mean, running_var = saved
        vectors = (running_mean.data_ptr(), running_var.data_ptr(), None, None)
    lib = _build.library()
    with torch.cuda.device(x.device):
        code = lib.batch_norm_bwd(x.data_ptr(), dy.data_ptr(), dx.data_ptr(), weight.data_ptr(), *vectors, part.data_ptr(), dw.data_ptr(), db.data_ptr(),
                                  g, plan.m, c, plan.vec, plan.lanes, plan.bands, plan.rows, plan.run, plan.tiles, int(batch), eps,
                                  _DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(code, "batch_norm_bwd launch")
    LAUNCHES["batch_norm_bwd_reduce"] += 1
    LAUNCHES["batch_norm_bwd_combine"] += 1
    if batch:
        LAUNCHES["batch_norm_bwd_dx"] += 1
    return dx, dw, db
