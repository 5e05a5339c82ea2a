"""Which stage of the clip_mha forward kernel takes its time on a CUDA card
(counterpart of tools/_fa_decomp.py).

    python -m clip_fsar_torch.tools.fa_decomp [--out fa_decomp.txt]

Times deliberately ablated variants of the kernel on the same qkv and grid:

  matmul : o = round(s) . v                      (no exponential, max or sum)
  exp    : o = round(exp(s)) . v                 (no max, no sum)
  nomax  : p = exp(s), o = round(p) . v / rowsum(p)   (no row-max pass)
  full   : the shipped kernel, ``clip_mha_cuda``

with s = q.k^T * Dh^-1/2 in fp32 and round() the rounding to qkv's dtype.  The
three ablated modes are the shipped kernel with stages left out
(``csrc/clip_mha_decomp.cu``: in bf16 the tensor-core loop of
``csrc/attn_mma.cuh``); their numbers are wrong by design, so the
inputs are scaled by 0.02 to keep exp(s) finite, and only the times mean
anything: ``full - nomax`` is the row max and its subtraction (the shipped
kernel forms q.k^T once up to 256 keys; above, this difference is its first
pass), ``nomax - exp`` the row sum and the divide, ``exp - matmul`` the
exponential.  Each mode has a plain version,
``fa_decomp_reference``, that its kernel is held against.

Shapes: the TPU tool's [240, 197, 2304] bf16, and the test and train slices'
[320, 197, 2304] and [480, 197, 2304].  Times are CUDA events over 10
launches, the modes in turn, 3 rounds, the least of each mode's readings;
every line carries the card's name and power limit.  Exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import argparse
from typing import Dict, Sequence

import torch

from clip_fsar_torch.ops import _build
from clip_fsar_torch.ops.fused_attention import _DTYPE_CODES, _check_qkv, _heads_split, check_alignment, clip_mha_cuda, clip_mha_reference

ABLATED = ("matmul", "exp", "nomax")  # the kernel's mode codes 0, 1, 2
MODES = ABLATED + ("full",)
SHAPES = ((240, 197, 2304), (320, 197, 2304), (480, 197, 2304))
HEADS = 12
INPUT_SCALE = 0.02  # as the TPU tool scales its inputs: exp(s) stays finite without the max

# launches of the ablated kernel since the last reset, by mode
LAUNCHES = {mode: 0 for mode in ABLATED}


def fa_decomp_reference(qkv: torch.Tensor, heads: int, mode: str) -> torch.Tensor:
    """Plain-torch version of one mode: o [B, N, H*Dh] in qkv's dtype from qkv
    [B, N, 3*H*Dh] (tools/_fa_decomp.py:36-53).  ``full`` is ``clip_mha_reference``."""
    if mode == "full":
        return clip_mha_reference(qkv, heads)[0]
    if mode not in ABLATED:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    b, n, d3 = qkv.shape
    dh = d3 // 3 // heads
    q, k, v = _heads_split(qkv, heads)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * dh**-0.5
    p = s if mode == "matmul" else torch.exp(s)
    o = torch.matmul(p.to(qkv.dtype).float(), v.float())
    if mode == "nomax":
        o = o / p.sum(dim=-1, keepdim=True)
    return o.to(qkv.dtype).transpose(1, 2).reshape(b, n, heads * dh)


def fa_decomp_cuda(qkv: torch.Tensor, heads: int, mode: str) -> torch.Tensor:
    """Launch one mode's kernel: returns o like fa_decomp_reference.  ``full``
    launches the shipped forward kernel.  Raises on any input the kernels do
    not take."""
    if mode == "full":
        return clip_mha_cuda(qkv, heads)[0]
    if mode not in ABLATED:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    dh = _check_qkv(qkv, heads, "fa_decomp_cuda")
    check_alignment("fa_decomp_cuda", qkv=qkv)
    b, n, _ = qkv.shape
    out = torch.empty((b, n, heads * dh), dtype=qkv.dtype, device=qkv.device)
    if qkv.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        code = lib.clip_mha_decomp(qkv.data_ptr(), out.data_ptr(), b, n, heads, dh, _DTYPE_CODES[qkv.dtype], ABLATED.index(mode),
                                   torch.cuda.current_stream().cuda_stream)
    _build.check(code, f"clip_mha_decomp[{mode}] launch")
    LAUNCHES[mode] += 1
    return out


def assert_close_to_scale(got: torch.Tensor, want: torch.Tensor, tol: float, what: str = "") -> float:
    """Hold ``got`` to ``want`` within ``tol`` of ``want``'s largest magnitude (plus ``tol`` of each
    value); returns the largest difference as a share of that magnitude.  With the inputs scaled
    by INPUT_SCALE the modes' outputs are small (about 1e-4 for ``matmul``, 1e-3 for ``nomax``), so
    a fixed absolute tolerance would exceed what it compares."""
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    if not scale > 0.0:
        raise AssertionError(f"{what}: the reference is all zeros (or not finite), nothing to compare")
    torch.testing.assert_close(got / scale, want / scale, atol=tol, rtol=tol, msg=lambda m: f"{what} (in units of max|ref| = {scale:.3e}): {m}")
    return (got - want).abs().max().item() / scale


def make_qkv(shape: Sequence[int], dtype: torch.dtype = torch.bfloat16, seed: int = 0) -> torch.Tensor:
    """The tool's input on the card: standard normal from the seed, scaled by INPUT_SCALE."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g) * INPUT_SCALE).to("cuda", dtype)


def time_modes(qkv: torch.Tensor, heads: int = HEADS, iters: int = 10, rounds: int = 3) -> Dict[str, float]:
    """ms per launch of each mode on ``qkv``: CUDA events around ``iters``
    launches, the modes in turn, ``rounds`` times; the least reading of each."""
    best = {mode: float("inf") for mode in MODES}
    for mode in MODES:  # warm-up (and the build, at the first call)
        fa_decomp_cuda(qkv, heads, mode)
    for _ in range(rounds):
        for mode in MODES:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(iters):
                fa_decomp_cuda(qkv, heads, mode)
            end.record()
            torch.cuda.synchronize()
            best[mode] = min(best[mode], start.elapsed_time(end) / iters)
    return best


def report(shape: Sequence[int], say=print, card_line: str = "") -> Dict[str, float]:
    """Time the four modes at ``shape`` (bf16) and print the table; returns the ms per mode."""
    ms = time_modes(make_qkv(shape))
    tag = f"fa_decomp {list(shape)} bf16 [{card_line}]"
    say(f"{tag}: " + ", ".join(f"{mode} {ms[mode]:.4f} ms" for mode in MODES))
    say(f"{tag}: row max (full - nomax) {ms['full'] - ms['nomax']:.4f} ms, row sum and divide (nomax - exp) "
        f"{ms['nomax'] - ms['exp']:.4f} ms, exponential (exp - matmul) {ms['exp'] - ms['matmul']:.4f} ms, "
        f"the two products and the traffic (matmul) {ms['matmul']:.4f} ms")
    return ms


def main(argv=None) -> None:
    from clip_fsar_torch.tools import profile_eval

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also append every line to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fa_decomp: torch sees no CUDA device; this script measures the card only")
    profile_eval.set_out(args.out)
    card_line = profile_eval.card()
    profile_eval.say(f"torch {torch.__version__} cuda {torch.version.cuda}")
    for shape in SHAPES:
        report(shape, profile_eval.say, card_line)


if __name__ == "__main__":
    main()
