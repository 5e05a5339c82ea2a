"""The port's CUDA kernels (clip_mha K1/K2, flash_mha K3-K5, layer_norm K6/K7, the clip_mha
stage-ablation kernels K8) against their plain-torch versions, on the card.

Skips without a CUDA device (the kernels have no CPU mode).  On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Imports no JAX, so it also runs where only torch is installed.
"""

import os

import pytest
import torch

from clip_fsar_torch.ops.attention import split_heads
from clip_fsar_torch.ops.flash_attention import (
    LAUNCHES,
    flash_mha,
    flash_mha_bwd_cuda,
    flash_mha_bwd_dkv_cuda,
    flash_mha_bwd_dq_cuda,
    flash_mha_bwd_reference,
    flash_mha_cuda,
    flash_mha_reference,
)
from clip_fsar_torch.ops.fused_attention import (
    BWD_RESIDENT_MAX,
    SINGLE_BLOCK_MAX,
    backward_branch,
    clip_mha,
    clip_mha_bwd_cuda,
    clip_mha_bwd_reference,
    clip_mha_cuda,
    clip_mha_reference,
    forward_branch,
)
from clip_fsar_torch.ops import fused_layernorm
from clip_fsar_torch.ops.fused_layernorm import (
    layer_norm,
    layer_norm_bwd_cuda,
    layer_norm_bwd_reference,
    layer_norm_cuda,
    layer_norm_reference,
)
from clip_fsar_torch.tools import fa_decomp

# atol = rtol: summation order (fp32); rounding of p, dS and the outputs to bf16 (bf16)
TOLERANCE = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]
# (320, 197, 12, 64): the ViT-B/16 test slice's batch of 4 episodes x 10 clips x 8 frames;
# (480, 197, 12, 64): the train slice's micro-batch of 2 episodes x 30 clips x 8 frames
SHAPES = [(2, 50, 12, 64), (2, 197, 12, 64), (320, 197, 12, 64), (2, 257, 16, 64), (1, 577, 16, 64), (3, 17, 2, 32)]
# what the bf16 tensor-core forward adds: the train micro-batch; the text tower's N = 77 at H = 8; ragged
# lengths on the single-block branch (203 in 13 sub-tiles of 16 keys, 251 in 16), its last length 256, and on
# the tiled branch (333); 1100 keys, which stream through shared memory in two stages
FWD_SHAPES = SHAPES + [(480, 197, 12, 64), (2, 77, 8, 64), (2, 203, 4, 64), (2, 251, 4, 32), (2, 256, 2, 64), (2, 333, 3, 32), (1, 1100, 2, 64)]
BWD_SHAPES = [(2, 50, 12, 64), (2, 197, 12, 64), (480, 197, 12, 64), (2, 257, 16, 64), (1, 577, 16, 64), (3, 17, 2, 32)]
# what the bf16 tensor-core backward adds: the text tower's N = 77; ragged lengths in tiles of 16 rows (203, 251) and
# of 32 (333), the last length of the small launch shape (256); N = 577 with more clips; the last resident length,
# the first staged one, and 1700 rows in three stages at Dh = 32
BWD_SHAPES += [(2, 77, 8, 64), (2, 203, 4, 64), (2, 251, 4, 32), (2, 256, 2, 64), (2, 333, 3, 32), (4, 577, 16, 64),
               (1, BWD_RESIDENT_MAX, 2, 64), (1, BWD_RESIDENT_MAX + 1, 2, 64), (1, 1100, 2, 64), (1, 1700, 2, 32)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    from clip_fsar_torch import runtime

    return runtime.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", TOLERANCE)
@pytest.mark.parametrize("b, n, h, dh", FWD_SHAPES)
def test_clip_mha_kernel_matches_plain(cuda, b, n, h, dh, dtype, tol):
    """K1 against clip_mha_reference on both branches of the bf16 kernel and on the fp32 kernel: o at the
    dtype's tolerance, lse at 1e-4, both finite (the ragged last query block); one launch counted; a second
    launch gives the same bits (no atomics, a fixed order of sums)."""
    g = torch.Generator().manual_seed(n)
    qkv = torch.randn(b, n, 3 * h * dh, generator=g).to(cuda, dtype)
    before = clip_mha_cuda.launches
    o, lse = clip_mha_cuda(qkv, h)
    torch.cuda.synchronize()
    assert clip_mha_cuda.launches == before + 1
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    ref_o, ref_lse = clip_mha_reference(qkv, h)
    torch.testing.assert_close(o.float(), ref_o.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(clip_mha(qkv, h), o, atol=0, rtol=0)
    again_o, again_lse = clip_mha_cuda(qkv, h)
    assert torch.equal(again_o, o) and torch.equal(again_lse, lse)


@pytest.mark.cuda
def test_forward_branch_is_the_launchers(cuda):
    """The length up to which the built kernels keep one block of scores is the one forward_branch
    reads, so the branch named for a length is the branch the launcher takes."""
    from clip_fsar_torch.ops import _build

    assert _build.library().attn_fwd_single_block_max() == SINGLE_BLOCK_MAX
    assert forward_branch(SINGLE_BLOCK_MAX) == "single" and forward_branch(SINGLE_BLOCK_MAX + 1) == "tiled"


@pytest.mark.cuda
def test_bf16_forward_kernels_refuse_unaligned_tensors(cuda):
    """The bf16 forwards copy 16 bytes at a time: a tensor that starts 2 bytes into its storage, or whose
    sequence stride is no multiple of 8 elements, is refused; fp32 goes to the scalar kernels, which take it."""
    b, n, h, dh = 2, 17, 2, 64
    flat = torch.randn(1 + b * n * 3 * h * dh, device=cuda).to(torch.bfloat16)
    shifted = flat[1:].view(b, n, 3 * h * dh)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte"):
        clip_mha_cuda(shifted, h)
    with pytest.raises(ValueError, match="16-byte"):
        flash_mha_cuda(*(split_heads(t, h) for t in shifted.chunk(3, dim=-1)))
    with pytest.raises(ValueError, match="16-byte"):
        fa_decomp.fa_decomp_cuda(shifted, h, "exp")
    wide = torch.randn(b, h, n, dh + 4, device=cuda).to(torch.bfloat16)[..., :dh]  # rows 68 elements apart
    with pytest.raises(ValueError, match="16-byte"):
        flash_mha_cuda(wide, wide, wide)
    o, _ = flash_mha_cuda(wide.float(), wide.float(), wide.float())
    torch.testing.assert_close(o, flash_mha_reference(wide.float(), wide.float(), wide.float())[0], atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", TOLERANCE)
@pytest.mark.parametrize("b, n, h, dh", BWD_SHAPES)
def test_clip_mha_bwd_kernel_matches_plain(cuda, b, n, h, dh, dtype, tol):
    """K2 against clip_mha_bwd_reference on the forward kernel's o and lse, on
    both branches of the bf16 kernel (resident and staged) and on the fp32
    kernels; dqkv finite everywhere (the ragged last tile, where LSE and
    delta are not defined); one launch counted per call; a second launch
    gives the same bits (no atomics); and the autograd backward of clip_mha
    is the kernel's result."""
    g = torch.Generator().manual_seed(n + 1)
    qkv = torch.randn(b, n, 3 * h * dh, generator=g).to(cuda, dtype)
    do = torch.randn(b, n, h * dh, generator=g).to(cuda, dtype)
    o, lse = clip_mha_cuda(qkv, h)
    before = clip_mha_bwd_cuda.launches
    dqkv = clip_mha_bwd_cuda(qkv, o, lse, do, h)
    torch.cuda.synchronize()
    assert clip_mha_bwd_cuda.launches == before + 1
    ref = clip_mha_bwd_reference(qkv, o, lse, do, h)
    assert dqkv.dtype == dtype and dqkv.shape == qkv.shape
    assert torch.isfinite(dqkv.float()).all()
    torch.testing.assert_close(dqkv.float(), ref.float(), atol=tol, rtol=tol)
    assert torch.equal(clip_mha_bwd_cuda(qkv, o, lse, do, h), dqkv)
    x = qkv.clone().requires_grad_(True)
    clip_mha(x, h).backward(do)
    assert clip_mha_bwd_cuda.launches == before + 3
    torch.testing.assert_close(x.grad, dqkv, atol=0, rtol=0)


@pytest.mark.cuda
def test_backward_branch_is_the_launchers(cuda):
    """The length up to which the built backward keeps a head's operands in shared memory is the one
    backward_branch reads."""
    from clip_fsar_torch.ops import _build

    assert _build.library().attn_bwd_resident_max() == BWD_RESIDENT_MAX
    assert backward_branch(BWD_RESIDENT_MAX) == "resident" and backward_branch(BWD_RESIDENT_MAX + 1) == "staged"


@pytest.mark.cuda
@pytest.mark.parametrize("n", [197, 333])
def test_clip_mha_bwd_kernel_masks_the_dead_columns_of_the_last_tile(cuda, n):
    """Rows past N are zero-filled in shared memory, so their score is 0; with every live score at -200
    (q = 5, k = -5 on all of Dh = 64) LSE is about -195 and exp(0 - LSE) overflows: unless P is set to 0
    there explicitly, inf * 0 puts NaN into dq (dead keys) and into dk and dv (dead queries).  Both launch
    shapes (tiles of 16 rows at 197, of 32 at 333)."""
    b, h, dh = 2, 3, 64
    g = torch.Generator().manual_seed(n)
    qkv = torch.randn(b, n, 3, h * dh, generator=g)
    qkv[:, :, 0], qkv[:, :, 1] = 5.0, -5.0
    qkv = qkv.reshape(b, n, 3 * h * dh).to(cuda, torch.bfloat16)
    do = torch.randn(b, n, h * dh, generator=g).to(cuda, torch.bfloat16)
    o, lse = clip_mha_cuda(qkv, h)
    assert lse.max().item() < -190
    dqkv = clip_mha_bwd_cuda(qkv, o, lse, do, h)
    assert torch.isfinite(dqkv.float()).all()
    torch.testing.assert_close(dqkv.float(), clip_mha_bwd_reference(qkv, o, lse, do, h).float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_bf16_backward_kernel_refuses_unaligned_tensors(cuda):
    """The bf16 backward copies rows of dO 16 bytes at a time: a dO or an o that starts 2 bytes into its
    storage is refused; in fp32 the scalar kernels take the same tensors."""
    b, n, h, dh = 2, 17, 2, 64
    qkv = torch.randn(b, n, 3 * h * dh, device=cuda).to(torch.bfloat16)
    o, lse = clip_mha_cuda(qkv, h)
    flat = torch.randn(1 + b * n * h * dh, device=cuda).to(torch.bfloat16)
    shifted = flat[1:].view(b, n, h * dh)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="bf16 do in 16-byte"):
        clip_mha_bwd_cuda(qkv, o, lse, shifted, h)
    with pytest.raises(ValueError, match="bf16 o in 16-byte"):
        clip_mha_bwd_cuda(qkv, shifted, lse, o, h)
    o32, lse32 = clip_mha_cuda(qkv.float(), h)
    got = clip_mha_bwd_cuda(qkv.float(), o32, lse32, shifted.float(), h)
    torch.testing.assert_close(got, clip_mha_bwd_reference(qkv.float(), o32, lse32, shifted.float(), h), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b, n, h, dh", [(2, 197, 12, 64), (3, 50, 2, 32)])
def test_clip_mha_grad_matches_autograd_of_plain_attention(cuda, b, n, h, dh):
    """fp32 kernels (forward and backward) against torch autograd of plain
    softmax attention in float64: checks the math independently of the
    rounding replica.  1e-4: fp32 summation order."""
    g = torch.Generator().manual_seed(7)
    qkv = torch.randn(b, n, 3 * h * dh, generator=g).to(cuda)
    do = torch.randn(b, n, h * dh, generator=g).to(cuda)
    x = qkv.clone().requires_grad_(True)
    clip_mha(x, h).backward(do)
    y = qkv.double().requires_grad_(True)
    q, k, v = y.reshape(b, n, 3, h, dh).permute(2, 0, 3, 1, 4).unbind(0)
    out = torch.softmax(q @ k.transpose(-1, -2) * dh**-0.5, dim=-1) @ v
    out.transpose(1, 2).reshape(b, n, h * dh).backward(do.double())
    torch.testing.assert_close(x.grad.double(), y.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_clip_mha_kernel_refuses_what_it_does_not_take(cuda):
    with pytest.raises(ValueError):
        clip_mha_cuda(torch.zeros(1, 8, 3 * 2 * 48, device=cuda), 2)  # Dh = 48
    with pytest.raises(TypeError):
        clip_mha_cuda(torch.zeros(1, 8, 3 * 2 * 64, device=cuda, dtype=torch.float16), 2)
    with pytest.raises(ValueError):
        clip_mha_cuda(torch.zeros(1, 3 * 2 * 64, 8, device=cuda).transpose(1, 2), 2)  # not contiguous


@pytest.mark.cuda
def test_clip_mha_bwd_kernel_refuses_what_it_does_not_take(cuda):
    def args(dh=64, dtype=torch.float32, device=cuda):
        qkv = torch.zeros(1, 8, 3 * 2 * dh, device=device, dtype=dtype)
        o = torch.zeros(1, 8, 2 * dh, device=device, dtype=dtype)
        return qkv, o, torch.zeros(1, 2, 8, device=device), o.clone(), 2

    with pytest.raises(ValueError):
        clip_mha_bwd_cuda(*args(dh=48))
    with pytest.raises(TypeError):
        clip_mha_bwd_cuda(*args(dtype=torch.float16))
    with pytest.raises(ValueError):
        clip_mha_bwd_cuda(*args(device="cpu"))
    qkv, o, lse, do, h = args()
    with pytest.raises(ValueError):
        clip_mha_bwd_cuda(qkv, o, lse, torch.zeros(1, 2 * 64, 8, device=cuda).transpose(1, 2), h)  # dO not contiguous
    with pytest.raises(ValueError):
        clip_mha_bwd_cuda(qkv, o, lse.double(), do, h)  # fp64 lse


# (B, H, Nq, Nk, Dh): the ViT sequence lengths (q, k and v as head-split views of the packed
# projection, as the towers pass them), the tiny tower's Dh = 32, and one cross-attention shape
# with Nq != Nk (separate contiguous tensors)
FLASH_SHAPES = [(2, 12, 50, 50, 64), (2, 12, 197, 197, 64), (320, 12, 197, 197, 64), (2, 16, 257, 257, 64),
                (1, 16, 577, 577, 64), (3, 2, 17, 17, 32), (2, 3, 128, 256, 64)]
# the backward at the train chunk's 480 frames; cross-attention from 300 queries onto 100 keys and back (Nq > Nk
# and Nq < Nk, Dh = 32 and 64); ragged lengths; and, for the bf16 tensor-core passes, the last length the streamed
# side keeps in shared memory and the first it stages (the dQ pass streams the keys, the dK/dV pass the queries),
# for both passes at once and for each alone
FLASH_BWD_SHAPES = [s if s[0] != 320 else (480,) + s[1:] for s in FLASH_SHAPES] + [
    (2, 3, 300, 100, 32), (2, 3, 100, 300, 64), (2, 8, 77, 77, 64), (2, 4, 203, 203, 64), (2, 3, 333, 333, 32),
    (1, 2, BWD_RESIDENT_MAX, BWD_RESIDENT_MAX, 64), (1, 2, BWD_RESIDENT_MAX + 1, BWD_RESIDENT_MAX + 1, 64),
    (1, 2, 100, BWD_RESIDENT_MAX + 1, 64), (1, 2, BWD_RESIDENT_MAX + 1, 100, 32)]
# the forward's extra lengths (see FWD_SHAPES), and cross-attention onto 300 keys (tiled, and causal rows that
# see fewer keys than the first tile holds) and from 300 queries onto 100 keys
FLASH_FWD_SHAPES = FLASH_SHAPES + [(b, h, n, n, dh) for b, n, h, dh in FWD_SHAPES[len(SHAPES):]] + [(2, 3, 100, 300, 64), (2, 3, 300, 100, 32)]


def _flash_inputs(b, h, nq, nk, dh, dtype, device, g):
    """q, k, v: views of one packed [B, N, 3*H*Dh] projection when Nq == Nk, else contiguous tensors."""
    if nq == nk:
        qkv = torch.randn(b, nq, 3 * h * dh, generator=g).to(device, dtype)
        return tuple(split_heads(t, h) for t in qkv.chunk(3, dim=-1))
    return tuple(torch.randn(b, h, n, dh, generator=g).to(device, dtype) for n in (nq, nk, nk))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype, tol", TOLERANCE)
@pytest.mark.parametrize("b, h, nq, nk, dh", FLASH_FWD_SHAPES)
def test_flash_mha_kernel_matches_plain(cuda, b, h, nq, nk, dh, dtype, tol, causal):
    """K3 against flash_mha_reference: o at the dtype's tolerance (bf16: the kernel takes the plain version's
    _auto_block key blocks, so p is rounded at the same points; fp32: the scalar kernel's 64-key tiles
    rescale at other points, the same function in fp32), lse at 1e-4, both finite (causal rows that see one
    key, the ragged last query block); one launch counted; flash_mha returns the kernel's result; a second
    launch gives the same bits."""
    g = torch.Generator().manual_seed(nq + nk)
    q, k, v = _flash_inputs(b, h, nq, nk, dh, dtype, cuda, g)
    before = LAUNCHES["flash_mha_fwd"]
    o, lse = flash_mha_cuda(q, k, v, causal)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_mha_fwd"] == before + 1
    assert o.shape == q.shape and o.dtype == dtype and lse.shape == (b, h, nq)
    ref_o, ref_lse = flash_mha_reference(q, k, v, causal)
    torch.testing.assert_close(o.float(), ref_o.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(flash_mha(q, k, v, causal=causal), o, atol=0, rtol=0)
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    again_o, again_lse = flash_mha_cuda(q, k, v, causal)
    assert torch.equal(again_o, o) and torch.equal(again_lse, lse)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype, tol", TOLERANCE)
@pytest.mark.parametrize("b, h, nq, nk, dh", FLASH_BWD_SHAPES)
def test_flash_mha_bwd_kernels_match_plain(cuda, b, h, nq, nk, dh, dtype, tol, causal):
    """K4 and K5 against flash_mha_bwd_reference on K3's o and lse (bf16: the tensor-core passes, whose
    ex2.approx and fragment packing stay within the dtype's tolerance; fp32: the scalar kernels), delta
    at 1e-4, everything finite; one launch of each counted per call, the same bits on a second launch,
    and the autograd backward of flash_mha is the kernels' result."""
    g = torch.Generator().manual_seed(nq + nk + 1)
    q, k, v = _flash_inputs(b, h, nq, nk, dh, dtype, cuda, g)
    o, lse = flash_mha_cuda(q, k, v, causal)
    do = torch.empty_like(o).copy_(torch.randn(o.shape, generator=g))
    before = dict(LAUNCHES)
    grads = flash_mha_bwd_cuda(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_mha_bwd_dq"] == before["flash_mha_bwd_dq"] + 1
    assert LAUNCHES["flash_mha_bwd_dkv"] == before["flash_mha_bwd_dkv"] + 1
    ref = flash_mha_bwd_reference(q, k, v, o, lse, do, causal)
    for name, got, want, x in zip(("dq", "dk", "dv"), grads, ref, (q, k, v)):
        assert got.dtype == dtype and got.shape == x.shape, name
        assert torch.isfinite(got.float()).all(), name
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol, msg=lambda m, name=name: f"{name}: {m}")
    dq, delta = flash_mha_bwd_dq_cuda(q, k, v, o, lse, do, causal)
    torch.testing.assert_close(delta, (do.float() * o.float()).sum(dim=-1), atol=1e-4, rtol=1e-4)
    for got, again in zip(grads, (dq, *flash_mha_bwd_dkv_cuda(q, k, v, lse, delta, do, causal))):
        assert torch.equal(got, again)
    before = dict(LAUNCHES)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    flash_mha(*leaves, causal=causal).backward(do)
    assert LAUNCHES["flash_mha_bwd_dkv"] == before["flash_mha_bwd_dkv"] + 1
    for leaf, got in zip(leaves, grads):
        torch.testing.assert_close(leaf.grad, got, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [197, 333])
def test_flash_mha_bwd_kernels_mask_the_dead_and_the_causal_columns(cuda, n, causal):
    """Every live score at -200 (q = 5, k = -5 on all of Dh = 64), so LSE is about -195 and exp(0 - LSE)
    overflows wherever a score of 0 is not masked: in the zero-filled rows past N of the last tile and,
    were S masked to 0 in place of P, past the diagonal.  dq, dk and dv stay finite and right, causal and
    not, in both launch shapes (tiles of 16 rows at 197, of 32 at 333), the same bits twice."""
    b, h, dh = 2, 3, 64
    g = torch.Generator().manual_seed(n)
    qkv = torch.randn(b, n, 3, h * dh, generator=g)
    qkv[:, :, 0], qkv[:, :, 1] = 5.0, -5.0
    q, k, v = (split_heads(t, h) for t in qkv.reshape(b, n, 3 * h * dh).to(cuda, torch.bfloat16).chunk(3, dim=-1))
    o, lse = flash_mha_cuda(q, k, v, causal)
    assert lse.max().item() < -190
    do = torch.empty_like(o).copy_(torch.randn(o.shape, generator=g))
    grads = flash_mha_bwd_cuda(q, k, v, o, lse, do, causal)
    for name, got, want in zip(("dq", "dk", "dv"), grads, flash_mha_bwd_reference(q, k, v, o, lse, do, causal)):
        assert torch.isfinite(got.float()).all(), name
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2, msg=lambda m, name=name: f"{name}: {m}")
    for got, again in zip(grads, flash_mha_bwd_cuda(q, k, v, o, lse, do, causal)):
        assert torch.equal(got, again)


@pytest.mark.cuda
def test_bf16_flash_backward_kernels_refuse_unaligned_tensors(cuda):
    """The bf16 passes read q, k, v, o and dO 16 bytes at a time: an o and dO that start 2 bytes into their
    storage are refused by both wrappers; in fp32 the scalar kernels take the same tensors."""
    b, h, n, dh = 2, 2, 17, 64
    q, k, v = (torch.randn(b, h, n, dh, device=cuda).to(torch.bfloat16) for _ in range(3))
    o, lse = flash_mha_cuda(q, k, v)
    do = torch.empty_like(o).copy_(torch.randn(o.shape, device=cuda))
    delta = torch.zeros_like(lse)

    def shifted(t):
        flat = torch.zeros(1 + t.numel(), device=cuda, dtype=t.dtype)
        out = flat[1:].view(b, n, h, dh).transpose(1, 2)  # o's layout, 2 bytes off
        return out.copy_(t)

    with pytest.raises(ValueError, match="bf16 o in 16-byte"):
        flash_mha_bwd_dq_cuda(q, k, v, shifted(o), lse, shifted(do))
    with pytest.raises(ValueError, match="bf16 do in 16-byte"):
        flash_mha_bwd_dkv_cuda(q, k, v, lse, delta, shifted(do))
    q32, k32, v32 = q.float(), k.float(), v.float()
    o32, lse32 = flash_mha_cuda(q32, k32, v32)
    got = flash_mha_bwd_cuda(q32, k32, v32, shifted(o32), lse32, shifted(do.float()))
    for x, y in zip(got, flash_mha_bwd_reference(q32, k32, v32, o32, lse32, do.float())):
        torch.testing.assert_close(x, y, atol=1e-4, rtol=1e-4)


# the tiny towers' train options on the card
TINY_TRAIN_OPTS = ["TRAIN.ENABLE", "True", "DATA.DECODER", "synthetic", "DATA.NUM_INPUT_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "64",
                   "DATA.TEST_CROP_SIZE", "64", "DATA.TEST_SCALE", "72", "DATA.TRAIN_JITTER_SCALES", "[72, 80]", "TPU.EPISODES_PER_STEP", "2"]
REMAT_OPTS = ["TPU.REMAT", "True", "TPU.FRAME_CHUNKS", "2", "AUGMENTATION.RANDOM_ERASING.ENABLE", "True"]


def _two_steps_never_wait(cuda, backbone, extra) -> None:
    """Two train steps of the tiny tower after a first one, under torch's sync debug mode: fails naming every
    python line inside them that synchronised with the device."""
    import warnings

    from clip_fsar_torch.config.config import load_config
    from clip_fsar_torch.data.loader import build_few_shot_loader
    from clip_fsar_torch.models.builder import build_few_shot_model
    from clip_fsar_torch.tools.profile_eval import CONFIG
    from clip_fsar_torch.train.loop import step_generator
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.state import TrainState
    from clip_fsar_torch.train.step import make_train_step

    cfg = load_config(CONFIG, ["VIDEO.HEAD.BACKBONE_NAME", backbone, *TINY_TRAIN_OPTS, "TRAIN.BATCH_SIZE_PER_TASK", "2", *extra])
    model = build_few_shot_model(cfg, flow="train", device=cuda)
    if extra:
        assert model.head.backbone.transformer.remat and model.head.frame_chunks == 2
    state = TrainState.create(cfg, model.head, Optimizer(cfg, model.head))
    step = make_train_step(model.head, cfg, model.text_train, model.text_test)
    with build_few_shot_loader(cfg, "train", num_steps=1, episodes_per_step=2) as loader:
        batch = next(iter(loader)).to(cuda)
    step(state, batch, 1e-3, step_generator(cfg, 0, cuda))  # builds and loads the kernels, fills the allocator and the constants
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            seen = [step(state, batch, 1e-3, step_generator(cfg, i, cuda)) for i in (1, 2)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert sorted({f"{w.filename}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)}) == []
    assert [bool(m["updated"]) for m in seen] == [True, False] and int(state.optimizer.mini_step) == 1  # the window closed on step 2 of 3
    assert all(torch.isfinite(m["loss"]).item() for m in seen)


@pytest.mark.cuda
@pytest.mark.parametrize("backbone, extra", [pytest.param("ViT-Tiny-Test", [], id="ViT-Tiny-Test"), pytest.param("RN-Tiny-Test", [], id="RN-Tiny-Test"),
                                             pytest.param("ViT-Tiny-Test", REMAT_OPTS, id="ViT-Tiny-Test-remat")])
def test_train_steps_never_wait_for_the_card(cuda, backbone, extra):
    """Two train steps of the tiny tower on the card (jitter and dropout on, an accumulation window of 2;
    the RN tower with live BatchNorm and its running-stat update; the ViT tower also rematerialized in 2
    frame chunks, with random erasing) with torch's sync debug mode on: no operation inside them
    synchronises with the device (each one that did would be named here by the python line that called
    it)."""
    _two_steps_never_wait(cuda, backbone, extra)


@pytest.mark.cuda
@pytest.mark.parametrize("backbone", ["ViT-Tiny-Test", "RN-Tiny-Test"])
def test_train_steps_under_a_process_group_never_wait_for_the_card(cuda, tmp_path, backbone):
    """The same two steps as one rank of a one-rank NCCL process group: the gradient, metric and
    running-stat all-reduces of each step are queued on the device like the rest of it, and nothing
    waits for the card."""
    import datetime

    import torch.distributed as dist

    from clip_fsar_torch.parallel import mesh

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120), device_id=cuda if cuda.index is not None else torch.device("cuda", 0))
    try:
        assert mesh.distributed() and mesh.build_mesh(None, "cuda").backend == "nccl"
        _two_steps_never_wait(cuda, backbone, [])
    finally:
        mesh.destroy()


@pytest.mark.cuda
@pytest.mark.parametrize("path", [["TPU.ATTENTION_LAYOUT", "fused"], ["TPU.PALLAS_ATTENTION", "True"]], ids=["fused", "flash"])
def test_remat_train_step_on_the_card_matches_none(cuda, path):
    """One train step's gradients of the tiny ViT in float32 on the kernels (K1 + K2, or K3 + K4 + K5),
    with TPU.REMAT off, on with policy nothing and on with policy dots: the same bits (the recompute
    launches the same kernels on the same inputs), and the forward kernel launched once more per layer
    under remat."""
    from clip_fsar_torch.config.config import load_config
    from clip_fsar_torch.data.loader import build_few_shot_loader
    from clip_fsar_torch.models.builder import build_few_shot_model
    from clip_fsar_torch.ops import flash_attention
    from clip_fsar_torch.tools.profile_eval import CONFIG
    from clip_fsar_torch.train.step import make_grad_fn

    def forward_launches() -> int:
        return clip_mha_cuda.launches + flash_attention.LAUNCHES["flash_mha_fwd"]

    grads, launches = [], []
    for remat in ([], ["TPU.REMAT", "True"], ["TPU.REMAT", "True", "TPU.REMAT_POLICY", "dots"]):
        cfg = load_config(CONFIG, ["VIDEO.HEAD.BACKBONE_NAME", "ViT-Tiny-Test", *TINY_TRAIN_OPTS, "TPU.COMPUTE_DTYPE", "float32", *path, *remat])
        if not grads:
            with build_few_shot_loader(cfg, "train", num_steps=1, episodes_per_step=2) as loader:
                batch = next(iter(loader)).to(cuda)
        model = build_few_shot_model(cfg, flow="train", device=cuda)
        before = forward_launches()
        make_grad_fn(model.head, cfg, model.text_train, model.text_test)(batch, None)
        launches.append(forward_launches() - before)
        grads.append({n: p.grad for n, p in model.head.named_parameters()})
    layers = model.head.arch.vision_layers
    assert launches == [layers, 2 * layers, 2 * layers]
    for other in grads[1:]:
        for name, g in grads[0].items():
            assert torch.equal(other[name], g), name


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [None, 2])
def test_rn_tower_on_the_card_matches_the_cpu(cuda, groups):
    """The tiny RN tower in float32 on the card (cuDNN convolutions on channels_last, TF32 off) against
    the same tower on the CPU, on running stats and on two groups' batch statistics: output at 1e-4,
    every parameter's gradient at rtol 1e-4 above a floor of 1e-5 of the tower's largest gradient (the
    attention pool's key bias has a gradient of 0 in exact arithmetic, so its own scale is rounding
    noise), and each group's advanced running stats at 1e-5."""
    from clip_fsar_torch.models.builder import init_weights
    from clip_fsar_torch.models.clip.arch import ARCHS
    from clip_fsar_torch.models.clip.model import BatchNorm, build_vision_tower

    g = torch.Generator().manual_seed(0)
    towers = {}
    for dev in ("cpu", cuda):
        towers[dev] = build_vision_tower(ARCHS["RN-Tiny-Test"])
        init_weights(towers[dev], torch.Generator().manual_seed(1))
        towers[dev].to(dev)
    x = torch.randn(4, 64, 64, 3, generator=g)
    w = torch.randn(4, 32, generator=g)
    out = {}
    for dev, tower in towers.items():
        y = tower(x.to(dev), groups)
        (y * w.to(dev)).sum().backward()
        out[dev] = y.detach().cpu()
    torch.testing.assert_close(out[cuda], out["cpu"], atol=1e-4, rtol=1e-4)
    ref = dict(towers["cpu"].named_parameters())
    floor = 1e-5 * max(p.grad.abs().max().item() for p in ref.values())
    for name, p in towers[cuda].named_parameters():
        torch.testing.assert_close(p.grad.cpu(), ref[name].grad, atol=floor, rtol=1e-4, msg=lambda m, name=name: f"{name}: {m}")
    for (name, a), b in zip(towers[cuda].named_modules(), towers["cpu"].modules()):
        if isinstance(a, BatchNorm):
            assert (a.step_stats is None) == (groups is None), name
            if groups is not None:
                torch.testing.assert_close(a.step_stats.cpu(), b.step_stats, atol=1e-5, rtol=1e-5, msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b, h, nq, nk, dh", [(2, 12, 197, 197, 64), (2, 3, 128, 256, 64), (3, 2, 17, 17, 32)])
def test_flash_mha_grad_matches_autograd_of_plain_attention(cuda, b, h, nq, nk, dh, causal):
    """fp32 K3 + K4 + K5 against torch autograd of plain softmax attention in float64, causal mask
    top-left aligned: the math independently of the rounding replica.  1e-4: fp32 summation order."""
    g = torch.Generator().manual_seed(11)
    q, k, v = _flash_inputs(b, h, nq, nk, dh, torch.float32, cuda, g)
    do = torch.randn(b, h, nq, dh, generator=g).to(cuda)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    flash_mha(*leaves, causal=causal).backward(do)
    ref = [t.detach().double().requires_grad_(True) for t in (q, k, v)]
    s = ref[0] @ ref[1].transpose(-1, -2) * dh**-0.5
    if causal:
        s = s.masked_fill(torch.ones(nq, nk, dtype=torch.bool, device=cuda).triu(1), float("-inf"))
    (torch.softmax(s, dim=-1) @ ref[2]).backward(do.double())
    for name, got, want in zip("qkv", leaves, ref):
        torch.testing.assert_close(got.grad.double(), want.grad, atol=1e-4, rtol=1e-4, msg=lambda m, name=name: f"d{name}: {m}")


@pytest.mark.cuda
def test_flash_mha_kernels_refuse_what_they_do_not_take(cuda):
    def qkv(dh=64, dtype=torch.float32, device=cuda):
        return tuple(torch.zeros(1, 2, 8, dh, device=device, dtype=dtype) for _ in range(3))

    with pytest.raises(ValueError):
        flash_mha_cuda(*qkv(dh=48))
    with pytest.raises(TypeError):
        flash_mha_cuda(*qkv(dtype=torch.float16))
    with pytest.raises(ValueError):
        flash_mha_cuda(*qkv(device="cpu"))
    q, k, v = qkv()
    with pytest.raises(ValueError):
        flash_mha_cuda(torch.zeros(1, 2, 64, 8, device=cuda).transpose(2, 3), k, v)  # Dh not unit-stride
    with pytest.raises(ValueError):
        flash_mha_cuda(q, k, torch.zeros(1, 8, 2, 64, device=cuda).transpose(1, 2))  # v's strides differ from k's
    with pytest.raises(ValueError):
        flash_mha_cuda(q, torch.zeros(1, 2, 9, 64, device=cuda), v)  # k and v of different lengths
    o, lse = flash_mha_cuda(q, k, v)
    do = torch.zeros_like(o)
    with pytest.raises(ValueError):
        flash_mha_bwd_cuda(q, k, v, o, lse.double(), do)  # fp64 lse
    with pytest.raises(ValueError):
        flash_mha_bwd_cuda(q, k, v, o, lse, do.contiguous())  # dO strides differ from o's
    with pytest.raises(TypeError):
        flash_mha_bwd_cuda(*qkv(dtype=torch.float16), o, lse, do)


# y and dx: (fp32 forward, fp32 gradients) at the JAX test's tolerances (summation order); one rounding of the output in bf16
LN_TOLERANCE = [(torch.float32, 1e-5, 2e-4), (torch.bfloat16, 2e-2, 2e-2)]
# small ragged shapes, every width class (64 tiny, 512 text and head, 768, 1024), a leading batch axis, and
# every token of the test slice's 320 frames and of the train chunk's 480 frames
LN_SHAPES = [(197, 256), (1300, 512), (3, 70, 128), (577, 1024), (130, 64), (63040, 768), (94560, 768)]


def _ln_inputs(shape, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    d = shape[-1]
    x = torch.randn(*shape, generator=g) * 2.0 + 0.5
    x.reshape(-1, d)[1] = 2.5  # a constant row: the variance is 0 up to rounding and is clamped
    return (x.to(device, dtype), (torch.rand(d, generator=g) + 0.5).to(device), torch.randn(d, generator=g).to(device),
            torch.randn(*shape, generator=g).to(device, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, y_tol, dx_tol", LN_TOLERANCE)
@pytest.mark.parametrize("shape", LN_SHAPES)
def test_layer_norm_kernels_match_plain(cuda, shape, dtype, y_tol, dx_tol):
    """K6 and K7 against their plain versions; dg and db at a tolerance that grows with the square root
    of the number of rows summed in fp32; one launch of each counted; the same result on a second run;
    layer_norm and its autograd backward return the kernels' results."""
    x, w, b, dy = _ln_inputs(shape, dtype, cuda, shape[0])
    before = dict(fused_layernorm.LAUNCHES)
    y = layer_norm_cuda(x, w, b)
    dx, dg, db = layer_norm_bwd_cuda(x, w, dy)
    torch.cuda.synchronize()
    assert fused_layernorm.LAUNCHES == {"layer_norm_fwd": before["layer_norm_fwd"] + 1, "layer_norm_bwd": before["layer_norm_bwd"] + 1}
    assert y.dtype == dx.dtype == dtype and y.shape == dx.shape == x.shape and dg.dtype == db.dtype == torch.float32
    ref_dx, ref_dg, ref_db = layer_norm_bwd_reference(x, w, dy)
    torch.testing.assert_close(y.float(), layer_norm_reference(x, w, b).float(), atol=y_tol, rtol=y_tol)
    torch.testing.assert_close(dx.float(), ref_dx.float(), atol=dx_tol, rtol=dx_tol)
    sum_tol = 1e-4 * max(1.0, (x.numel() // shape[-1]) ** 0.5)
    torch.testing.assert_close(dg, ref_dg, atol=sum_tol, rtol=1e-4)
    torch.testing.assert_close(db, ref_db, atol=sum_tol, rtol=1e-4)
    for a, r in zip(layer_norm_bwd_cuda(x, w, dy), (dx, dg, db)):
        torch.testing.assert_close(a, r, atol=0, rtol=0)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    out = layer_norm(*leaves)
    torch.testing.assert_close(out, y, atol=0, rtol=0)
    out.backward(dy)
    for leaf, r in zip(leaves, (dx, dg, db)):
        torch.testing.assert_close(leaf.grad, r, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(197, 768), (3, 70, 128), (577, 1024)])
def test_layer_norm_grad_matches_float64_autograd(cuda, shape):
    """fp32 K6 + K7 through autograd against float64 autograd of the two-pass formula, with a dy that
    arrives non-contiguous (the backward packs it): the math independently of the rounding replica."""
    x, w, b, dy = _ln_inputs(shape, torch.float32, cuda, 13)
    dy = dy.repeat_interleave(2, dim=-1)[..., ::2]  # the same values behind a stride of 2
    assert not dy.is_contiguous()
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    before = fused_layernorm.LAUNCHES["layer_norm_bwd"]
    layer_norm(*leaves).backward(dy)
    assert fused_layernorm.LAUNCHES["layer_norm_bwd"] == before + 1
    ref = [t.double().requires_grad_(True) for t in (x, w, b)]
    mu = ref[0].mean(-1, keepdim=True)
    ((ref[0] - mu) / torch.sqrt(ref[0].var(-1, unbiased=False, keepdim=True) + 1e-5) * ref[1] + ref[2]).backward(dy.double())
    for name, got, want in zip(("dx", "dg", "db"), leaves, ref):
        torch.testing.assert_close(got.grad.double(), want.grad, atol=1e-4, rtol=1e-4, msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.cuda
def test_layer_norm_kernels_refuse_what_they_do_not_take(cuda):
    w, b = torch.ones(768, device=cuda), torch.zeros(768, device=cuda)
    x = torch.zeros(8, 768, device=cuda)
    for d in (1028, 2048, 4):  # not a multiple of 8, wider than 1024, narrower than 8
        with pytest.raises(ValueError):
            layer_norm_cuda(torch.zeros(8, d, device=cuda), torch.ones(d, device=cuda), torch.zeros(d, device=cuda))
    with pytest.raises(TypeError):
        layer_norm_cuda(x.half(), w, b)
    with pytest.raises(ValueError):
        layer_norm_cuda(x.cpu(), w.cpu(), b.cpu())
    with pytest.raises(ValueError):
        layer_norm_cuda(torch.zeros(768, 8, device=cuda).t(), w, b)  # not contiguous
    with pytest.raises(ValueError):
        layer_norm_cuda(x, w.bfloat16(), b)  # g must be float32 at the launcher
    with pytest.raises(ValueError):
        layer_norm_bwd_cuda(x, w, torch.zeros(768, 8, device=cuda).t())  # dy not contiguous
    with pytest.raises(ValueError):
        layer_norm_bwd_cuda(x, w, x.bfloat16())  # dy in another dtype than x
    y = layer_norm(torch.zeros(8, 1024, device=cuda).t()[:768].t(), w, b)  # the op packs a strided x itself
    assert y.shape == (8, 768)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", TOLERANCE)
@pytest.mark.parametrize("mode", fa_decomp.ABLATED)
@pytest.mark.parametrize("b, n, h, dh", [(4, 197, 12, 64), (4, 50, 8, 64), (3, 17, 2, 32), (320, 197, 12, 64), (2, 333, 3, 32)])
def test_fa_decomp_kernels_match_plain(cuda, b, n, h, dh, mode, dtype, tol):
    """Each ablated mode of K8 against its plain version, on inputs scaled as the tool scales them (so
    the tolerance is a share of the reference's largest value, not absolute); one launch counted;
    ``full`` is the shipped forward kernel."""
    qkv = fa_decomp.make_qkv((b, n, 3 * h * dh), dtype, seed=n)
    before = dict(fa_decomp.LAUNCHES)
    o = fa_decomp.fa_decomp_cuda(qkv, h, mode)
    torch.cuda.synchronize()
    assert fa_decomp.LAUNCHES == {**before, mode: before[mode] + 1}
    ref = fa_decomp.fa_decomp_reference(qkv, h, mode)
    assert o.dtype == dtype and o.shape == ref.shape
    fa_decomp.assert_close_to_scale(o, ref, tol, f"clip_mha_decomp[{mode}]")
    torch.testing.assert_close(fa_decomp.fa_decomp_cuda(qkv, h, "full"), clip_mha_cuda(qkv, h)[0], atol=0, rtol=0)


@pytest.mark.cuda
def test_fa_decomp_kernel_refuses_what_it_does_not_take(cuda):
    with pytest.raises(ValueError):
        fa_decomp.fa_decomp_cuda(torch.zeros(1, 8, 3 * 2 * 48, device=cuda), 2, "exp")  # Dh = 48
    with pytest.raises(ValueError):
        fa_decomp.fa_decomp_cuda(torch.zeros(1, 8, 3 * 2 * 64, device=cuda), 2, "softmax")
    with pytest.raises(TypeError):
        fa_decomp.fa_decomp_cuda(torch.zeros(1, 8, 3 * 2 * 64, device=cuda, dtype=torch.float16), 2, "exp")


MOLO_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "projects", "MoLo", "hmdb51",
                           "MoLo_HMDB51_1shot_v1.yaml")


@pytest.mark.cuda
def test_molo_train_steps_are_the_same_bits_on_a_second_run(cuda):
    """Two MoLo train steps on the card (resnet18 trunk, 4 frames at 112 px, E = 2, an Adam update on each,
    jitter and dropout on), run twice from one seed: the same loss bits and the same parameters and
    running stats bit for bit.  The decoder's bilinear upsampling used to go through ``F.interpolate``,
    whose backward adds into the input gradient with atomics in an order that changes between runs."""
    from clip_fsar_torch.config.config import load_config
    from clip_fsar_torch.data.loader import build_few_shot_loader
    from clip_fsar_torch.models.builder import build_few_shot_model
    from clip_fsar_torch.train.loop import step_generator
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.state import TrainState
    from clip_fsar_torch.train.step import make_train_step

    cfg = load_config(MOLO_CONFIG, ["VIDEO.HEAD.BACKBONE_NAME", "resnet18", "DATA.DECODER", "synthetic", "DATA.NUM_INPUT_FRAMES", "4",
                                    "DATA.TRAIN_CROP_SIZE", "112", "DATA.TEST_CROP_SIZE", "112", "DATA.TRAIN_JITTER_SCALES", "[128, 128]",
                                    "TPU.EPISODES_PER_STEP", "2", "TRAIN.BATCH_SIZE_PER_TASK", "1"])
    with build_few_shot_loader(cfg, "train", num_steps=2, episodes_per_step=2) as loader:
        batches = [b.to(cuda) for b in loader]

    def run():
        model = build_few_shot_model(cfg, flow="train", device=cuda)
        state = TrainState.create(cfg, model.head, Optimizer(cfg, model.head))
        step = make_train_step(model.head, cfg, model.text_train, model.text_test)
        losses = torch.stack([step(state, b, 1e-3, step_generator(cfg, i, cuda))["loss"] for i, b in enumerate(batches)])
        return losses.cpu(), {k: v.detach().clone() for k, v in model.head.state_dict().items()}

    (a, first), (b, second) = run(), run()
    assert torch.isfinite(a).all() and torch.equal(a, b), (a.tolist(), b.tolist())
    assert sorted(k for k in first if not torch.equal(first[k], second[k])) == []


_CLS_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "classification", "TAda2D_K400.yaml")
# a small TAda2D (26-bottleneck, narrow) at 8 frames of 64 px; jitter, erasing, elem-mode mixup / cutmix and EMA on
_CLS_OPTS = ["VIDEO.BACKBONE.DEPTH", "26", "VIDEO.BACKBONE.NUM_FILTERS", "[16, 32, 64, 64, 128]", "VIDEO.HEAD.NUM_CLASSES", "10",
             "DATA.NUM_INPUT_FRAMES", "8", "DATA.TRAIN_CROP_SIZE", "64", "DATA.TEST_CROP_SIZE", "64", "AUGMENTATION.COLOR_AUG", "True",
             "AUGMENTATION.RANDOM_ERASING.ENABLE", "True", "AUGMENTATION.MIXUP.ENABLE", "True", "AUGMENTATION.MIXUP.MODE", "elem",
             "AUGMENTATION.CUTMIX.ENABLE", "True", "AUGMENTATION.CUTMIX.ALPHA", "1.0", "MODEL.EMA.ENABLE", "True"]


@pytest.mark.cuda
def test_classification_train_steps_never_wait_for_the_card(cuda):
    """Two classification train steps (bf16) after a first one, under torch's sync debug mode: no operation
    inside them synchronises with the device (the mixup draws and the jitter's op order come from the host,
    the NaN guard and the metrics stay on the card)."""
    import warnings

    from clip_fsar_torch.config.config import load_config
    from clip_fsar_torch.models.video.model import build_video_model
    from clip_fsar_torch.train.classification import make_classification_train_step, step_generator
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.state import TrainState

    cfg = load_config(_CLS_CONFIG, _CLS_OPTS)
    model = build_video_model(cfg, dtype=torch.bfloat16, device=cuda)
    state = TrainState.create(cfg, model, Optimizer(cfg, model, name_prefix=""))
    step = make_classification_train_step(model, cfg)
    videos = torch.randint(0, 256, (4, 8, 64, 64, 3), dtype=torch.uint8, device=cuda)
    labels = torch.arange(4, dtype=torch.int32, device=cuda)
    step(state, videos, labels, 1e-3, step_generator(cfg, 0, 0, cuda))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            seen = [step(state, videos, labels, 1e-3, step_generator(cfg, 0, i, cuda)) for i in (1, 2)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert sorted({f"{w.filename}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)}) == []
    assert all(bool(m["updated"]) and torch.isfinite(m["loss"]).item() for m in seen)


@pytest.mark.cuda
def test_classification_bf16_eval_matches_fp32(cuda):
    """The small TAda2D's eval predictions (softmax over 10 classes) in bf16 against fp32 on the same weights
    and clips: within 2e-2 (bf16 rounds every conv's operands; measured on the card in chip_smoke.py's phase
    24 at full width), and both finite."""
    from clip_fsar_torch.config.config import load_config
    from clip_fsar_torch.data.transforms import normalize_images
    from clip_fsar_torch.models.video.model import build_video_model

    cfg = load_config(_CLS_CONFIG, _CLS_OPTS)
    fp32 = build_video_model(cfg, dtype=torch.float32, device=cuda)
    bf16 = build_video_model(cfg, dtype=torch.bfloat16, device=cuda)
    bf16.load_state_dict(fp32.state_dict())
    x = normalize_images(torch.randint(0, 256, (4, 8, 64, 64, 3), dtype=torch.uint8, device=cuda), cfg.DATA.MEAN, cfg.DATA.STD)
    with torch.no_grad():
        want, got = fp32(x, train=False)[0], bf16(x, train=False)[0]
    assert torch.isfinite(got).all() and torch.isfinite(want).all()
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=0)


# the localization task and MoSI pretraining at tiny sizes (configs/localization, configs/pretrain)
BMN_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "localization", "BMN_EPIC100.yaml")
BMN_TINY = ["DATA.TEMPORAL_SCALE", "32", "DATA.NUM_INPUT_CHANNELS", "16", "DATA.DECODER", "synthetic", "VIDEO.DIM1D", "32", "VIDEO.DIM2D", "16",
            "VIDEO.DIM3D", "16", "VIDEO.HEAD.NUM_SAMPLE", "8", "VIDEO.HEAD.NUM_CLASSES", "[3, 4]", "TRAIN.BATCH_SIZE", "4"]
MOSI_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "pretrain", "MoSI_R2D3D_HMDB51.yaml")
MOSI_TINY = ["VIDEO.BACKBONE.DEPTH", "10", "VIDEO.BACKBONE.NUM_FILTERS", "[8, 16, 16, 32, 32]", "VIDEO.HEAD.NUM_CLASSES", "3",
             "PRETRAIN.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32", "TRAIN.BATCH_SIZE", "2"]


def _bmn_batch(cfg, device):
    from clip_fsar_torch.data.tal_features import TalFeatureDataset
    from clip_fsar_torch.train.localization import _batches

    feats, maps, _ = next(_batches(TalFeatureDataset(cfg, "train"), int(cfg.TRAIN.BATCH_SIZE), False, 0))
    return torch.from_numpy(feats).to(device), {k: torch.from_numpy(v).to(device) for k, v in maps.items()}


@pytest.mark.cuda
def test_bmn_forward_and_backward_on_the_card_match_the_cpu(cuda):
    """SimpleLocalizationConv + BaseBMN (regression and verb/noun maps on, D = T from the preset's
    DURATION_SCALE -1) in float32 with TF32 off: every output map and the gradient of every parameter the
    BMN loss reaches (Loss_PemReg's draws the same on both) on the card against the CPU at 1e-4."""
    from clip_fsar_torch.config.config import load_config
    from clip_fsar_torch.train.localization import build_bmn_model
    from clip_fsar_torch.train.localization_losses import pem_reg_draws
    from clip_fsar_torch.train.losses import calculate_loss

    cfg = load_config(BMN_CONFIG, BMN_TINY)
    feats, maps = _bmn_batch(cfg, "cpu")
    draws = pem_reg_draws(maps["iou_map"].shape, torch.Generator().manual_seed(0))
    outs, grads = [], []
    for dev in ("cpu", cuda):
        model = build_bmn_model(cfg, dev)
        preds = model(feats.to(dev))
        loss, _ = calculate_loss(cfg, preds, None, {"supervised": {k: v.to(dev) for k, v in maps.items()}}, draws=tuple(d.to(dev) for d in draws))
        loss.backward()
        outs.append({k: v.detach().cpu() for k, v in preds.items()})
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None})  # the regression map feeds no loss
    assert outs[0]["confidence_map"].shape == (4, 2, 32, 32) and outs[0]["verb_map"].shape == (4, 3, 32, 32)
    for k, v in outs[0].items():
        torch.testing.assert_close(outs[1][k], v, atol=1e-4, rtol=1e-4, msg=lambda m, k=k: f"{k}: {m}")
    assert grads[0].keys() == grads[1].keys() and "head.x_3d_p.weight" in grads[0] and "backbone.conv_0.weight" in grads[0]
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, atol=1e-4, rtol=1e-4, msg=lambda m, n=n: f"grad {n}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["localization", "pretrain_adam", "pretrain_lars"])
def test_bmn_and_mosi_steps_never_wait_for_the_card(cuda, tmp_path, task):
    """Two BMN train steps, or two MoSI pretrain steps (the preset's per-frame colour jitter and dropout on;
    Adam or LARS), after a first one, under torch's sync debug mode: nothing inside them synchronises with
    the device."""
    import warnings

    from clip_fsar_torch.config.config import load_config
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.state import TrainState

    if task == "localization":
        from clip_fsar_torch.train.localization import build_bmn_model, make_localization_train_step, step_generator

        cfg = load_config(BMN_CONFIG, BMN_TINY)
        model = build_bmn_model(cfg, cuda)
        step, (x, y) = make_localization_train_step(model, cfg), _bmn_batch(cfg, cuda)
        run = lambda i: step(state, x, y, 1e-3, step_generator(cfg, 0, i, cuda))[0]  # noqa: E731
    else:
        from clip_fsar_torch.data.classification import build_classification_loader
        from clip_fsar_torch.models.video.model import build_video_model
        from clip_fsar_torch.train.classification import _to_device, make_classification_train_step
        from clip_fsar_torch.train.classification import step_generator as cls_generator

        for split in ("train", "test"):
            with open(tmp_path / f"hmdb51_{split}_list.txt", "w") as f:
                f.write("".join(f"videos/c{i % 3}/{split}_{i}.avi {i % 3}\n" for i in range(4)))
        cfg = load_config(MOSI_CONFIG, MOSI_TINY + ["DATA.DECODER", "synthetic", "DATA.ANNO_DIR", str(tmp_path), "SOLVER.OPTIM_METHOD", task.split("_")[1]])
        model = build_video_model(cfg, device=cuda)
        videos, labels, _ = next(iter(build_classification_loader(cfg, "train")))
        x, y = _to_device(videos, cuda), _to_device(labels, cuda)
        step = make_classification_train_step(model, cfg)
        run = lambda i: step(state, x, y, 1e-3, cls_generator(cfg, 0, i, cuda))["loss"]  # noqa: E731
    state = TrainState.create(cfg, model, Optimizer(cfg, model, name_prefix=""))
    run(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            losses = [run(i) for i in (1, 2)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert sorted({f"{w.filename}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)}) == []
    assert all(torch.isfinite(v).item() for v in losses)


# the pools' backward kernel at the shapes of the paths that run it: MoSI's R-2D3D stem pool (10 of a step's 90 clips),
# S3D-G's stem, branch and stage pools at 16 frames of 224 px (batch 2), TAdaConv's pooled branch on TAda2D-R50's first
# stage (fp32, as the branch pools); (x shape [N, C, D, H, W], kernel, stride, padding, mode)
POOL_CASES = [((10, 64, 16, 56, 56), (1, 3, 3), (1, 2, 2), (0, 1, 1), "max"),
              ((2, 64, 8, 112, 112), (1, 3, 3), (1, 2, 2), (0, 1, 1), "max"),
              ((2, 192, 8, 28, 28), (3, 3, 3), (1, 1, 1), (1, 1, 1), "max"),
              ((2, 480, 8, 28, 28), (3, 3, 3), (2, 2, 2), (1, 1, 1), "max"),
              ((2, 832, 4, 14, 14), (2, 2, 2), (2, 2, 2), (0, 0, 0), "max"),
              ((2, 64, 16, 56, 56), (3, 1, 1), (1, 1, 1), (1, 0, 0), "avg")]
# fp32: the plain version adds in the kernel's order, so 1e-6 relative leaves room only for the last bit; bf16: one
# rounding of the fp32 sum in each (the plain version's sum is the same, its rounding too)
POOL_TOLERANCE = [(torch.float32, 1e-6), (torch.bfloat16, 1e-2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", POOL_TOLERANCE)
@pytest.mark.parametrize("channels_last", [True, False], ids=["channels_last", "ncdhw"])
@pytest.mark.parametrize("shape, kernel, stride, padding, mode", POOL_CASES)
def test_pool3d_bwd_kernel_matches_plain(cuda, shape, kernel, stride, padding, mode, channels_last, dtype, tol):
    """The pools' backward kernel against its plain version on the card, from the forward's own argmax, with
    ties (values from {0, 1, 2}); dx in x's memory format; one launch counted; a second launch the same bits."""
    from clip_fsar_torch.ops import pool3d

    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randint(0, 3, shape, generator=g).to(cuda, dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last_3d)
    if mode == "max":
        y, argmax = torch.nn.functional.max_pool3d(x, kernel, stride, padding, return_indices=True)
    else:
        y, argmax = torch.nn.functional.avg_pool3d(x, kernel, stride, padding), None
    dy = torch.randn(y.shape, generator=g).to(cuda, dtype)
    before = dict(pool3d.LAUNCHES)
    dx = pool3d.pool3d_bwd_cuda(mode, dy, argmax, shape, kernel, stride, padding, channels_last)
    torch.cuda.synchronize()
    assert pool3d.LAUNCHES == {**before, f"{mode}_pool3d_bwd": before[f"{mode}_pool3d_bwd"] + 1}
    assert dx.dtype == dtype and dx.is_contiguous(memory_format=torch.channels_last_3d if channels_last else torch.contiguous_format)
    if mode == "max":
        ref = pool3d.max_pool3d_bwd_reference(dy, argmax, shape, kernel, stride, padding)
    else:
        ref = pool3d.avg_pool3d_bwd_reference(dy, shape, kernel, stride, padding)
    assert torch.isfinite(dx.float()).all()
    torch.testing.assert_close(dx.float(), ref.float(), rtol=tol, atol=tol)
    assert torch.equal(pool3d.pool3d_bwd_cuda(mode, dy, argmax, shape, kernel, stride, padding, channels_last), dx)


@pytest.mark.cuda
def test_pool3d_autograd_on_the_card_launches_the_kernel_and_matches_the_cpu(cuda):
    """max_pool3d and avg_pool3d through autograd on the card: the forward is F's, the backward the kernel (one
    launch each), and the input gradient equals the CPU's plain backward at fp32 1e-6."""
    from clip_fsar_torch.ops import pool3d

    x = torch.randn(2, 8, 6, 15, 14, generator=torch.Generator().manual_seed(0))
    for fn, name in ((pool3d.max_pool3d, "max_pool3d_bwd"), (pool3d.avg_pool3d, "avg_pool3d_bwd")):
        grads = []
        for dev in (cuda, torch.device("cpu")):
            t = x.to(dev).contiguous(memory_format=torch.channels_last_3d).requires_grad_(True)
            before = pool3d.LAUNCHES[name]
            y = fn(t, (3, 3, 3), (2, 2, 2), (1, 1, 1))
            y.backward(torch.arange(y.numel(), dtype=torch.float32, device=dev).reshape(y.shape).sin())
            assert pool3d.LAUNCHES[name] == before + (dev.type == "cuda")
            grads.append(t.grad.cpu())
        torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_pool3d_kernel_refuses_what_it_does_not_take(cuda):
    from clip_fsar_torch.ops import pool3d

    dy = torch.zeros(1, 2, 2, 2, 2, device=cuda)
    with pytest.raises(TypeError):
        pool3d.pool3d_bwd_cuda("avg", dy.half(), None, (1, 2, 4, 4, 4), 2, 2, 0, False)
    with pytest.raises(ValueError):
        pool3d.pool3d_bwd_cuda("max", dy, None, (1, 2, 4, 4, 4), 2, 2, 0, False)  # no argmax
    with pytest.raises(ValueError):
        pool3d.pool3d_bwd_cuda("avg", dy, None, (1, 2, 7, 7, 7), 2, 2, 0, False)  # dy is not that pool's output (3 a side)


@pytest.mark.cuda
def test_mosi_train_steps_are_the_same_bits_on_a_second_run(cuda, tmp_path):
    """Three MoSI pretrain steps on the card (R-2D3D at full width, 4 frames of 112 px, the preset's colour jitter and
    dropout, Adam), run twice from one seed: the same loss bits and parameters.  The stem's overlapping
    (1, 3, 3) / (1, 2, 2) max-pool used to go through F.max_pool3d, whose CUDA backward adds with atomics."""
    from clip_fsar_torch.config.config import load_config
    from clip_fsar_torch.data.classification import build_classification_loader
    from clip_fsar_torch.models.video.model import build_video_model
    from clip_fsar_torch.ops import pool3d
    from clip_fsar_torch.train.classification import _to_device, make_classification_train_step, step_generator
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.state import TrainState

    for split in ("train", "test"):
        with open(tmp_path / f"hmdb51_{split}_list.txt", "w") as f:
            f.write("".join(f"videos/c{i % 3}/{split}_{i}.avi {i % 3}\n" for i in range(4)))
    cfg = load_config(MOSI_CONFIG, ["DATA.DECODER", "synthetic", "DATA.ANNO_DIR", str(tmp_path), "PRETRAIN.NUM_FRAMES", "4",
                                    "TRAIN.BATCH_SIZE", "4"])
    videos, labels, _ = next(iter(build_classification_loader(cfg, "train")))
    x, y = _to_device(videos, cuda), _to_device(labels, cuda)

    def run():
        model = build_video_model(cfg, device=cuda)
        state = TrainState.create(cfg, model, Optimizer(cfg, model, name_prefix=""))
        step = make_classification_train_step(model, cfg)
        before = pool3d.LAUNCHES["max_pool3d_bwd"]
        losses = torch.stack([step(state, x, y, 1e-3, step_generator(cfg, 0, i, cuda))["loss"] for i in range(3)])
        assert pool3d.LAUNCHES["max_pool3d_bwd"] == before + 3
        return losses.cpu(), {k: v.detach().clone() for k, v in model.state_dict().items()}

    (a, first), (b, second) = run(), run()
    assert torch.isfinite(a).all() and torch.equal(a, b), (a.tolist(), b.tolist())
    assert sorted(k for k in first if not torch.equal(first[k], second[k])) == []


@pytest.mark.cuda
def test_tada2d_train_steps_past_the_first_update_are_the_same_bits_on_a_second_run(cuda):
    """Three train steps of the small TAda2D (bf16, jitter, erasing, mixup, EMA) at a learning rate that moves the
    pooled branch's zero-initialised BatchNorm scale in the first update, so that the second and third steps send a
    gradient through TAdaConv's average pool; run twice from one seed: the same loss bits and parameters.  The pool
    used to go through F.avg_pool3d, whose CUDA backward adds with atomics where the (3, 1, 1) windows overlap."""
    from clip_fsar_torch.config.config import load_config
    from clip_fsar_torch.models.video.model import build_video_model
    from clip_fsar_torch.ops import pool3d
    from clip_fsar_torch.train.classification import make_classification_train_step, step_generator
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.state import TrainState

    cfg = load_config(_CLS_CONFIG, _CLS_OPTS)
    g = torch.Generator().manual_seed(0)
    videos = torch.randint(0, 256, (4, 8, 64, 64, 3), dtype=torch.uint8, generator=g).to(cuda)
    labels = torch.arange(4, dtype=torch.int32, device=cuda)

    def run():
        model = build_video_model(cfg, dtype=torch.bfloat16, device=cuda)
        state = TrainState.create(cfg, model, Optimizer(cfg, model, name_prefix=""))
        step = make_classification_train_step(model, cfg)
        scales = [n for n in dict(model.named_parameters()) if n.endswith("b_avgpool_bn.weight")]
        assert scales and all(not model.get_parameter(n).any() for n in scales)
        before = pool3d.LAUNCHES["avg_pool3d_bwd"]
        losses = [step(state, videos, labels, 1e-2, step_generator(cfg, 0, 0, cuda))["loss"]]
        assert all(model.get_parameter(n).any() for n in scales)  # the first update moved every pooled branch's scale
        losses += [step(state, videos, labels, 1e-2, step_generator(cfg, 0, i, cuda))["loss"] for i in (1, 2)]
        assert pool3d.LAUNCHES["avg_pool3d_bwd"] == before + 3 * len(scales)
        return torch.stack(losses).cpu(), {k: v.detach().clone() for k, v in model.state_dict().items()}

    (a, first), (b, second) = run(), run()
    assert torch.isfinite(a).all() and torch.equal(a, b), (a.tolist(), b.tolist())
    assert sorted(k for k in first if not torch.equal(first[k], second[k])) == []
