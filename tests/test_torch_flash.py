"""clip_fsar_torch's flash_mha against clip_fsar_tpu's: the plain versions of
K3 (forward) and K4 + K5 (backward, through the autograd Function) against
the JAX Pallas kernels in interpret mode on the CPU, the mask route to the
plain mha, and the CPU dispatch.  Inputs are numpy arrays from a seed.

Shapes (B, H, Nq, Nk, Dh): ViT-Tiny-Test's N = 17; N = 300, where the JAX
kernel streams three 128-wide key blocks and really rescales; a causal
case; Nq != Nk (the cross-attention shape of
tests/test_flash_attention.py), with and without the causal mask; N = 257
(ViT-L/14: the first length past the single key block, two blocks of 128
and a ragged one of 1 key); the text tower's causal N = 77 (one block); and
causal cross-attention in each direction at ragged lengths (Nq 40 < Nk 100:
keys that no query sees; Nq 100 > Nk 40: query rows past Nk that see every
key).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_fsar_torch.ops import attention as tattn
from clip_fsar_torch.ops.flash_attention import (
    LAUNCHES,
    _FlashMHA,
    flash_mha,
    flash_mha_bwd_cuda,
    flash_mha_bwd_reference,
    flash_mha_cuda,
    flash_mha_reference,
)
from clip_fsar_torch.ops.fused_attention import check_alignment
from tests.torch_parity import pallas_interpret

torch.set_num_threads(2)

CASES = [
    ((2, 2, 17, 17, 32), False),
    ((1, 2, 300, 300, 32), False),
    ((2, 2, 40, 40, 32), True),
    ((1, 2, 128, 256, 32), False),
    ((1, 2, 128, 256, 32), True),
    ((1, 2, 257, 257, 32), False),
    ((1, 2, 77, 77, 32), True),
    ((1, 2, 40, 100, 32), True),
    ((1, 2, 100, 40, 32), True),
]
# fp32: summation order; bf16: one bf16 ulp of values near 1 (p and dS are rounded at the same
# points on both sides, but fp32 sums taken in another order can land a rounding one ulp apart)
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2}
IDS = [f"{nq}x{nk}" + ("-causal" if causal else "") for (_, _, nq, nk, _), causal in CASES]


def _inputs(b, h, nq, nk, dh, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, n, dh).astype(np.float32) for n in (nq, nk, nk, nq)]  # q, k, v, dO


def _jax_flash():
    from clip_fsar_tpu.ops import flash_attention as jfa

    return jfa


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape, causal", CASES, ids=IDS)
def test_flash_mha_reference_matches_jax_kernel(shape, causal, dtype):
    """K3's plain version vs the Pallas forward it stands for (o and lse).
    Measured worst |o - o_jax|: 4.2e-7 (fp32), 9.8e-4 (bf16, at N = 300
    where both rescale across key blocks); lse at 2e-5."""
    jfa = _jax_flash()
    b, h, nq, nk, dh = shape
    q, k, v, _ = _inputs(*shape, seed=nq + nk)
    with pallas_interpret():
        o_j, lse_j = jfa._fwd_impl(*(jnp.asarray(x, dtype) for x in (q, k, v)), causal, jfa._auto_block(nq), jfa._auto_block(nk))
    tdt = getattr(torch, dtype)
    o_t, lse_t = flash_mha_reference(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), causal)
    assert o_t.dtype == tdt and o_t.shape == (b, h, nq, dh) and lse_t.dtype == torch.float32 and lse_t.shape == (b, h, nq)
    tol = TOLERANCE[dtype]
    np.testing.assert_allclose(o_t.float().numpy(), np.asarray(o_j, np.float32), atol=tol, rtol=tol)
    # JAX keeps the LSE as [B*H, Nq padded to its block, 128 lanes], replicated over the lanes
    want_lse = np.asarray(lse_j)[:, :nq, 0].reshape(b, h, nq)
    np.testing.assert_allclose(lse_t.numpy(), want_lse, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape, causal", CASES, ids=IDS)
def test_flash_mha_bwd_reference_matches_jax_vjp(shape, causal, dtype):
    """K4 + K5's plain versions, through _FlashMHA's autograd on CPU tensors,
    vs jax.vjp of the JAX flash_mha (its custom_vjp runs the Pallas dQ and
    dK/dV kernels).  Measured worst: 1.9e-6 (fp32), 9.8e-4 (bf16)."""
    jfa = _jax_flash()
    q, k, v, do = _inputs(*shape, seed=shape[2] + shape[3] + 1)
    with pallas_interpret():
        out, vjp = jax.vjp(lambda a, b_, c: jfa.flash_mha(a, b_, c, causal=causal), *(jnp.asarray(x, dtype) for x in (q, k, v)))
        want = vjp(jnp.asarray(do, dtype))
    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_(True) for x in (q, k, v)]
    o = _FlashMHA.apply(*leaves, causal)
    o.backward(torch.from_numpy(do).to(tdt))
    tol = TOLERANCE[dtype]
    np.testing.assert_allclose(o.detach().float().numpy(), np.asarray(out, np.float32), atol=tol, rtol=tol)
    for name, leaf, w in zip("qkv", leaves, want):
        assert leaf.grad.dtype == tdt, name
        np.testing.assert_allclose(leaf.grad.float().numpy(), np.asarray(w, np.float32), atol=tol, rtol=tol, err_msg=f"d{name}")


def test_flash_mha_grad_matches_autograd_of_plain_attention():
    """flash_mha's forward and backward on CPU tensors (the plain K3-K5)
    against torch autograd of softmax attention in float64, causal and not,
    with Nq != Nk; fp32 at 1e-5."""
    b, h, nq, nk, dh = 2, 3, 19, 23, 32
    for causal in (False, True):
        q, k, v, do = (torch.from_numpy(x) for x in _inputs(b, h, nq, nk, dh, seed=5))
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        flash_mha(*leaves, causal=causal).backward(do)
        ref = [t.double().requires_grad_(True) for t in (q, k, v)]
        s = ref[0] @ ref[1].transpose(-1, -2) * dh**-0.5
        if causal:
            s = s.masked_fill(torch.ones(nq, nk, dtype=torch.bool).triu(1), float("-inf"))
        (torch.softmax(s, dim=-1) @ ref[2]).backward(do.double())
        for name, got, want in zip("qkv", leaves, ref):
            torch.testing.assert_close(got.grad.double(), want.grad, atol=1e-5, rtol=1e-5, msg=lambda m, name=name: f"d{name}: {m}")


def test_flash_mha_mask_routes_to_plain_mha():
    """An additive mask sends flash_mha to the plain mha, as the JAX
    flash_mha sends it to XLA (flash_attention.py:327-330): equal to mha with
    that mask, to the JAX function at 2e-5, and to the in-kernel causal path
    at 1e-5 for the causal mask; no launch counted."""
    from clip_fsar_tpu.ops import attention as jattn

    jfa = _jax_flash()
    q, k, v, _ = _inputs(1, 2, 16, 16, 32, seed=1)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    mask = tattn.causal_mask(16)
    before = dict(LAUNCHES)
    got = flash_mha(tq, tk, tv, mask=mask)
    torch.testing.assert_close(got, tattn.mha(tq, tk, tv, mask=mask), atol=0, rtol=0)
    want = jfa.flash_mha(*(jnp.asarray(x) for x in (q, k, v)), mask=jattn.causal_mask(16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(got, flash_mha(tq, tk, tv, causal=True), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(tattn.mha(tq, tk, tv, backend="pallas", causal=True), flash_mha(tq, tk, tv, causal=True), atol=0, rtol=0)
    assert LAUNCHES == before


def test_flash_mha_dispatch_on_cpu():
    """A CPU tensor takes the plain versions in both directions, with no
    launch counted; the kernel entries refuse CPU tensors."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, 2, 17, 17, 32, seed=3))
    before = dict(LAUNCHES)
    o, lse = flash_mha_reference(q, k, v)
    torch.testing.assert_close(flash_mha(q, k, v), o, atol=0, rtol=0)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash_mha(*leaves).backward(do)
    for leaf, want in zip(leaves, flash_mha_bwd_reference(q, k, v, o, lse, do)):
        torch.testing.assert_close(leaf.grad, want, atol=0, rtol=0)
    assert LAUNCHES == before
    with pytest.raises(ValueError):
        flash_mha_cuda(q, k, v)
    with pytest.raises(ValueError):
        flash_mha_bwd_cuda(q, k, v, o, lse, do)


@pytest.mark.parametrize("name", ["o", "do", "dq", "dk", "dv"])
def test_check_alignment_refuses_a_misaligned_head_split_tensor(name):
    """The bf16 flash backward reads o and dO and writes dq, dk and dv as
    [B, H, N, Dh] views of [B, N, H, Dh] buffers, 16 bytes at a time: one that
    starts 2 bytes into its storage, or whose head stride is no multiple of 8
    elements, is refused by name, whichever of the five it is; aligned views
    and fp32 tensors pass."""
    b, h, n, dh = 2, 2, 5, 32

    def heads_last(offset=0, pad=0, dtype=torch.bfloat16):
        flat = torch.zeros(offset + b * n * h * (dh + pad), dtype=dtype)
        return flat[offset:].view(b, n, h, dh + pad)[..., :dh].transpose(1, 2)

    good = {key: heads_last() for key in ("q", "k", "v", "o", "do", "dq", "dk", "dv")}
    check_alignment("flash_mha_bwd_dq_cuda", **good)
    shifted = heads_last(offset=1)
    assert shifted.shape == (b, h, n, dh) and shifted.data_ptr() % 16 == 2 and shifted.stride(-1) == 1
    with pytest.raises(ValueError, match=f"bf16 {name} in 16-byte pieces"):
        check_alignment("flash_mha_bwd_dq_cuda", **{**good, name: shifted})
    with pytest.raises(ValueError, match=f"bf16 {name} in 16-byte pieces"):
        check_alignment("flash_mha_bwd_dkv_cuda", **{**good, name: heads_last(pad=4)})  # head stride Dh + 4
    check_alignment("flash_mha_bwd_dq_cuda", **{**good, name: heads_last(offset=1, dtype=torch.float32)})
