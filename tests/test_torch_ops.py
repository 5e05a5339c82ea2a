"""clip_fsar_torch ops against clip_fsar_tpu: the clip_mha plain versions,
forward and backward, against the JAX Pallas kernels (interpret mode on the
CPU), mha, OTAM, cos_sim and class_mean.  Inputs are numpy arrays from a
seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_fsar_tpu.models.heads import common as jcommon
from clip_fsar_tpu.ops import attention as jattn
from clip_fsar_tpu.ops import fused_attention as jfa
from clip_fsar_tpu.ops import otam as jotam
from clip_fsar_torch.models.heads import common as tcommon
from clip_fsar_torch.ops import attention as tattn
from clip_fsar_torch.ops import otam as totam
from clip_fsar_torch.ops.flash_attention import _auto_block
from clip_fsar_torch.ops.fused_attention import (
    BWD_RESIDENT_MAX,
    SINGLE_BLOCK_MAX,
    backward_branch,
    check_alignment,
    clip_mha,
    clip_mha_bwd_cuda,
    clip_mha_bwd_reference,
    clip_mha_cuda,
    clip_mha_reference,
    forward_branch,
)

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [50, 197])
def test_clip_mha_reference_matches_jax_kernel(n, dtype):
    """K1's plain version vs the Pallas kernel it stands for.  fp32: 2e-5
    (summation order); bf16: one bf16 ulp of the output (both round p
    before P.V and O at the end, at the same points)."""
    heads, dh, b = 2, 64, 2
    qkv = np.random.RandomState(n).randn(b, n, 3 * heads * dh).astype(np.float32)
    o_j, lse_j = jfa._fwd_impl(jnp.asarray(qkv, dtype), heads)
    o_t, lse_t = clip_mha_reference(torch.from_numpy(qkv).to(getattr(torch, dtype)), heads)
    tol = 2e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(o_t.float().numpy(), np.asarray(o_j, np.float32), atol=tol, rtol=tol)
    # JAX keeps the LSE per head in the lane axis of [B, N, 128]
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[:, :, :heads].transpose(0, 2, 1), atol=2e-5, rtol=2e-5)
    assert o_t.dtype == getattr(torch, dtype) and o_t.shape == (b, n, heads * dh)


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("n", [77, 257])
def test_clip_mha_reference_matches_jax_kernel_on_both_branches(n, dtype, tol):
    """The same at the lengths that send the bf16 CUDA kernel down its two
    branches: N = 77 (one block of scores) and N = 257 (ViT-L/14, key tiles
    and two passes).  The function is one: the plain version and the Pallas
    kernel both round p against the exact row max whatever the length.  fp32
    at 1e-5 (summation order), bf16 at 2e-2 (one rounding of p and of O)."""
    heads, dh, b = 2, 64, 1
    qkv = np.random.RandomState(n).randn(b, n, 3 * heads * dh).astype(np.float32)
    o_j, lse_j = jfa._fwd_impl(jnp.asarray(qkv, dtype), heads)
    o_t, lse_t = clip_mha_reference(torch.from_numpy(qkv).to(getattr(torch, dtype)), heads)
    np.testing.assert_allclose(o_t.float().numpy(), np.asarray(o_j, np.float32), atol=tol, rtol=tol)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[:, :, :heads].transpose(0, 2, 1), atol=1e-5, rtol=1e-5)


def test_forward_branch_follows_the_key_block():
    """The bf16 forward kernels' branch is a function of the key count alone:
    one block of scores exactly where the JAX flash kernels' ``_auto_block``
    is a single block (n <= 256), key tiles of 128 above, where ``_auto_block``
    gives 128; the port's ``_auto_block`` is the JAX one."""
    from clip_fsar_tpu.ops import flash_attention as jflash

    assert SINGLE_BLOCK_MAX == 256
    for n in range(1, 1200):
        assert _auto_block(n) == jflash._auto_block(n)
        branch = forward_branch(n)
        assert branch == forward_branch(n) == ("single" if _auto_block(n) >= n else "tiled")
        assert (branch == "tiled") == (_auto_block(n) == 128 and n > 128)
    assert [forward_branch(n) for n in (17, 50, 77, 197, 256, 257, 577)] == ["single"] * 5 + ["tiled"] * 2


def test_backward_branch_follows_the_length():
    """The bf16 backward's branch is a function of the sequence length alone:
    the other side's operands of a head stay in shared memory while 2
    operands x n rows x 64 x 2 bytes and two fp32 statistics a row fit a
    CTA's 232,448 bytes in whole tiles of 64 rows; longer sequences are
    staged.  Every ViT length of the repo is resident."""
    per_row = 2 * 64 * 2 + 2 * 4
    assert BWD_RESIDENT_MAX % 64 == 0 and BWD_RESIDENT_MAX * per_row <= 232448 < (BWD_RESIDENT_MAX + 64) * per_row
    for n in range(1, 2000):
        assert backward_branch(n) == ("resident" if n <= BWD_RESIDENT_MAX else "staged")
    assert [backward_branch(n) for n in (17, 50, 77, 197, 257, 577, 832, 833, 1100)] == ["resident"] * 7 + ["staged"] * 2


def test_check_alignment_refuses_a_misaligned_bf16_output_gradient():
    """The bf16 backward copies rows of dO 16 bytes at a time: a dO that
    starts 2 bytes into its storage, or whose row stride is no multiple of 8
    elements, is refused by name; an aligned one and any fp32 tensor pass."""
    b, n, d = 2, 5, 64
    flat = torch.zeros(1 + b * n * d, dtype=torch.bfloat16)
    shifted = flat[1:].view(b, n, d)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="bf16 do in 16-byte pieces"):
        check_alignment("clip_mha_bwd_cuda", o=flat[:-1].view(b, n, d), do=shifted)
    with pytest.raises(ValueError, match="bf16 do"):
        check_alignment("clip_mha_bwd_cuda", do=torch.zeros(b, n, d + 4, dtype=torch.bfloat16)[..., :d])
    check_alignment("clip_mha_bwd_cuda", o=flat[:-1].view(b, n, d), do=flat[:-1].view(b, n, d), dqkv=torch.zeros(b, n, 3 * d, dtype=torch.bfloat16))
    check_alignment("clip_mha_bwd_cuda", do=torch.zeros(1 + b * n * d)[1:].view(b, n, d))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [17, 50, 197])
def test_clip_mha_bwd_reference_matches_jax_kernel(n, dtype):
    """K2's plain version vs the Pallas backward it stands for, on the JAX
    forward's o and lse.  fp32: 1e-5 (summation order; measured 7e-7);
    bf16: 1e-2, one bf16 ulp of values near 1 (dS, P and the outputs are
    rounded at the same points, so a rare product lands one ulp apart)."""
    heads, dh, b = 2, 64, 2
    rng = np.random.RandomState(n)
    qkv = rng.randn(b, n, 3 * heads * dh).astype(np.float32)
    do = rng.randn(b, n, heads * dh).astype(np.float32)
    q_j = jnp.asarray(qkv, dtype)
    o_j, lse_j = jfa._fwd_impl(q_j, heads)
    (want,) = jfa._bwd_impl(q_j, o_j, lse_j, jnp.asarray(do, dtype), heads)
    tdt = getattr(torch, dtype)
    o_t = torch.from_numpy(np.array(o_j.astype(jnp.float32))).to(tdt)
    lse_t = torch.from_numpy(np.asarray(lse_j)[:, :, :heads].transpose(0, 2, 1).copy())  # [B, N, 128] lanes -> [B, H, N]
    got = clip_mha_bwd_reference(torch.from_numpy(qkv).to(tdt), o_t, lse_t, torch.from_numpy(do).to(tdt), heads)
    assert got.dtype == tdt and got.shape == (b, n, 3 * heads * dh)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


def test_clip_mha_grad_matches_autograd_of_plain_attention():
    """clip_mha's backward on a CPU tensor (the plain K2) against torch
    autograd of plain softmax attention, fp32 at 2e-6."""
    b, n, heads, dh = 2, 19, 3, 32
    rng = np.random.RandomState(4)
    qkv = torch.from_numpy(rng.randn(b, n, 3 * heads * dh).astype(np.float32))
    do = torch.from_numpy(rng.randn(b, n, heads * dh).astype(np.float32))
    x = qkv.clone().requires_grad_(True)
    clip_mha(x, heads).backward(do)
    y = qkv.clone().requires_grad_(True)
    q, k, v = y.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4).unbind(0)
    out = torch.softmax(q @ k.transpose(-1, -2) * dh**-0.5, dim=-1) @ v
    out.transpose(1, 2).reshape(b, n, heads * dh).backward(do)
    torch.testing.assert_close(x.grad, y.grad, atol=2e-6, rtol=2e-6)


def test_clip_mha_dispatch_on_cpu():
    """A CPU tensor takes the plain versions in both directions, with no
    launch counted; the kernel entries refuse CPU tensors."""
    qkv = torch.from_numpy(np.random.RandomState(0).randn(2, 17, 3 * 64).astype(np.float32))
    do = torch.from_numpy(np.random.RandomState(1).randn(2, 17, 64).astype(np.float32))
    before = (clip_mha_cuda.launches, clip_mha_bwd_cuda.launches)
    torch.testing.assert_close(clip_mha(qkv, 2), clip_mha_reference(qkv, 2)[0], atol=0, rtol=0)
    x = qkv.clone().requires_grad_(True)
    clip_mha(x, 2).backward(do)
    o, lse = clip_mha_reference(qkv, 2)
    torch.testing.assert_close(x.grad, clip_mha_bwd_reference(qkv, o, lse, do, 2), atol=0, rtol=0)
    assert (clip_mha_cuda.launches, clip_mha_bwd_cuda.launches) == before
    with pytest.raises(ValueError):
        clip_mha_cuda(qkv, 2)
    with pytest.raises(ValueError):
        clip_mha_bwd_cuda(qkv, o, lse, do, 2)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("backend", ["plain", "plain:bf16"])
def test_mha_matches_jax(backend, causal):
    """fp32 softmax path at 2e-5; the compute-dtype softmax (bf16 inputs)
    at 2e-2, bf16 rounding of logits and probabilities."""
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(2, 3, 19, 32).astype(np.float32) for _ in range(3))
    dt = "bfloat16" if backend == "plain:bf16" else "float32"
    jbackend = {"plain": "xla", "plain:bf16": "xla:bf16"}[backend]
    want = jattn.mha(*(jnp.asarray(x, dt) for x in (q, k, v)), backend=jbackend, causal=causal)
    got = tattn.mha(*(torch.from_numpy(x).to(getattr(torch, dt)) for x in (q, k, v)), backend=backend, causal=causal)
    tol = 2e-5 if dt == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)
    x = rng.randn(2, 19, 96).astype(np.float32)
    np.testing.assert_array_equal(tattn.split_heads(torch.from_numpy(x), 3).numpy(), np.asarray(jattn.split_heads(jnp.asarray(x), 3)))
    np.testing.assert_array_equal(tattn.merge_heads(tattn.split_heads(torch.from_numpy(x), 3)).numpy(), x)


@pytest.mark.parametrize("single_direction", [False, True])
def test_otam_matches_jax(single_direction):
    """OTAM soft-min recurrence on an 8x8 grid and a non-square 4x6 one, fp32 at 1e-5."""
    rng = np.random.RandomState(2)
    for shape in ((3, 5, 8, 8), (2, 4, 6)):
        d = rng.rand(*shape).astype(np.float32)
        want = jotam.otam_distance(jnp.asarray(d), single_direction=single_direction)
        got = totam.otam_distance(torch.from_numpy(d), single_direction=single_direction)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_cos_sim_and_class_mean_match_jax():
    """cos_sim with epsilon on the norm product, and the class-id-ordered
    mean, unbatched and with a leading episode axis; fp32 at 1e-6."""
    rng = np.random.RandomState(3)
    x, y = rng.randn(6, 16).astype(np.float32), rng.randn(4, 16).astype(np.float32)
    np.testing.assert_allclose(
        tcommon.cos_sim(torch.from_numpy(x), torch.from_numpy(y)).numpy(), np.asarray(jcommon.cos_sim(jnp.asarray(x), jnp.asarray(y))),
        atol=1e-6, rtol=1e-6,
    )
    feats = rng.randn(2, 10, 4, 8).astype(np.float32)
    labels = np.stack([rng.permutation(np.repeat(np.arange(5), 2)) for _ in range(2)]).astype(np.int32)
    got = tcommon.class_mean(torch.from_numpy(feats), torch.from_numpy(labels), 5)
    for e in range(2):
        want = jcommon.class_mean(jnp.asarray(feats[e]), jnp.asarray(labels[e]), 5)
        np.testing.assert_allclose(got[e].numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(
            tcommon.class_mean(torch.from_numpy(feats[e]), torch.from_numpy(labels[e]), 5).numpy(), np.asarray(want), atol=1e-6, rtol=1e-6
        )
