"""The port's CUDA kernels against their plain-torch versions, on the card.

Skips without a CUDA device (the kernels have no CPU mode).  On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Imports no JAX, so it also runs where only torch is installed.
"""

import pytest
import torch

from clip_fsar_torch.ops.fused_attention import (
    clip_mha,
    clip_mha_bwd_cuda,
    clip_mha_bwd_reference,
    clip_mha_cuda,
    clip_mha_reference,
)

# atol = rtol: summation order (fp32); rounding of p, dS and the outputs to bf16 (bf16)
TOLERANCE = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]
# (320, 197, 12, 64): the ViT-B/16 test slice's batch of 4 episodes x 10 clips x 8 frames;
# (480, 197, 12, 64): the train slice's micro-batch of 2 episodes x 30 clips x 8 frames
SHAPES = [(2, 50, 12, 64), (2, 197, 12, 64), (320, 197, 12, 64), (2, 257, 16, 64), (1, 577, 16, 64), (3, 17, 2, 32)]
BWD_SHAPES = [(2, 50, 12, 64), (2, 197, 12, 64), (480, 197, 12, 64), (2, 257, 16, 64), (1, 577, 16, 64), (3, 17, 2, 32)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the clip_mha kernels have no CPU mode")
    from clip_fsar_torch import runtime

    return runtime.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", TOLERANCE)
@pytest.mark.parametrize("b, n, h, dh", SHAPES)
def test_clip_mha_kernel_matches_plain(cuda, b, n, h, dh, dtype, tol):
    g = torch.Generator().manual_seed(n)
    qkv = torch.randn(b, n, 3 * h * dh, generator=g).to(cuda, dtype)
    before = clip_mha_cuda.launches
    o, lse = clip_mha_cuda(qkv, h)
    torch.cuda.synchronize()
    assert clip_mha_cuda.launches == before + 1
    ref_o, ref_lse = clip_mha_reference(qkv, h)
    torch.testing.assert_close(o.float(), ref_o.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(clip_mha(qkv, h), o, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", TOLERANCE)
@pytest.mark.parametrize("b, n, h, dh", BWD_SHAPES)
def test_clip_mha_bwd_kernel_matches_plain(cuda, b, n, h, dh, dtype, tol):
    """K2 against clip_mha_bwd_reference on the forward kernel's o and lse;
    one launch counted per call, and the autograd backward of clip_mha is
    the kernel's result."""
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
    torch.testing.assert_close(dqkv.float(), ref.float(), atol=tol, rtol=tol)
    x = qkv.clone().requires_grad_(True)
    clip_mha(x, h).backward(do)
    assert clip_mha_bwd_cuda.launches == before + 2
    torch.testing.assert_close(x.grad, dqkv, atol=0, rtol=0)


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
