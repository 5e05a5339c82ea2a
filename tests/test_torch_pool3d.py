"""The port's 3-D pools (clip_fsar_torch/ops/pool3d.py) against the JAX package's flax pools, on the CPU.

The forward is ATen's; the backward is the plain version of the ``pool3d_bwd`` kernel (a sum over the window's
offsets, in a fixed order, of strided slices).  Held to ``jax.grad`` of ``nn.max_pool`` / ``nn.avg_pool`` at fp32
1e-6 (sums of at most 27 terms in another order), at the four max-pool shapes the video backbones use
(DownSampleStem's and S3D-G's (1,3,3)/(1,2,2)/(0,1,1), S3D-G's (3,3,3)/1/1 branch pool and its two stage pools) and
TAdaConv's (3,1,1)/1/(1,0,0) average pool; on NCDHW and channels_last_3d inputs; on tied windows (the gradient
goes to the first maximum in window order on both sides); and on negative inputs, where padding by -inf differs
from padding by 0.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from clip_fsar_torch.ops import pool3d

torch.set_num_threads(2)

# (kernel, stride, padding): the max-pool sites of the video backbones
MAX_SHAPES = [((1, 3, 3), (1, 2, 2), (0, 1, 1)), ((3, 3, 3), (1, 1, 1), (1, 1, 1)), ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
              ((2, 2, 2), (2, 2, 2), (0, 0, 0))]
# TAdaConvBlockAvgPool's POOL_K [3, 1, 1] at stride 1, and a window that overlaps on every axis
AVG_SHAPES = [((3, 1, 1), (1, 1, 1), (1, 0, 0)), ((3, 3, 3), (1, 1, 1), (1, 1, 1))]
X_SHAPE = (2, 5, 9, 8, 3)  # NDHWC: odd extents leave positions no window covers at stride 2
TOL = 1e-6


def _jax_pool(kind, x, kernel, stride, padding):
    pool = nn.max_pool if kind == "max" else nn.avg_pool
    return pool(x, kernel, strides=stride, padding=[(p, p) for p in padding])


def _jax_value_and_grad(kind, x_ndhwc, g_ndhwc, kernel, stride, padding):
    """The JAX pool of x and the gradient of <pool(x), g> with respect to x, both NDHWC numpy."""
    y, vjp = jax.vjp(lambda x: _jax_pool(kind, x, kernel, stride, padding), jnp.asarray(x_ndhwc))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(g_ndhwc))[0])


def _torch_value_and_grad(kind, x_ndhwc, g_ndhwc, kernel, stride, padding, channels_last):
    """The port's pool and its gradient on the NCDHW view of the same values, returned NDHWC."""
    x = torch.from_numpy(x_ndhwc).permute(0, 4, 1, 2, 3)
    x = x.contiguous(memory_format=torch.channels_last_3d) if channels_last else x.contiguous()
    x.requires_grad_(True)
    y = (pool3d.max_pool3d if kind == "max" else pool3d.avg_pool3d)(x, kernel, stride, padding)
    y.backward(torch.from_numpy(g_ndhwc).permute(0, 4, 1, 2, 3))
    assert x.grad.is_contiguous(memory_format=torch.channels_last_3d if channels_last else torch.contiguous_format)
    return y.detach().permute(0, 2, 3, 4, 1).numpy(), x.grad.permute(0, 2, 3, 4, 1).numpy()


def _check(kind, x, kernel, stride, padding, channels_last, seed=1):
    g = np.random.default_rng(seed).standard_normal(_jax_pool(kind, jnp.asarray(x), kernel, stride, padding).shape).astype(np.float32)
    want_y, want_dx = _jax_value_and_grad(kind, x, g, kernel, stride, padding)
    got_y, got_dx = _torch_value_and_grad(kind, x, g, kernel, stride, padding, channels_last)
    np.testing.assert_allclose(got_y, want_y, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_dx, want_dx, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("channels_last", [False, True], ids=["ncdhw", "channels_last"])
@pytest.mark.parametrize("kernel, stride, padding", MAX_SHAPES, ids=["stem", "branch", "stage_s2", "stage_k2"])
def test_max_pool_matches_jax(kernel, stride, padding, channels_last):
    x = np.random.default_rng(0).standard_normal(X_SHAPE).astype(np.float32)
    _check("max", x, kernel, stride, padding, channels_last)


@pytest.mark.parametrize("kernel, stride, padding", MAX_SHAPES, ids=["stem", "branch", "stage_s2", "stage_k2"])
def test_max_pool_ties_go_to_the_first_maximum_as_in_jax(kernel, stride, padding):
    """Values from {0, 1, 2}: nearly every window holds its maximum more than once."""
    x = np.random.default_rng(2).integers(0, 3, X_SHAPE).astype(np.float32)
    _check("max", x, kernel, stride, padding, channels_last=True)


def test_max_pool_on_an_all_ones_plane():
    """Every window of an all-ones [4, 4] plane is a tie: the gradient lands on each window's first element in
    window order, on both sides (with a gradient of ones, the top-left 2 x 2 block takes one window each)."""
    x = np.ones((1, 1, 4, 4, 1), np.float32)
    kernel, stride, padding = MAX_SHAPES[0]
    g = np.ones((1, 1, 2, 2, 1), np.float32)
    _, want = _jax_value_and_grad("max", x, g, kernel, stride, padding)
    _, got = _torch_value_and_grad("max", x, g, kernel, stride, padding, channels_last=False)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 0, :, :, 0], [[1, 1, 0, 0], [1, 1, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]])


@pytest.mark.parametrize("kernel, stride, padding", MAX_SHAPES, ids=["stem", "branch", "stage_s2", "stage_k2"])
def test_max_pool_pads_by_minus_infinity_as_jax(kernel, stride, padding):
    """All inputs below -1: a zero-padded pool would return 0 at every border window and send no gradient there."""
    x = (-1.5 - np.random.default_rng(3).random(X_SHAPE)).astype(np.float32)
    _check("max", x, kernel, stride, padding, channels_last=False)
    if any(padding):  # the case is one: padded by 0, the border windows would read 0
        t = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
        zero_padded = F.max_pool3d(F.pad(t, [p for p in reversed(padding) for _ in (0, 1)]), kernel, stride)
        assert (zero_padded == 0).any() and not (pool3d.max_pool3d(t, kernel, stride, padding) == 0).any()


@pytest.mark.parametrize("channels_last", [False, True], ids=["ncdhw", "channels_last"])
@pytest.mark.parametrize("kernel, stride, padding", AVG_SHAPES, ids=["tada_pool_k", "cube"])
def test_avg_pool_matches_jax(kernel, stride, padding, channels_last):
    """count_include_pad: the divisor is the whole window, padded zeros included, as flax's nn.avg_pool."""
    x = np.random.default_rng(4).standard_normal(X_SHAPE).astype(np.float32)
    _check("avg", x, kernel, stride, padding, channels_last)


@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("kernel, stride, padding", MAX_SHAPES + AVG_SHAPES)
def test_plain_backward_matches_torch_autograd(kind, kernel, stride, padding):
    """The forward is ATen's, bit for bit, and the plain backward agrees with autograd through F's pools at
    fp32 1e-6 (torch's CPU backward sums in another order)."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 3, 6, 7, 9)).astype(np.float32))
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    if kind == "max":
        ya, yb = pool3d.max_pool3d(a, kernel, stride, padding), F.max_pool3d(b, kernel, stride, padding)
    else:
        ya, yb = pool3d.avg_pool3d(a, kernel, stride, padding), F.avg_pool3d(b, kernel, stride, padding, count_include_pad=True)
    assert torch.equal(ya, yb)
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(ya.shape).astype(np.float32))
    ya.backward(g)
    yb.backward(g)
    torch.testing.assert_close(a.grad, b.grad, rtol=TOL, atol=TOL)


def test_bf16_backward_sums_in_fp32_and_rounds_once():
    """bf16 dy: the plain backward equals the fp32 backward of the same dy rounded once to bf16."""
    kernel, stride, padding = MAX_SHAPES[1]
    x = torch.from_numpy(np.random.default_rng(7).integers(0, 3, (1, 2, 4, 5, 6)).astype(np.float32))  # ties: sums of many terms
    _, argmax = F.max_pool3d(x, kernel, stride, padding, return_indices=True)
    dy = torch.from_numpy(np.random.default_rng(8).standard_normal(argmax.shape).astype(np.float32)).bfloat16()
    got = pool3d.max_pool3d_bwd_reference(dy, argmax, x.shape, kernel, stride, padding)
    want = pool3d.max_pool3d_bwd_reference(dy.float(), argmax, x.shape, kernel, stride, padding).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_kernel_wrapper_takes_only_cuda_tensors():
    dy = torch.zeros(1, 1, 2, 2, 2)
    with pytest.raises(ValueError, match="CUDA"):
        pool3d.pool3d_bwd_cuda("max", dy, dy.long(), (1, 1, 4, 4, 4), 2, 2, 0, False)
