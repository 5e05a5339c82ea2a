"""MoLo's bilinear resize (``clip_fsar_torch.models.heads.molo.resize_bilinear``,
one weight matrix per axis applied by matrix products) against
``jax.image.resize(..., "bilinear")`` on the CPU: the decoder's whole-factor
upscales at the shipped MoLo sizes (7 -> 14 -> 56 -> 224 of a 224 px
ResNet-50 map), a ragged upscale, antialiased shrinks, and the gradient of
each through ``jax.vjp``; fp32 at 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_fsar_torch.models.heads.molo import resize_bilinear

torch.set_num_threads(2)

SIZES = [((7, 7), (14, 14)), ((14, 14), (56, 56)), ((56, 56), (224, 224)), ((5, 3), (11, 13)), ((224, 224), (112, 112)),
         ((17, 23), (7, 5)), ((8, 8), (8, 20))]


@pytest.mark.parametrize("size_in, size_out", SIZES, ids=[f"{a[0]}x{a[1]}-{b[0]}x{b[1]}" for a, b in SIZES])
def test_resize_and_its_gradient_match_jax(size_in, size_out):
    rng = np.random.RandomState(size_in[0] * 31 + size_out[1])
    x = rng.randn(2, 3, *size_in).astype(np.float32)
    g = rng.randn(2, 3, *size_out).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jax.image.resize(v, (2, 3, *size_out), method="bilinear"), jnp.asarray(x))
    (want_grad,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = resize_bilinear(xt, size_out)
    got.backward(torch.from_numpy(g))
    assert got.shape == (2, 3, *size_out)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_grad), atol=1e-5, rtol=1e-5)


def test_resize_keeps_a_channels_last_map_and_its_dtype():
    """A channels-last bf16 map (the decoder's conv output layout and compute type) resizes to the same
    values as its contiguous fp32 copy, rounded once."""
    x = torch.randn(2, 4, 7, 7).to(memory_format=torch.channels_last)
    got = resize_bilinear(x.bfloat16(), (14, 14))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 4, 14, 14)
    torch.testing.assert_close(got.float(), resize_bilinear(x.contiguous(), (14, 14)), atol=3e-2, rtol=1e-2)
