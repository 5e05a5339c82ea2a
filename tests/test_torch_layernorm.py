"""The port's layer_norm (its plain versions, on CPU tensors) against the JAX
package's layer_norm, whose Pallas kernels run in interpret mode on the CPU
(clip_fsar_tpu/ops/fused_layernorm.py:37-40 turns it on by itself).

The same numpy-seeded inputs go through both.  Tolerances are those of
tests/test_fused_layernorm.py: 1e-5 for the fp32 forward, 2e-4 for the
gradients (fp32 summation order), 2e-2 for a bf16 output (one rounding).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_fsar_tpu.models.clip.model import LayerNorm as JaxLayerNorm
from clip_fsar_tpu.ops.fused_layernorm import layer_norm as jax_layer_norm

from clip_fsar_torch.models.clip import convert
from clip_fsar_torch.ops import fused_layernorm
from clip_fsar_torch.ops.fused_layernorm import layer_norm, layer_norm_bwd_reference, layer_norm_reference

EPS = 1e-5


@functools.lru_cache(maxsize=None)
def _jax_fwd():
    return jax.jit(lambda x, g, b: jax_layer_norm(x, g, b, EPS))


@functools.lru_cache(maxsize=None)
def _jax_grads():
    return jax.jit(jax.grad(lambda x, g, b, w: jnp.sum(jax_layer_norm(x, g, b, EPS).astype(jnp.float32) * w), argnums=(0, 1, 2)))


def _inputs(seed, shape, scale=1.0):
    rng = np.random.RandomState(seed)
    d = shape[-1]
    x = (rng.randn(*shape) * scale).astype(np.float32)
    return x, (rng.rand(d) + 0.5).astype(np.float32), rng.randn(d).astype(np.float32), rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(512, 256), (197, 256), (1300, 256), (3, 70, 128)],
                         ids=["one-block", "padded", "multi-block-padded", "batch-axis"])
def test_forward_matches_jax(shape):
    x, g, b, _ = _inputs(0, shape)
    want = np.asarray(_jax_fwd()(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)))
    before = dict(fused_layernorm.LAUNCHES)
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b), EPS)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert fused_layernorm.LAUNCHES == before  # CPU tensors: the plain version, no kernel launch


def test_gradients_match_jax():
    x, g, b, w = _inputs(1, (300, 128))
    want = _jax_grads()(*(jnp.asarray(a) for a in (x, g, b, w)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, g, b)]
    (layer_norm(*leaves, EPS) * torch.from_numpy(w)).sum().backward()
    for name, leaf, ref in zip(("dx", "dg", "db"), leaves, want):
        assert leaf.grad.dtype == torch.float32 and leaf.grad.shape == leaf.shape, name
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4, err_msg=name)
    # the autograd backward is the plain K7
    dx, dg, db = layer_norm_bwd_reference(leaves[0].detach(), leaves[1].detach(), torch.from_numpy(w), EPS)
    for leaf, ref in zip(leaves, (dx, dg, db)):
        torch.testing.assert_close(leaf.grad, ref, atol=0, rtol=0)


def test_bf16_input_fp32_statistics():
    """bf16 x with fp32 g, b: a bf16 y and dx, fp32 dg and db, as the JAX op returns them."""
    x, g, b, w = _inputs(2, (640, 128), scale=3.0)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    np.testing.assert_array_equal(np.asarray(xj.astype(jnp.float32)), xt.float().numpy())  # the same bf16 values on both sides
    want = _jax_fwd()(xj, jnp.asarray(g), jnp.asarray(b))
    assert want.dtype == jnp.bfloat16
    leaves = [xt.clone().requires_grad_(True), torch.from_numpy(g).requires_grad_(True), torch.from_numpy(b).requires_grad_(True)]
    got = layer_norm(*leaves, EPS)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=2e-2, atol=2e-2)
    want_grads = _jax_grads()(xj, jnp.asarray(g), jnp.asarray(b), jnp.asarray(w))
    (got.float() * torch.from_numpy(w)).sum().backward()
    assert [leaf.grad.dtype for leaf in leaves] == [torch.bfloat16, torch.float32, torch.float32]
    np.testing.assert_allclose(leaves[0].grad.float().numpy(), np.asarray(want_grads[0].astype(jnp.float32)), rtol=2e-2, atol=2e-2)
    # dg and db sum 640 rows of bf16-rounded dy: the sums' size sets the tolerance
    for leaf, ref in zip(leaves[1:], want_grads[1:]):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), rtol=2e-2, atol=2e-1)


def test_constant_row_clamps_the_variance():
    """A row of one value: mean(x*x) - mu*mu is 0 up to rounding and is clamped at 0, so y = b and
    dx = 0 on both sides, with nothing infinite."""
    x, g, b, w = _inputs(3, (8, 128))
    x[2] = 2.5
    x[5] = -1024.0
    want = np.asarray(_jax_fwd()(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, g, b)]
    got = layer_norm(*leaves, EPS)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy()[[2, 5]], np.stack([b, b]), rtol=0, atol=1e-6)
    (got * torch.from_numpy(w)).sum().backward()
    want_grads = _jax_grads()(*(jnp.asarray(a) for a in (x, g, b, w)))
    for leaf, ref in zip(leaves, want_grads):
        assert torch.isfinite(leaf.grad).all()
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


def test_converted_parameters_of_a_jax_layernorm():
    """weight and bias as the port's converter takes them out of a JAX LayerNorm's variables
    ({"LayerNorm_0": {"scale", "bias"}}): the port's layer_norm on them agrees with the JAX
    module, with the JAX op, and with the port's own LayerNorm module."""
    from clip_fsar_torch.models.clip.model import LayerNorm

    x, g, b, _ = _inputs(4, (197, 64))
    module = JaxLayerNorm()
    fresh = module.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    assert set(fresh) == {"LayerNorm_0"} and set(fresh["LayerNorm_0"]) == {"scale", "bias"}
    variables = {"params": {"LayerNorm_0": {"scale": g, "bias": b}}}  # the module's tree, with values that are not 1 and 0
    sd = {}
    convert._norm(sd, "ln", variables["params"])
    assert sd["ln.weight"].dtype == torch.float32 and sd["ln.weight"].shape == (64,)
    got = layer_norm(torch.from_numpy(x), sd["ln.weight"], sd["ln.bias"], EPS)
    np.testing.assert_allclose(got.numpy(), np.asarray(module.apply(variables, jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(_jax_fwd()(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))), rtol=1e-5, atol=1e-5)
    port = LayerNorm(64)
    port.load_state_dict({"weight": sd["ln.weight"], "bias": sd["ln.bias"]})
    torch.testing.assert_close(got, port(torch.from_numpy(x)), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_plain_versions_against_float64_autograd(dtype):
    """layer_norm_reference and layer_norm_bwd_reference against torch autograd of the formula in
    float64 on the same (rounded) inputs: the math, independently of the JAX package."""
    x, g, b, w = _inputs(5, (70, 96))
    xt = torch.from_numpy(x).to(dtype)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    ref = [xt.double().requires_grad_(True), torch.from_numpy(g).double().requires_grad_(True), torch.from_numpy(b).double().requires_grad_(True)]
    mu = ref[0].mean(-1, keepdim=True)
    y = (ref[0] - mu) / torch.sqrt(ref[0].var(-1, unbiased=False, keepdim=True) + EPS) * ref[1] + ref[2]
    dy = torch.from_numpy(w).to(dtype)
    y.backward(dy.double())
    torch.testing.assert_close(layer_norm_reference(xt, ref[1].detach().float(), ref[2].detach().float(), EPS).double(), y.detach(),
                               atol=tol, rtol=tol)
    dx, dg, db = layer_norm_bwd_reference(xt, torch.from_numpy(g), dy, EPS)
    assert dx.dtype == dtype and dg.dtype == db.dtype == torch.float32
    torch.testing.assert_close(dx.double(), ref[0].grad, atol=tol, rtol=tol)
    torch.testing.assert_close(dg.double(), ref[1].grad, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(db.double(), ref[2].grad, atol=1e-4, rtol=1e-4)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The launchers take CUDA tensors only: there is no fallback from a kernel to its plain version."""
    x = torch.zeros(4, 64)
    with pytest.raises(ValueError):
        fused_layernorm.layer_norm_cuda(x, torch.ones(64), torch.zeros(64))
    with pytest.raises(ValueError):
        fused_layernorm.layer_norm_bwd_cuda(x, torch.ones(64), x)
