"""The plain version of each stage-ablation mode of the port's
``clip_fsar_torch.tools.fa_decomp`` against the JAX tool's Pallas kernel of
that mode (``tools/_fa_decomp.py``: ``make_kernel(mode)`` through ``impl``),
run in interpret mode on the CPU.

``tools/`` is no package, so the JAX tool is loaded by path; its ``impl``
calls ``pl.pallas_call`` directly, hence ``pallas_interpret``.  Inputs are
scaled by 0.02, as both tools scale theirs, so exp(s) needs no row max.
Tolerances: 1e-5 in fp32 (summation order), 2e-2 in bf16 (the rounding of p
and of the output), each as a share of the reference's largest value: the
outputs are as small as 3e-5 at these inputs, so an absolute tolerance would
pass anything.
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import REPO, pallas_interpret

from clip_fsar_torch.ops.fused_attention import clip_mha_reference
from clip_fsar_torch.tools import fa_decomp

SHAPE, HEADS = (2, 17, 192), 2  # Dh = 32


@functools.lru_cache(maxsize=None)
def _jax_tool():
    spec = importlib.util.spec_from_file_location("_fa_decomp", os.path.join(REPO, "tools", "_fa_decomp.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _qkv():
    return (np.random.RandomState(0).randn(*SHAPE) * fa_decomp.INPUT_SCALE).astype(np.float32)


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("mode", fa_decomp.MODES)
def test_plain_mode_matches_the_jax_kernel(mode, dtype, tol):
    tool = _jax_tool()
    qkv = _qkv()
    with pallas_interpret():
        want = tool.impl(tool.make_kernel(mode), jnp.asarray(qkv, dtype=getattr(jnp, dtype)), HEADS)
    xt = torch.from_numpy(qkv).to(getattr(torch, dtype))
    got = fa_decomp.fa_decomp_reference(xt, HEADS, mode)
    assert got.dtype == xt.dtype and got.shape == (SHAPE[0], SHAPE[1], SHAPE[2] // 3)
    fa_decomp.assert_close_to_scale(got, torch.from_numpy(np.array(want.astype(jnp.float32))), tol, f"{mode} {dtype}")
    if mode == "full":  # the shipped kernel's plain version, not a copy of it
        torch.testing.assert_close(got, clip_mha_reference(xt, HEADS)[0], atol=0, rtol=0)


def test_modes_differ_as_designed():
    """nomax is softmax attention when no max is needed; exp is nomax without the divide; matmul
    has no exponential: the three are different functions, and nomax equals full at these inputs."""
    xt = torch.from_numpy(_qkv())
    out = {mode: fa_decomp.fa_decomp_reference(xt, HEADS, mode) for mode in fa_decomp.MODES}
    torch.testing.assert_close(out["nomax"], out["full"], atol=1e-6, rtol=1e-6)
    assert (out["exp"] - out["nomax"]).abs().max() > 1e-3
    assert (out["matmul"] - out["exp"]).abs().max() > 1e-3


@pytest.mark.parametrize("wrong", ["zeros", "half", "sign"])
def test_scaled_tolerance_rejects_wrong_outputs(wrong):
    """The comparison the kernels are held with is not vacuous at these magnitudes: zeros, a
    mis-scaled and a sign-flipped output all fail it in every ablated mode, in fp32 and bf16."""
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        xt = torch.from_numpy(_qkv()).to(dtype)
        for mode in fa_decomp.ABLATED:
            ref = fa_decomp.fa_decomp_reference(xt, HEADS, mode)
            assert fa_decomp.assert_close_to_scale(ref, ref, tol) == 0.0
            bad = {"zeros": torch.zeros_like(ref), "half": ref * 0.5, "sign": -ref}[wrong]
            with pytest.raises(AssertionError):
                fa_decomp.assert_close_to_scale(bad, ref, tol, mode)
    with pytest.raises(AssertionError):
        fa_decomp.assert_close_to_scale(torch.zeros(3), torch.zeros(3), 1e-4)  # nothing to compare


def test_launcher_refuses_cpu_tensors_and_unknown_modes():
    xt = torch.from_numpy(_qkv())
    before = dict(fa_decomp.LAUNCHES)
    with pytest.raises(ValueError):
        fa_decomp.fa_decomp_cuda(xt, HEADS, "matmul")  # a CPU tensor: no fallback to the plain version
    with pytest.raises(ValueError):
        fa_decomp.fa_decomp_reference(xt, HEADS, "softmax")
    assert fa_decomp.LAUNCHES == before


def test_tool_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tool would run for real")
    with pytest.raises(SystemExit):
        fa_decomp.main([])
