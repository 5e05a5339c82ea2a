"""The port's SlowFast backbones against the JAX package's, as
tests/test_torch_video_resnet3d.py holds the ResNet3D family: SlowFast 8x8
and 4x16 (10-bottleneck, narrow; one input tensor, whose slow pathway is
subsampled inside, and a [slow, fast] pair).  Eval predictions at 1e-4,
train-mode logits at 1e-4 and gradients at 2e-4, fp32."""

import pytest
import torch

from tests.torch_video_parity import as_port, check_eval, check_names, check_train, jax_case, port_model

torch.set_num_threads(2)

SLOWFAST = (("VIDEO.BACKBONE.NUM_FILTERS", (16, 32, 32, 64, 64)), ("VIDEO.BACKBONE.DEPTH", "10"))
# case -> (preset, frames, overrides, slow pathway handed in as a pair at this alpha, or 0)
CASES = {
    "slowfast_8x8": ("slowfast_8x8", 8, SLOWFAST, 0),
    "slowfast_8x8_pair": ("slowfast_8x8", 8, SLOWFAST, 4),
    "slowfast_4x16": ("slowfast_4x16", 16, SLOWFAST, 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_eval_predictions_match_jax(case):
    preset, frames, overrides, alpha = CASES[case]
    check_eval(preset, frames, overrides, alpha)


@pytest.mark.parametrize("case", list(CASES))
def test_train_logits_and_gradients_match_jax(case):
    preset, frames, overrides, alpha = CASES[case]
    check_train(preset, frames, overrides, alpha)


@pytest.mark.parametrize("case", [c for c in CASES if not c.endswith("_pair")])
def test_state_dict_names_and_parameter_groups_match_jax(case):
    preset, frames, overrides, _ = CASES[case]
    check_names(preset, frames, overrides)


def test_slowfast_single_tensor_input_subsamples_slow():
    """One input tensor gives the pair [x[:, ::alpha], x] (JAX meta.py:200-206):
    the same predictions as the pair handed in."""
    preset, frames, overrides, _ = CASES["slowfast_8x8"]
    want = jax_case(preset, frames, overrides, 0, 32)
    model = port_model(preset, frames, overrides, want["variables"])
    with torch.no_grad():
        one = model(as_port(want["x"], 0), train=False)[0]
        pair = model(as_port(want["x"], 4), train=False)[0]
    torch.testing.assert_close(one, pair, atol=0, rtol=0)
