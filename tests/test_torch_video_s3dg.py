"""The port's S3D-G backbone against the JAX package's, as
tests/test_torch_video_resnet3d.py holds the ResNet3D family: Inception3D at
its own widths (they are fixed in the architecture) with self-gating, 8
frames of 32 px.  Eval predictions at 1e-4, train-mode
logits at 1e-4 and gradients at 2e-4, fp32."""

import pytest
import torch

from tests.torch_video_parity import check_eval, check_names, check_train

torch.set_num_threads(2)

CASES = {
    "s3dg": ("s3dg", 8, (), 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_eval_predictions_match_jax(case):
    preset, frames, overrides, alpha = CASES[case]
    check_eval(preset, frames, overrides, alpha)


@pytest.mark.parametrize("case", list(CASES))
def test_train_logits_and_gradients_match_jax(case):
    preset, frames, overrides, alpha = CASES[case]
    check_train(preset, frames, overrides, alpha)


@pytest.mark.parametrize("case", list(CASES))
def test_state_dict_names_and_parameter_groups_match_jax(case):
    preset, frames, overrides, _ = CASES[case]
    check_names(preset, frames, overrides)
