"""The port's video transformers and EPIC's two-head BaseHeadx2 against the
JAX package's, as tests/test_torch_video_resnet3d.py holds the ResNet3D
family: TimeSformer (divided space-time attention), ViViT and the ViViT
factorized encoder (DEPTH 2, width 32, 4 heads, dropout off; the encoder
also at an eval crop whose patch grid differs from the train grid, so its
position table is resized), and BaseHeadx2 on R2D3D.  S3D-G and SlowFast are
in tests/test_torch_video_s3dg_slowfast.py.  Eval predictions at 1e-4,
train-mode logits at 1e-4 and gradients at 2e-4, fp32."""

import pytest
import torch

from tests.torch_video_parity import SMALL_RESNET, SMALL_TRANSFORMER, check_eval, check_names, check_train

torch.set_num_threads(2)

# case -> (preset, frames, overrides, slow pathway handed in as a pair at this alpha, or 0)
CASES = {
    "timesformer": ("timesformer", 4, SMALL_TRANSFORMER, 0),
    "vivit": ("vivit", 4, SMALL_TRANSFORMER, 0),
    "vivit_fac_enc": ("vivit_fac_enc", 4, SMALL_TRANSFORMER + (("VIDEO.BACKBONE.DEPTH_TEMP", 2),), 0),
    "epic_base_head_x2": ("r2d3ds", 4, SMALL_RESNET + (("VIDEO.BACKBONE.DEPTH", 10), ("VIDEO.HEAD.NAME", "BaseHeadx2"),
                                                      ("VIDEO.HEAD.NUM_CLASSES", (3, 4))), 0),
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


def test_factorized_encoder_resizes_its_position_table_for_another_crop():
    """Eval at 48 px under TRAIN_CROP_SIZE 32: a 3x3 patch grid for a 2x2
    table, resized bilinearly as jax.image.resize does."""
    preset, frames, overrides, _ = CASES["vivit_fac_enc"]
    check_eval(preset, frames, overrides, 0, 48)
