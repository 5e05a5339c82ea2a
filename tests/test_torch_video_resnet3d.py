"""The port's ResNet3D video backbones against the JAX package's, through
``build_video_model`` of both on the same random weights (the JAX variables
perturbed, zero-initialized kernels included, with random BatchNorm running
statistics, converted by ``models/video/convert.params_from_jax``): R2D3D
(DEPTH 10 simple blocks), R(2+1)D (DEPTH 18 simple, DEPTH 26 bottleneck),
TAda2D (26-bottleneck TAdaConv blocks: the calibration off 1 and the pooled
branch's BatchNorm scale off 0), ir-CSN (grouped convs), a NonLocal stage,
and TAda2D under BN.EPS 1e-3, which both packages ignore (eps 1e-5), at 4
frames of 32 px and narrow widths.  Eval predictions at 1e-4, train-mode
logits at 1e-4 and gradients at 2e-4, fp32."""

import pytest
import torch

from tests.torch_video_parity import SMALL_RESNET, check_eval, check_names, check_train

torch.set_num_threads(2)

CASES = {
    "r2d3d_10": ("r2d3ds", SMALL_RESNET + (("VIDEO.BACKBONE.DEPTH", 10),)),
    "r2plus1d_18": ("r2p1d", SMALL_RESNET + (("VIDEO.BACKBONE.DEPTH", 18),)),
    "r2plus1d_26_bottleneck": ("r2p1d", SMALL_RESNET + (("VIDEO.BACKBONE.DEPTH", "26"),)),
    "tada2d_26": ("tada2d", SMALL_RESNET + (("VIDEO.BACKBONE.DEPTH", "26"),)),
    "csn_26": ("csn", SMALL_RESNET + (("VIDEO.BACKBONE.DEPTH", "26"),)),
    "nonlocal_stages_4_5": ("r2d3ds", SMALL_RESNET + (("VIDEO.BACKBONE.DEPTH", 10), ("VIDEO.BACKBONE.NONLOCAL.ENABLE", True),
                                                      ("VIDEO.BACKBONE.NONLOCAL.STAGES", (4, 5)))),
    "tada2d_26_bn_eps_1e-3": ("tada2d", SMALL_RESNET + (("VIDEO.BACKBONE.DEPTH", "26"), ("BN.EPS", 1e-3))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_eval_predictions_match_jax(case):
    preset, overrides = CASES[case]
    check_eval(preset, overrides=overrides)


@pytest.mark.parametrize("case", list(CASES))
def test_train_logits_and_gradients_match_jax(case):
    preset, overrides = CASES[case]
    check_train(preset, overrides=overrides)


@pytest.mark.parametrize("case", list(CASES))
def test_state_dict_names_and_parameter_groups_match_jax(case):
    preset, overrides = CASES[case]
    check_names(preset, overrides=overrides)


def test_batch_norm_ignores_bn_eps_and_never_trains():
    """As the JAX package's ``bn`` (blocks.py:92-93): eps 1e-5 whatever BN.EPS
    says, and the running statistics in train mode too, unchanged by a step."""
    from tests.torch_video_parity import configs

    from clip_fsar_torch.models.video.blocks import BatchNorm
    from clip_fsar_torch.models.video.model import build_video_model

    _, cfg = configs("tada2d", overrides=CASES["tada2d_26_bn_eps_1e-3"][1])
    model = build_video_model(cfg)
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    assert norms and all(m.eps == 1e-5 for m in norms)
    before = {k: v.clone() for k, v in model.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    model(torch.rand(2, 4, 32, 32, 3), train=True)[0].sum().backward()
    assert all(torch.equal(model.state_dict()[k], v) for k, v in before.items())


def test_fresh_tada_block_calibrates_by_exactly_one():
    """RouteFuncMLP's last conv starts at zero and the pooled branch's BatchNorm
    scale at 0, so a fresh TAda block's calibration is exactly 1."""
    from tests.torch_video_parity import configs

    from clip_fsar_torch.models.video.branches import RouteFuncMLP
    from clip_fsar_torch.models.video.model import build_video_model

    _, cfg = configs("tada2d", overrides=CASES["tada2d_26"][1])
    model = build_video_model(cfg)
    rf = next(m for m in model.modules() if isinstance(m, RouteFuncMLP))
    x = torch.rand(2, rf.g.weight.shape[1], 4, 8, 8)
    assert torch.equal(rf(x), torch.ones(2, rf.g.weight.shape[0], 4))
    assert all(float(m.b_avgpool_bn.weight.abs().max()) == 0.0 for m in model.modules() if hasattr(m, "b_avgpool_bn"))
