"""The train steps run their forward and backward with cuDNN's deterministic convolution algorithms
(``runtime.deterministic_convolutions``), so that a step repeats bit for bit on the card; the flag is restored
after each step.  On the CPU the flag changes no result: these tests read its value from hooks inside the steps."""

import os

import torch

from clip_fsar_torch import runtime
from tests.torch_parity import REPO

torch.set_num_threads(2)


def _flag_recorder(module, seen):
    """Forward and backward hooks on ``module`` that record the cuDNN determinism flag when each runs."""
    module.register_forward_hook(lambda *_: seen.append(("forward", torch.backends.cudnn.deterministic)))
    module.register_full_backward_hook(lambda *_: seen.append(("backward", torch.backends.cudnn.deterministic)))


def test_deterministic_convolutions_sets_and_restores_the_flag():
    before = torch.backends.cudnn.deterministic
    for outer in (False, True):
        torch.backends.cudnn.deterministic = outer
        with runtime.deterministic_convolutions():
            assert torch.backends.cudnn.deterministic
        assert torch.backends.cudnn.deterministic == outer

        @runtime.deterministic_convolutions()
        def inside():
            return torch.backends.cudnn.deterministic

        assert inside() and inside() and torch.backends.cudnn.deterministic == outer
    torch.backends.cudnn.deterministic = before


def test_classification_train_step_runs_its_backward_under_deterministic_convolutions():
    from clip_fsar_torch.config.config import load_config
    from clip_fsar_torch.models.video.model import build_video_model
    from clip_fsar_torch.train.classification import make_classification_train_step, step_generator
    from clip_fsar_torch.train.optimizer import Optimizer
    from clip_fsar_torch.train.state import TrainState

    cfg = load_config(os.path.join(REPO, "configs", "classification", "TAda2D_K400.yaml"),
                      ["VIDEO.BACKBONE.DEPTH", "26", "VIDEO.BACKBONE.NUM_FILTERS", "[8, 16, 16, 32, 32]", "VIDEO.HEAD.NUM_CLASSES", "4",
                       "DATA.NUM_INPUT_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32"])
    model = build_video_model(cfg, device="cpu")
    seen = []
    _flag_recorder(model.backbone.conv1, seen)
    state = TrainState.create(cfg, model, Optimizer(cfg, model, name_prefix=""))
    videos = torch.randint(0, 256, (2, 4, 32, 32, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(0))
    torch.backends.cudnn.deterministic = False
    make_classification_train_step(model, cfg)(state, videos, torch.arange(2, dtype=torch.int32), 1e-3, step_generator(cfg, 0, 0, "cpu"))
    assert seen == [("forward", True), ("backward", True)] and not torch.backends.cudnn.deterministic


def test_few_shot_grad_fn_runs_its_backward_under_deterministic_convolutions():
    from clip_fsar_torch.config.config import load_config
    from clip_fsar_torch.data.loader import build_few_shot_loader
    from clip_fsar_torch.models.builder import build_few_shot_model
    from clip_fsar_torch.train.loop import step_generator
    from clip_fsar_torch.train.step import make_grad_fn
    from tests.torch_parity import CONFIG, TINY_OPTS

    cfg = load_config(CONFIG, TINY_OPTS + ["VIDEO.HEAD.BACKBONE_NAME", "RN-Tiny-Test", "TPU.EPISODES_PER_STEP", "2", "TPU.EPISODE_CHUNKS", "2"])
    with build_few_shot_loader(cfg, "train", num_steps=1, episodes_per_step=2) as loader:
        batch = next(iter(loader)).to("cpu")
    model = build_few_shot_model(cfg, flow="train", device="cpu")
    seen = []
    _flag_recorder(model.head.backbone.conv1, seen)
    torch.backends.cudnn.deterministic = False
    make_grad_fn(model.head, cfg, model.text_train, model.text_test)(batch, step_generator(cfg, 0, "cpu"))
    # two episode chunks: each chunk's forward (the support and the target call) and its backward
    assert {flag for _, flag in seen} == {True} and ("backward", True) in seen and not torch.backends.cudnn.deterministic
