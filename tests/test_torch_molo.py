"""The MoLo head (CNN_BiMHM_MoLo) of clip_fsar_torch against clip_fsar_tpu,
built through the port's builder from the shipped MoLo 1-shot config at a
tiny size: the bilinear resize, the eval forward on the tiny ViT and RN CLIP
towers, the train forward with its decoder's batch statistics on the
torchvision resnet18 trunk, three train steps with every loss term, the
train step on a frozen trunk, the parameter groups; then the shipped HyRSM++
and MoLo configs through the port's CLI, and the JAX package's ``.npz``
archives of both heads.  float32, the JAX weights carried over by
``params_from_jax``, inputs from a numpy seed, dropout off."""

import os
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_fsar_torch.models.clip.convert import params_from_jax
from clip_fsar_torch.models.clip.model import BatchNorm
from clip_fsar_torch.train import optimizer as topt
from tests.test_torch_fsheads import (
    HYRSM_5SHOT,
    TINY,
    assert_outputs_match,
    assert_train_steps_match,
    episodes,
    jax_episode,
    jax_head,
    jax_outputs,
    jax_train_steps,
    port_episode,
    port_head,
    port_train_steps,
)
from tests.torch_parity import REPO, host_reads

torch.set_num_threads(2)

MOLO_1SHOT = os.path.join(REPO, "configs", "projects", "MoLo", "hmdb51", "MoLo_HMDB51_1shot_v1.yaml")
MOLO = "CNN_BiMHM_MoLo"
DECODER_STATS = [f"up{i}.bn.{k}" for i in (1, 2, 3) for k in ("running_mean", "running_var")]


@pytest.mark.parametrize("size_in, size_out", [((3, 5), (6, 10)), ((4, 4), (16, 16)), ((9, 9), (10, 10)), ((10, 12), (7, 5))],
                         ids=["x2", "x4", "up_ragged", "down_antialiased"])
def test_resize_matches_jax_image_resize(size_in, size_out):
    """``resize_bilinear`` against ``jax.image.resize(..., "bilinear")``:
    whole-factor upscales (the UpBlocks), a ragged upscale and an
    antialiased downscale (MoLo's final resize where the ratio does not
    divide), fp32 at 1e-5."""
    from clip_fsar_torch.models.heads.molo import resize_bilinear

    x = np.random.RandomState(sum(size_out)).randn(2, *size_in, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *size_out, 3), method="bilinear"))
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), size_out).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("backbone", ["ViT-Tiny-Test", "RN-Tiny-Test"])
def test_molo_eval_matches_jax(backbone):
    """The eval branch on a CLIP tower's token grid (the RN tower's through
    its ``c_proj_tokens``), built through build_few_shot_model from the
    shipped config: logits, class logits, the four contrastive logits and a
    zero loss_recons at 1e-4."""
    model = port_head(MOLO_1SHOT, MOLO, backbone)
    want = jax_outputs(MOLO_1SHOT, MOLO, backbone)
    with torch.no_grad():
        got = model.head(port_episode(episodes()), model.text_train, model.text_test, train=False)
    assert got["logits"].shape == got["logits_s2q_motion"].shape == (2, 6, 3)
    assert_outputs_match(got, want)
    assert (got["loss_recons"] == 0).all()


def _jax_train_forward(backbone, res):
    """The JAX head's train branch vmapped over two episodes (mutable batch_stats, dropout off)."""
    head, variables = jax_head(MOLO_1SHOT, MOLO, backbone) if res == 64 else _jax_head_at(backbone, res)
    run = jax.jit(jax.vmap(lambda ep: head.apply(variables, ep, train=True, rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])))
    with mock.patch.object(fnn.Dropout, "__call__", lambda self, x, *a, **k: x):
        out, mutated = run(jax_episode(episodes(res=res, seed=4)))
    return variables, jax.device_get(out), jax.device_get(mutated["batch_stats"])


def _jax_head_at(backbone, res):
    """The JAX MoLo head initialised at ``res`` px (random running stats)."""
    import clip_fsar_tpu.models.builder  # noqa: F401
    from clip_fsar_tpu.utils.registry import HEAD_REGISTRY as JREG

    from tests.test_torch_fsheads import head_cfg
    from tests.torch_parity import random_batch_stats

    cfg = head_cfg(MOLO_1SHOT, MOLO, "VIDEO.HEAD.BACKBONE_NAME", backbone, "DATA.TRAIN_CROP_SIZE", str(res), package="jax")
    head = JREG.get(MOLO)(cfg)
    variables = jax.device_get(jax.jit(lambda ep: head.init(jax.random.PRNGKey(0), ep, train=False))(jax_episode(episodes(res=res), 0)))
    return head, {**variables, "batch_stats": random_batch_stats(variables["batch_stats"])}


@pytest.mark.parametrize("res", [64, 80], ids=["ratio_divides", "final_resize"])
def test_molo_train_forward_matches_jax(res):
    """The train branch on the resnet18 trunk (frozen running stats): logits,
    the four contrastive logits and loss_recons at 1e-4, and each episode's
    decoder running stats after its support and target calls against the
    JAX head's mutated batch_stats at 1e-5.  At 80 px the trunk's 3 x 3 map
    is decoded to 72 px and resized to 80."""
    from clip_fsar_torch.models.builder import build_few_shot_model
    from tests.test_torch_fsheads import head_cfg

    variables, want, mutated = _jax_train_forward("resnet18", res)
    model = build_few_shot_model(head_cfg(MOLO_1SHOT, MOLO, "VIDEO.HEAD.BACKBONE_NAME", "resnet18", "DATA.TRAIN_CROP_SIZE", str(res)),
                                 flow="train", device="cpu")
    head = model.head
    head.load_state_dict(params_from_jax(variables))
    got = head(port_episode(episodes(res=res, seed=4)), model.text_train, model.text_test, train=True)
    assert_outputs_match(got, want)
    assert float(got["loss_recons"].detach().min()) > 0
    assert head.live_batch_norms() == [head.up1.bn, head.up2.bn, head.up3.bn]
    for g in range(2):
        new = params_from_jax({"params": variables["params"], "batch_stats": jax.tree_util.tree_map(lambda x: x[g], mutated)})
        for i, name in enumerate(("up1", "up2", "up3")):
            bn = getattr(head, name).bn
            for j, key in enumerate(("running_mean", "running_var")):
                np.testing.assert_allclose(bn.step_stats[g, j].detach().numpy(), new[f"{name}.bn.{key}"].numpy(), atol=1e-5, rtol=1e-5,
                                           err_msg=f"{name} {key} episode {g}")
    assert all(m.step_stats is None for m in head.backbone.modules() if isinstance(m, BatchNorm))  # the trunk ran on its running stats


# SGD with the config's Nesterov momentum at lr 1e-4, whose update is linear in the gradient: Adam turns a gradient
# element at rounding-noise level into a step of lr either way, and the next step's decoder batch statistics see it
# (the first step's gradients agree within 7e-5 under Adam, measured); tests/test_torch_rn.py makes the same choice
SGD = ["SOLVER.OPTIM_METHOD", "sgd", "SOLVER.BASE_LR", "1e-4"]


def test_molo_three_train_steps_match_jax():
    """Three MoLo 1-shot train steps on the resnet18 trunk (E = 2 in two
    episode chunks) with every loss term of the shipped config: CE,
    USE_CLASSIFICATION_VALUE 0.4 * class CE, USE_CONTRASTIVE_COFF 0.05 * CE
    of each contrastive logit, RECONS_COFF 0.05 * BATCH_SIZE 4 *
    loss_recons; losses at 1e-4, gradients at 2e-4, and after every step the
    decoder's running stats at 1e-5, the frozen trunk's unchanged.  Both
    packages run a smooth activation in place of ReLU here
    (``tests/test_torch_rn.py::_smooth_relu``): with ReLU, the trunk's and the
    decoder's activations that lie within the packages' roundings of 0 flip
    from the second step on (0.3 % of the first conv's gradient, measured);
    the forward tests and the CLI run ReLU."""
    from tests.test_torch_rn import _smooth_relu

    with _smooth_relu():
        cfg, variables, batches, want_losses, want_grads, want_stats = jax_train_steps(MOLO_1SHOT, MOLO, "resnet18", extra=SGD)
        head, losses, grads, stats = port_train_steps(MOLO_1SHOT, MOLO, variables, batches, "resnet18", extra=SGD)
    assert cfg.TRAIN.USE_CONTRASTIVE and cfg.TRAIN.USE_RECONS and cfg.TRAIN.USE_CLASSIFICATION
    assert_train_steps_match(want_losses, want_grads, losses, grads)
    start = params_from_jax(variables)
    for got, want in zip(stats, want_stats):
        assert set(got) == set(want)
        for name, v in got.items():
            torch.testing.assert_close(v, want[name], atol=1e-5, rtol=1e-5, msg=lambda m, name=name: f"{name}: {m}")
            assert torch.equal(v, start[name]) == name.startswith("backbone."), name


def test_molo_train_step_on_a_frozen_trunk_commits_the_decoder_stats_only():
    """The train step lists only the BatchNorms that run on batch statistics:
    MoLo's three decoder BatchNorms, not its trunk's 20 (which never get
    step statistics); a step with dropout and its generator moves the
    decoder's running stats and leaves the trunk's, and reads no tensor
    value back to python."""
    from clip_fsar_torch.train.state import TrainState
    from clip_fsar_torch.train.step import make_train_step
    from tests.test_torch_fsheads import TRAIN_OPTS, head_cfg, port_batch

    model = port_head(MOLO_1SHOT, MOLO, "resnet18")
    head = model.head
    assert len([m for m in head.backbone.modules() if isinstance(m, BatchNorm)]) == 20
    assert head.live_batch_norms() == [head.up1.bn, head.up2.bn, head.up3.bn]
    cfg = head_cfg(MOLO_1SHOT, MOLO, "VIDEO.HEAD.BACKBONE_NAME", "resnet18", *TRAIN_OPTS)
    state = TrainState.create(cfg, head, topt.Optimizer(cfg, head))
    before = {k: v.clone() for k, v in head.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    batch = port_batch(jax_episode(episodes(seed=5)))
    batch = batch.replace(support_images=(batch.support_images * 40 + 128).clamp(0, 255).to(torch.uint8),
                          target_images=(batch.target_images * 40 + 128).clamp(0, 255).to(torch.uint8))
    with host_reads() as reads:  # nor does the step read a value back (it would wait for the card there)
        metrics = make_train_step(head, cfg, model.text_train, model.text_test)(state, batch, 1e-3, torch.Generator().manual_seed(0))
    assert reads == []
    assert torch.isfinite(metrics["loss"]) and bool(metrics["updated"])
    for k, v in head.state_dict().items():
        if k in before:
            assert torch.equal(v, before[k]) == k.startswith("backbone."), k


@pytest.mark.parametrize("backbone", ["ViT-Tiny-Test", "resnet18"])
def test_molo_param_groups_match_jax(backbone):
    """Every MoLo parameter (class tokens, temperatures, the decoder's
    BatchNorms, the 3-D conv) in its JAX group and with its decay."""
    from tests.test_torch_fsheads import _code_groups

    model = port_head(MOLO_1SHOT, MOLO, backbone)
    code, coded, decay = _code_groups(jax_head(MOLO_1SHOT, MOLO, backbone)[1]["params"])
    names = [n for n, _ in model.head.named_parameters()]
    groups = topt.param_groups(names, "head")
    assert set(coded) == set(names) and {"class_token", "scale", "scale_motion", "motion_reduce.weight", "up1.bn.weight"} <= set(names)
    for n in names:
        assert (coded[n] == code[groups[n]]).all(), n
        assert (decay[n] == float(groups[n] in ("rest", "head"))).all(), n


# ---------------------------------------------------------------------------
# the shipped configs through the CLI, and the JAX package's weight archives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", [HYRSM_5SHOT, MOLO_1SHOT], ids=["hyrsm_pp_5shot", "molo_1shot"])
def test_shipped_config_trains_and_tests_through_the_cli(tmp_path, path):
    """A shipped HyRSM++ and a shipped MoLo config, their resnet50 trunk as
    written, through the port's CLI on the CPU at 64 px and 4 frames: 2
    train episodes (one update each), then the test protocol on 2 episodes
    from the last checkpoint.  Finite losses and logits; MoLo's checkpoint
    holds decoder running stats that moved."""
    from clip_fsar_torch.runs.run import main

    opts = [o for i, o in enumerate(TINY) if TINY[i - (i % 2)] != "VIDEO.HEAD.BACKBONE_NAME"]
    opts += ["DATA.ANNO_DIR", os.path.dirname(path) + "/", "TRAIN.NUM_TRAIN_TASKS", "2", "TPU.EPISODES_PER_STEP", "1",
             "TRAIN.BATCH_SIZE_PER_TASK", "1", "TRAIN.NUM_TEST_TASKS", "2", "TEST.BATCH_SIZE", "2", "OUTPUT_DIR", str(tmp_path)]
    results = main(["--cfg", path, "--device", "cpu", *opts])
    train, test = results["train_few_shot"], results["test_few_shot"]
    assert len(train["losses"]) == 2 and np.isfinite(train["losses"]).all() and train["updates"] == 2
    assert test["weights"].endswith("2.pt") and test["episodes"] == 2 and np.isfinite(test["episode_logits"]).all()
    saved = torch.load(test["weights"], map_location="cpu", weights_only=True)["head"]
    if path == MOLO_1SHOT:
        assert all(not torch.equal(saved[f"up1.bn.{k}"], torch.full_like(saved[f"up1.bn.{k}"], float(k == "running_var")))
                   for k in ("running_mean", "running_var"))


@pytest.mark.parametrize("path, name, backbone", [(HYRSM_5SHOT, "CNN_HyRSM_plusplus_5shot", "ViT-Tiny-Test"), (MOLO_1SHOT, MOLO, "resnet18")],
                         ids=["hyrsm_pp_5shot", "molo_1shot"])
def test_npz_archive_of_a_classic_head_loads_every_entry(tmp_path, path, name, backbone):
    """The JAX package's ``save_weights_npz`` archive of a classic head (and
    of MoLo with its ``batch_stats/``) through the port's checkpoint loader:
    every head entry comes back bit for bit."""
    from clip_fsar_tpu.train.pretrain import save_weights_npz

    from clip_fsar_torch.train.checkpoint import load_checkpoint_file

    variables = jax_head(path, name, backbone)[1]
    archive = str(tmp_path / "head.npz")
    save_weights_npz(archive, variables)
    head = port_head(path, name, backbone).head
    want = params_from_jax(variables)
    for p in head.parameters():
        torch.nn.init.zeros_(p)
    assert set(head.state_dict()) == set(want) and load_checkpoint_file(archive, head)
    for key, value in head.state_dict().items():
        assert torch.equal(value, want[key]), key
