"""Reference-framework checkpoints (``.pyth`` / ``.pth``) in clip_fsar_torch
(models/convert_reference.py, train/checkpoint.py) against the JAX package's
``load_reference_checkpoint``: a file written here from the tiny CLIP-FSAR
model under the reference's key names (``model_state``, ``module.head.``,
``context2.layers.{i}.{0,1}``, BatchNorm step counters), on the tiny ViT and
the tiny RN tower, loaded through TEST.CHECKPOINT_FILE_PATH, gives the JAX
head's logits on the same episodes at 1e-4 (fp32).  Also: the formats are
told apart by content, a classic head refuses a reference file naming
itself, a tower of another arch is refused, and the port's own ``.pt``
files load as before."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_fsar_torch.config.config import load_config
from clip_fsar_torch.data.types import Episode
from clip_fsar_torch.models.builder import build_few_shot_model
from clip_fsar_torch.models.convert_reference import (
    convert_clipfsar_state_dict,
    is_reference_checkpoint,
    load_reference_checkpoint,
    reference_state_dict,
)
from clip_fsar_torch.models.heads.clipfsar import CLIPFSARConfig, CLIPFSARHead
from clip_fsar_torch.train.checkpoint import Checkpointer, load_checkpoint_file, load_test_weights, save_checkpoint
from tests.torch_parity import CONFIG, REPO, TINY_OPTS, jax_tiny_model, port_head_state

torch.set_num_threads(2)

BACKBONES = ["ViT-Tiny-Test", "RN-Tiny-Test"]
HYRSM_5SHOT = os.path.join(REPO, "configs", "projects", "hyrsmplusplus", "hmdb51", "HyRSMplusplus_HMDB51_5shot_v1.yaml")
# the port's TransformerV1 names -> the reference's Transformer_v1 names (few_shot.py:979-999)
TO_REFERENCE = [("norm_{i}.", "layers.{i}.0.norm."), ("attn_{i}.to_out.", "layers.{i}.0.fn.to_out.0."), ("attn_{i}.", "layers.{i}.0.fn."),
                ("ff_{i}.fc1.", "layers.{i}.1.net.0."), ("ff_{i}.fc2.", "layers.{i}.1.net.3.")]


def _opts(backbone):
    return [*TINY_OPTS, "VIDEO.HEAD.BACKBONE_NAME", backbone]


def reference_state(head_state, prefix="module.head."):
    """A port head state dict under the reference's names: the context2 layers renamed, a step counter
    beside every BatchNorm's running stats, everything under ``prefix``."""
    out = {}
    for key, value in head_state.items():
        if key.startswith("text."):
            continue
        if key.startswith("context2."):
            rest = key[len("context2."):]
            i = rest.split(".")[0].split("_")[-1]
            for port, ref in TO_REFERENCE:
                if rest.startswith(port.format(i=i)):
                    rest = ref.format(i=i) + rest[len(port.format(i=i)):]
                    break
            key = "context2." + rest
        out[prefix + key] = value
        if key.endswith(".running_var"):
            out[prefix + key[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    return out


def _perturbed_state(backbone):
    """The JAX tiny model's weights moved off their init by noise from a seed (so that a head loads them or
    shows that it did not), as the port's head state with its text tower."""
    _, _, clip_vars, model = jax_tiny_model(backbone=backbone)
    rng = np.random.RandomState(5)
    return {k: v + torch.from_numpy(rng.normal(0.0, 0.02, v.shape).astype(np.float32)) if k.endswith("weight") else v
            for k, v in port_head_state(model, clip_vars).items()}


def _episodes(num=2, way=5, frames=4, res=64, seed=0):
    rng = np.random.RandomState(seed)
    eps = []
    for _ in range(num):
        classes = rng.choice(10, size=way, replace=False)
        s_lab, q_lab = rng.permutation(way), rng.permutation(way)
        eps.append(dict(support_images=rng.randn(way, frames, res, res, 3).astype(np.float32), support_labels=s_lab.astype(np.int32),
                        real_support_labels=classes[s_lab].astype(np.int32), target_images=rng.randn(way, frames, res, res, 3).astype(np.float32),
                        target_labels=q_lab.astype(np.int32), real_target_labels=classes[q_lab].astype(np.int32),
                        batch_class_list=classes.astype(np.int32)))
    return {k: np.stack([e[k] for e in eps]) for k in eps[0]}


def _jax_logits(backbone, variables, batch):
    from clip_fsar_tpu.data.types import Episode as JEpisode

    _, _, _, model = jax_tiny_model(backbone=backbone)
    run = jax.jit(jax.vmap(lambda ep: model.head.apply(variables, ep, model.text_train, model.text_test, train=False)["logits"]))
    return np.asarray(run(JEpisode(**{k: jnp.asarray(v) for k, v in batch.items()})))


@pytest.mark.parametrize("backbone", BACKBONES)
def test_pyth_through_the_test_path_gives_the_jax_logits(tmp_path, backbone):
    """A ``.pyth`` as the reference writes it ({"model_state": ..., "epoch", "cfg"}, ``module.head.`` keys)
    named by TEST.CHECKPOINT_FILE_PATH: the port's test-time search loads it into a fresh head, whose eval
    logits on two episodes equal the JAX head's with JAX ``load_reference_checkpoint``'s variables at 1e-4."""
    from clip_fsar_tpu.models.convert_reference import load_reference_checkpoint as jax_load

    path = str(tmp_path / "checkpoint_epoch_00010.pyth")
    state = _perturbed_state(backbone)
    torch.save({"epoch": 10, "model_state": reference_state(state), "cfg": "TRAIN:\n  ENABLE: true\n"}, path)
    cfg = load_config(CONFIG, _opts(backbone) + ["TEST.CHECKPOINT_FILE_PATH", path, "OUTPUT_DIR", str(tmp_path / "out")])
    _, arch, _, jmodel = jax_tiny_model(backbone=backbone)
    head = CLIPFSARHead(arch, CLIPFSARConfig.from_cfg(cfg))
    assert load_test_weights(cfg, head) == path
    loaded = load_reference_checkpoint(path, arch)
    for key, value in head.state_dict().items():
        assert torch.equal(value, state[key]) and torch.equal(loaded[key], value), key
    batch = _episodes()
    with torch.no_grad():
        text = [torch.from_numpy(np.array(t)) for t in (jmodel.text_train, jmodel.text_test)]
        got = head(Episode(**{k: torch.from_numpy(v) for k, v in batch.items()}), *text, train=False)["logits"].numpy()
    want = _jax_logits(backbone, jax_load(path), batch)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("layout", ["module.head.", "head.", "bare", "pt_suffix"])
def test_reference_files_are_told_apart_by_content(tmp_path, layout):
    """The reference's layouts (DDP's ``module.head.``, a single-process ``head.``, a bare head state dict
    in its names) are read, whatever the suffix: a reference file named ``.pt`` is one too; the port's own
    ``{"head": ...}`` files are not."""
    state = _perturbed_state("ViT-Tiny-Test")
    prefix = {"module.head.": "module.head.", "head.": "head.", "bare": "", "pt_suffix": "module.head."}[layout]
    blob = reference_state(state, prefix)
    if layout != "bare":
        blob = {"model_state": blob}
    path = str(tmp_path / ("ckpt.pt" if layout == "pt_suffix" else "ckpt.pth"))
    torch.save(blob, path)
    assert is_reference_checkpoint(blob) and not is_reference_checkpoint({"head": {k: v for k, v in state.items() if not k.startswith("text.")}})
    _, arch, _, _ = jax_tiny_model()
    head = CLIPFSARHead(arch, CLIPFSARConfig.from_cfg(load_config(CONFIG, TINY_OPTS)))
    assert load_checkpoint_file(path, head, "CNN_OTAM_CLIPFSAR")
    for key, value in head.state_dict().items():
        assert torch.equal(value, state[key]), key
    assert not any(k.endswith("num_batches_tracked") for k in convert_clipfsar_state_dict(reference_state(_perturbed_state("RN-Tiny-Test"))))
    if layout == "module.head.":  # the port's own writer of the reference's names (chip_smoke.py's .pyth) gives the same dict
        port_state = {k: v for k, v in state.items() if not k.startswith("text.")}
        assert reference_state_dict(port_state).keys() == reference_state(port_state).keys()


def test_classic_head_refuses_a_reference_file_and_names_itself(tmp_path):
    """The reference mapping covers CNN_OTAM_CLIPFSAR only (as the JAX package's): a HyRSM++ config whose
    TEST.CHECKPOINT_FILE_PATH is a reference file raises, naming its head."""
    path = str(tmp_path / "hyrsm.pyth")
    torch.save({"model_state": {"module.head.backbone.conv1.weight": torch.zeros(8, 3, 7, 7)}}, path)
    opts = ["VIDEO.HEAD.BACKBONE_NAME", "resnet18", "DATA.NUM_INPUT_FRAMES", "4", "DATA.TEST_CROP_SIZE", "64", "DATA.DECODER", "synthetic",
            "DATA.ANNO_DIR", os.path.dirname(HYRSM_5SHOT) + "/", "TEST.CHECKPOINT_FILE_PATH", path, "OUTPUT_DIR", str(tmp_path / "out")]
    cfg = load_config(HYRSM_5SHOT, opts)
    head = build_few_shot_model(cfg, flow="test", device="cpu").head
    with pytest.raises(NotImplementedError, match="CNN_HyRSM_plusplus_5shot.*CLIP-FSAR only"):
        load_test_weights(cfg, head)


def test_reference_tower_of_another_arch_is_refused(tmp_path):
    """A file written from the tiny RN tower, named for the tiny ViT's config: refused by the shapes, before any load."""
    path = str(tmp_path / "rn.pyth")
    torch.save({"model_state": reference_state(_perturbed_state("RN-Tiny-Test"))}, path)
    _, arch, _, _ = jax_tiny_model()
    head = CLIPFSARHead(arch, CLIPFSARConfig.from_cfg(load_config(CONFIG, TINY_OPTS)))
    before = {k: v.clone() for k, v in head.state_dict().items()}
    with pytest.raises(ValueError, match="not the config's"):
        load_checkpoint_file(path, head, "CNN_OTAM_CLIPFSAR")
    assert all(torch.equal(v, before[k]) for k, v in head.state_dict().items())


def test_the_ports_own_pt_files_still_load(tmp_path):
    """A head file (``save_checkpoint``) and a step checkpoint of the port load into a fresh head exactly."""
    state = {k: v for k, v in _perturbed_state("ViT-Tiny-Test").items() if not k.startswith("text.")}
    _, arch, _, _ = jax_tiny_model()
    cfg = load_config(CONFIG, TINY_OPTS)
    source = CLIPFSARHead(arch, CLIPFSARConfig.from_cfg(cfg))
    source.load_state_dict(state)
    save_checkpoint(str(tmp_path / "head.pt"), source)
    os.makedirs(Checkpointer(str(tmp_path)).dir)
    torch.save({"step": 3, "head": source.state_dict(), "optimizer": {}, "ema": None}, Checkpointer(str(tmp_path)).path(3))
    for path in (str(tmp_path / "head.pt"), Checkpointer(str(tmp_path)).path(3)):
        head = CLIPFSARHead(arch, CLIPFSARConfig.from_cfg(cfg))
        assert load_checkpoint_file(path, head, "CNN_OTAM_CLIPFSAR")
        for key, value in head.state_dict().items():
            assert torch.equal(value, state[key]), (path, key)
