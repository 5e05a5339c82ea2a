"""Every shipped project config through the port, against the JAX package: the CPU counterpart of
tests/test_project_configs_build.py.

All 50 YAMLs under configs/projects load with the port's loader to the tree the JAX loader reads from them, and each
names a head the port's registry holds.  The configs fall into 9 model signatures (head, trunk, MERGE_BEFORE,
SHOT_TEST, SHOT, queries a class); for each, one model is built through both packages' builders from its first YAML
at a tiny size (the RN50 tower as RN-Tiny-Test, the torchvision ResNet-50 trunk as resnet18; 4 frames of 64 px;
float32; the JAX weights carried over), and the logits of one test episode of the signature's own shape (WAY x
SHOT_TEST or SHOT supports, WAY x QUERY_PER_CLASS_TEST queries) are held to JAX's at 1e-4."""

import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_fsar_torch.config.config import load_config
from clip_fsar_torch.data.types import Episode
from clip_fsar_torch.models.clip.convert import params_from_jax
from tests.torch_parity import REPO

torch.set_num_threads(2)

YAMLS = sorted(glob.glob(os.path.join(REPO, "configs", "projects", "**", "*.yaml"), recursive=True))
# the keys the few-shot model, its loaders and its train step read, held one by one besides the whole tree
MODEL_KEYS = ["TASK_TYPE", "VIDEO.HEAD.NAME", "VIDEO.HEAD.BACKBONE_NAME", "TRAIN.WAY", "TRAIN.SHOT", "TRAIN.QUERY_PER_CLASS",
              "TRAIN.QUERY_PER_CLASS_TEST", "TRAIN.SHOT_TEST", "TRAIN.MERGE_BEFORE", "TRAIN.NUM_CLASS", "TRAIN.USE_CLASSIFICATION",
              "TRAIN.USE_CLASSIFICATION_VALUE", "TRAIN.DATASET_FEW", "TRAIN.CLASS_NAME", "TEST.CLASS_NAME", "DATA.NUM_INPUT_FRAMES",
              "DATA.TRAIN_CROP_SIZE", "DATA.TEST_CROP_SIZE", "DATA.MEAN", "DATA.STD", "SOLVER.OPTIM_METHOD", "SOLVER.BASE_LR",
              "TPU.EPISODES_PER_STEP"]
# the tiny stand-ins of the shipped trunks
TINY_TRUNK = {"RN50": "RN-Tiny-Test", "resnet50": "resnet18"}
FRAMES, RES = 4, 64


def _jax_load(path, opts=()):
    from clip_fsar_tpu.config.config import load_config as jax_load_config

    return jax_load_config(path, list(opts))


def _get(cfg, dotted):
    node = cfg
    for part in dotted.split("."):
        if part not in node:
            return "<absent>"
        node = node[part]
    return node


def _signature(cfg):
    t = cfg.TRAIN
    return (str(cfg.VIDEO.HEAD.NAME), str(cfg.VIDEO.HEAD.BACKBONE_NAME), bool(t.get("MERGE_BEFORE", False)), t.get("SHOT_TEST", None),
            int(t.SHOT), int(t.QUERY_PER_CLASS), int(t.get("QUERY_PER_CLASS_TEST", t.QUERY_PER_CLASS)))


def _representatives():
    reps = {}
    for path in YAMLS:
        reps.setdefault(_signature(load_config(path, [])), path)
    return reps


REPRESENTATIVES = _representatives()


def _rel(path):
    return os.path.relpath(path, os.path.join(REPO, "configs", "projects"))


def test_the_shipped_configs_fall_into_nine_signatures():
    assert len(YAMLS) == 50
    assert len(REPRESENTATIVES) == 9
    assert {sig[0] for sig in REPRESENTATIVES} == {"CNN_OTAM_CLIPFSAR", "CNN_BiMHM_MoLo", "CNN_HyRSM_plusplus_1shot", "CNN_HyRSM_plusplus_5shot"}


@pytest.mark.parametrize("path", YAMLS, ids=[_rel(p) for p in YAMLS])
def test_yaml_loads_to_the_tree_the_jax_loader_reads(path):
    port, jax_cfg = load_config(path, []), _jax_load(path)
    for key in MODEL_KEYS:
        assert _get(port, key) == _get(jax_cfg, key), key
    assert port.to_dict() == jax_cfg.to_dict()
    assert port.TASK_TYPE == "few_shot_action" and port.TRAIN.WAY >= 2 and port.TRAIN.SHOT >= 1


@pytest.mark.parametrize("path", YAMLS, ids=[_rel(p) for p in YAMLS])
def test_head_resolves_in_the_port_registry_as_in_jax(path):
    import clip_fsar_tpu.models.builder  # noqa: F401  (registers the JAX heads)
    from clip_fsar_tpu.utils.registry import HEAD_REGISTRY as JAX_HEADS

    import clip_fsar_torch.models.builder  # noqa: F401
    from clip_fsar_torch.utils.registry import HEAD_REGISTRY

    name = load_config(path, []).VIDEO.HEAD.NAME
    assert HEAD_REGISTRY.get(name).__name__ == JAX_HEADS.get(name).__name__


def _tiny_opts(path):
    backbone = load_config(path, []).VIDEO.HEAD.BACKBONE_NAME
    return ["VIDEO.HEAD.BACKBONE_NAME", TINY_TRUNK[backbone], "DATA.NUM_INPUT_FRAMES", str(FRAMES), "DATA.TRAIN_CROP_SIZE", str(RES),
            "DATA.TEST_CROP_SIZE", str(RES), "DATA.TEST_SCALE", "72", "DATA.TRAIN_JITTER_SCALES", "[72, 80]", "TPU.COMPUTE_DTYPE",
            "float32", "DATA.DECODER", "synthetic", "DATA.ANNO_DIR", os.path.dirname(path) + "/", "TRAIN.ENABLE", "False"]


def _test_episode(cfg, text_rows, seed=0):
    """One normalized-image test episode of the config's shape (a leading E = 1 axis), numpy."""
    t = cfg.TRAIN
    way, shot, qpc = int(t.WAY), int(t.get("SHOT_TEST", t.SHOT)), int(t.get("QUERY_PER_CLASS_TEST", t.QUERY_PER_CLASS))
    rng = np.random.RandomState(seed)
    classes = rng.choice(max(text_rows, way), size=way, replace=False)
    s_lab, q_lab = rng.permutation(np.repeat(np.arange(way), shot)), rng.permutation(np.repeat(np.arange(way), qpc))
    ep = dict(support_images=rng.randn(way * shot, FRAMES, RES, RES, 3).astype(np.float32), support_labels=s_lab.astype(np.int32),
              real_support_labels=classes[s_lab].astype(np.int32), target_images=rng.randn(way * qpc, FRAMES, RES, RES, 3).astype(np.float32),
              target_labels=q_lab.astype(np.int32), real_target_labels=classes[q_lab].astype(np.int32),
              batch_class_list=classes.astype(np.int32))
    return {k: v[None] for k, v in ep.items()}


CLIP_FILES: dict = {}  # tiny CLIP tower -> its OpenAI-format weights file (written by the module fixture below)


@pytest.fixture(scope="module", autouse=True)
def _clip_files(tmp_path_factory):
    """Fresh CLIP weights of each tiny CLIP tower the signatures use, drawn by the port, as an OpenAI-format file."""
    from clip_fsar_torch.models import builder

    for path in sorted(REPRESENTATIVES.values()):
        cfg = load_config(path, _tiny_opts(path))
        name = cfg.VIDEO.HEAD.BACKBONE_NAME
        if name in builder.ARCHS and name not in CLIP_FILES:
            _, sd = builder.load_or_init_clip(cfg, torch.Generator().manual_seed(0), flow="test")
            sd = {k[len("text."):] if k.startswith("text.") else k: v for k, v in sd.items()}
            sd["logit_scale"] = torch.tensor(np.log(1 / 0.07), dtype=torch.float32)
            CLIP_FILES[name] = str(tmp_path_factory.mktemp("clip") / f"{name}.pt")
            torch.save(sd, CLIP_FILES[name])
    yield


@functools.lru_cache(maxsize=None)
def _signature_logits():
    """For every signature, {path: (the port's logits, JAX's logits)} on one test episode of its shape, numpy.  The
    JAX model comes from the JAX builder (a CLIP tower's weights from the port's fresh ones in CLIP_FILES, so that it
    compiles no init of them); signatures that share a head and a trunk share one build (the same variables and text
    banks), each with the head its own config makes.  The port's model comes
    from the port's builder with the JAX weights loaded (strict: every entry of its head, nothing else) and the JAX
    text banks (the port's own text tower draws other fresh weights).  Builds and runs go on threads at once: XLA
    compiles, and torch initialises, outside the interpreter lock, and that is most of the work at this size."""
    from concurrent.futures import ThreadPoolExecutor

    from clip_fsar_tpu.data.types import Episode as JaxEpisode
    from clip_fsar_tpu.models import builder as jax_builder
    from clip_fsar_tpu.utils.registry import HEAD_REGISTRY as JAX_HEADS

    from clip_fsar_torch.models.builder import build_few_shot_model

    groups = {}
    for path in sorted(REPRESENTATIVES.values()):
        cfg = _jax_load(path, _tiny_opts(path))
        groups.setdefault((cfg.VIDEO.HEAD.NAME, cfg.VIDEO.HEAD.BACKBONE_NAME), []).append((path, cfg))

    def build(cfg):
        if cfg.VIDEO.HEAD.BACKBONE_NAME in CLIP_FILES:  # the JAX builder reads the CLIP weights instead of compiling their init
            cfg.TRAIN["CLIP_WEIGHTS"] = CLIP_FILES[cfg.VIDEO.HEAD.BACKBONE_NAME]
        built = jax_builder.build_few_shot_model(cfg, jax.random.PRNGKey(0), flow="test")
        return built, params_from_jax(jax.device_get(built.variables)), [torch.from_numpy(np.array(t)) for t in (built.text_train, built.text_test)]

    def run(path, jax_cfg, pending):
        cfg = load_config(path, _tiny_opts(path))
        port = build_few_shot_model(cfg, flow="test", device="cpu")
        built, state, text = pending.result()
        head = JAX_HEADS.get(jax_cfg.VIDEO.HEAD.NAME)(jax_cfg, arch=getattr(built.head, "arch", None))
        batch = _test_episode(cfg, text[1].shape[0])
        apply = jax.jit(jax.vmap(lambda ep: head.apply(built.variables, ep, built.text_train, built.text_test, train=False)))
        want = apply(JaxEpisode(**{k: jnp.asarray(v) for k, v in batch.items()}))["logits"]
        port.head.load_state_dict(state)
        with torch.no_grad():
            got = port.head(Episode(**{k: torch.from_numpy(v) for k, v in batch.items()}), *text, train=False)["logits"]
        return got.numpy(), np.asarray(want)

    # every build and every signature's run at once: a run waits for its group's build on its own thread
    with ThreadPoolExecutor(max_workers=len(groups) + len(REPRESENTATIVES)) as pool:
        builds = {key: pool.submit(build, members[0][1]) for key, members in groups.items()}
        runs = {path: pool.submit(run, path, cfg, builds[key]) for key, members in groups.items() for path, cfg in members}
        return {path: future.result() for path, future in runs.items()}


@pytest.mark.parametrize("path", sorted(REPRESENTATIVES.values()), ids=lambda p: _rel(p))
def test_signature_test_logits_match_jax(path):
    """The signature's model at the tiny size through both builders, the JAX weights carried over, one test episode of
    the signature's shape in the eval branch: the logits, [1, WAY x QUERY_PER_CLASS_TEST, WAY], finite, at 1e-4."""
    got, want = _signature_logits()[path]
    t = load_config(path, []).TRAIN
    assert got.shape == (1, int(t.WAY) * int(t.get("QUERY_PER_CLASS_TEST", t.QUERY_PER_CLASS)), int(t.WAY))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
