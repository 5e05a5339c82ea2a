"""The port stands alone: it imports nothing of clip_fsar_tpu or of the JAX
stack, and its own copies of the host-side modules it used to borrow (config
loader, tokenizer with its merges file, frame samplers, split parser,
decoders, the fixed-point resize and its native C++ pass) give what the
originals give on the same inputs.
"""

import ast
import glob
import os
import shutil

import numpy as np
import pytest

from torch_parity import CONFIG, REPO

FORBIDDEN = {"clip_fsar_tpu", "jax", "jaxlib", "flax", "optax", "orbax"}
PORT_FILES = sorted(glob.glob(os.path.join(REPO, "clip_fsar_torch", "**", "*.py"), recursive=True)) + [os.path.join(REPO, "chip_smoke.py")]
OVERRIDES = ["DATA.DECODER", "synthetic", "TRAIN.NUM_TEST_TASKS", "16", "SOLVER.WEIGHT_DECAY", "5e-5", "DATA.TRAIN_JITTER_SCALES", "[72, 80]"]


def _imports(path):
    """Top-level names of every module a file imports, anywhere in it (function bodies included)."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", PORT_FILES, ids=[os.path.relpath(p, REPO) for p in PORT_FILES])
def test_file_imports_nothing_of_the_jax_package_or_stack(path):
    bad = [(name, line) for name, line in _imports(path) if name in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_the_import_scan_sees_the_whole_port():
    """The list above is taken at collection: it holds the package's modules, the new ones included."""
    rel = {os.path.relpath(p, REPO) for p in PORT_FILES}
    for must in ("chip_smoke.py", "clip_fsar_torch/config/config.py", "clip_fsar_torch/native/frameops.py",
                 "clip_fsar_torch/ops/fused_layernorm.py", "clip_fsar_torch/tools/fa_decomp.py", "clip_fsar_torch/runs/run.py",
                 "clip_fsar_torch/data/frame_bank.py", "clip_fsar_torch/models/convert_reference.py", "clip_fsar_torch/utils/misc.py",
                 "clip_fsar_torch/parallel/mesh.py", "clip_fsar_torch/parallel/tensor.py", "clip_fsar_torch/ops/pool3d.py",
                 "clip_fsar_torch/ops/boundary_matching.py", "clip_fsar_torch/tools/profile_bmn.py"):
        assert must in rel
    assert list(_imports(os.path.join(REPO, "tests", "torch_parity.py")))  # and the scan does find imports: this file has jax


def test_load_config_equals_the_original():
    from clip_fsar_tpu.config import config as original

    from clip_fsar_torch.config import config as port

    a, b = port.load_config(CONFIG, OVERRIDES), original.load_config(CONFIG, OVERRIDES)
    assert a.to_dict() == b.to_dict()
    assert a.SOLVER.WEIGHT_DECAY == 5e-5 and a.DATA.TRAIN_JITTER_SCALES == [72, 80] and not hasattr(a.DATA, "NO_SUCH_KEY")
    assert port._find_pool_base(CONFIG) == original._find_pool_base(CONFIG)
    # the port's parser adds --device (the card unless the CPU is asked for); the rest is the original's
    ns = vars(port.parse_args(["--cfg", CONFIG, "DATA.DECODER", "synthetic"]))
    assert ns.pop("device") == "cuda"
    assert ns == vars(original.parse_args(["--cfg", CONFIG, "DATA.DECODER", "synthetic"]))
    asked = port.parse_args(["--cfg", CONFIG, "--device", "cpu", "DATA.DECODER", "synthetic"])
    assert asked.device == "cpu" and asked.opts == ["DATA.DECODER", "synthetic"]


def test_tokenizer_equals_the_original_and_reads_its_own_merges_file():
    from clip_fsar_tpu.models.clip import tokenizer as original

    from clip_fsar_torch.config.config import load_config
    from clip_fsar_torch.models.clip import tokenizer as port

    assert os.path.dirname(port._VOCAB_PATH) == os.path.join(REPO, "clip_fsar_torch", "models", "clip")
    assert os.path.exists(port._VOCAB_PATH)
    cfg = load_config(CONFIG, [])
    names = list(cfg.TRAIN.CLASS_NAME) + list(cfg.TEST.CLASS_NAME)
    assert len(names) > 10
    prompts = [f"a photo of {n}" for n in names] + ["Café &amp; crème  brûlée!!"]
    np.testing.assert_array_equal(port.tokenize(prompts), original.tokenize(prompts))


@pytest.mark.parametrize("split, extra", [("train", []), ("test", []), ("train", ["DATA.SAMPLING_RATE", "4"]), ("test", ["DATA.SAMPLING_RATE", "4"])],
                         ids=["train-segments", "test-segments", "train-interval", "test-interval"])
def test_frame_sampler_equals_the_original(split, extra):
    from clip_fsar_tpu.data import sampling as original

    from clip_fsar_torch.config.config import load_config
    from clip_fsar_torch.data import sampling as port

    cfg = load_config(CONFIG, extra)
    for length in (9, 40, 117):
        got = port.sample_indices_for_cfg(cfg, split, length, 30.0, np.random.default_rng(length))
        want = original.sample_indices_for_cfg(cfg, split, length, 30.0, np.random.default_rng(length))
        np.testing.assert_array_equal(got, want)
        assert len(got) == int(cfg.DATA.NUM_INPUT_FRAMES)


def test_split_parser_equals_the_original():
    from clip_fsar_tpu.data import splits as original

    from clip_fsar_torch.data import splits as port

    path = os.path.join(os.path.dirname(CONFIG), "test_few_shot.txt")
    a, b = port.load_split_file(path, "test", ssv2_style=False), original.load_split_file(path, "test", ssv2_style=False)
    assert len(a) == len(b) > 0 and a.unique_classes() == b.unique_classes()
    for c in a.unique_classes():
        assert a.num_videos_for_class(c) == b.num_videos_for_class(c)
        assert a.get(c, 0) == b.get(c, 0)
    ssv2 = ["train8/78687", "train8/1234", "train11/42"]
    x, y = port.FewShotSplit(ssv2, "train", ssv2_style=True), original.FewShotSplit(ssv2, "train", ssv2_style=True)
    assert x.unique_classes() == y.unique_classes() == [8, 11] and x.get(8, 1) == y.get(8, 1)


def test_synthetic_decoder_equals_the_original_and_registries_are_separate():
    from clip_fsar_tpu.data import decode as original
    from clip_fsar_tpu.utils import registry as original_registry

    from clip_fsar_torch.data import decode as port
    from clip_fsar_torch.utils import registry as port_registry

    assert port_registry.DECODER_REGISTRY is not original_registry.DECODER_REGISTRY
    a, b = port.build_decoder("synthetic"), original.build_decoder("synthetic")
    assert type(a).__module__ == "clip_fsar_torch.data.decode"
    for path in ("videos/brush_hair/a.avi", "videos/cartwheel/b.avi"):
        assert a.length(path) == b.length(path)
        np.testing.assert_array_equal(a.read(path, [0, 3, 7]), b.read(path, [0, 3, 7]))
    with pytest.raises(KeyError):
        port_registry.DECODER_REGISTRY.get("no_such_decoder")


def _clip():
    return np.random.RandomState(0).randint(0, 256, (5, 97, 131, 3), dtype=np.uint8)  # non-square, odd sizes


RESIZE_ARGS = (120, 150, 7, 19, 96)  # resize to 120 x 150, crop 96 x 96 at (7, 19)


def test_numpy_resize_equals_the_original():
    from clip_fsar_tpu.data import transforms as original

    from clip_fsar_torch.data import transforms as port

    for flip in (False, True):
        np.testing.assert_array_equal(port._np_resize_crop_flip(_clip(), *RESIZE_ARGS, flip), original._np_resize_crop_flip(_clip(), *RESIZE_ARGS, flip))
    assert port._stretch_dims([256, 320]) == original._stretch_dims([256, 320]) == (256, 320)
    assert port._stretch_dims(224) == original._stretch_dims(224)


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native resize cannot be built, the transforms take the numpy replica")


def test_native_resize_is_pixel_identical(gxx):
    """The port's native pass, its numpy replica and the JAX package's native binding on a flipped,
    cropped, non-square clip; the port's library is built under build/native/, not beside its source."""
    from clip_fsar_tpu.native import frameops as original

    from clip_fsar_torch.data import transforms
    from clip_fsar_torch.native import frameops

    assert frameops.available(), frameops.failure()
    assert not glob.glob(os.path.join(REPO, "clip_fsar_torch", "native", "*.so"))
    assert glob.glob(os.path.join(frameops.BUILD_ROOT, "*", "libframeops.so"))
    nh, nw, y, x, size = RESIZE_ARGS
    for flip in (False, True):
        native = frameops.resize_crop_flip(_clip(), nh, nw, y, x, size, size, flip)
        np.testing.assert_array_equal(native, transforms._np_resize_crop_flip(_clip(), *RESIZE_ARGS, flip))
        if original.available():
            np.testing.assert_array_equal(native, original.resize_crop_flip(_clip(), nh, nw, y, x, size, size, flip))
    np.testing.assert_array_equal(frameops.resize(_clip(), 64, 80), transforms._np_resize_crop_flip(_clip(), 64, 80, 0, 0, 64, False, size_w=80))
    with pytest.raises(ValueError):
        frameops.resize_crop_flip(_clip(), 64, 64, 0, 0, 65, 65)


def test_transforms_count_which_resize_they_took(gxx):
    """The same transform with the native pass and, switched off, with the numpy replica: identical
    pixels, and RESIZE_CALLS says which ran."""
    from clip_fsar_torch.config.config import load_config
    from clip_fsar_torch.data import transforms
    from clip_fsar_torch.native import frameops

    cfg = load_config(CONFIG, ["DATA.TEST_SCALE", "72", "DATA.TEST_CROP_SIZE", "64"])
    before = dict(transforms.RESIZE_CALLS)
    try:
        native = transforms.fewshot_test_transform(_clip(), cfg)
        frameops.set_enabled(False)
        replica = transforms.fewshot_test_transform(_clip(), cfg)
    finally:
        frameops.set_enabled(True)
    np.testing.assert_array_equal(native, replica)
    assert native.shape == (5, 64, 64, 3)
    assert transforms.RESIZE_CALLS == {"native": before["native"] + 1, "numpy": before["numpy"] + 1}


_BANKS_NO_JAX = """
import sys
for name in ("clip_fsar_tpu", "jax", "jaxlib", "flax", "optax", "orbax"):
    sys.modules[name] = None  # any import of them now raises ImportError
import torch
from clip_fsar_torch.runs.run import main
from clip_fsar_torch.utils import misc
out = main(sys.argv[1:])
train, test = out["train_few_shot"], out["test_few_shot"]
assert set(train["frame_banks"]) == {"train", "val"} and train["steps"] == 2, train
assert test["frame_bank"]["gb"] > 0 and test["episodes"] == 4, test
head = torch.load(test["weights"], weights_only=True)["head"]
reference = {"model_state": {"module.head." + k: v for k, v in head.items()}}
torch.save(reference, sys.argv[-1] + "/reference.pyth")
print("BANKS_OK", misc.params_count(torch.nn.Linear(2, 3)))
"""


def test_banks_and_model_info_run_with_jax_blocked(tmp_path):
    """The new modules stand alone too: the CLI trains off a train frame bank, validates and tests off eval
    frame banks (2 grid frames a video), logs the model_info line (utils/misc.py) and writes a
    reference-format copy of its checkpoint, with clip_fsar_tpu, jax, jaxlib, flax, optax and orbax
    unimportable; then the test protocol reads that copy through TEST.CHECKPOINT_FILE_PATH
    (models/convert_reference.py), still without them."""
    import subprocess
    import sys

    from torch_parity import TINY_OPTS

    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    banks = ["TPU.EVAL_FRAME_BANK", "True", "TPU.EVAL_FRAME_BANK_FRAMES", "2", "TPU.TRAIN_FRAME_BANK", "True", "TPU.TRAIN_FRAME_BANK_FRAMES", "2"]
    train = ["TRAIN.ENABLE", "True", "TRAIN.NUM_TRAIN_TASKS", "2", "TRAIN.BATCH_SIZE_PER_TASK", "2", "TPU.EPISODES_PER_STEP", "2",
             "TRAIN.VAL_FRE_ITER", "2", "TRAIN.NUM_VAL_TASKS", "2"]
    out = str(tmp_path / "run")
    proc = subprocess.run([sys.executable, "-c", _BANKS_NO_JAX, "--cfg", CONFIG, "--device", "cpu", *TINY_OPTS, *train, *banks, "OUTPUT_DIR", out],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "BANKS_OK 9" in proc.stdout and '"_type": "model_info"' in proc.stdout
    blocked = "import sys\nfor m in ('clip_fsar_tpu', 'jax', 'jaxlib', 'flax', 'optax', 'orbax'):\n    sys.modules[m] = None\n" \
              "from clip_fsar_torch.runs.run import main\nprint('WEIGHTS', main(sys.argv[1:])['test_few_shot']['weights'])"
    pyth = os.path.join(out, "reference.pyth")
    proc = subprocess.run([sys.executable, "-c", blocked, "--cfg", CONFIG, "--device", "cpu", *TINY_OPTS, "TEST.CHECKPOINT_FILE_PATH", pyth,
                           "OUTPUT_DIR", str(tmp_path / "test")], cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert f"WEIGHTS {pyth}" in proc.stdout
