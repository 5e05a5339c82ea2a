"""The few-shot slices end to end: the port's CLI against the JAX eval step
on ViT-Tiny-Test (64 px, 4 frames, synthetic decoder, float32), with the
clip_mha and the flash_mha attention, and the
port's CLI, test and train, in a process where jax, jaxlib, flax, optax and
orbax cannot be imported (the GPU machine has no flax, optax or orbax)."""

import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from clip_fsar_torch.models.builder import _attention_backend_from_cfg
from clip_fsar_torch.models.heads.clipfsar import CLIPFSARConfig, CLIPFSARHead
from clip_fsar_torch.ops.flash_attention import LAUNCHES
from clip_fsar_torch.runs.run import main
from clip_fsar_torch.train.checkpoint import save_checkpoint
from tests.torch_parity import CONFIG, REPO, TINY_OPTS, jax_tiny_model, openai_state_dict, pallas_interpret, port_head_state

torch.set_num_threads(2)


def _jax_eval(cfg, model, num_tasks, e):
    """Per-episode logits and the test_few_shot metrics of the JAX package,
    from its own loader and make_eval_step."""
    from clip_fsar_tpu.data.loader import build_few_shot_loader
    from clip_fsar_tpu.train.step import _normalize_episode, make_eval_step

    mean, std = tuple(cfg.DATA.MEAN), tuple(cfg.DATA.STD)
    step = jax.jit(make_eval_step(model.head, cfg, model.text_train, model.text_test))
    head_logits = jax.jit(
        lambda v, b: jax.vmap(lambda ep: model.head.apply(v, ep, model.text_train, model.text_test, train=False)["logits"])(
            _normalize_episode(b, mean, std)
        )
    )
    logits, outs = [], []
    with build_few_shot_loader(cfg, "test", num_steps=-(-num_tasks // e), episodes_per_step=e) as loader:
        for batch in loader:
            outs.append(jax.device_get(step(model.variables, batch)))
            logits.append(np.asarray(head_logits(model.variables, batch)))
    count = sum(int(o["count"].sum()) for o in outs)
    return np.concatenate(logits)[:num_tasks], {
        "top1_acc": sum(int(o["top1_correct"].sum()) for o in outs) / count * 100.0,
        "top5_acc": sum(int(o["top5_correct"].sum()) for o in outs) / count * 100.0,
        "loss": float(np.mean([o["loss"].mean() for o in outs])),
    }


def _slice_vs_jax(tmp_path, opts, want_logits_and_metrics, npz=False):
    """The port's CLI with ``opts`` (CLIP weights from an OpenAI-format file,
    head weights from a port checkpoint, or with ``npz`` from a weight
    archive the JAX package wrote) against the JAX eval step's 4 episodes:
    top-1 / top-5 equal, loss and per-episode logits at 1e-4."""
    cfg, arch, clip_vars, model, (want_logits, want) = want_logits_and_metrics
    head_sd = port_head_state(model, clip_vars)
    clip_path = tmp_path / "clip.pt"
    torch.save(openai_state_dict(head_sd, clip_vars["params"]["logit_scale"]), str(clip_path))
    if npz:
        from clip_fsar_tpu.train.pretrain import save_weights_npz

        head_path = tmp_path / "head.npz"
        save_weights_npz(str(head_path), jax.device_get(model.variables))
    else:
        head = CLIPFSARHead(arch, CLIPFSARConfig.from_cfg(cfg))
        head.load_state_dict({k: v for k, v in head_sd.items() if not k.startswith("text.")})
        head_path = tmp_path / "head.pt"
        save_checkpoint(str(head_path), head)
    child = tmp_path / "slice.yaml"
    child.write_text(f"_BASE: {CONFIG}\nTRAIN:\n  CLIP_WEIGHTS: {clip_path}\n")

    got = main([
        "--cfg", str(child), "--device", "cpu", *TINY_OPTS, *opts,
        "TEST.CHECKPOINT_FILE_PATH", str(head_path), "OUTPUT_DIR", str(tmp_path / "out"),
    ])["test_few_shot"]

    assert got["episodes"] == 4 and got["episode_logits"].shape == (4, 5, 5)
    assert got["weights"] == str(head_path)
    np.testing.assert_allclose(got["episode_logits"], want_logits, atol=1e-4, rtol=1e-4)
    assert got["top1_acc"] == want["top1_acc"] and got["top5_acc"] == want["top5_acc"]
    np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-4, rtol=1e-4)


def test_slice_matches_jax(tmp_path):
    """The port's CLI (CLIP weights from an OpenAI-format file, head weights
    from a port checkpoint, attention through clip_mha) against the JAX eval
    step with TPU.ATTENTION_LAYOUT fused (clip_mha in Pallas interpret
    mode): same 4 episodes, top-1 / top-5 equal, loss and per-episode logits
    at 1e-4 (fp32)."""
    _slice_vs_jax(tmp_path, ["TPU.ATTENTION_LAYOUT", "fused"], _fused_jax_slice())


@functools.lru_cache(maxsize=None)
def _fused_jax_slice():
    """The JAX tiny model with clip_mha and its eval step's 4 episodes, made once for the tests that share them."""
    cfg, arch, clip_vars, model = jax_tiny_model("fused")
    return cfg, arch, clip_vars, model, _jax_eval(cfg, model, num_tasks=4, e=2)


def test_slice_from_jax_npz_archive_matches_jax(tmp_path):
    """The offline route for weights the JAX package trained: its
    ``save_weights_npz`` archive of the tiny model's variables, named by
    TEST.CHECKPOINT_FILE_PATH, is what the port tests (``weights`` names the
    archive), and the logits are the JAX eval step's at 1e-4 (fp32)."""
    _slice_vs_jax(tmp_path, ["TPU.ATTENTION_LAYOUT", "fused"], _fused_jax_slice(), npz=True)


def test_pallas_slice_matches_jax(tmp_path):
    """The same with TPU.PALLAS_ATTENTION True on both sides: every ViT
    layer's attention through the port's flash_mha (its plain versions on
    the CPU) against the JAX eval step with flash_mha's Pallas kernels in
    interpret mode; logits and loss at 1e-4 (fp32)."""
    with pallas_interpret():
        cfg, arch, clip_vars, model = jax_tiny_model("split", pallas=True)
        want = _jax_eval(cfg, model, num_tasks=4, e=2)
    before = dict(LAUNCHES)
    _slice_vs_jax(tmp_path, ["TPU.PALLAS_ATTENTION", "True"], (cfg, arch, clip_vars, model, want))
    assert LAUNCHES == before  # CPU tensors: the plain versions, no kernel launch


_NO_JAX = """
import sys
for name in ("clip_fsar_tpu", "jax", "jaxlib", "flax", "optax", "orbax"):
    sys.modules[name] = None  # any import of them now raises ImportError
from clip_fsar_torch.runs.run import main
out = main(sys.argv[1:])
test = out["test_few_shot"]
assert test["episodes"] == 4 and test["episode_logits"].shape == (4, 5, 5), test
if "train_few_shot" in out:
    assert out["train_few_shot"]["steps"] == 2 and out["train_few_shot"]["updates"] == 1, out["train_few_shot"]
    assert test["weights"].endswith("2.pt"), test["weights"]
print("SLICE_OK", test["top1_acc"])
"""


def test_slice_runs_with_jax_blocked(tmp_path):
    """The whole CPU slice through the port's CLI with clip_fsar_tpu, jax,
    jaxlib, flax, optax and orbax unimportable: nothing on the path may need them.  Run
    three times: the test protocol alone, TRAIN.ENABLE True (two train steps
    with one Adam update, validation, checkpoints, then the test of the
    step-2 checkpoint), and the same with TPU.PALLAS_ATTENTION True."""
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    train = ["TRAIN.ENABLE", "True", "TRAIN.NUM_TRAIN_TASKS", "2", "TRAIN.BATCH_SIZE_PER_TASK", "2", "TPU.EPISODES_PER_STEP", "2",
             "TRAIN.VAL_FRE_ITER", "1", "TRAIN.NUM_VAL_TASKS", "2"]
    for name, extra in (("test", []), ("train", train), ("pallas", train + ["TPU.PALLAS_ATTENTION", "True"])):
        proc = subprocess.run(
            [sys.executable, "-c", _NO_JAX, "--cfg", CONFIG, "--device", "cpu", *TINY_OPTS, *extra, "OUTPUT_DIR", str(tmp_path / name)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
        )
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
        assert "SLICE_OK" in proc.stdout


def test_cli_runs_on_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """The card is the default: without one, ``main`` with no ``--device``
    raises before any episode is loaded or any file written, and the same
    call with ``--device cpu`` runs the test protocol on the CPU."""
    from clip_fsar_torch import runtime
    from clip_fsar_torch.data import loader

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.device()
    assert runtime.device("cpu") == torch.device("cpu")
    built = []
    build = loader.build_few_shot_loader
    monkeypatch.setattr("clip_fsar_torch.train.loop.build_few_shot_loader", lambda *a, **k: built.append(a) or build(*a, **k))
    argv = [*TINY_OPTS, "OUTPUT_DIR", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--cfg", CONFIG, *argv])
    assert not built and not os.path.exists(tmp_path / "out")
    got = main(["--cfg", CONFIG, "--device", "cpu", *argv])["test_few_shot"]
    assert len(built) == 1 and got["episodes"] == 4 and np.isfinite(got["episode_logits"]).all()


def test_chip_smoke_refuses_without_a_card():
    """chip_smoke.py measures the card only: with no CUDA device it exits
    non-zero and prints no result line, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run for real")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "no CUDA device" in proc.stderr


def test_profile_eval_busy_time_and_refusal():
    """The slice profilers count overlapping device events once, group the
    kernels by name, and measure the card only: with no CUDA device they
    exit non-zero."""
    from types import SimpleNamespace

    from clip_fsar_torch.tools import profile_eval

    def event(start, end):
        return SimpleNamespace(time_range=SimpleNamespace(start=start, end=end))

    assert profile_eval._busy_us([event(20, 30), event(0, 10), event(5, 12), event(21, 22)]) == 22
    names = ("clip_mha_fwd_kernel<bf16, 64>", "clip_mha_bwd_dkv_kernel<bf16, 64>", "flash_mha_fwd_kernel<bf16, 64>",
             "flash_mha_bwd_delta_kernel<bf16, 64>", "flash_mha_bwd_dq_kernel<bf16, 64>", "flash_mha_bwd_dkv_kernel<bf16, 64>",
             "nvjet_tst_192x192", "Memcpy HtoD", "reduce_kernel",
             "void attn_mma::forward_kernel<(anonymous namespace)::clip_mha_fwd_bf16, 64, 13, 0, 0, 64, 4>(attn_mma::Params)",
             "void attn_mma::forward_kernel<(anonymous namespace)::flash_mha_fwd_bf16, 64, 8, 1, 0, 256, 1>(attn_mma::Params)")
    assert [profile_eval._group(n) for n in names] == ["clip_mha", "clip_mha_bwd", "flash_mha", "flash_mha_bwd_dq",
                                                        "flash_mha_bwd_dq", "flash_mha_bwd_dkv", "gemm", "memcpy", "other",
                                                        "clip_mha", "flash_mha"]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: profile_eval would run for real")
    with pytest.raises(SystemExit, match="no CUDA device"):
        profile_eval.main([])
    from clip_fsar_torch.tools import profile_train

    with pytest.raises(SystemExit, match="no CUDA device"):
        profile_train.main([])


def test_cli_refuses_runners_not_ported(tmp_path):
    """Every runner of the JAX package is ported, localization and
    pretraining among them; what the port cannot run raises before any work
    instead of being skipped: a TPU.MESH model axis that does not divide the
    one process (the JAX package's ValueError), and the localization runners
    under a process group of more than one rank."""
    from unittest import mock

    with pytest.raises(ValueError, match="TPU.MESH.MODEL=2 must divide the device count 1"):
        main(["--cfg", CONFIG, "--device", "cpu", *TINY_OPTS, "TPU.MESH", "{DATA: -1, MODEL: 2}", "TRAIN.ENABLE", "True", "OUTPUT_DIR", str(tmp_path)])
    with mock.patch.dict(os.environ, {"WORLD_SIZE": "2"}), pytest.raises(NotImplementedError, match="'train_localization' under a process group"):
        main(["--cfg", CONFIG, "--device", "cpu", *TINY_OPTS, "TASK_TYPE", "localization", "TRAIN.ENABLE", "True", "OUTPUT_DIR", str(tmp_path)])
    assert not os.path.exists(os.path.join(tmp_path, "checkpoints"))


@pytest.mark.parametrize(
    "layout, softmax, device, want",
    [("auto", "float32", "cuda", "fused"), ("auto", "float32", "cpu", "plain"), ("auto", "bfloat16", "cpu", "plain:bf16"),
     ("fused", "bfloat16", "cpu", "fused"), ("split", "float32", "cuda", "plain"), ("unsplit", "bfloat16", "cuda", "plain:bf16"),
     ("auto", "float32", "cuda", "pallas"), ("auto", "float32", "cpu", "pallas"), ("fused", "float32", "cuda", "pallas"),
     ("split", "bfloat16", "cpu", "pallas"), ("unsplit", "float32", "cuda", "pallas")],
)
def test_attention_backend_from_cfg(layout, softmax, device, want):
    """TPU.ATTENTION_LAYOUT / TPU.SOFTMAX_DTYPE as the JAX builder reads
    them (builder.py:66-88), auto resolving by device.  The cases that want
    "pallas" set TPU.PALLAS_ATTENTION True, which wins whatever the layout,
    the softmax dtype and the device: read before the layout, as in the JAX
    builder (builder.py:73-74), which gives "pallas" too."""
    from clip_fsar_tpu.models.builder import _attention_backend_from_cfg as jax_backend
    from tests.torch_parity import tiny_cfg

    pallas = want == "pallas"
    cfg = tiny_cfg("TPU.ATTENTION_LAYOUT", layout, "TPU.SOFTMAX_DTYPE", softmax, "TPU.PALLAS_ATTENTION", str(pallas))
    assert _attention_backend_from_cfg(cfg, torch.device(device)) == want
    if pallas:
        assert jax_backend(cfg) == "pallas"
