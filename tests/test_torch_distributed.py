"""Data parallelism of the port over torch.distributed, on the CPU: two
gloo ranks (rendezvous through a FileStore) against one process with no
process group, and against the JAX package's train step on a 2-device data
mesh, at the tiny archs in float32.

One launch serves every test of the file: the two ranks and the
one-process run (tests/_torch_dist_worker.py) start together, each with a
timeout, while the JAX steps run here.  Every run goes through the entry
points (``train_few_shot``, ``test_few_shot``) at a global E that the ranks
split 2 + 2; dropout is off (each rank draws its own masks), jitter on
unless the JAX package is the reference."""

import json
import os
import subprocess
import sys
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_fsar_torch.models.clip.convert import params_from_jax
from tests.torch_parity import CONFIG, TINY_OPTS, jax_tiny_clip, openai_state_dict, port_head_state, tiny_cfg

torch.set_num_threads(2)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_dist_worker.py")
TIMEOUT_S = 300  # each process (its group times out at 240 s); the whole launch takes ~40 s on 8 idle cores
EPISODES, STEPS = 4, 3
# lr 1e-3 from the first step (no warmup), one Adam update per step, the global E = 4 in 2 episode chunks per process
TRAIN_OPTS = ["TRAIN.ENABLE", "True", "SOLVER.BASE_LR", "1e-3", "SOLVER.WARMUP_EPOCHS", "0", "TRAIN.BATCH_SIZE_PER_TASK", "1",
              "TPU.EPISODES_PER_STEP", str(EPISODES), "TPU.EPISODE_CHUNKS", "2", "TRAIN.VAL_FRE_ITER", "0", "TPU.ATTENTION_LAYOUT", "split"]


def _jax_model():
    """(cfg, clip_vars, JAX FewShotModel) of the tiny ViT train config."""
    from clip_fsar_tpu.models import builder as jbuilder

    cfg = tiny_cfg(*TRAIN_OPTS)
    _, arch, clip_vars = jax_tiny_clip()
    with mock.patch.object(jbuilder, "load_or_init_clip", return_value=(arch, clip_vars)):
        model = jbuilder.build_few_shot_model(cfg, jax.random.PRNGKey(0), flow="train")
    return cfg, clip_vars, model


def _jax_mesh_steps(cfg, model):
    """Three JAX train steps on a 2-device data mesh (params replicated, each
    batch's E = 4 sharded 2 + 2), jitter and dropout off: losses and the
    parameters after them in the port's names."""
    from clip_fsar_tpu.data.loader import build_few_shot_loader
    from clip_fsar_tpu.parallel.mesh import build_mesh, shard_batch, shard_params
    from clip_fsar_tpu.train import step as jstep
    from clip_fsar_tpu.train.loop import build_state
    from clip_fsar_tpu.train.optimizer import build_optimizer, epoch_for_iter, get_lr_at_epoch

    mesh = build_mesh(cfg, devices=jax.devices()[:2])
    tx = build_optimizer(cfg, model.variables["params"], name_prefix="head")
    state = shard_params(build_state(cfg, model, tx), mesh)
    with build_few_shot_loader(cfg, "train", num_steps=STEPS, episodes_per_step=EPISODES) as loader:
        batches = list(loader)
    losses = []
    with mock.patch.object(fnn.Dropout, "__call__", lambda self, x, *a, **k: x), \
            mock.patch("clip_fsar_tpu.data.augment.color_jitter_batch", lambda key, x, **kw: x):
        step = jax.jit(jstep.make_train_step(model.head, tx, cfg, model.text_train, model.text_test))
        for i, batch in enumerate(batches):
            lr = jnp.float32(get_lr_at_epoch(cfg, epoch_for_iter(cfg, i)))
            state, metrics = step(state, shard_batch(batch, mesh), lr, jax.random.PRNGKey(i))
            losses.append(float(metrics["loss"]))
    return losses, params_from_jax({"params": jax.device_get(state.params)})


def _specs(root: str, cfg_path: str, head_path: str) -> dict:
    """The runs of each world: the same weights (the JAX tiny model's, from
    an OpenAI-format CLIP file and a head checkpoint) in every ViT run."""
    vit = TINY_OPTS + TRAIN_OPTS + ["TRAIN.CHECKPOINT_FILE_PATH", head_path]

    def train(name, steps, world, jitter=True, out_dir="train"):
        return {"name": name, "runner": "train", "cfg": cfg_path, "jitter": jitter,
                "opts": vit + ["TRAIN.NUM_TRAIN_TASKS", str(steps), "OUTPUT_DIR", os.path.join(root, f"w{world}_{out_dir}")]}

    def rn(world):
        return {"name": "rn", "runner": "train", "opts": TINY_OPTS + TRAIN_OPTS + [
            "VIDEO.HEAD.BACKBONE_NAME", "RN-Tiny-Test", "TRAIN.NUM_TRAIN_TASKS", "2", "OUTPUT_DIR", os.path.join(root, f"w{world}_rn")]}

    def protocol(world, e, bank=False):
        return {"name": "bank" if bank else "eval", "runner": "test", "cfg": cfg_path, "opts": vit + [
            "TRAIN.NUM_TEST_TASKS", "5", "TEST.BATCH_SIZE", str(e), "OUTPUT_DIR", os.path.join(root, f"w{world}_eval")]
            + (["TPU.EVAL_FRAME_BANK", "True", "TPU.EVAL_FRAME_BANK_FRAMES", "2"] if bank else [])}

    return {
        # one process: 4 uninterrupted steps (the first 3 are world 2's, the 4th its resumed one), the RN steps, the protocol at E = 4
        1: [train("train", STEPS + 1, 1), rn(1), protocol(1, 4), protocol(1, 4, bank=True)],
        # two ranks: 3 steps, then auto-resume to 4 in the same OUTPUT_DIR; 3 steps without jitter against JAX; the RN
        # steps; the protocol at TEST.BATCH_SIZE 3, which the two ranks round up to 4, on pixels and off an eval frame bank
        2: [train("train", STEPS, 2), train("train_resumed", STEPS + 1, 2), train("nojitter", STEPS, 2, jitter=False, out_dir="nojitter"),
            rn(2), protocol(2, 3), protocol(2, 3, bank=True)],
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"world1": rank-0 output, "rank0"/"rank1": the two ranks' outputs, "jax": (losses, params)}."""
    root = str(tmp_path_factory.mktemp("dist"))
    cfg, clip_vars, model = _jax_model()
    head_sd = {k: v for k, v in port_head_state(model, clip_vars).items() if not k.startswith("text.")}
    torch.save({"head": head_sd}, os.path.join(root, "head.pt"))
    head_sd_text = port_head_state(model, clip_vars)
    torch.save(openai_state_dict(head_sd_text, clip_vars["params"]["logit_scale"]), os.path.join(root, "clip.pt"))
    cfg_path = os.path.join(root, "child.yaml")
    with open(cfg_path, "w") as f:
        f.write(f"_BASE: {CONFIG}\nTRAIN:\n  CLIP_WEIGHTS: {os.path.join(root, 'clip.pt')}\n")
    procs = {}
    for world, spec in _specs(root, cfg_path, os.path.join(root, "head.pt")).items():
        spec_path = os.path.join(root, f"spec{world}.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        for rank in range(world):
            name = "world1" if world == 1 else f"rank{rank}"
            procs[name] = subprocess.Popen(
                [sys.executable, WORKER, "--spec", spec_path, "--world", str(world), "--rank", str(rank),
                 "--store", os.path.join(root, "store"), "--out", os.path.join(root, f"{name}.pt")],
                env={**os.environ, "OMP_NUM_THREADS": "2"}, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        jax_ref = _jax_mesh_steps(cfg, model)
        logs = {name: p.communicate(timeout=TIMEOUT_S)[0] for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, p in procs.items():
        assert p.returncode == 0, f"{name} failed:\n{logs[name][-4000:]}"
    out = {name: torch.load(os.path.join(root, f"{name}.pt"), weights_only=False) for name in procs}
    return {**out, "jax": jax_ref}


def _assert_close(got: dict, want: dict, atol: float, what: str) -> None:
    assert set(got) == set(want), what
    for name, v in want.items():
        torch.testing.assert_close(got[name], v, atol=atol, rtol=atol, msg=lambda m, name=name: f"{what} {name}: {m}")


def _assert_ranks_identical(runs, name: str) -> None:
    """The two ranks hold the same parameters, bit for bit, and saw the same losses and gradients."""
    r0, r1 = runs["rank0"][name], runs["rank1"][name]
    for key, v in r0["state"].items():
        assert torch.equal(v, r1["state"][key]), key
    for s0, s1 in zip(r0["steps"], r1["steps"]):
        assert all(torch.equal(g, s1["grads"][n]) for n, g in s0["grads"].items())
    if "losses" in r0["stats"]:
        assert r0["stats"]["losses"] == r1["stats"]["losses"]


def test_two_ranks_train_as_one_process(runs):
    """(a) Three train steps of two ranks (2 + 2 episodes, jitter drawn for
    the global 4 and sliced at each rank's offset) against one process
    taking the 4 episodes: losses at 1e-4; the gradient each optimizer step
    saw (the all-reduced mean) and the parameters after the steps at 2e-4
    (fp32); the two ranks bit-identical."""
    one, two = runs["world1"]["train"], runs["rank0"]["train"]
    np.testing.assert_allclose(two["stats"]["losses"], one["stats"]["losses"][:STEPS], atol=1e-4, rtol=1e-4)
    assert len(two["steps"]) == STEPS and two["stats"]["updates"] == STEPS
    for i in range(STEPS):
        _assert_close(two["steps"][i]["grads"], one["steps"][i]["grads"], 2e-4, f"step {i} grad")
    after = one["steps"][STEPS]["params"]  # what the 4th step of the one process started from
    _assert_close({k: v for k, v in two["state"].items() if k in after}, after, 2e-4, "param")
    start = two["steps"][0]["params"]
    assert max((two["state"][k] - v).abs().max().item() for k, v in start.items()) > 1e-3  # the parameters did move
    _assert_ranks_identical(runs, "train")


def test_two_ranks_match_the_jax_data_mesh(runs):
    """(b) The same two-rank train run without jitter draws against the JAX
    package's train step on a 2-device data mesh from the same converted
    weights and batches (its jitter and dropout off): losses at 1e-4 and
    parameters at 2e-4 (fp32)."""
    want_losses, want_params = runs["jax"]
    got = runs["rank0"]["nojitter"]
    np.testing.assert_allclose(got["stats"]["losses"], want_losses, atol=1e-4, rtol=1e-4)
    _assert_close({k: v for k, v in got["state"].items() if k in want_params}, {k: v for k, v in want_params.items() if k in got["state"]},
                  2e-4, "param")
    _assert_ranks_identical(runs, "nojitter")


def test_live_batch_norm_running_stats_are_the_global_mean(runs):
    """(c) The RN tower with live BatchNorm, two steps: each rank's episodes
    run on their own batch statistics, and the running statistics the ranks
    commit are the mean over the global 4 episodes: those of one process at
    1e-5, moved from their start, the same bits on both ranks."""
    one, two = runs["world1"]["rn"], runs["rank0"]["rn"]
    stats = [k for k in one["state"] if k.endswith(("running_mean", "running_var"))]
    assert stats
    for key in stats:
        torch.testing.assert_close(two["state"][key], one["state"][key], atol=1e-5, rtol=1e-5, msg=lambda m, key=key: f"{key}: {m}")
    assert any(not torch.equal(one["state"][k], torch.zeros_like(one["state"][k])) for k in stats if k.endswith("running_mean"))
    np.testing.assert_allclose(two["stats"]["losses"], one["stats"]["losses"], atol=1e-4, rtol=1e-4)
    _assert_ranks_identical(runs, "rn")


def test_test_protocol_gathers_every_rank_in_episode_order(runs):
    """(d) The test protocol on 5 episodes at TEST.BATCH_SIZE 3, which two
    ranks round up to 4 (as the JAX package rounds E to its data mesh),
    against one process at 4: the same stats, per-class table and
    per-episode logits in the global episode order, at 1e-5, on both ranks."""
    want = runs["world1"]["eval"]["stats"]
    for rank in ("rank0", "rank1"):
        got = runs[rank]["eval"]["stats"]
        assert got["episodes"] == want["episodes"] == 5 and got["episode_logits"].shape == want["episode_logits"].shape == (5, 5, 5)
        np.testing.assert_allclose(got["episode_logits"], want["episode_logits"], atol=1e-5, rtol=1e-5)
        for key in ("top1_acc", "top5_acc", "loss"):
            np.testing.assert_allclose(got[key], want[key], atol=1e-5, rtol=1e-5, err_msg=key)
        assert got["per_class"] == want["per_class"] and got["weights"] == want["weights"]
        assert got["h2d_bytes_per_step"] * 2 == want["h2d_bytes_per_step"]  # each rank copies its half of a step


def test_frame_bank_is_decoded_once_and_sent_to_every_rank(runs):
    """The test protocol off an eval frame bank at two ranks: the host's first rank decodes the split (the only
    host work), the other receives its copy of the bank and the table, and both give the one process's stats and
    logits off its own bank (at 1e-5)."""
    want = runs["world1"]["bank"]["stats"]
    builds = {rank: runs[rank]["bank"]["stats"]["frame_bank"] for rank in ("rank0", "rank1")}
    assert builds["rank0"]["build_seconds"] > 0 and builds["rank1"]["build_seconds"] == 0
    assert builds["rank0"]["gb"] == builds["rank1"]["gb"] == want["frame_bank"]["gb"] > 0
    for rank in ("rank0", "rank1"):
        got = runs[rank]["bank"]["stats"]
        assert got["episodes"] == want["episodes"] == 5
        np.testing.assert_allclose(got["episode_logits"], want["episode_logits"], atol=1e-5, rtol=1e-5)
        assert got["per_class"] == want["per_class"]


def test_rank_zero_writes_and_every_rank_resumes_the_stream(runs):
    """(e) Only rank 0 writes the checkpoints; both ranks auto-resume from
    the step-3 one and their 4th step is the one process's 4th step (the
    (seed, step) episode stream and the optimizer state continue): loss at
    1e-4, parameters at 2e-4."""
    assert runs["rank0"]["train"]["saves"] == ["3.pt"] and runs["rank1"]["train"]["saves"] == []
    assert runs["rank0"]["train_resumed"]["saves"] == ["4.pt"] and runs["rank1"]["train_resumed"]["saves"] == []
    one = runs["world1"]["train"]
    for rank in ("rank0", "rank1"):
        resumed = runs[rank]["train_resumed"]
        assert resumed["stats"]["init_weights"] == "resumed" and resumed["stats"]["steps"] == 1
        np.testing.assert_allclose(resumed["stats"]["losses"], one["stats"]["losses"][STEPS:], atol=1e-4, rtol=1e-4)
        _assert_close(resumed["state"], one["state"], 2e-4, f"{rank} param")
    _assert_ranks_identical(runs, "train_resumed")
