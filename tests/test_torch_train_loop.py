"""The port's few-shot train loop on ViT-Tiny-Test (64 px, 4 frames,
float32, synthetic decoder): auto-resume continues a run exactly, and a CLI
run that trains then tests the weights it trained (the test-time checkpoint
search tries the last OUTPUT_DIR checkpoint before the TRAIN path and fresh
weights, as the JAX package's does)."""

from unittest import mock

import numpy as np
import torch

from clip_fsar_torch.models.builder import build_few_shot_model
from clip_fsar_torch.runs.run import main
from clip_fsar_torch.train.checkpoint import Checkpointer
from clip_fsar_torch.train import loop
from clip_fsar_torch.train.loop import evaluate, train_few_shot
from tests.torch_parity import CONFIG, TINY_OPTS, host_reads, tiny_cfg

torch.set_num_threads(2)

# E = 2 episodes per step, the config's BATCH_SIZE_PER_TASK 4, jitter and dropout on, lr 1e-3
LOOP_OPTS = ["TRAIN.ENABLE", "True", "TPU.EPISODES_PER_STEP", "2", "SOLVER.BASE_LR", "1e-3", "SOLVER.WARMUP_EPOCHS", "0",
             "TRAIN.VAL_FRE_ITER", "0", "LOG_PERIOD", "1"]


def test_resume_continues_a_run_exactly(tmp_path):
    """4 steps straight equal 2 steps + auto-resume + 2 more, bit for bit:
    the loader continues the (seed, step) episode stream, each step's
    generator depends on (seed, step) only, and the checkpoint carries the
    open accumulation window (BATCH_SIZE_PER_TASK 4: the one update lands on
    step 4, after the resume)."""
    straight = train_few_shot(tiny_cfg(*LOOP_OPTS, "TRAIN.NUM_TRAIN_TASKS", "4", "OUTPUT_DIR", str(tmp_path / "a")), device="cpu")
    first = train_few_shot(tiny_cfg(*LOOP_OPTS, "TRAIN.NUM_TRAIN_TASKS", "2", "OUTPUT_DIR", str(tmp_path / "b")), device="cpu")
    resumed = train_few_shot(tiny_cfg(*LOOP_OPTS, "TRAIN.NUM_TRAIN_TASKS", "4", "OUTPUT_DIR", str(tmp_path / "b")), device="cpu")
    assert (straight["steps"], first["steps"], resumed["steps"]) == (4, 2, 2)
    assert (straight["updates"], first["updates"], resumed["updates"]) == (1, 0, 1)
    assert straight["losses"] == first["losses"] + resumed["losses"]
    a, b = Checkpointer(str(tmp_path / "a")).load(), Checkpointer(str(tmp_path / "b")).load()
    assert a["step"] == b["step"] == 4
    for name, v in a["head"].items():
        assert torch.equal(v, b["head"][name]), name
    for key, moments in a["optimizer"]["inner"]["state"].items():
        for m, v in moments.items():
            assert torch.equal(v, b["optimizer"]["inner"]["state"][key][m]), (key, m)
    assert a["optimizer"]["mini_step"] == b["optimizer"]["mini_step"] == 0


def test_train_loop_reads_metrics_only_where_it_logs(tmp_path):
    """LOG_PERIOD 10 and 4 steps (an update on the 4th), no validation: from
    the start of the first train step to the end of the last, nothing is read
    back from a tensor -- not inside a step, not between two steps -- so the
    host can run ahead of the card; the one fetch comes after the 4th step,
    and the stats are python numbers as before."""
    steps = {"done": 0, "inside": False}
    make = loop.make_train_step

    def counting(*args):
        step = make(*args)

        def train_step(*a):
            steps["inside"] = True
            out = step(*a)
            steps["inside"], steps["done"] = False, steps["done"] + 1
            return out

        return train_step

    cfg = tiny_cfg(*LOOP_OPTS, "LOG_PERIOD", "10", "TRAIN.NUM_TRAIN_TASKS", "4", "OUTPUT_DIR", str(tmp_path))
    with mock.patch.object(loop, "make_train_step", counting), host_reads(lambda: (steps["done"], steps["inside"])) as reads:
        stats = train_few_shot(cfg, device="cpu")
    early = [r for r in reads if r[1][1] or 0 < r[1][0] < 4]
    assert steps["done"] == 4 and early == []
    assert ("tolist", (4, False)) in reads  # the fetch at the loop's end
    assert stats["updates"] == 1 and len(stats["losses"]) == 4
    assert all(isinstance(x, float) for x in stats["losses"]) and isinstance(stats["updates"], int)
    assert np.isfinite(stats["losses"]).all()


def test_cli_trains_then_tests_the_trained_checkpoint(tmp_path):
    """TRAIN.ENABLE True through the CLI: one train step with one update,
    interleaved validation, a checkpoint, then test_few_shot in the same
    OUTPUT_DIR tests that checkpoint: its logits are those of the trained
    weights and not of the fresh ones."""
    out = str(tmp_path / "out")
    opts = [*TINY_OPTS, *LOOP_OPTS, "TRAIN.NUM_TRAIN_TASKS", "1", "TRAIN.BATCH_SIZE_PER_TASK", "1", "TRAIN.VAL_FRE_ITER", "1",
            "TRAIN.NUM_VAL_TASKS", "2", "OUTPUT_DIR", out]
    results = main(["--cfg", CONFIG, "--device", "cpu", *opts])
    assert results["train_few_shot"]["updates"] == 1 and np.isfinite(results["train_few_shot"]["losses"]).all()
    tested = results["test_few_shot"]
    ckpt = Checkpointer(out)
    assert ckpt.steps() == [1] and tested["weights"] == ckpt.path(1)

    cfg = tiny_cfg(*opts)
    model = build_few_shot_model(cfg, flow="test", device="cpu")
    fresh = evaluate(cfg, model, 4, 2, device="cpu")["episode_logits"]
    model.head.load_state_dict(ckpt.load()["head"])
    trained = evaluate(cfg, model, 4, 2, device="cpu")["episode_logits"]
    np.testing.assert_array_equal(tested["episode_logits"], trained)
    assert np.abs(tested["episode_logits"] - fresh).max() > 1e-4


def test_ema_weights_are_kept_validated_and_checkpointed(tmp_path):
    """MODEL.EMA: after one update from the fresh weights p0 to p1 the
    checkpointed EMA is decay * p0 + (1 - decay) * p1 (fp32, 1e-6), the
    interleaved validation on the EMA weights leaves the trained weights in
    the head, and a resumed run restores the EMA."""
    opts = [*LOOP_OPTS, "TRAIN.NUM_TRAIN_TASKS", "1", "TRAIN.BATCH_SIZE_PER_TASK", "1", "TRAIN.VAL_FRE_ITER", "1",
            "TRAIN.NUM_VAL_TASKS", "2", "MODEL.EMA.ENABLE", "True", "MODEL.EMA.DECAY", "0.5", "OUTPUT_DIR", str(tmp_path)]
    cfg = tiny_cfg(*opts)
    fresh = dict(build_few_shot_model(cfg, flow="train", device="cpu").head.named_parameters())
    assert train_few_shot(cfg, device="cpu")["updates"] == 1
    saved = Checkpointer(str(tmp_path)).load()
    for name, p0 in fresh.items():
        p1 = saved["head"][name]
        assert not torch.equal(saved["ema"][name], p1) or torch.equal(p0, p1), name
        torch.testing.assert_close(saved["ema"][name], 0.5 * p0.detach() + 0.5 * p1, atol=1e-6, rtol=1e-6)
    resumed = train_few_shot(tiny_cfg(*opts[:-2], "TRAIN.NUM_TRAIN_TASKS", "2", "OUTPUT_DIR", str(tmp_path)), device="cpu")
    assert resumed["steps"] == 1
    again = Checkpointer(str(tmp_path)).load()
    for name, e1 in saved["ema"].items():
        torch.testing.assert_close(again["ema"][name], 0.5 * e1 + 0.5 * again["head"][name], atol=1e-6, rtol=1e-6)


def test_model_info_line_is_logged_with_the_jax_parameter_count(tmp_path, caplog):
    """LOG_MODEL_INFO (true in base.yaml, so in every shipped config): train_few_shot logs one
    ``model_info`` JSON line, labelled head/backbone, whose parameter count is the JAX package's
    ``params_count`` of its model for the same tiny config; on the CPU the line has no memory entries,
    as the JAX package's has none where the backend reports no memory stats."""
    import json
    import logging

    from clip_fsar_tpu.utils.misc import params_count
    from clip_fsar_torch.utils.misc import device_mem_usage
    from tests.torch_parity import jax_tiny_model

    package_logger = logging.getLogger("clip_fsar_torch")  # it does not propagate to the root logger caplog listens on
    package_logger.addHandler(caplog.handler)
    cfg = tiny_cfg(*LOOP_OPTS, "TRAIN.NUM_TRAIN_TASKS", "1", "OUTPUT_DIR", str(tmp_path))
    assert cfg.LOG_MODEL_INFO
    try:
        with caplog.at_level(logging.INFO, logger="clip_fsar_torch"):
            train_few_shot(cfg, device="cpu")
    finally:
        package_logger.removeHandler(caplog.handler)
    lines = [json.loads(r.getMessage().split("json_stats: ", 1)[1]) for r in caplog.records if '"_type": "model_info"' in r.getMessage()]
    assert len(lines) == 1
    assert lines[0] == {"_type": "model_info", "label": "CNN_OTAM_CLIPFSAR/ViT-Tiny-Test", "params": params_count(jax_tiny_model()[3].variables["params"])}
    assert device_mem_usage("cpu") is None
