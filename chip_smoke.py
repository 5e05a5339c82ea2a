"""Drive the port's few-shot test and train paths once on an NVIDIA GPU and check them.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero without them.  Phases:

1. device: the card's name and power limit, torch / CUDA versions, and
   whether the host packages the data path needs (yaml, regex, cv2) import;
2. build: compile the CUDA kernels from ``clip_fsar_torch/csrc``, one nvcc
   per source, all started together;
3. K1 vs plain: ``clip_mha_cuda`` against ``clip_mha_reference`` at the ViT
   shapes and at the test slice's shape [320, 197, 2304] bf16, where both are
   also timed with CUDA events;
4. K2 vs plain: ``clip_mha_bwd_cuda`` against ``clip_mha_bwd_reference`` at
   the same ViT shapes and at the train slice's shape [480, 197, 2304] bf16,
   timed there; and the two kernels' gradient against torch autograd of
   plain float64 softmax attention at two shapes;
5. test slice: the port's CLI ``main`` on the HMDB51 1-shot config with a
   ViT-B/16 tower at full width (fresh weights from the seed, synthetic
   decoder), 16 episodes in 4 steps of 4; checks the episode count, finite
   logits and that every ViT layer of every step launched K1; then the same
   slice on the plain attention path, logits compared;
6. train slice: the CLI with TRAIN.ENABLE True on the same config and tower:
   E = 4 episodes per step in 2 chunks, BATCH_SIZE_PER_TASK 4, 8 steps (2
   Adam updates), validation every 4 steps, then the test protocol on 16
   episodes from the step-8 checkpoint; checks finite losses, the update
   count, the launches of K1 and K2 (every ViT layer of every chunk of every
   step, and of every eval step) and which checkpoint was tested;
7. the kernels inside the train step: one step's loss and gradients on the
   kernel path against the plain attention path, same weights, batch and
   random draws.

The second-to-last line is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Any failed phase raises before it.
"""

from __future__ import annotations

import importlib
import json
import os
import tempfile
import time

import torch

# the test slice: HMDB51 1-shot config, ViT-B/16, synthetic decoder, 16 episodes in steps of 4
from clip_fsar_torch.tools.profile_eval import CONFIG, PLAIN_OPTS, SLICE_OPTS, card

REPO = os.path.dirname(os.path.abspath(__file__))
# (B, N, H, Dh): the ViT-B/32, B/16, L/14, L/14@336px sequence lengths at
# 12 and 16 heads, plus the tiny test tower's Dh = 32, H = 2
KERNEL_SHAPES = [(4, n, h, 64) for n in (50, 197, 257, 577) for h in (12, 16)] + [(4, 17, 2, 32)]
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # atol = rtol: summation order (fp32); rounding of p, dS and the outputs (bf16)
SLICE_SHAPE = (320, 197, 2304)  # test slice: E=4 episodes x 10 clips x 8 frames, N=197, 3*768

# the train slice: the flagship's E = 4 and BATCH_SIZE_PER_TASK 4; 2 episode chunks so that the
# eager activations (about 26 GB per episode of 240 frames) fit the card's 80 GB
EPISODES, CHUNKS, ACCUM, TRAIN_STEPS, VAL_EVERY, TEST_EPISODES = 4, 2, 4, 8, 4, 16
LAYERS = 12
TRAIN_SHAPE = (EPISODES // CHUNKS * 30 * 8, 197, 2304)  # one chunk: 2 episodes x 30 clips x 8 frames
TRAIN_OPTS = [
    "VIDEO.HEAD.BACKBONE_NAME", "ViT-B/16",
    "TRAIN.ENABLE", "True",
    "DATA.DECODER", "synthetic",
    "TPU.EPISODES_PER_STEP", str(EPISODES),
    "TPU.EPISODE_CHUNKS", str(CHUNKS),
    "TRAIN.BATCH_SIZE_PER_TASK", str(ACCUM),
    "TRAIN.NUM_TRAIN_TASKS", str(TRAIN_STEPS),
    "TRAIN.VAL_FRE_ITER", str(VAL_EVERY),
    "TRAIN.NUM_VAL_TASKS", "4",
    "TPU.EVAL_EPISODES_PER_STEP", "4",
    "TRAIN.NUM_TEST_TASKS", str(TEST_EPISODES),
    "TEST.BATCH_SIZE", "4",
    "LOG_PERIOD", "1",
]
# norm-relative gradient error allowed between the kernel and the plain attention path in one bf16 train
# step: each bf16 rounding is ~4e-3 relative, and the two paths round attention at different points
# through 12 layers of backward
GRAD_REL_TOL = 5e-2


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device; this script runs on the GPU only")
    smi = card()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    for mod in ("yaml", "regex", "cv2"):
        try:
            importlib.import_module(mod)
            print(f"host package {mod}: ok")
        except ImportError as e:
            print(f"host package {mod}: MISSING ({e})")
    return smi


def phase_build() -> float:
    from clip_fsar_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    seconds = time.perf_counter() - t0
    print(f"build: {seconds:.2f} s -> {os.path.relpath(path, REPO)}")
    with open(os.path.join(os.path.dirname(path), "nvcc.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line or line.startswith("=="):
                print("  ptxas:", line.strip())
    return seconds


def _time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _alternate(kernel, plain, iters: int = 20) -> tuple:
    """Kernel and plain times (ms), taken kernel, plain, kernel, plain; the better of each pair."""
    k1, p1, k2, p2 = _time_ms(kernel, iters), _time_ms(plain, iters), _time_ms(kernel, iters), _time_ms(plain, iters)
    return min(k1, k2), min(p1, p2), (k1, k2, p1, p2)


def phase_fwd_vs_plain() -> dict:
    from clip_fsar_torch.ops.fused_attention import clip_mha_cuda, clip_mha_reference

    g = torch.Generator().manual_seed(0)
    worst = 0.0
    for b, n, h, dh in KERNEL_SHAPES + [(SLICE_SHAPE[0], SLICE_SHAPE[1], 12, 64)]:
        for dtype, tol in TOLERANCE.items():
            if b == SLICE_SHAPE[0] and dtype != torch.bfloat16:
                continue
            qkv = torch.randn(b, n, 3 * h * dh, generator=g).to("cuda", dtype)
            o, lse = clip_mha_cuda(qkv, h)
            torch.cuda.synchronize()
            ref_o, ref_lse = clip_mha_reference(qkv, h)
            err = (o.float() - ref_o.float()).abs().max().item()
            print(f"K1 clip_mha_fwd [{b},{n},{3 * h * dh}] H={h} Dh={dh} {str(dtype)[6:]}: max|o-ref| {err:.3e} "
                  f"max|lse-ref| {(lse - ref_lse).abs().max().item():.3e} (tol {tol})")
            torch.testing.assert_close(o.float(), ref_o.float(), atol=tol, rtol=tol)
            torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
            worst = max(worst, err)
    ms, plain_ms, all_ms = _alternate(lambda: clip_mha_cuda(qkv, 12), lambda: clip_mha_reference(qkv, 12))
    print(f"K1 clip_mha_fwd {list(SLICE_SHAPE)} bf16: kernel {all_ms[0]:.4f} / {all_ms[1]:.4f} ms, plain {all_ms[2]:.4f} / {all_ms[3]:.4f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def phase_bwd_vs_plain() -> dict:
    from clip_fsar_torch.ops.fused_attention import clip_mha, clip_mha_bwd_cuda, clip_mha_bwd_reference, clip_mha_cuda

    g = torch.Generator().manual_seed(1)
    worst = 0.0
    for b, n, h, dh in KERNEL_SHAPES + [(TRAIN_SHAPE[0], TRAIN_SHAPE[1], 12, 64)]:
        for dtype, tol in TOLERANCE.items():
            if b == TRAIN_SHAPE[0] and dtype != torch.bfloat16:
                continue
            qkv = torch.randn(b, n, 3 * h * dh, generator=g).to("cuda", dtype)
            do = torch.randn(b, n, h * dh, generator=g).to("cuda", dtype)
            o, lse = clip_mha_cuda(qkv, h)
            dqkv = clip_mha_bwd_cuda(qkv, o, lse, do, h)
            torch.cuda.synchronize()
            ref = clip_mha_bwd_reference(qkv, o, lse, do, h)
            err = (dqkv.float() - ref.float()).abs().max().item()
            print(f"K2 clip_mha_bwd [{b},{n},{3 * h * dh}] H={h} Dh={dh} {str(dtype)[6:]}: max|dqkv-ref| {err:.3e} (tol {tol})")
            torch.testing.assert_close(dqkv.float(), ref.float(), atol=tol, rtol=tol)
            worst = max(worst, err)
    ms, plain_ms, all_ms = _alternate(lambda: clip_mha_bwd_cuda(qkv, o, lse, do, 12), lambda: clip_mha_bwd_reference(qkv, o, lse, do, 12))
    print(f"K2 clip_mha_bwd {list(TRAIN_SHAPE)} bf16: kernel {all_ms[0]:.4f} / {all_ms[1]:.4f} ms, plain {all_ms[2]:.4f} / {all_ms[3]:.4f} ms")
    fwd_ms = _time_ms(lambda: clip_mha_cuda(qkv, 12))
    print(f"K1 clip_mha_fwd {list(TRAIN_SHAPE)} bf16: kernel {fwd_ms:.4f} ms (K2 / K1 = {ms / fwd_ms:.2f})")

    # the math, independently of the rounding replica: fp32 kernels vs autograd of float64 softmax attention
    for b, n, h, dh in ((4, 197, 12, 64), (2, 577, 16, 64)):
        qkv = torch.randn(b, n, 3 * h * dh, generator=g).to("cuda")
        do = torch.randn(b, n, h * dh, generator=g).to("cuda")
        x = qkv.clone().requires_grad_(True)
        clip_mha(x, h).backward(do)
        y = qkv.double().requires_grad_(True)
        q, k, v = y.reshape(b, n, 3, h, dh).permute(2, 0, 3, 1, 4).unbind(0)
        out = torch.softmax(q @ k.transpose(-1, -2) * dh**-0.5, dim=-1) @ v
        out.transpose(1, 2).reshape(b, n, h * dh).backward(do.double())
        err = (x.grad.double() - y.grad).abs().max().item()
        print(f"K1+K2 grad vs float64 autograd [{b},{n},{3 * h * dh}] fp32: max abs {err:.3e} (tol 1e-4)")
        torch.testing.assert_close(x.grad.double(), y.grad, atol=1e-4, rtol=1e-4)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def run_test_slice(extra_opts, out_dir: str) -> dict:
    from clip_fsar_torch.runs.run import main

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = main(["--cfg", CONFIG, *SLICE_OPTS, "OUTPUT_DIR", out_dir, *extra_opts])["test_few_shot"]
    torch.cuda.synchronize()
    stats["wall_seconds"] = time.perf_counter() - t0
    stats["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    _check_test_stats(stats)
    frames = 16 * 10 * 8
    print(f"test slice {extra_opts or 'default'}: top1 {stats['top1_acc']:.2f} loss {stats['loss']:.5f}; "
          f"{16 / stats['seconds']:.3f} episodes/s, {frames / stats['seconds']:.1f} frames/s over the {stats['seconds']:.2f} s "
          f"episode loop ({stats['wall_seconds']:.2f} s with the model build); "
          f"peak memory {stats['max_memory_allocated'] / 2**30:.3f} GiB")
    return stats


def _check_test_stats(stats: dict) -> None:
    logits = stats["episode_logits"]
    if logits.shape != (16, 5, 5):
        raise AssertionError(f"expected logits for 16 episodes of 5 queries x 5 ways, got {logits.shape}")
    if stats["episodes"] != 16:
        raise AssertionError(f"expected metrics for 16 episodes, got {stats['episodes']}")
    if not torch.isfinite(torch.from_numpy(logits)).all():
        raise AssertionError("non-finite logits")


def phase_test_slice(out_dir: str) -> int:
    from clip_fsar_torch.ops.fused_attention import clip_mha_bwd_cuda, clip_mha_cuda

    clip_mha_cuda.launches = clip_mha_bwd_cuda.launches = 0
    fused = run_test_slice([], os.path.join(out_dir, "fused"))
    launches = (clip_mha_cuda.launches, clip_mha_bwd_cuda.launches)
    if launches != (LAYERS * 4, 0):
        raise AssertionError(f"test slice launched (K1, K2) {launches} times, expected ({LAYERS} layers x 4 steps, 0)")

    clip_mha_cuda.launches = 0
    # same weights and episodes; attention through the plain path
    plain = run_test_slice(PLAIN_OPTS, os.path.join(out_dir, "plain"))
    if clip_mha_cuda.launches:
        raise AssertionError(f"the plain-path test slice launched clip_mha {clip_mha_cuda.launches} times")
    diff = abs(fused["episode_logits"] - plain["episode_logits"]).max()
    print(f"test slice logits, kernel vs plain attention: max abs diff {diff:.3e} (bf16 tol 2e-2); "
          f"{16 / fused['seconds']:.3f} episodes/s kernel, {16 / plain['seconds']:.3f} plain")
    torch.testing.assert_close(torch.from_numpy(fused["episode_logits"]), torch.from_numpy(plain["episode_logits"]), atol=2e-2, rtol=2e-2)
    return launches[0]


def phase_train_slice(out_dir: str) -> dict:
    """The main path of this slice: train then test through the CLI."""
    from clip_fsar_torch.ops.fused_attention import clip_mha_bwd_cuda, clip_mha_cuda
    from clip_fsar_torch.runs.run import main

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clip_mha_cuda.launches = clip_mha_bwd_cuda.launches = 0
    t0 = time.perf_counter()
    results = main(["--cfg", CONFIG, *TRAIN_OPTS, "OUTPUT_DIR", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"clip_mha_fwd": clip_mha_cuda.launches, "clip_mha_bwd": clip_mha_bwd_cuda.launches}
    peak = torch.cuda.max_memory_allocated()

    train, test = results["train_few_shot"], results["test_few_shot"]
    losses = train["losses"]
    print(f"train slice: losses per step {[round(x, 5) for x in losses]}; {train['updates']} optimizer updates; "
          f"best val top1 {train['best_val_top1']:.2f}")
    if len(losses) != TRAIN_STEPS or not all(torch.isfinite(torch.tensor(losses))):
        raise AssertionError(f"expected {TRAIN_STEPS} finite losses, got {losses}")
    if train["updates"] != TRAIN_STEPS // ACCUM:
        raise AssertionError(f"expected {TRAIN_STEPS // ACCUM} optimizer updates, got {train['updates']}")
    want_bwd = LAYERS * TRAIN_STEPS * CHUNKS
    # every chunk's forward, then one eval step of 4 episodes per validation and 4 test steps
    want_fwd = want_bwd + LAYERS * (TRAIN_STEPS // VAL_EVERY + TEST_EPISODES // 4)
    if launches != {"clip_mha_fwd": want_fwd, "clip_mha_bwd": want_bwd}:
        raise AssertionError(f"launches {launches}, expected K1 {want_fwd} and K2 {want_bwd} ({LAYERS} layers x {TRAIN_STEPS} steps x {CHUNKS} chunks)")
    if not test["weights"].endswith(os.path.join("checkpoints", f"{TRAIN_STEPS}.pt")):
        raise AssertionError(f"test_few_shot tested {test['weights']}, not the step-{TRAIN_STEPS} checkpoint")
    _check_test_stats(test)
    step_seconds = train["seconds"] - train["val_seconds"]
    eps = TRAIN_STEPS * EPISODES / step_seconds
    print(f"train slice: {eps:.3f} train episodes/s ({TRAIN_STEPS * EPISODES} episodes, {TRAIN_STEPS * EPISODES * 240} frames, "
          f"in {step_seconds:.2f} s of steps; the loop took {train['seconds']:.2f} s with {train['val_seconds']:.2f} s of "
          f"validation and checkpoints); CLI wall {wall:.2f} s with the builds and the test of {test['weights']} "
          f"({TEST_EPISODES / test['seconds']:.3f} episodes/s, top1 {test['top1_acc']:.2f}); peak memory {peak / 2**30:.3f} GiB; "
          f"launches {launches}")
    return {"launches": launches, "episodes_per_s": eps, "peak_gib": peak / 2**30}


def phase_train_step_paths() -> None:
    """One train step's loss and gradients, kernel path against the plain
    attention path (fp32 logits), same fresh weights, batch and generator."""
    from clip_fsar_torch import runtime
    from clip_fsar_torch.data.loader import build_few_shot_loader
    from clip_fsar_torch.models.builder import build_few_shot_model
    from clip_fsar_torch.runs.run import load_config
    from clip_fsar_torch.train.loop import step_generator
    from clip_fsar_torch.train.step import make_grad_fn

    dev = runtime.device("cuda")
    picked = ("backbone.transformer.resblocks.0.attn.in_proj_weight", f"backbone.transformer.resblocks.{LAYERS - 1}.attn.in_proj_weight")
    runs = {}
    for path, extra in (("kernel", ["TPU.ATTENTION_LAYOUT", "fused"]), ("plain", PLAIN_OPTS)):
        cfg = load_config(CONFIG, TRAIN_OPTS + extra)
        if path == "kernel":
            with build_few_shot_loader(cfg, "train", num_steps=1, episodes_per_step=EPISODES) as loader:
                batch = next(iter(loader)).to(dev)
        model = build_few_shot_model(cfg, flow="train", device=dev)
        metrics = make_grad_fn(model.head, cfg, model.text_train, model.text_test)(batch, step_generator(cfg, 0, dev))
        named = dict(model.head.named_parameters())
        grads = {n: named[n].grad.float().clone() for n in picked}
        grads["context2"] = torch.cat([p.grad.float().flatten() for n, p in named.items() if n.startswith("context2.")])
        runs[path] = (metrics["loss"], grads)
        del model, named
        torch.cuda.empty_cache()
    (loss_k, g_k), (loss_p, g_p) = runs["kernel"], runs["plain"]
    print(f"train step, kernel vs plain attention: loss {loss_k:.6f} vs {loss_p:.6f} (tol 2e-2)")
    torch.testing.assert_close(torch.tensor(loss_k), torch.tensor(loss_p), atol=2e-2, rtol=2e-2)
    for name in g_k:
        rel = ((g_k[name] - g_p[name]).norm() / g_p[name].norm()).item()
        print(f"train step grad {name}: |kernel - plain| / |plain| = {rel:.3e} (tol {GRAD_REL_TOL}); |plain| = {g_p[name].norm().item():.4e}")
        if not rel <= GRAD_REL_TOL:
            raise AssertionError(f"gradient of {name} differs between the kernel and the plain path by {rel:.3e} (norm-relative)")


def main() -> None:
    phase_device()
    build_seconds = phase_build()
    fwd = phase_fwd_vs_plain()
    bwd = phase_bwd_vs_plain()
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as out_dir:
        phase_test_slice(out_dir)
        train = phase_train_slice(os.path.join(out_dir, "train"))
    phase_train_step_paths()

    print(f"summary: build {build_seconds:.2f} s; train slice {train['episodes_per_s']:.3f} episodes/s, peak {train['peak_gib']:.3f} GiB")
    kernels = [
        ("clip_mha_fwd", "clip_fsar_torch/csrc/clip_mha_fwd.cu", "clip_fsar_tpu/ops/fused_attention.py:71", fwd),
        ("clip_mha_bwd", "clip_fsar_torch/csrc/clip_mha_bwd.cu", "clip_fsar_tpu/ops/fused_attention.py:97", bwd),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": train["launches"][name],
         "max_abs_err": timing["max_abs_err"], "ms": timing["ms"], "plain_ms": timing["plain_ms"]}
        for name, source, replaces, timing in kernels
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
