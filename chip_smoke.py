"""Drive the port's few-shot test and train paths once on an NVIDIA GPU and check them.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero without them.  Each path is driven
through the port's CLI with every kernel launch count set to 0 just before it
and read just after.  Phases:

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
5. K3 vs plain: ``flash_mha_cuda`` against ``flash_mha_reference`` (o and
   lse) at the same ViT shapes as head-split views of a packed projection and
   at one cross-attention shape (Nq 128, Nk 256), fp32 and bf16, causal and
   not; timed at the test slice's [320, 12, 197, 64] bf16;
6. K4 / K5 vs plain: ``flash_mha_bwd_dq_cuda`` (with its delta pass) and
   ``flash_mha_bwd_dkv_cuda`` against their plain versions at the same
   shapes, timed at the train chunk's [480, 12, 197, 64] bf16; and K3 + K4 +
   K5 in fp32 against torch autograd of float64 softmax attention, causal
   and not;
7. test slice: the port's CLI ``main`` on the HMDB51 1-shot config with a
   ViT-B/16 tower at full width (fresh weights from the seed, synthetic
   decoder), 16 episodes in 4 steps of 4, three times: the fused path (K1 in
   every ViT layer of every step), the plain attention path, and
   ``TPU.PALLAS_ATTENTION True`` (K3 in every layer of every step); checks the
   episode count, finite logits, the launches, and both kernel paths' logits
   against the plain path's;
8. train slices: the CLI with TRAIN.ENABLE True on the same config and tower,
   on the fused path and then on the flash path: E = 4 episodes per step in 2
   chunks, BATCH_SIZE_PER_TASK 4, 8 steps (2 Adam updates), validation every
   4 steps, then the test protocol on 16 episodes from the step-8
   checkpoint; checks finite losses, the update count, every kernel's
   launches (every ViT layer of every chunk of every step, and of every eval
   step; none of the other path's kernels) and which checkpoint was tested;
9. the kernels inside the train step: one step's loss and gradients on each
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
# (B, H, Nq, Nk, Dh) for flash_mha: the same ViT shapes, and one cross-attention shape with Nq != Nk
FLASH_SHAPES = [(b, h, n, n, dh) for b, n, h, dh in KERNEL_SHAPES] + [(2, 12, 128, 256, 64)]
FLASH_OPTS = ["TPU.PALLAS_ATTENTION", "True"]

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


def _reset_launches() -> None:
    from clip_fsar_torch.ops import flash_attention
    from clip_fsar_torch.ops.fused_attention import clip_mha_bwd_cuda, clip_mha_cuda

    clip_mha_cuda.launches = clip_mha_bwd_cuda.launches = 0
    for name in flash_attention.LAUNCHES:
        flash_attention.LAUNCHES[name] = 0


def _launches() -> dict:
    """Every kernel's launches since the last reset, by kernel name."""
    from clip_fsar_torch.ops.flash_attention import LAUNCHES
    from clip_fsar_torch.ops.fused_attention import clip_mha_bwd_cuda, clip_mha_cuda

    return {"clip_mha_fwd": clip_mha_cuda.launches, "clip_mha_bwd": clip_mha_bwd_cuda.launches, **LAUNCHES}


def _expect_launches(what: str, **want: int) -> dict:
    """The launches since the last reset; raises unless the named kernels launched ``want`` times and
    every other kernel never."""
    got = _launches()
    expected = {name: want.get(name, 0) for name in got}
    if got != expected:
        raise AssertionError(f"{what} launched {got}, expected {expected}")
    return got


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


def _flash_inputs(b, h, nq, nk, dh, dtype, g) -> tuple:
    """q, k, v on the card: head-split views of one packed [B, N, 3*H*Dh] projection when Nq == Nk (as
    the ViT layers pass them), else contiguous [B, H, N, Dh] tensors."""
    from clip_fsar_torch.ops.attention import split_heads

    if nq == nk:
        qkv = torch.randn(b, nq, 3 * h * dh, generator=g).to("cuda", dtype)
        return tuple(split_heads(t, h) for t in qkv.chunk(3, dim=-1))
    return tuple(torch.randn(b, h, n, dh, generator=g).to("cuda", dtype) for n in (nq, nk, nk))


def _flash_cases():
    """(shape, dtype, tol, causal) at every FLASH_SHAPES entry, fp32 and bf16, causal and not."""
    for shape in FLASH_SHAPES:
        for dtype, tol in TOLERANCE.items():
            for causal in (False, True):
                yield shape, dtype, tol, causal


def phase_flash_fwd_vs_plain() -> dict:
    from clip_fsar_torch.ops.flash_attention import flash_mha_cuda, flash_mha_reference

    g = torch.Generator().manual_seed(2)
    worst = 0.0
    for (b, h, nq, nk, dh), dtype, tol, causal in _flash_cases():
        q, k, v = _flash_inputs(b, h, nq, nk, dh, dtype, g)
        o, lse = flash_mha_cuda(q, k, v, causal)
        torch.cuda.synchronize()
        ref_o, ref_lse = flash_mha_reference(q, k, v, causal)
        err = (o.float() - ref_o.float()).abs().max().item()
        print(f"K3 flash_mha_fwd [{b},{h},{nq},{nk},{dh}] {str(dtype)[6:]}{' causal' if causal else ''}: max|o-ref| {err:.3e} "
              f"max|lse-ref| {(lse - ref_lse).abs().max().item():.3e} (tol {tol})")
        torch.testing.assert_close(o.float(), ref_o.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
        worst = max(worst, err)
    b, n, _ = SLICE_SHAPE
    q, k, v = _flash_inputs(b, 12, n, n, 64, torch.bfloat16, g)
    ms, plain_ms, all_ms = _alternate(lambda: flash_mha_cuda(q, k, v), lambda: flash_mha_reference(q, k, v))
    print(f"K3 flash_mha_fwd [{b},12,{n},64] bf16 (views of [{b},{n},2304]): kernel {all_ms[0]:.4f} / {all_ms[1]:.4f} ms, "
          f"plain {all_ms[2]:.4f} / {all_ms[3]:.4f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def phase_flash_bwd_vs_plain() -> tuple:
    """K4 (with its delta pass) and K5 against their plain versions; returns the records of both."""
    from clip_fsar_torch.ops.flash_attention import (
        flash_mha,
        flash_mha_bwd_dkv_cuda,
        flash_mha_bwd_dkv_reference,
        flash_mha_bwd_dq_cuda,
        flash_mha_bwd_dq_reference,
        flash_mha_cuda,
    )

    g = torch.Generator().manual_seed(3)
    worst_dq = worst_dkv = 0.0

    def inputs(b, h, nq, nk, dh, dtype, causal):
        q, k, v = _flash_inputs(b, h, nq, nk, dh, dtype, g)
        o, lse = flash_mha_cuda(q, k, v, causal)
        do = torch.empty_like(o).copy_(torch.randn(o.shape, generator=g))  # o's layout, as autograd hands it over
        return q, k, v, o, lse, do

    for (b, h, nq, nk, dh), dtype, tol, causal in _flash_cases():
        q, k, v, o, lse, do = inputs(b, h, nq, nk, dh, dtype, causal)
        dq, delta = flash_mha_bwd_dq_cuda(q, k, v, o, lse, do, causal)
        dk, dv = flash_mha_bwd_dkv_cuda(q, k, v, lse, delta, do, causal)
        torch.cuda.synchronize()
        ref_dq, ref_delta = flash_mha_bwd_dq_reference(q, k, v, o, lse, do, causal)
        ref_dk, ref_dv = flash_mha_bwd_dkv_reference(q, k, v, lse, ref_delta, do, causal)
        errs = [(got.float() - want.float()).abs().max().item() for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv))]
        print(f"K4/K5 flash_mha_bwd [{b},{h},{nq},{nk},{dh}] {str(dtype)[6:]}{' causal' if causal else ''}: max|dq-ref| {errs[0]:.3e} "
              f"max|dk-ref| {errs[1]:.3e} max|dv-ref| {errs[2]:.3e} max|delta-ref| {(delta - ref_delta).abs().max().item():.3e} (tol {tol})")
        torch.testing.assert_close(delta, ref_delta, atol=1e-4, rtol=1e-4)
        for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
            torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
        worst_dq, worst_dkv = max(worst_dq, errs[0]), max(worst_dkv, *errs[1:])

    b, n, _ = TRAIN_SHAPE
    q, k, v, o, lse, do = inputs(b, 12, n, n, 64, torch.bfloat16, False)
    _, delta = flash_mha_bwd_dq_cuda(q, k, v, o, lse, do)
    dq_ms, dq_plain_ms, dq_all = _alternate(lambda: flash_mha_bwd_dq_cuda(q, k, v, o, lse, do),
                                            lambda: flash_mha_bwd_dq_reference(q, k, v, o, lse, do))
    dkv_ms, dkv_plain_ms, dkv_all = _alternate(lambda: flash_mha_bwd_dkv_cuda(q, k, v, lse, delta, do),
                                               lambda: flash_mha_bwd_dkv_reference(q, k, v, lse, delta, do))
    fwd_ms = _time_ms(lambda: flash_mha_cuda(q, k, v))
    shape = f"[{b},12,{n},64] bf16 (views of {list(TRAIN_SHAPE)})"
    print(f"K4 flash_mha_bwd_dq (delta pass + dQ) {shape}: kernel {dq_all[0]:.4f} / {dq_all[1]:.4f} ms, plain {dq_all[2]:.4f} / {dq_all[3]:.4f} ms")
    print(f"K5 flash_mha_bwd_dkv {shape}: kernel {dkv_all[0]:.4f} / {dkv_all[1]:.4f} ms, plain {dkv_all[2]:.4f} / {dkv_all[3]:.4f} ms")
    print(f"K3 flash_mha_fwd {shape}: kernel {fwd_ms:.4f} ms ((K4 + K5) / K3 = {(dq_ms + dkv_ms) / fwd_ms:.2f})")

    # the math, independently of the rounding replica: fp32 kernels vs autograd of float64 softmax attention
    for b, h, nq, nk, dh in ((4, 12, 197, 197, 64), (2, 12, 128, 256, 64)):
        for causal in (False, True):
            q, k, v = _flash_inputs(b, h, nq, nk, dh, torch.float32, g)
            do = torch.randn(b, h, nq, dh, generator=g).to("cuda")
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            flash_mha(*leaves, causal=causal).backward(do)
            ref = [t.detach().double().requires_grad_(True) for t in (q, k, v)]
            s = ref[0] @ ref[1].transpose(-1, -2) * dh**-0.5
            if causal:
                s = s.masked_fill(torch.ones(nq, nk, dtype=torch.bool, device="cuda").triu(1), float("-inf"))
            (torch.softmax(s, dim=-1) @ ref[2]).backward(do.double())
            err = max((x.grad.double() - y.grad).abs().max().item() for x, y in zip(leaves, ref))
            print(f"K3+K4+K5 grad vs float64 autograd [{b},{h},{nq},{nk},{dh}] fp32{' causal' if causal else ''}: max abs {err:.3e} (tol 1e-4)")
            for x, y in zip(leaves, ref):
                torch.testing.assert_close(x.grad.double(), y.grad, atol=1e-4, rtol=1e-4)
    return ({"max_abs_err": worst_dq, "ms": dq_ms, "plain_ms": dq_plain_ms},
            {"max_abs_err": worst_dkv, "ms": dkv_ms, "plain_ms": dkv_plain_ms})


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


def phase_test_slice(out_dir: str) -> None:
    """The test slice on the fused path (K1), the plain path and the flash path (K3), each path's
    launches counted from 0; both kernel paths' logits against the plain path's."""
    runs = {}
    # same weights and episodes on every path; the plain path launches no kernel
    for path, opts, want in (("fused", [], {"clip_mha_fwd": LAYERS * 4}), ("plain", PLAIN_OPTS, {}),
                             ("flash", FLASH_OPTS, {"flash_mha_fwd": LAYERS * 4})):
        _reset_launches()
        runs[path] = run_test_slice(opts, os.path.join(out_dir, path))
        _expect_launches(f"the {path}-path test slice ({LAYERS} layers x 4 steps)", **want)
    plain = runs["plain"]
    for path in ("fused", "flash"):
        diff = abs(runs[path]["episode_logits"] - plain["episode_logits"]).max()
        print(f"test slice logits, {path} kernel path vs plain attention: max abs diff {diff:.3e} (bf16 tol 2e-2); "
              f"{16 / runs[path]['seconds']:.3f} episodes/s {path}, {16 / plain['seconds']:.3f} plain")
        torch.testing.assert_close(torch.from_numpy(runs[path]["episode_logits"]), torch.from_numpy(plain["episode_logits"]),
                                   atol=2e-2, rtol=2e-2)


# the kernels each train path launches: (forward, backward kernels)
TRAIN_PATHS = {"fused": ([], ("clip_mha_fwd",), ("clip_mha_bwd",)),
               "flash": (FLASH_OPTS, ("flash_mha_fwd",), ("flash_mha_bwd_dq", "flash_mha_bwd_dkv"))}


def phase_train_slice(out_dir: str, path: str) -> dict:
    """A main path: train then test through the CLI, on the fused or the flash attention path."""
    from clip_fsar_torch.runs.run import main

    opts, fwd_kernels, bwd_kernels = TRAIN_PATHS[path]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    results = main(["--cfg", CONFIG, *TRAIN_OPTS, *opts, "OUTPUT_DIR", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want_bwd = LAYERS * TRAIN_STEPS * CHUNKS
    # every chunk's forward, then one eval step of 4 episodes per validation and 4 test steps
    want_fwd = want_bwd + LAYERS * (TRAIN_STEPS // VAL_EVERY + TEST_EPISODES // 4)
    launches = _expect_launches(f"the {path} train slice ({LAYERS} layers x {TRAIN_STEPS} steps x {CHUNKS} chunks, then eval)",
                                **{name: want_fwd for name in fwd_kernels}, **{name: want_bwd for name in bwd_kernels})
    peak = torch.cuda.max_memory_allocated()

    train, test = results["train_few_shot"], results["test_few_shot"]
    losses = train["losses"]
    print(f"train slice [{path}]: losses per step {[round(x, 5) for x in losses]}; {train['updates']} optimizer updates; "
          f"best val top1 {train['best_val_top1']:.2f}")
    if len(losses) != TRAIN_STEPS or not all(torch.isfinite(torch.tensor(losses))):
        raise AssertionError(f"expected {TRAIN_STEPS} finite losses, got {losses}")
    if train["updates"] != TRAIN_STEPS // ACCUM:
        raise AssertionError(f"expected {TRAIN_STEPS // ACCUM} optimizer updates, got {train['updates']}")
    if not test["weights"].endswith(os.path.join("checkpoints", f"{TRAIN_STEPS}.pt")):
        raise AssertionError(f"test_few_shot tested {test['weights']}, not the step-{TRAIN_STEPS} checkpoint")
    _check_test_stats(test)
    step_seconds = train["seconds"] - train["val_seconds"]
    eps = TRAIN_STEPS * EPISODES / step_seconds
    print(f"train slice [{path}]: {eps:.3f} train episodes/s ({TRAIN_STEPS * EPISODES} episodes, {TRAIN_STEPS * EPISODES * 240} frames, "
          f"in {step_seconds:.2f} s of steps; the loop took {train['seconds']:.2f} s with {train['val_seconds']:.2f} s of "
          f"validation and checkpoints); CLI wall {wall:.2f} s with the builds and the test of {test['weights']} "
          f"({TEST_EPISODES / test['seconds']:.3f} episodes/s, top1 {test['top1_acc']:.2f}); peak memory {peak / 2**30:.3f} GiB; "
          f"launches {launches}")
    return {"launches": launches, "episodes_per_s": eps, "peak_gib": peak / 2**30}


def phase_train_step_paths() -> None:
    """One train step's loss and gradients, each kernel path (fused, flash) against the plain
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
    paths = (("fused", ["TPU.ATTENTION_LAYOUT", "fused"], {"clip_mha_fwd": LAYERS * CHUNKS, "clip_mha_bwd": LAYERS * CHUNKS}),
             ("flash", FLASH_OPTS, {name: LAYERS * CHUNKS for name in ("flash_mha_fwd", "flash_mha_bwd_dq", "flash_mha_bwd_dkv")}),
             ("plain", PLAIN_OPTS, {}))
    for path, extra, want in paths:
        cfg = load_config(CONFIG, TRAIN_OPTS + extra)
        if not runs:
            with build_few_shot_loader(cfg, "train", num_steps=1, episodes_per_step=EPISODES) as loader:
                batch = next(iter(loader)).to(dev)
        model = build_few_shot_model(cfg, flow="train", device=dev)
        _reset_launches()
        metrics = make_grad_fn(model.head, cfg, model.text_train, model.text_test)(batch, step_generator(cfg, 0, dev))
        _expect_launches(f"one train step on the {path} path ({LAYERS} layers x {CHUNKS} chunks)", **want)
        named = dict(model.head.named_parameters())
        grads = {n: named[n].grad.float().clone() for n in picked}
        grads["context2"] = torch.cat([p.grad.float().flatten() for n, p in named.items() if n.startswith("context2.")])
        runs[path] = (metrics["loss"], grads)
        del model, named
        torch.cuda.empty_cache()
    loss_p, g_p = runs["plain"]
    for path in ("fused", "flash"):
        loss_k, g_k = runs[path]
        print(f"train step, {path} kernel path vs plain attention: loss {loss_k:.6f} vs {loss_p:.6f} (tol 2e-2)")
        torch.testing.assert_close(torch.tensor(loss_k), torch.tensor(loss_p), atol=2e-2, rtol=2e-2)
        for name in g_k:
            rel = ((g_k[name] - g_p[name]).norm() / g_p[name].norm()).item()
            print(f"train step grad [{path}] {name}: |kernel - plain| / |plain| = {rel:.3e} (tol {GRAD_REL_TOL}); "
                  f"|plain| = {g_p[name].norm().item():.4e}")
            if not rel <= GRAD_REL_TOL:
                raise AssertionError(f"gradient of {name} differs between the {path} and the plain path by {rel:.3e} (norm-relative)")


def main() -> None:
    phase_device()
    build_seconds = phase_build()
    timings = {"clip_mha_fwd": phase_fwd_vs_plain(), "clip_mha_bwd": phase_bwd_vs_plain(), "flash_mha_fwd": phase_flash_fwd_vs_plain()}
    timings["flash_mha_bwd_dq"], timings["flash_mha_bwd_dkv"] = phase_flash_bwd_vs_plain()
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as out_dir:
        phase_test_slice(out_dir)
        train = {path: phase_train_slice(os.path.join(out_dir, f"train_{path}"), path) for path in TRAIN_PATHS}
    phase_train_step_paths()

    print(f"summary: build {build_seconds:.2f} s; "
          + "; ".join(f"{path} train slice {t['episodes_per_s']:.3f} episodes/s, peak {t['peak_gib']:.3f} GiB" for path, t in train.items()))
    kernels = [
        ("clip_mha_fwd", "fused", "clip_fsar_torch/csrc/clip_mha_fwd.cu", "clip_fsar_tpu/ops/fused_attention.py:71"),
        ("clip_mha_bwd", "fused", "clip_fsar_torch/csrc/clip_mha_bwd.cu", "clip_fsar_tpu/ops/fused_attention.py:97"),
        ("flash_mha_fwd", "flash", "clip_fsar_torch/csrc/flash_mha_fwd.cu", "clip_fsar_tpu/ops/flash_attention.py:47"),
        ("flash_mha_bwd_dq", "flash", "clip_fsar_torch/csrc/flash_mha_bwd.cu", "clip_fsar_tpu/ops/flash_attention.py:98"),
        ("flash_mha_bwd_dkv", "flash", "clip_fsar_torch/csrc/flash_mha_bwd.cu", "clip_fsar_tpu/ops/flash_attention.py:123"),
    ]
    # launches: each kernel's count from the train slice (train, validation, test) of its own path
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": train[path]["launches"][name],
         "max_abs_err": timings[name]["max_abs_err"], "ms": timings[name]["ms"], "plain_ms": timings[name]["plain_ms"]}
        for name, path, source, replaces in kernels
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
