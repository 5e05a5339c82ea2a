"""Whole step: model FLOPs of the train or test steps (portbench/counts/: forward, and the backward of what
trains; nothing recomputed) done in the traced run's window outside the profiler, over its wall
time, as a share of the card's bf16 dense peak."""


def read(ctx):
    w = ctx["window"]
    if w["rest_samples"] <= 0 or w["rest_seconds"] <= 0:
        return None
    e = ctx["episodes_per_step"]
    steps = w["rest_samples"] / e
    return 100.0 * steps * ctx["counts"].model_flops(ctx["cfg"], ctx["kind"], e) / w["rest_seconds"] / ctx["peak"]["bf16_flops"]
