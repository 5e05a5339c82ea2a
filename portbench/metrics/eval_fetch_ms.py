"""Evaluate's read-back: host milliseconds a test step's outputs take to reach the host (train/loop.py evaluate,
consume: the .cpu() reads of the step before, which wait for the card): the total of the program's
fsar.eval.fetch spans (utils/tracing.py) over the traced run's steps, per call of fsar.step.  Host time under
the profiler, so higher than the same work untraced."""


def read(ctx):
    try:
        from clip_fsar_torch.utils import tracing
    except ImportError:
        return None
    by_name = tracing.collect()["by_name"]
    steps = by_name.get("fsar.step", {}).get("calls", 0)
    total = by_name.get("fsar.eval.fetch", {}).get("total_ns", 0)
    return total / steps / 1e6 if steps and total else None
