"""Evaluate's accounting: host milliseconds a test step's outputs take to be counted once on the host
(train/loop.py evaluate, consume after the read, and the periodic log line): the total of the program's
fsar.eval.account spans (utils/tracing.py) over the traced run's steps, per call of fsar.step.  Host time under
the profiler, so higher than the same work untraced."""


def read(ctx):
    try:
        from clip_fsar_torch.utils import tracing
    except ImportError:
        return None
    by_name = tracing.collect()["by_name"]
    steps = by_name.get("fsar.step", {}).get("calls", 0)
    total = by_name.get("fsar.eval.account", {}).get("total_ns", 0)
    return total / steps / 1e6 if steps and total else None
