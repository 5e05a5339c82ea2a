"""Backward: host milliseconds a train step spends issuing its backward (train/step.py: each episode chunk's
loss.backward(), then the gradients' division by the chunk count): the total of the program's fsar.backward
spans (utils/tracing.py) over the traced run's steps, per call of fsar.step.  Host time under the profiler,
so higher than the same work untraced."""


def read(ctx):
    try:
        from clip_fsar_torch.utils import tracing
    except ImportError:
        return None
    by_name = tracing.collect()["by_name"]
    steps = by_name.get("fsar.step", {}).get("calls", 0)
    total = by_name.get("fsar.backward", {}).get("total_ns", 0)
    return total / steps / 1e6 if steps and total else None
