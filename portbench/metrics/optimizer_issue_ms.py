"""Optimizer: host milliseconds a train step spends issuing the optimizer's micro-step (train/step.py,
train/optimizer.py Optimizer.step, BatchNorm.commit, zero_grad and the EMA): the total of the program's
fsar.optimizer spans (utils/tracing.py) over the traced run's steps, per call of fsar.step.  Host time under
the profiler, so higher than the same work untraced."""


def read(ctx):
    try:
        from clip_fsar_torch.utils import tracing
    except ImportError:
        return None
    by_name = tracing.collect()["by_name"]
    steps = by_name.get("fsar.step", {}).get("calls", 0)
    total = by_name.get("fsar.optimizer", {}).get("total_ns", 0)
    return total / steps / 1e6 if steps and total else None
