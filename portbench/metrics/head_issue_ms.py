"""Head: host milliseconds a train or test step spends issuing its forward outside the vision tower (the
prototype modulation, OTAM and the losses or the episode metrics: train/step.py, models/heads/clipfsar.py):
the program's fsar.forward spans (utils/tracing.py) less the fsar.tower spans inside them, over the traced
run's steps, per call of fsar.step.  Host time under the profiler, so higher than the same work untraced."""


def read(ctx):
    try:
        from clip_fsar_torch.utils import tracing
    except ImportError:
        return None
    by_name = tracing.collect()["by_name"]
    steps = by_name.get("fsar.step", {}).get("calls", 0)
    forward = by_name.get("fsar.forward", {}).get("total_ns", 0)
    tower = by_name.get("fsar.tower", {}).get("total_ns", 0)
    return (forward - tower) / steps / 1e6 if steps and forward else None
