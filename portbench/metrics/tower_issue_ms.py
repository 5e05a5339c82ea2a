"""Tower: host milliseconds a train or test step spends issuing the vision tower (models/heads/clipfsar.py
CLIPFSARHead._encode): the total of the program's fsar.tower spans (utils/tracing.py) over the traced run's
steps, per call of fsar.step.  Host time under the profiler, so higher than the same work untraced."""


def read(ctx):
    try:
        from clip_fsar_torch.utils import tracing
    except ImportError:
        return None
    by_name = tracing.collect()["by_name"]
    steps = by_name.get("fsar.step", {}).get("calls", 0)
    total = by_name.get("fsar.tower", {}).get("total_ns", 0)
    return total / steps / 1e6 if steps and total else None
