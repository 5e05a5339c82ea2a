"""MoLo's motion stream: host milliseconds a train step spends issuing the motion Conv3d, its 3x3 conv and the
frame difference (models/heads/molo.py MoLoHead.forward): the total of the program's fsar.molo.motion spans
(utils/tracing.py) over the traced run's steps, per call of fsar.step.  Host time under the profiler, so higher
than the same work untraced."""


def read(ctx):
    try:
        from clip_fsar_torch.utils import tracing
    except ImportError:
        return None
    by_name = tracing.collect()["by_name"]
    steps = by_name.get("fsar.step", {}).get("calls", 0)
    total = by_name.get("fsar.molo.motion", {}).get("total_ns", 0)
    return total / steps / 1e6 if steps and total else None
