"""MoLo's decoder: host milliseconds a train step spends issuing the two decoder calls that rebuild the frame
differences (models/heads/molo.py MoLoHead._decode: upsampling, 3x3 conv, BatchNorm on per-episode statistics,
ReLU, three times, then the 1x1 conv to RGB): the total of the program's fsar.molo.decode spans
(utils/tracing.py) over the traced run's steps, per call of fsar.step.  Host time under the profiler, so higher
than the same work untraced."""


def read(ctx):
    try:
        from clip_fsar_torch.utils import tracing
    except ImportError:
        return None
    by_name = tracing.collect()["by_name"]
    steps = by_name.get("fsar.step", {}).get("calls", 0)
    total = by_name.get("fsar.molo.decode", {}).get("total_ns", 0)
    return total / steps / 1e6 if steps and total else None
