"""Host data: the mean wait of the train or test loop for its next batch (data/loader.py, data/frame_bank.py's
samplers, data/types.py), by the host clock, over the traced run's steps outside the profiler."""


def read(ctx):
    waits = ctx["spans"].get("loader_wait")
    return sum(waits) / len(waits) if waits else None
