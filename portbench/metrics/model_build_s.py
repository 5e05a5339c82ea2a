"""Set-up: host seconds the process spends building the model and the train state (models/builder.py make_head,
train/state.py TrainState.create, train/optimizer.py Optimizer): the total of the program's fsar.setup.model
and fsar.setup.state spans (utils/tracing.py), which record with or without a profiler, over the process."""


def read(ctx):
    try:
        from clip_fsar_torch.utils import tracing
    except ImportError:
        return None
    by_name = tracing.collect()["by_name"]
    total = sum(by_name.get(name, {}).get("total_ns", 0) for name in ("fsar.setup.model", "fsar.setup.state"))
    return total / 1e9 if total else None
