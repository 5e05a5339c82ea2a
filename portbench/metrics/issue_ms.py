"""Step, launch thread: the host's mean milliseconds from the train or test step's call to its return
(train/step.py, train/optimizer.py, make_eval_step; the step reads nothing back), over the traced run's steps
outside the profiler."""


def read(ctx):
    calls = ctx["spans"].get("issue")
    return sum(calls) / len(calls) if calls else None
