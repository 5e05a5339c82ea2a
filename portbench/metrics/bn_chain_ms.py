"""RN tower: device milliseconds a train or test step in the BatchNorm chain (models/clip/model.py
BatchNorm): the kernels under the bn_chain ranges around every BatchNorm forward, and of the
autograd node _BatchNormFnBackward."""


def read(ctx):
    t = ctx["trace"]
    if not t:
        return None
    r = t["ranges"]
    ms = 1e3 * (r.get("bn_chain", 0.0) + (r.get("_BatchNormFnBackward", 0.0)
                                         or r.get("autograd::engine::evaluate_function: _BatchNormFnBackward", 0.0)))
    return ms / t["steps"] if ms > 0 else None
