"""Attention kernels (ops/fused_attention.py, csrc/clip_mha_fwd.cu, csrc/clip_mha_bwd.cu): the
least time the card needs for the train or test steps' K1 (and K2) launches at their shapes, counted in
portbench/counts/, over the device time of the kernels named clip_mha*."""


def read(ctx):
    from portbench.peaks import bound_s

    t = ctx["trace"]
    if not t:
        return None
    spent = t["groups"].get("clip_mha", 0.0) + t["groups"].get("clip_mha_bwd", 0.0)
    work = ctx["counts"].attention_work(ctx["cfg"], ctx["kind"], ctx["episodes_per_step"])
    if spent <= 0 or not work:
        return None
    need = t["steps"] * sum(bound_s(b, f, ctx["peak"]) for b, f in work)
    return 100.0 * need / spent
