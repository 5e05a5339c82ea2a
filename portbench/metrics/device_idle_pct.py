"""Device: the share of the profiled train steps' window in which no kernel or copy ran on the
card: 100 - the union of the device events over the window, from the first step's start to the
last event's end."""


def read(ctx):
    t = ctx["trace"]
    if not t or not t["device_events"] or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
