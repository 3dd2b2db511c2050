"""``idle_share.train``: the share of the window in which the card ran
nothing (%): the device's busy time a traced step (the union of its
kernel, copy and set intervals, from a trace of the device alone) over
the window's mean step time.  Tracing slows the host's launches, not the
kernels, so the traced step's own wall time would count the tracer's
work as idle."""


def read(rec):
    t = rec.get("traced")
    if not t or not t.get("busy_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["steps"] / t["window_step_s"])
