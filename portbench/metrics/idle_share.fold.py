"""``idle_share.fold``: the share of the window in which the card ran
nothing (%): the device's busy time a traced round (the union of its
kernel, copy and set intervals, from a trace of the device alone; copies
over the host link count as busy) over the window's mean round time."""


def read(rec):
    t = rec.get("traced")
    if not t or not t.get("busy_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["rounds"]
                    / (rec["window_s"] / rec["window_rounds"]))
