"""``scatter_wsum_roofline``: the least time the round's ``scatter_wsum``
launches could take (``counts.scatter_bound_s``: each value, index and
scale read once, 16 B of fp64 accumulator a coordinate, against HBM) over
the device time of the kernels named so, per traced round (%)."""


def read(rec):
    t, bound = rec.get("traced"), rec.get("scatter_bound_s_per_round")
    if not t or not bound or not t.get("scatter_s"):
        return None
    return 100.0 * bound / (t["scatter_s"] / t["rounds"])
