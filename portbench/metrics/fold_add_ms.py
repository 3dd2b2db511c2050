"""``fold_add_ms``: host ms a round in the accumulator's ``add`` of the
sites' results, over the window's rounds."""


def read(rec):
    h = rec.get("host_s_per_round")
    return None if h is None else h["add"] * 1e3
