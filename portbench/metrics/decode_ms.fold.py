"""``decode_ms.fold``: host ms a round in ``decode_fit_res`` of the sites'
frames (the round base attached), over the window's rounds."""


def read(rec):
    h = rec.get("host_s_per_round")
    return None if h is None else h["decode"] * 1e3
