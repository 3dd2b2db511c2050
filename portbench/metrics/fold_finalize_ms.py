"""``fold_finalize_ms``: host ms a round in the accumulator's
``finalize`` (staging, ``scatter_wsum``, the base, the cast and the copy
back, which ends in a device sync), over the window's rounds."""


def read(rec):
    h = rec.get("host_s_per_round")
    return None if h is None else h["finalize"] * 1e3
