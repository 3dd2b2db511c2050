"""``peak_gb.train``: the card's allocated peak over the window (GB),
from its statistics reset at the window's start."""


def read(rec):
    b = rec.get("peak_window_bytes")
    return b / 1e9 if b else None
