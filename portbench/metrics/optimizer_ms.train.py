"""``optimizer_ms.train``: device ms a step under the program's update
span (clip, AdamW, apply), over the traced steps."""


def read(rec):
    t = rec.get("traced")
    if not t or not t["split"]["optimizer_update"]:
        return None
    return t["split"]["optimizer_update"] / t["steps"] * 1e3
