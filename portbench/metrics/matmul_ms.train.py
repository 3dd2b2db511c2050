"""``matmul_ms.train``: device ms a step in the bf16 GEMMs (the trunk's
and the MLP's or experts' projections, the head), over the traced
steps."""


def read(rec):
    t = rec.get("traced")
    if not t or not t["split"]["bf16_matmul"]:
        return None
    return t["split"]["bf16_matmul"] / t["steps"] * 1e3
