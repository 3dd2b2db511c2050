"""``attention_ms.train``: device ms a step in the eager attention's fp32
score and value einsums and their gradients (the fp32 GEMM kernels under
the GEMM ops), over the traced steps."""


def read(rec):
    t = rec.get("traced")
    if not t or not t["split"]["fp32_attention_einsum"]:
        return None
    return t["split"]["fp32_attention_einsum"] / t["steps"] * 1e3
