"""``attention_elementwise_ms.train``: device ms a step in the eager
attention's other kernels on its scores: those of every op that reads the
5-D score tensor, or is called by one that does, apart from the GEMMs
(the mask's ``where``, the softmax forward and backward, the weights'
casts, the gradients' products), over the traced steps."""


def read(rec):
    t = rec.get("traced")
    if not t or not t["split"]["attention_elementwise"]:
        return None
    return t["split"]["attention_elementwise"] / t["steps"] * 1e3
