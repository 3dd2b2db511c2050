"""``train_mfu``: the window's model FLOPs (``counts.train_model_flops``,
no recompute) over its time, as a share of the card's bf16 peak (%)."""
from portbench import counts


def read(rec):
    pk = counts.peak(rec.get("device_kind", ""), "bf16_flops")
    if pk is None or not rec.get("window_steps"):
        return None
    return 100.0 * rec["model_flops_per_step"] * rec["window_steps"] \
        / rec["window_s"] / pk
