"""Step functions of the port (port of ``repro/train``): serving steps only;
the training steps come with the training slice (ROADMAP queue 1, item 12)."""
from repro_torch.train.steps import (  # noqa: F401
    greedy_generate,
    make_decode_step,
    make_prefill_step,
)
