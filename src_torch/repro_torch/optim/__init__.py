from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    make_optimizer,
    sgd,
    momentum,
    adam,
    adamw,
    adafactor,
    clip_by_global_norm,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant_schedule,
    cosine_schedule,
    linear_warmup_cosine,
)
