"""Architecture registry of the port -- one module per architecture.

Importing this package populates ``repro_torch.config.ARCH_REGISTRY`` /
``SMOKE_REGISTRY`` with the same architectures as the reference's.
"""
from repro_torch.configs import (  # noqa: F401
    deepseek_v2_236b,
    flower_quickstart,
    granite_34b,
    granite_moe_1b_a400m,
    h2o_danube_1_8b,
    internvl2_1b,
    qwen3_32b,
    recurrentgemma_2b,
    whisper_medium,
    xlstm_350m,
    yi_34b,
)
