"""Architecture registry of the port -- one module per architecture.

Importing this package populates ``repro_torch.config.ARCH_REGISTRY`` /
``SMOKE_REGISTRY``.  Only the families the port runs are registered; the
others come with their families (ROADMAP queue 1, item 11).
"""
from repro_torch.configs import (  # noqa: F401
    flower_quickstart,
    h2o_danube_1_8b,
    recurrentgemma_2b,
)
