"""The paper's contribution: running unmodified Flower apps inside the
FLARE runtime by routing the Flower transport through FLARE (Fig. 4)."""
from repro_torch.core.superlink import (  # noqa: F401
                                        SuperLink, SuperLinkDriver, SuperNode, NativeConnection,
                                        TaskStream, EdgeAggregatorApp, InlineFleetDriver, make_edge_tier,
                                        )
from repro_torch.core.lgs import LGSConnection  # noqa: F401
from repro_torch.core.lgc import LGC  # noqa: F401
from repro_torch.core.interop import (  # noqa: F401
                                      run_native, run_in_flare, run_hierarchical,
                                      )
from repro_torch.core.collective import tight_fedavg, make_fl_round_step  # noqa: F401
