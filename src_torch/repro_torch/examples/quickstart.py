"""Paper §5.1: the quickstart app, run natively AND inside FLARE — no code
changes, identical results (Fig. 5).  Port of ``examples/quickstart.py``.

    python -m repro_torch.examples.quickstart        # on the CUDA card
    python -c "from repro_torch.examples.quickstart import main; \
main([], device='cpu')"                             # on the CPU

Clients fit and the server folds (``FedAdam`` over the ``weighted_sum``
kernel) on the device.
"""
import os

# deterministic cuBLAS, set before CUDA starts: the three sites fit
# concurrently and the Fig. 5 check compares native and FLARE bitwise
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse  # noqa: E402
from typing import Optional, Sequence  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.core import run_in_flare, run_native  # noqa: E402
from repro_torch.device import DeviceLike  # noqa: E402
from repro_torch.examples import example_device  # noqa: E402
from repro_torch.fl import FedAdam, ServerApp, ServerConfig  # noqa: E402
from repro_torch.fl.quickstart import make_client_app  # noqa: E402
from repro_torch.runtime import FlareRuntime  # noqa: E402

SITES = ["site-1", "site-2", "site-3"]
ROUNDS = 3
SERVER_LR = 0.1
LR, SKEW = 0.02, 0.2


def make_server_app(device: DeviceLike = None, initial_parameters=None):
    # paper Listing 1: strategy + ServerApp
    strategy = FedAdam(server_lr=SERVER_LR,
                       initial_parameters=initial_parameters)
    dev = example_device(device)
    return ServerApp(config=ServerConfig(num_rounds=ROUNDS,
                                         agg_device=str(dev)),
                     strategy=strategy)


def client_app_fn(device: DeviceLike = None):
    dev = example_device(device)
    return lambda s: make_client_app(s, lr=LR, skew=SKEW, device=dev)


def run(device: DeviceLike = None, initial_parameters=None):
    """The app natively, then the same app inside the FLARE runtime:
    (native History, FLARE History)."""
    h_native = run_native(make_server_app(device, initial_parameters),
                          client_app_fn(device), SITES)
    rt = FlareRuntime()
    for s in SITES:
        rt.provision_site(s)
    try:
        h_flare = run_in_flare(rt, make_server_app(device, initial_parameters),
                               client_app_fn(device), SITES)
    finally:
        rt.shutdown()
    return h_native, h_flare


def bitwise_same(a, b) -> bool:
    return a.losses() == b.losses() and all(
        x.dtype == y.dtype and x.tobytes() == y.tobytes()
        for x, y in zip(a.final_parameters, b.final_parameters))


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = None):
    argparse.ArgumentParser(description=__doc__.split("\n")[0]) \
        .parse_args(argv)
    dev = example_device(device)
    print(f"== running the Flower app natively (SuperLink + SuperNodes) "
          f"on {dev} ==")
    h_native, h_flare = run(dev)
    for rnd, loss in h_native.losses():
        print(f"  round {rnd}: eval loss {loss:.5f}")
    print("== the SAME app inside the FLARE runtime ==")
    for rnd, loss in h_flare.losses():
        print(f"  round {rnd}: eval loss {loss:.5f}")
    same = bitwise_same(h_native, h_flare)
    print(f"\nFig. 5 check — curves and final params bitwise identical: "
          f"{same}")
    losses = [l for _, l in h_native.losses()]
    if not same:
        raise RuntimeError("Fig. 5: native and FLARE runs differ")
    if len(losses) != ROUNDS or not np.all(np.isfinite(losses)):
        raise RuntimeError(f"quickstart losses {losses}")
    return {"native": h_native, "flare": h_flare, "bitwise": same}


if __name__ == "__main__":
    main()
