"""Secure + private federation: pairwise-mask SecAgg and local DP, composed
as client mods (the Flower built-ins the paper's FLARE users gain, §1),
with seeds derived from FLARE provisioning.  Port of
``examples/secure_federation.py``.

    python -m repro_torch.examples.secure_federation   # on the CUDA card
    python -c "from repro_torch.examples.secure_federation import main; \
main([], device='cpu')"                               # on the CPU

Clients fit on the device; plain FedAvg folds there through the
``weighted_sum`` kernel, SecAgg sums the masked shares there as int64
adds.
"""
import os

# deterministic cuBLAS, set before CUDA starts (concurrent client fits)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse  # noqa: E402
from typing import Optional, Sequence  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.core import run_native  # noqa: E402
from repro_torch.device import DeviceLike  # noqa: E402
from repro_torch.examples import example_device  # noqa: E402
from repro_torch.fl import (DPMod, FedAvg, SecAggFedAvg,  # noqa: E402
                            SecAggMod, ServerApp, ServerConfig)
from repro_torch.fl.quickstart import make_client_app  # noqa: E402
from repro_torch.runtime.provision import Provisioner  # noqa: E402

SITES = ["site-1", "site-2", "site-3"]
ROUNDS = 3
LR, SKEW = 0.02, 0.2
PROJECT, SECRET = "secure-fed-demo", b"\x07" * 32
DP_CLIP, DP_NOISE, DP_SEED = 1.0, 0.1, 13
#: SecAgg's fixed-point quantization moves the mean by at most this much
#: from plain FedAvg's (the bound ``tests/test_mods.py`` holds it to)
SECAGG_TOL = 1e-3


def provisioner() -> Provisioner:
    prov = Provisioner(PROJECT, secret=SECRET)
    for s in SITES:
        prov.issue(s, "client")
    return prov


def _server(strategy, device):
    return ServerApp(config=ServerConfig(num_rounds=ROUNDS,
                                         agg_device=str(device)),
                     strategy=strategy)


def run_plain(device: DeviceLike = None, initial_parameters=None):
    dev = example_device(device)
    return run_native(
        _server(FedAvg(initial_parameters=initial_parameters), dev),
        lambda s: make_client_app(s, lr=LR, skew=SKEW, device=dev), SITES)


def run_secagg(prov: Provisioner, device: DeviceLike = None,
               initial_parameters=None, dp: bool = False):
    """SecAgg (with local DP first when ``dp``): the server only ever sees
    masked shares."""
    dev = example_device(device)

    def mods(s):
        out = [SecAggMod(site=s, peers=SITES,
                         pairwise_seed_fn=prov.pairwise_seed)]
        if dp:
            out.insert(0, DPMod(clip_norm=DP_CLIP, noise_multiplier=DP_NOISE,
                                site_id=int(s[-1]), seed=DP_SEED))
        return out

    return run_native(
        _server(SecAggFedAvg(initial_parameters=initial_parameters), dev),
        lambda s: make_client_app(s, lr=LR, skew=SKEW, mods=mods(s),
                                  device=dev), SITES)


def max_param_delta(a, b) -> float:
    return max(float(np.abs(x.astype(np.float64) - y.astype(np.float64))
                     .max()) for x, y in zip(a.final_parameters,
                                             b.final_parameters))


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = None):
    argparse.ArgumentParser(description=__doc__.split("\n")[0]) \
        .parse_args(argv)
    dev = example_device(device)
    prov = provisioner()

    print(f"== plain FedAvg (server sees every update) on {dev} ==")
    h_plain = run_plain(dev)
    print("  losses:", [f"{l:.5f}" for _, l in h_plain.losses()])

    print("== SecAgg: server only ever sees masked shares ==")
    h_sec = run_secagg(prov, dev)
    print("  losses:", [f"{l:.5f}" for _, l in h_sec.losses()])
    delta = max_param_delta(h_plain, h_sec)
    print(f"  max param delta vs plain: {delta:.2e} "
          f"(fixed-point quantization only)")

    print(f"== SecAgg + local DP (clip {DP_CLIP}, sigma {DP_NOISE}) ==")
    h_dp = run_secagg(prov, dev, dp=True)
    print("  losses:", [f"{l:.5f}" for _, l in h_dp.losses()])

    if not delta < SECAGG_TOL:
        raise RuntimeError(f"SecAgg moved the model {delta} from plain "
                           f"FedAvg (bound {SECAGG_TOL})")
    for name, h in (("plain", h_plain), ("secagg", h_sec), ("dp", h_dp)):
        losses = [l for _, l in h.losses()]
        if len(losses) != ROUNDS or not np.all(np.isfinite(losses)):
            raise RuntimeError(f"{name} losses {losses}")
    return {"plain": h_plain, "secagg": h_sec, "dp": h_dp,
            "max_param_delta": delta}


if __name__ == "__main__":
    main()
