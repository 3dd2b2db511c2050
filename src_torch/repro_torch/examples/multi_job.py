"""Paper §3.1: FLARE's multi-job system — two independent FL experiments
run CONCURRENTLY over the same server/clients, without extra ports, each in
its own Job Network.  Port of ``examples/multi_job.py``.

    python -m repro_torch.examples.multi_job           # on the CUDA card
    python -c "from repro_torch.examples.multi_job import main; \
main([], device='cpu')"                               # on the CPU

Both jobs' clients fit, and both servers fold, on the one device.
"""
import os

# deterministic cuBLAS, set before CUDA starts (concurrent client fits)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse  # noqa: E402
import time  # noqa: E402
from typing import Optional, Sequence  # noqa: E402

from repro_torch.core.interop import (_FlowerClientJob,  # noqa: E402
                                     _FlowerServerJob)
from repro_torch.device import DeviceLike  # noqa: E402
from repro_torch.examples import example_device  # noqa: E402
from repro_torch.fl import (FedAdam, FedAvg, ServerApp,  # noqa: E402
                            ServerConfig)
from repro_torch.fl.quickstart import make_client_app  # noqa: E402
from repro_torch.runtime import FlareRuntime, JobSpec  # noqa: E402

SITES = ["site-1", "site-2", "site-3"]
ROUNDS = 2
SKEW = 0.2
#: (job name, strategy name, client lr); FedAdam at server lr 0.1
JOBS = (("fedavg-lr02", "fedavg", 0.02), ("fedadam-lr05", "fedadam", 0.05))
SERVER_LR = 0.1


def _job_strategy(name: str, initial_parameters=None):
    if name == "fedavg":
        return FedAvg(initial_parameters=initial_parameters)
    return FedAdam(server_lr=SERVER_LR, initial_parameters=initial_parameters)


def flower_jobspec(name, strategy, lr, device: DeviceLike = None):
    dev = example_device(device)
    server_app = ServerApp(config=ServerConfig(num_rounds=ROUNDS,
                                               round_timeout=300,
                                               agg_device=str(dev)),
                           strategy=strategy)
    return JobSpec(
        name=name,
        server_app_fn=lambda: _FlowerServerJob(server_app, len(SITES)),
        client_app_fn=lambda s: _FlowerClientJob(
            s, make_client_app(s, lr=lr, skew=SKEW, device=dev)),
        min_sites=len(SITES),
        resources={"gpu": 0.5},      # two jobs fit concurrently
    )


def run(device: DeviceLike = None, initial_parameters=None):
    """Submit both jobs to one runtime and wait: their JobRecords, in the
    order of ``JOBS``."""
    dev = example_device(device)
    rt = FlareRuntime(request_timeout=300.0)
    for s in SITES:
        rt.provision_site(s)
    try:
        admin = rt.provisioner.issue("admin", "admin")
        ids = [rt.submit_job(flower_jobspec(
            name, _job_strategy(strat, initial_parameters), lr, dev), admin)
            for name, strat, lr in JOBS]
        print(f"submitted jobs {ids[0]} and {ids[1]}; both RUNNING "
              f"concurrently")
        return [rt.wait(j, timeout=600) for j in ids]
    finally:
        rt.shutdown()


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = None):
    argparse.ArgumentParser(description=__doc__.split("\n")[0]) \
        .parse_args(argv)
    dev = example_device(device)
    t0 = time.time()
    records = run(dev)
    dt = time.time() - t0
    print(f"\nboth done in {dt:.1f}s")
    for (name, _, _), rec in zip(JOBS, records):
        losses = rec.result.losses() if rec.result is not None else []
        print(f"  {name}: {rec.status.value:10s} "
              f"losses={[f'{l:.4f}' for _, l in losses]}")
    bad = [(name, rec.status.value, rec.error)
           for (name, _, _), rec in zip(JOBS, records)
           if rec.status.value != "COMPLETED"]
    if bad:
        raise RuntimeError(f"jobs not COMPLETED: {bad}")
    return {"records": records, "seconds": dt}


if __name__ == "__main__":
    main()
