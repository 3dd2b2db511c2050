"""Paper §5.2: hybrid integration — the Flower client uses FLARE's
experiment-tracking SummaryWriter (Listing 3); metrics from every client
stream to the server and are exported TensorBoard-style (Fig. 6).  Port of
``examples/hybrid_tracking.py``; writes ``metrics_fig6.json`` into the
working directory.

    python -m repro_torch.examples.hybrid_tracking     # on the CUDA card
    python -c "from repro_torch.examples.hybrid_tracking import main; \
main([], device='cpu')"                               # on the CPU
"""
import os

# deterministic cuBLAS, set before CUDA starts (concurrent client fits)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse  # noqa: E402
import json  # noqa: E402
from typing import Optional, Sequence  # noqa: E402

from repro_torch.core import run_in_flare  # noqa: E402
from repro_torch.device import DeviceLike  # noqa: E402
from repro_torch.examples import example_device  # noqa: E402
from repro_torch.fl import FedAvg, ServerApp, ServerConfig  # noqa: E402
from repro_torch.fl.client import ClientApp  # noqa: E402
from repro_torch.fl.quickstart import QuickstartClient  # noqa: E402
from repro_torch.runtime import FlareRuntime  # noqa: E402

SITES = ["site-1", "site-2", "site-3"]
ROUNDS = 3
LR, SKEW = 0.02, 0.2
EXPORT = "metrics_fig6.json"
#: what every client streams (QuickstartClient with a writer)
CLIENT_TAGS = ("train_loss", "train_accuracy", "test_accuracy")


def client_app_fn(device: DeviceLike = None):
    dev = example_device(device)

    def for_site(site):
        def with_ctx(ctx):
            writer = ctx.summary_writer()    # <- nvflare.client.tracking API
            return ClientApp(client_fn=lambda cid: QuickstartClient(
                site, writer=writer, lr=LR, skew=SKEW,
                device=dev).to_client())
        return with_ctx
    return for_site


def run(device: DeviceLike = None, initial_parameters=None):
    """The FLARE job: (History, its MetricCollector)."""
    dev = example_device(device)
    rt = FlareRuntime()
    for s in SITES:
        rt.provision_site(s)
    try:
        history = run_in_flare(
            rt, ServerApp(config=ServerConfig(num_rounds=ROUNDS,
                                              agg_device=str(dev)),
                          strategy=FedAvg(
                              initial_parameters=initial_parameters)),
            client_app_fn(dev), SITES)
        return history, rt.metrics(next(iter(rt._jobs)))
    finally:
        rt.shutdown()


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = None):
    argparse.ArgumentParser(description=__doc__.split("\n")[0]) \
        .parse_args(argv)
    dev = example_device(device)
    history, mc = run(dev)
    print("streamed tags:", mc.tags())
    for tag in mc.tags():
        print(f"  {tag}: {[(s, round(v, 4)) for s, v in mc.series(tag)]}")
    out = mc.export_tensorboard_json(EXPORT)
    print(f"\nexported {len(out)} bytes to {EXPORT} (Fig. 6 artifact)")
    missing = [f"{s}/{t}" for s in SITES for t in CLIENT_TAGS
               if f"{s}/{t}" not in mc.tags()]
    if missing:
        raise RuntimeError(f"tags not streamed: {missing}")
    with open(EXPORT) as f:
        exported = json.load(f)
    return {"history": history, "tags": mc.tags(),
            "series": {t: mc.series(t) for t in mc.tags()},
            "path": os.path.abspath(EXPORT), "exported": exported}


if __name__ == "__main__":
    main()
