"""End-to-end driver (deliverable b): federated training of a transformer
LM across sites through the FLARE runtime (port of
``examples/federated_llm.py``).

Each site holds a non-IID synthetic corpus (its own Markov chain); clients
run the mesh-sharded train step on the registry transformer (fsdp
"data"/"model" axes via :func:`repro_torch.launch.mesh.make_local_mesh` --
a (1,1) mesh on one card, the same code path as a larger mesh); the server
aggregates with FedAvg through the six-hop bridged path, and fit results
ship as structured-sparse 0xF5 TopK deltas by default.  At --scale full
the model is ~100M params and runs a few hundred local steps total; the
default is small.

    PYTHONPATH=src_torch python -m repro_torch.examples.federated_llm
    PYTHONPATH=src_torch python -m repro_torch.examples.federated_llm --scale full
    PYTHONPATH=src_torch python -m repro_torch.examples.federated_llm --codec q8

The command line runs on the CUDA card; ``main(argv, device="cpu")`` runs
the same on the CPU.  Two properties this file is careful about (pinned by
``tests/test_torch_federated_llm.py``):

- the local optimizer state PERSISTS across rounds: ``fit`` replaces only
  the params in the running ``TrainState``, so Adam moments and the LR
  schedule's step counter stay continuous;
- the step is SHARED: every client with the same ``(cfg, tcfg, mesh)``
  gets one step from :func:`repro_torch.train.steps.get_train_step`.

A client's returned arrays live on the host; its template of the params
(``_like``) is the ``meta``-device tree (shapes and dtypes only), so a
site keeps no second copy of the model on the card.
"""
from __future__ import annotations

import argparse
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.config import TrainConfig, get_model_config
from repro_torch.core import run_in_flare
from repro_torch.data.loader import FederatedDataLoader
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fl import FedAvg, ServerApp, ServerConfig
from repro_torch.fl.client import ClientApp, NumPyClient
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.runtime import FlareRuntime
from repro_torch.train.steps import (TrainState, cross_entropy_loss,
                                     full_tree, get_train_step)
from repro_torch.utils.pytree import tree_leaves, tree_unflatten

SITES = ["site-1", "site-2", "site-3", "site-4"]


def params_to_arrays(params):
    """The parameter tree as host fp32 numpy arrays in the reference's leaf
    order (DTensor leaves gathered)."""
    return [x.detach().cpu().numpy() for x in tree_leaves(full_tree(params))]


def arrays_to_params(arrays, like, device: DeviceLike = None):
    """Host arrays back into ``like``'s tree (its dtypes) on ``device``."""
    leaves = tree_leaves(like)
    assert len(leaves) == len(arrays), (len(leaves), len(arrays))
    dev = resolve_device(device)

    def one(a, leaf):
        a = np.asarray(a, dtype=np.float32)
        if dev.type == "cpu":
            # the tensor is the training state: its own copy
            return torch.from_numpy(a.copy()).to(dtype=leaf.dtype)
        # a received frame's arrays are read-only views of its buffer; the
        # host tensor over them is only read, by the copy to the card
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            host = torch.from_numpy(a)
        return host.to(device=dev, dtype=leaf.dtype)

    return tree_unflatten(like, [one(a, l) for a, l in zip(arrays, leaves)])


class LMClient(NumPyClient):
    """A training client: local steps on the site's own corpus."""

    def __init__(self, site: str, cfg, tcfg, loader, local_steps: int,
                 mesh=None):
        self.site = site
        self.site_idx = int(site.rsplit("-", 1)[-1]) - 1
        self.model = build_model(cfg)
        self.tcfg = tcfg
        self.loader = loader
        self.local_steps = local_steps
        self.mesh = mesh if mesh is not None else make_local_mesh()
        self.device = torch.device(self.mesh.device_type)
        # one mesh-sharded step per (cfg, tcfg, mesh) in the whole process
        # -- sites share it
        self._step_fn = get_train_step(cfg, tcfg, mesh=self.mesh)
        self._like = self.model.abstract()
        self._opt = make_optimizer(tcfg)
        # persistent local TrainState: moments + step survive across
        # rounds; fit() only swaps in the aggregated params
        self._state: Optional[TrainState] = None

    def get_parameters(self, config):
        return params_to_arrays(self.model.init(0, device=self.device))

    def fit(self, parameters, config):
        params = arrays_to_params(parameters, self._like, self.device)
        if self._state is None:
            self._state = TrainState(
                params, self._opt.init(params),
                torch.zeros((), dtype=torch.int32, device=self.device))
        else:
            self._state = self._state._replace(params=params)
        del params
        losses = []
        for _ in range(self.local_steps):
            batch = self.loader.next_batch(self.site_idx)
            self._state, m = self._step_fn(self._state, batch)
            losses.append(float(m["loss"]))
        n = self.local_steps * self.tcfg.global_batch * self.tcfg.seq_len
        return (params_to_arrays(self._state.params), n,
                {"train_loss": float(np.mean(losses))})

    @torch.no_grad()
    def evaluate(self, parameters, config):
        params = arrays_to_params(parameters, self._like, self.device)
        batch = self.loader.next_batch(self.site_idx)
        logits, _, _ = self.model.apply(params, batch, mode="train")
        loss = float(cross_entropy_loss(logits, batch["labels"]))
        return loss, batch["tokens"].size, {}


def federate(cfg, tcfg, rounds: int, local_steps: int, *,
             codec: str = "sparse", sparse_frac: float = 0.05,
             device: DeviceLike = None):
    """Run the federation: the :data:`SITES` as :class:`LMClient` sites on
    one local mesh through ``run_in_flare``, FedAvg folding on ``device``
    (None: the card).  Returns the History."""
    dev = resolve_device(device)
    mesh = make_local_mesh(device=dev)
    loader = FederatedDataLoader(cfg.vocab_size, tcfg.seq_len,
                                 num_sites=len(SITES),
                                 batch_per_site=tcfg.global_batch,
                                 seed=7, non_iid_alpha=0.5)

    def client_app_fn(site):
        return ClientApp(client_fn=lambda cid: LMClient(
            site, cfg, tcfg, loader, local_steps, mesh=mesh).to_client())

    rt = FlareRuntime(request_timeout=600.0)
    for s in SITES:
        rt.provision_site(s)
    server = ServerApp(
        config=ServerConfig(
            num_rounds=rounds, round_timeout=3600,
            codec=None if codec == "flat" else codec,
            sparse_frac=sparse_frac, agg_device=str(dev)),
        strategy=FedAvg())
    try:
        return run_in_flare(rt, server, client_app_fn, SITES, timeout=7200)
    finally:
        rt.shutdown()


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", choices=["small", "full"], default="small")
    ap.add_argument("--rounds", type=int, default=0)
    ap.add_argument("--codec", choices=["flat", "bf16", "q8", "sparse"],
                    default="sparse",
                    help="negotiated uplink codec (default: 0xF5 "
                         "structured-sparse TopK deltas)")
    ap.add_argument("--sparse-frac", type=float, default=0.05,
                    help="TopK fraction for --codec sparse")
    args = ap.parse_args(argv)

    base = get_model_config("flower-quickstart")
    if args.scale == "full":
        cfg = base.replace(d_model=768, num_layers=12, d_ff=3072,
                           num_heads=12, num_kv_heads=12, vocab_size=8192)
        tcfg = TrainConfig(global_batch=8, seq_len=256, learning_rate=1e-3,
                           warmup_steps=20, total_steps=400)
        rounds, local_steps = args.rounds or 5, 20   # 400 steps total
    else:
        cfg = base.replace(d_model=256, num_layers=4, d_ff=1024,
                           vocab_size=2048, remat=False)
        tcfg = TrainConfig(global_batch=8, seq_len=128, learning_rate=2e-3,
                           warmup_steps=10, total_steps=120)
        rounds, local_steps = args.rounds or 3, 10

    model = build_model(cfg)
    mesh = make_local_mesh(device=device)
    print(f"federated LM: {model.param_count()/1e6:.1f}M params, "
          f"{len(SITES)} sites, {rounds} rounds x {local_steps} local "
          f"steps, mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}, "
          f"codec {args.codec}")

    history = federate(cfg, tcfg, rounds, local_steps, codec=args.codec,
                       sparse_frac=args.sparse_frac, device=device)

    print("\nper-round federated eval loss:")
    for rec in history.rounds:
        extra = ""
        if "wire_codec" in rec.metrics:
            extra = f"  [wire={rec.metrics['wire_codec']}]"
        if rec.loss is not None:
            print(f"  round {rec.round}: {rec.loss:.4f}{extra}")
    first, last = history.losses()[0][1], history.losses()[-1][1]
    print(f"\nloss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    if last >= first:
        raise SystemExit("federated loss did not improve")
    return history


if __name__ == "__main__":
    main()
