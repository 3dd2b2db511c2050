"""Cross-cutting FL integration on the port: the cases of
``tests/test_fl_roundtrip.py`` against ``repro_torch``.

Convergence through the runtime and FedProx plumbing on the quickstart
(clients and fold on the CPU); tight mode through the port's own
``core/collective.py``: ``tight_fedavg`` over 8 gloo ranks (a 2 x 2 x 2
pod / data / model mesh, each rank a separate interpreter, as the
reference forces 8 host devices in a subprocess) equals the mean the loose
path computes, and ``make_fl_round_step`` on one device diverges per pod
and FedAvg-averages, with the reference's assertions.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import subprocess
import textwrap

import numpy as np
import torch

from repro_torch.core import run_native
from repro_torch.fl import FedAvg, FedProx, ServerApp, ServerConfig
from repro_torch.fl.quickstart import make_client_app
from repro_torch.fl.strategy import weighted_average

SITES = ["site-1", "site-2", "site-3"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 240


def _clients(s):
    return make_client_app(s, lr=0.02, skew=0.2, device="cpu")


def test_fedavg_converges_on_quickstart():
    h = run_native(ServerApp(ServerConfig(num_rounds=4, agg_device="cpu"),
                             FedAvg()), _clients, SITES)
    losses = [l for _, l in h.losses()]
    assert losses[-1] < losses[0] * 0.5
    accs = [r.metrics.get("accuracy", 0) for r in h.rounds]
    assert accs[-1] > 0.9


def test_fedprox_reaches_similar_loss():
    h = run_native(ServerApp(ServerConfig(num_rounds=3, agg_device="cpu"),
                             FedProx(proximal_mu=0.01)), _clients, SITES)
    assert h.losses()[-1][1] < 1.0


def test_tight_mode_fedavg_equals_loose_mean(tmp_path):
    """Tight-mode collective FedAvg (8 gloo ranks, pod axis of 2) must
    equal the arithmetic mean the loose path computes.  Each rank holds
    its pod's replica of the pod-stacked params; separate interpreters, so
    no process group leaks into other tests."""
    code = textwrap.dedent("""
        import os, sys
        sys.path.insert(0, {src!r})
        import torch, torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        from repro_torch.core.collective import tight_fedavg
        RANK, WORLD = int(sys.argv[1]), 8
        dist.init_process_group("gloo", store=dist.FileStore({store!r}, WORLD),
                                rank=RANK, world_size=WORLD)
        mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 2, 2).tolist(),
                          mesh_dim_names=("pod", "data", "model"))
        pod = mesh.get_local_rank("pod")
        # pod-stacked params: two divergent site replicas, 0 and 2
        params = {{"w": torch.full((1, 4), 2.0 * pod)}}
        out = tight_fedavg(params, mesh)
        # FedAvg = mean over the pod dim, broadcast back to both pods
        assert torch.equal(out["w"], torch.ones((1, 4))), out
        dist.destroy_process_group()
        print("TIGHT_OK")
    """).format(src=os.path.join(ROOT, "src_torch"),
                store=str(tmp_path / "store"))
    script = tmp_path / "rank.py"
    script.write_text(code)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(8)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    for out in outs:
        assert "TIGHT_OK" in out, out[-3000:]
    loose = weighted_average([([np.zeros(4, np.float32)], 1.0),
                              ([np.full(4, 2.0, np.float32)], 1.0)],
                             backend="numpy", device="cpu")
    np.testing.assert_array_equal(loose[0], np.ones(4, np.float32))


def test_fl_round_step_semantics_single_device():
    """Round step over pods on one device: K local steps diverge per pod,
    FedAvg averages."""
    from repro_torch.config import TrainConfig, get_model_config
    from repro_torch.core.collective import (make_fl_round_step,
                                             pod_stacked_state)
    from repro_torch.models import build_model
    from repro_torch.train.steps import make_train_state
    from repro_torch.utils.pytree import tree_leaves

    cfg = get_model_config("flower-quickstart", smoke=True)
    model = build_model(cfg)
    tcfg = TrainConfig(learning_rate=1e-3, global_batch=2, seq_len=16)
    round_fn = make_fl_round_step(model, tcfg, None, local_steps=2)

    state = pod_stacked_state(make_train_state(model, tcfg, 0,
                                               device="cpu"), 2)
    rng = np.random.default_rng(0)
    batches = {
        "tokens": torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (2, 2, 2, 16), dtype=np.int32)),
        "labels": torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (2, 2, 2, 16), dtype=np.int32)),
    }
    new_state, metrics = round_fn(state, batches)
    assert metrics["round_losses"].shape == (2, 2)
    assert torch.isfinite(metrics["round_losses"]).all()
    # post-FedAvg params identical across the pod dim
    for leaf in tree_leaves(new_state.params):
        np.testing.assert_allclose(leaf[0].detach().numpy(),
                                   leaf[1].detach().numpy(),
                                   rtol=1e-6, atol=1e-6)
    # and actually moved from init
    l0 = tree_leaves(state.params)[1]
    l1 = tree_leaves(new_state.params)[1]
    assert not torch.equal(l0, l1)
