"""Tight mode, meshes and the sharded step of the port, on the CPU.

- ``tight_fedavg`` over 2 and 8 gloo ranks (a ``"pod"`` axis; separate
  processes, as ``tests/test_fl_roundtrip.py`` runs the reference's
  8-device check) equals the mean, for plain and DTensor leaves.
- ``make_fl_round_step`` on one device follows the reference's
  ``test_fl_round_step_semantics_single_device``: post-FedAvg params equal
  across pods and moved from init; from the reference's own state its
  round losses lie within the training tolerance of
  ``tests/test_torch_train.py`` (1e-5 relative) of the reference's.
- The mesh-sharded step (``get_train_step(mesh=...)``) equals the plain
  step bitwise on a one-rank mesh, and on 2 gloo ranks over ``"data"``
  (FSDP-sharded params, a batch split over ranks) its losses and grad
  norms are within 1e-5 / 2e-5 relative of the plain step's and its Adam
  moments within 2e-5 of each leaf's largest entry after one step from
  the same state.
- ``abstract_train_state`` has the reference's paths, shapes and dtypes.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import dataclasses
import subprocess
import textwrap

import jax
import numpy as np
import pytest
import torch

import repro.config as RC
from repro.core.collective import make_fl_round_step as r_round
from repro.core.collective import pod_stacked_state as r_stack
from repro.models import build_model as r_build
from repro.train import steps as RS
import repro_torch.config as TC
from repro_torch.core import make_fl_round_step, tight_fedavg
from repro_torch.core.collective import pod_stacked_state
from repro_torch.models import build_model, train_state_from_reference
from repro_torch.train import steps as TS
from repro_torch.utils.pytree import tree_flatten_with_paths, tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 240


def _port_config(rcfg) -> TC.ModelConfig:
    return TC.ModelConfig(**{f.name: getattr(rcfg, f.name)
                             for f in dataclasses.fields(rcfg)
                             if f.name not in ("moe", "mla")})


def _run_ranks(body: str, world: int, tmp_path) -> list:
    """Run ``body`` in ``world`` fresh interpreters, one gloo rank each
    (``RANK``, ``WORLD`` and an initialised default group in scope); every
    rank must print ``RANK_OK``."""
    code = textwrap.dedent("""
        import os, sys
        sys.path.insert(0, {src!r})
        import torch, torch.distributed as dist
        RANK, WORLD = int(sys.argv[1]), int(sys.argv[2])
        dist.init_process_group("gloo", store=dist.FileStore({store!r}, WORLD),
                                rank=RANK, world_size=WORLD)
    """).format(src=os.path.join(ROOT, "src_torch"),
                store=str(tmp_path / "store")) + textwrap.dedent(body) + \
        "\ndist.destroy_process_group()\nprint('RANK_OK')\n"
    script = tmp_path / "rank.py"
    script.write_text(code)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(world)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=RANK_TIMEOUT)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    for out in outs:
        assert "RANK_OK" in out, out[-3000:]
    return outs


@pytest.mark.parametrize("world,shape", [(2, (2, 1, 1)), (8, (2, 2, 2))])
def test_tight_fedavg_over_gloo_ranks_is_the_mean(world, shape, tmp_path):
    _run_ranks(f"""
        import numpy as np
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.core import tight_fedavg
        mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape({shape}).tolist(),
                          mesh_dim_names=("pod", "data", "model"))
        pod = mesh.get_local_rank("pod")
        # the rank's own pod: two divergent site replicas, 0 and 2
        params = {{"w": torch.full((1, 4), 2.0 * pod),
                   "b": {{"x": torch.full((1, 3), 4.0 * pod + 1.0)}},
                   "n": torch.full((1,), 7, dtype=torch.int32)}}
        out = tight_fedavg(params, mesh)
        assert torch.equal(out["w"], torch.ones((1, 4))), out
        assert torch.equal(out["b"]["x"], torch.full((1, 3), 3.0)), out
        assert torch.equal(out["n"], params["n"])
        # a DTensor leaf sharded over "pod" on its stacked dim
        g = DTensor.from_local(torch.full((1, 4), 2.0 * pod), mesh,
                               [Shard(0), Replicate(), Replicate()])
        got = tight_fedavg({{"w": g}}, mesh)["w"]
        assert isinstance(got, DTensor)
        assert torch.equal(got.full_tensor(), torch.ones((2, 4)))
        bf = tight_fedavg(params, mesh, aggregate_dtype=torch.bfloat16)
        assert bf["w"].dtype == torch.float32
        assert torch.equal(bf["w"], torch.ones((1, 4)))
    """, world, tmp_path)


def test_tight_fedavg_one_process_is_the_mean():
    params = {"w": torch.stack([torch.zeros(4), torch.ones(4) * 2.0])}
    out = tight_fedavg(params)
    assert torch.equal(out["w"], torch.ones((2, 4)))


def _round_configs(dtype="float32"):
    rcfg = RC.get_model_config("flower-quickstart", smoke=True).replace(
        dtype=dtype)
    rt = RC.TrainConfig(learning_rate=1e-3, global_batch=2, seq_len=16)
    return rcfg, rt, _port_config(rcfg), TC.TrainConfig(
        **dataclasses.asdict(rt))


def test_fl_round_step_semantics_single_device():
    """K local steps diverge per pod, FedAvg averages; from the
    reference's state the round losses are the reference's."""
    rcfg, rt, tcfg, tt = _round_configs()
    rmodel = r_build(rcfg)
    rstate = r_stack(RS.make_train_state(rmodel, rt, jax.random.key(0)), 2)
    rng = np.random.default_rng(0)
    batches = {
        "tokens": rng.integers(0, rcfg.vocab_size, (2, 2, 2, 16),
                               dtype=np.int32),
        "labels": rng.integers(0, rcfg.vocab_size, (2, 2, 2, 16),
                               dtype=np.int32),
    }
    rmesh = jax.make_mesh((1, 1), ("data", "model"))
    rnew, rmet = jax.jit(r_round(rmodel, rt, rmesh, local_steps=2))(
        rstate, batches)

    state = train_state_from_reference(jax.tree.map(np.asarray, rstate),
                                       device="cpu")
    round_fn = make_fl_round_step(build_model(tcfg), tt, None, local_steps=2)
    tb = {k: torch.as_tensor(v) for k, v in batches.items()}
    new_state, metrics = round_fn(state, tb)
    losses = metrics["round_losses"]
    assert losses.shape == (2, 2)
    assert torch.isfinite(losses).all()
    np.testing.assert_allclose(losses.numpy(),
                               np.asarray(rmet["round_losses"]), rtol=1e-5)
    for leaf in tree_leaves(new_state.params):
        assert torch.equal(leaf[0], leaf[1])
    for leaf in tree_leaves(new_state.opt_state):
        assert torch.equal(leaf[0], leaf[1])
    l0 = tree_leaves(state.params)[1]
    l1 = tree_leaves(new_state.params)[1]
    assert not torch.equal(l0, l1)
    assert torch.equal(new_state.step, torch.full((2,), 2, dtype=torch.int32))
    # pure FedAvg: the moments stay per pod
    keep, _ = make_fl_round_step(build_model(tcfg), tt, None, local_steps=2,
                                 aggregate_opt_state=False)(state, tb)
    assert any(not torch.equal(x[0], x[1])
               for x in tree_leaves(keep.opt_state))


def test_pod_stacked_abstract_state_stays_storage_free():
    _, _, tcfg, tt = _round_configs()
    st = pod_stacked_state(TS.abstract_train_state(build_model(tcfg), tt), 3)
    for x in tree_leaves(st):
        assert x.device.type == "meta" and x.shape[0] == 3


@pytest.mark.parametrize("optimizer", ["adamw", "sgd", "momentum",
                                       "adafactor"])
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "recurrentgemma-2b",
                                  "flower-quickstart"])
def test_abstract_train_state_has_the_reference_shapes(arch, optimizer):
    rcfg = RC.get_model_config(arch)
    rt = RC.TrainConfig(optimizer=optimizer)
    want = tree_flatten_with_paths(RS.abstract_train_state(r_build(rcfg), rt))
    got = tree_flatten_with_paths(TS.abstract_train_state(
        build_model(_port_config(rcfg)),
        TC.TrainConfig(**dataclasses.asdict(rt))))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.device.type == "meta", path
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path


def _tiny_train(dtype="float32", microbatches=1):
    rcfg = RC.get_model_config("h2o-danube-1.8b", smoke=True).replace(
        dtype=dtype)
    tcfg = _port_config(rcfg)
    tt = TC.TrainConfig(global_batch=4, seq_len=16, learning_rate=1e-2,
                        warmup_steps=2, total_steps=10, grad_clip=1.0,
                        microbatches=microbatches)
    return tcfg, tt


def test_sharded_step_on_one_rank_equals_the_plain_step_bitwise():
    from repro_torch.data.loader import FederatedDataLoader
    from repro_torch.launch.mesh import make_local_mesh

    tcfg, tt = _tiny_train(microbatches=2)
    mesh = make_local_mesh(device="cpu")
    plain = TS.get_train_step(tcfg, tt, device="cpu")
    sharded = TS.get_train_step(tcfg, tt, mesh=mesh)
    assert sharded is TS.get_train_step(tcfg, tt, mesh=mesh)
    assert sharded is not plain
    a = b = TS.make_train_state(build_model(tcfg), tt, 3, device="cpu")
    loader = FederatedDataLoader(tcfg.vocab_size, tt.seq_len, 1,
                                 tt.global_batch, seed=23, prefetch=1)
    for _ in range(2):
        batch = loader.next_batch(0)
        a, ma = plain(a, batch)
        b, mb = sharded(b, batch)
        assert float(ma["loss"]) == float(mb["loss"])
        assert float(ma["grad_norm"]) == float(mb["grad_norm"])
    for x, y in zip(tree_leaves(a), tree_leaves(TS.full_tree(b))):
        assert torch.equal(x, y)


def test_sharded_step_on_two_data_ranks_matches_the_plain_step(tmp_path):
    _run_ranks("""
        import dataclasses
        import repro_torch.config as TC
        from repro_torch.data.loader import FederatedDataLoader
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.models import build_model
        from repro_torch.train import steps as TS
        from repro_torch.utils.pytree import tree_flatten_with_paths
        from torch.distributed.tensor import Shard

        cfg = TC.get_model_config("h2o-danube-1.8b", smoke=True).replace(
            dtype="float32")
        tt = TC.TrainConfig(global_batch=4, seq_len=16, learning_rate=1e-2,
                            warmup_steps=2, total_steps=10, grad_clip=1.0,
                            microbatches=2)
        mesh = make_local_mesh(data=2, device="cpu")
        plain = TS.get_train_step(cfg, tt, device="cpu")
        sharded = TS.get_train_step(cfg, tt, mesh=mesh)
        start = TS.make_train_state(build_model(cfg), tt, 3, device="cpu")
        loader = FederatedDataLoader(cfg.vocab_size, tt.seq_len, 1,
                                     tt.global_batch, seed=23, prefetch=1)
        a = b = start
        for t in range(2):
            batch = loader.next_batch(0)
            a, ma = plain(a, batch)
            b, mb = sharded(b, batch)
            la, lb = float(ma["loss"]), float(mb["loss"])
            assert abs(lb / la - 1) <= 1e-5, (t, la, lb)
            ga, gb = float(ma["grad_norm"]), float(mb["grad_norm"])
            assert abs(gb / ga - 1) <= 2e-5, (t, ga, gb)
            if t == 0:
                # FSDP: the embedding's d_model dim is split over "data"
                emb = b.params["embed"]
                assert Shard(1) in emb.placements, emb.placements
                assert emb.to_local().shape[1] == cfg.d_model // 2
                got = dict(tree_flatten_with_paths(TS.full_tree(b)))
                want = dict(tree_flatten_with_paths(a))
                for k, w in want.items():
                    if k.startswith(".opt_state"):
                        err = float((got[k] - w).abs().max())
                        assert err <= 2e-5 * float(w.abs().max()), (k, err)
    """, 2, tmp_path)


def test_first_local_meshes_from_two_threads_start_one_group():
    """Two threads call ``make_local_mesh`` first in a fresh interpreter
    (no default group yet): one group is started, both get the one mesh.
    The group's start is slowed, so that an unguarded check would let both
    threads start one (the second silently replacing the first)."""
    code = textwrap.dedent("""
        import sys, threading, time
        sys.path.insert(0, {src!r})
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_local_mesh

        init, calls = dist.init_process_group, []

        def slow_init(*a, **kw):
            calls.append(1)
            time.sleep(0.5)
            return init(*a, **kw)

        dist.init_process_group = slow_init
        start, meshes, errors = threading.Barrier(2), [], []

        def first():
            start.wait()
            try:
                meshes.append(make_local_mesh(device="cpu"))
            except Exception as e:
                errors.append(repr(e))

        threads = [threading.Thread(target=first) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        assert len(calls) == 1, calls
        assert len(meshes) == 2 and meshes[0] is meshes[1], meshes
        assert dist.get_world_size() == 1
        dist.destroy_process_group()
        print("MESH_OK")
    """).format(src=os.path.join(ROOT, "src_torch"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=RANK_TIMEOUT,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert "MESH_OK" in out.stdout, out.stdout[-3000:] + out.stderr[-3000:]


def test_production_mesh_names_the_devices_it_needs():
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(RuntimeError, match="256 devices"):
        make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="512 devices"):
        make_production_mesh(multi_pod=True, device="cpu")
