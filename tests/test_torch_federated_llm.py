"""The port's federated-LLM example: ports of ``tests/test_federated_llm.py``.

Inside the port, bitwise: ``LMClient.fit`` keeps the optimizer state
across rounds (round R+1 continuing from round R's ``TrainState`` equals
one uninterrupted local run; re-initialising the moments diverges), the
step cache gives one step per ``(cfg, tcfg, impl, mesh)``, clients with
equal configs share it, and the sharded step on the local mesh follows the
plain one.  Across the packages, from the reference's parameters,
``LMClient.fit`` against the reference's ``get_train_step(cfg, tcfg)``
(the reference's mesh path fails on this JAX) over the same batches: one
step's state within the tolerances of ``tests/test_torch_train.py``, the
losses of a free run within 1e-5 relative.  The federation itself
(``federate``: 4 sites through ``run_in_flare``, 0xF5 uplink) improves its
loss on the CPU.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as RC
import repro.data as RD
from repro.models import build_model as r_build
from repro.optim import make_optimizer as r_opt
from repro.train import steps as RS
import repro_torch.config as TC
from repro_torch.data.loader import FederatedDataLoader
from repro_torch.examples import federated_llm as mod
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.train.steps import TrainState, full_tree, get_train_step

from test_torch_train import _hold_state, _lr, _rel, port_config


def _tiny():
    cfg = TC.get_model_config("flower-quickstart").replace(
        d_model=32, num_layers=1, d_ff=64, vocab_size=128, remat=False)
    tcfg = TC.TrainConfig(global_batch=2, seq_len=16, learning_rate=1e-2,
                          warmup_steps=2, total_steps=64)
    return cfg, tcfg


def _loader(cfg, tcfg, seed=11):
    return FederatedDataLoader(cfg.vocab_size, tcfg.seq_len, num_sites=1,
                               batch_per_site=tcfg.global_batch, seed=seed,
                               non_iid_alpha=0.5, prefetch=1)


def _mesh():
    return make_local_mesh(device="cpu")


def _client(cfg, tcfg, loader, local_steps, site="site-1"):
    return mod.LMClient(site, cfg, tcfg, loader, local_steps, mesh=_mesh())


def test_fit_preserves_optimizer_state_across_rounds():
    cfg, tcfg = _tiny()
    local_steps = 3
    client = _client(cfg, tcfg, _loader(cfg, tcfg), local_steps)
    p0 = client.get_parameters({})
    out1, _, _ = client.fit(p0, {"round": 0})
    st1 = full_tree(client._state)            # snapshot after round 0
    assert int(st1.step) == local_steps
    out2, _, _ = client.fit(out1, {"round": 1})
    assert int(full_tree(client._state.step)) == 2 * local_steps

    # replay round 1 by hand: same batch stream, CONTINUING from round 0's
    # moments + step
    replay = _loader(cfg, tcfg)
    for _ in range(local_steps):
        replay.next_batch(0)
    state = TrainState(mod.arrays_to_params(out1, client._like, "cpu"),
                       st1.opt_state, st1.step)
    step_fn = client._step_fn
    for _ in range(local_steps):
        state, _ = step_fn(state, replay.next_batch(0))
    for got, want in zip(out2, mod.params_to_arrays(state.params)):
        np.testing.assert_array_equal(got, want)

    # the pinned bug: re-initializing the moments each round diverges
    params1 = mod.arrays_to_params(out1, client._like, "cpu")
    replay2 = _loader(cfg, tcfg)
    for _ in range(local_steps):
        replay2.next_batch(0)
    stale = TrainState(params1, client._opt.init(params1),
                       torch.tensor(local_steps, dtype=torch.int32))
    for _ in range(local_steps):
        stale, _ = step_fn(stale, replay2.next_batch(0))
    assert any(np.any(a != b) for a, b in zip(
        out2, mod.params_to_arrays(stale.params)))


def test_rounds_match_one_uninterrupted_local_run():
    """3 federated rounds on a single site == 9 straight local steps."""
    cfg, tcfg = _tiny()
    local_steps = 3
    client = _client(cfg, tcfg, _loader(cfg, tcfg), local_steps)
    params = client.get_parameters({})
    for rnd in range(3):
        params, _, _ = client.fit(params, {"round": rnd})

    straight = _loader(cfg, tcfg)
    p = mod.arrays_to_params(client.get_parameters({}), client._like, "cpu")
    state = TrainState(p, client._opt.init(p),
                       torch.zeros((), dtype=torch.int32))
    for _ in range(3 * local_steps):
        state, _ = client._step_fn(state, straight.next_batch(0))
    for got, want in zip(params, mod.params_to_arrays(state.params)):
        np.testing.assert_array_equal(got, want)


def test_train_step_cache_shares_one_step():
    cfg, tcfg = _tiny()
    assert get_train_step(cfg, tcfg, device="cpu") is \
        get_train_step(cfg, tcfg, device="cpu")
    mesh = _mesh()
    assert get_train_step(cfg, tcfg, mesh=mesh) is \
        get_train_step(cfg, tcfg, mesh=mesh)
    assert get_train_step(cfg, tcfg, device="cpu") is not \
        get_train_step(cfg, tcfg, mesh=mesh)
    # distinct configs must NOT collide
    other = dataclasses.replace(tcfg, learning_rate=5e-3)
    assert get_train_step(cfg, other, device="cpu") is not \
        get_train_step(cfg, tcfg, device="cpu")
    assert get_train_step(cfg, other, mesh=mesh) is not \
        get_train_step(cfg, tcfg, mesh=mesh)
    with pytest.raises(ValueError, match="mesh"):
        get_train_step(cfg, tcfg, mesh=mesh, device="cuda")


def test_clients_with_equal_configs_share_the_step():
    cfg, tcfg = _tiny()
    loader = _loader(cfg, tcfg)
    c1 = _client(cfg, tcfg, loader, 1, "site-1")
    c2 = _client(cfg, tcfg, loader, 1, "site-2")
    assert c1._step_fn is c2._step_fn


def test_sharded_step_matches_unsharded_on_local_mesh():
    """The (1,1)-mesh sharded step and the plain step compute the same
    training trajectory."""
    cfg, tcfg = _tiny()
    plain = get_train_step(cfg, tcfg, device="cpu")
    sharded = get_train_step(cfg, tcfg, mesh=_mesh())
    from repro_torch.models import build_model
    from repro_torch.train.steps import make_train_state

    s_a = s_b = make_train_state(build_model(cfg), tcfg, 3, device="cpu")
    loader = _loader(cfg, tcfg, seed=23)
    for _ in range(3):
        batch = loader.next_batch(0)
        s_a, m_a = plain(s_a, batch)
        s_b, m_b = sharded(s_b, batch)
        np.testing.assert_allclose(float(m_a["loss"]), float(m_b["loss"]),
                                   rtol=1e-5)
    for a, b in zip(mod.params_to_arrays(s_a.params),
                    mod.params_to_arrays(s_b.params)):
        np.testing.assert_allclose(a.astype(np.float64),
                                   b.astype(np.float64),
                                   rtol=1e-5, atol=1e-6)


def _cross_configs():
    rcfg = RC.get_model_config("flower-quickstart").replace(
        d_model=32, num_layers=2, d_ff=64, vocab_size=128, remat=False,
        dtype="float32")
    rt = RC.TrainConfig(global_batch=2, seq_len=16, learning_rate=1e-2,
                        warmup_steps=2, total_steps=64)
    return rcfg, rt, port_config(rcfg), TC.TrainConfig(
        **dataclasses.asdict(rt))


@pytest.mark.parametrize("local_steps", [1, 3])
def test_fit_from_the_reference_params_follows_the_reference(local_steps):
    rcfg, rt, cfg, tcfg = _cross_configs()
    rparams = r_build(rcfg).init(jax.random.key(0))
    arrays = [np.asarray(x) for x in jax.tree.leaves(rparams)]
    client = _client(cfg, tcfg, _loader(cfg, tcfg), local_steps)
    _, n, metrics = client.fit(arrays, {"round": 0})
    assert n == local_steps * tcfg.global_batch * tcfg.seq_len

    rstep = RS.get_train_step(rcfg, rt)
    ref = RS.TrainState(rparams, r_opt(rt).init(rparams),
                        jnp.zeros((), jnp.int32))
    loader = RD.FederatedDataLoader(rcfg.vocab_size, rt.seq_len, 1,
                                    rt.global_batch, seed=11,
                                    non_iid_alpha=0.5, prefetch=1)
    losses = []
    for _ in range(local_steps):
        ref, rm = rstep(ref, loader.next_batch(0))
        losses.append(float(rm["loss"]))
    assert _rel(metrics["train_loss"], np.mean(losses)) <= 1e-5
    if local_steps == 1:
        _hold_state(full_tree(client._state), ref, _lr(rt, 0))


def test_federation_improves_its_loss_on_the_cpu():
    """Four sites through ``run_in_flare`` with 0xF5 uplinks.  At this
    width a 5% TopK moves the model by less than the eval batches' noise
    in two rounds, so the CPU run keeps a quarter of each delta and
    evaluates 512 tokens a site."""
    cfg = TC.get_model_config("flower-quickstart").replace(
        d_model=64, num_layers=2, d_ff=128, vocab_size=256, remat=False)
    tcfg = TC.TrainConfig(global_batch=8, seq_len=64, learning_rate=5e-3,
                          warmup_steps=2, total_steps=30)
    history = mod.federate(cfg, tcfg, rounds=2, local_steps=3,
                           codec="sparse", sparse_frac=0.25, device="cpu")
    losses = [l for _, l in history.losses()]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert all(r.metrics.get("wire_codec") == "sparse"
               for r in history.rounds)
    assert all(not r.failures for r in history.rounds), \
        [r.failures for r in history.rounds]
