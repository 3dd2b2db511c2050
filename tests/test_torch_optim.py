"""The port's optimizers, schedules and pytree helpers against the
reference's, on the CPU.

The same params, grads and state, made from a numpy seed, go through
``repro.optim`` and ``repro_torch.optim`` for several steps; every step's
updates and states are compared leaf by leaf.  Tolerances
(``assert_allclose``): schedules and ``clip_by_global_norm`` within 1e-6
relative; the optimizers' updates and states within 1e-6 relative, plus
an absolute floor of 1e-6 of each leaf's largest entry (the reference's
arithmetic in its order, in fp32; XLA's and torch's ``pow``, ``sqrt`` and
reductions round in other places).
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
import repro.optim as RO
import repro.utils.pytree as RP
import repro_torch.config as TC
import repro_torch.optim as TO
import repro_torch.utils.pytree as TP

RTOL = 1e-6
OPTIMIZERS = ("sgd", "momentum", "adam", "adamw", "adafactor")


def _params(seed=0):
    """A tree with a 0-d, 1-d, 2-d and 3-d leaf, in nested dicts."""
    rng = np.random.default_rng(seed)
    return {"norm": {"scale": rng.normal(size=(16,)).astype(np.float32)},
            "w": rng.normal(size=(16, 24)).astype(np.float32),
            "stack": {"wq": rng.normal(size=(3, 8, 12)).astype(np.float32)},
            "gain": np.asarray(rng.normal(), np.float32)}


def _grads(step: int, like):
    rng = np.random.default_rng(100 + step)
    # a few exact zeros: Adam's 0 / (0 + eps) and Adafactor's eps floor
    return jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.3 *
                                   (rng.random(a.shape) > 0.1)
                                   ).astype(np.float32), like)


def _to_torch(tree):
    return TP.tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                       tree)


def _close(got_tree, want_tree, rtol=RTOL):
    got = dict(TP.tree_flatten_with_paths(TP.tree_to_numpy(got_tree)))
    want = dict(RP.tree_flatten_with_paths(jax.tree.map(np.asarray,
                                                        want_tree)))
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k], np.float64)
        floor = rtol * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=floor,
                                   err_msg=k)


def _tcfg(kind, **kw):
    r = RC.TrainConfig(optimizer=kind, learning_rate=1e-2, warmup_steps=2,
                       total_steps=8, **kw)
    return r, TC.TrainConfig(**dataclasses.asdict(r))


def test_train_config_is_the_reference_s():
    for cls in ("TrainConfig", "MeshConfig", "FLConfig", "ServeConfig"):
        r, t = getattr(RC, cls)(), getattr(TC, cls)()
        assert dataclasses.asdict(r) == dataclasses.asdict(t), cls
        assert hash(t) == hash(getattr(TC, cls)())
    assert TC.MeshConfig(axes=("pod", "data")).multi_pod
    exp = TC.Experiment(TC.ModelConfig())
    assert exp.train == TC.TrainConfig() and exp.fl == TC.FLConfig()


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "recurrentgemma-2b",
                                  "flower-quickstart"])
def test_shape_matrix_and_subquadratic_are_the_reference_s(arch):
    for smoke in (False, True):
        r = RC.get_model_config(arch, smoke=smoke)
        t = TC.get_model_config(arch, smoke=smoke)
        assert r.is_subquadratic == t.is_subquadratic
        for name in RC.INPUT_SHAPES:
            assert RC.shape_supported(r, RC.INPUT_SHAPES[name]) \
                == TC.shape_supported(t, TC.INPUT_SHAPES[name]), name


@pytest.mark.parametrize("sched", ["constant", "cosine", "warmup_cosine"])
def test_schedules_match(sched):
    make = {"constant": lambda m: m.constant_schedule(3e-4),
            "cosine": lambda m: m.cosine_schedule(3e-4, 7, 0.2),
            "warmup_cosine": lambda m: m.linear_warmup_cosine(3e-4, 3, 10)}
    r, t = make[sched](RO), make[sched](TO)
    for step in range(0, 14):
        want = np.asarray(r(jnp.asarray(step, jnp.int32)))
        got = t(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches(max_norm):
    p = _params()
    g = _grads(0, p)
    rg, rn = RO.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    tg, tn = TO.clip_by_global_norm(_to_torch(g), max_norm)
    np.testing.assert_allclose(tn.numpy(), np.asarray(rn), rtol=RTOL)
    _close(tg, rg)
    np.testing.assert_allclose(TP.tree_global_norm(_to_torch(g)).numpy(),
                               np.asarray(RP.tree_global_norm(g)), rtol=RTOL)


@pytest.mark.parametrize("kind", OPTIMIZERS)
def test_optimizer_matches_over_several_steps(kind):
    """Five steps from the same params: each step's updates, the new state
    and the params after ``p + u`` agree; the port's state is fed back in
    (its own trajectory, not the reference's)."""
    rcfg, tcfg = _tcfg(kind)
    ropt, topt = RO.make_optimizer(rcfg), TO.make_optimizer(tcfg)
    assert ropt.name == topt.name
    p0 = _params()
    rp, tp = jax.tree.map(jnp.asarray, p0), _to_torch(p0)
    rs, ts = ropt.init(rp), topt.init(tp)
    _close(ts, rs)
    for step in range(5):
        g = _grads(step, p0)
        ru, rs = ropt.update(jax.tree.map(jnp.asarray, g), rs, rp,
                             jnp.asarray(step, jnp.int32))
        tu, ts = topt.update(_to_torch(g), ts, tp,
                             torch.tensor(step, dtype=torch.int32))
        _close(tu, ru)
        _close(ts, rs)
        rp = jax.tree.map(lambda a, u: a + u, rp, ru)
        tp = TP.tree_map(lambda a, u: a + u, tp, tu)
        _close(tp, rp)
    assert type(ts).__name__ == type(rs).__name__


def test_adamw_keeps_the_param_dtype_and_fp32_moments():
    _, tcfg = _tcfg("adamw")
    opt = TO.make_optimizer(tcfg)
    p = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    st = opt.init(p)
    assert st.mu["w"].dtype == torch.float32
    u, st = opt.update({"w": torch.full((4, 4), 0.5, dtype=torch.bfloat16)},
                       st, p, torch.tensor(0, dtype=torch.int32))
    assert u["w"].dtype == torch.bfloat16 and st.nu["w"].dtype == torch.float32
    assert not u["w"].requires_grad


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        TO.make_optimizer(TC.TrainConfig(optimizer="lion"))


def test_pytree_helpers_match():
    p = _params()
    t = _to_torch(p)
    assert TP.tree_count(t) == RP.tree_count(p)
    assert TP.tree_bytes(t) == RP.tree_bytes(jax.tree.map(jnp.asarray, p))
    assert [k for k, _ in TP.tree_flatten_with_paths(t)] \
        == [k for k, _ in RP.tree_flatten_with_paths(p)]
    q = _to_torch(_grads(1, p))
    mean = TP.tree_weighted_mean([t, q], [1.0, 3.0])
    want = RP.tree_weighted_mean([p, _grads(1, p)], [1.0, 3.0])
    _close(mean, want)
    _close(TP.tree_sub(TP.tree_add(t, q), q), p)
    assert TP.tree_allclose(TP.tree_zeros_like(t),
                            jax.tree.map(np.zeros_like, p))
    back = TP.tree_from_numpy(TP.tree_to_numpy(t), like=t)
    assert all(torch.equal(a, b) for a, b in zip(TP.tree_leaves(back),
                                                 TP.tree_leaves(t)))
    with pytest.raises(ValueError):
        TP.tree_weighted_mean([t], [0.0])
