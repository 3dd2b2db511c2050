"""The port's sharding rules against the reference's, exactly.

``repro_torch.sharding`` (``spec_for``, ``tree_specs``, the fallback
record) and ``repro_torch.launch.shardings`` (``params_shardings``,
``state_shardings``, ``batch_shardings``, ``cache_shardings``,
``rules_for_shape``) are pure logic: for every config the port registers
(full and smoke) and every mesh shape from one card to the reference's
production meshes, they must give the reference's ``PartitionSpec`` as a
tuple, entry for entry.  The specs read only the mesh's axis names and
shape, so both sides get a mesh-shaped stand-in; the reference's
``NamedSharding`` wrapper is replaced by its spec for the comparison.

Also: the ``constrain_*`` calls are no-ops with no activation mesh, and
under one they redistribute a DTensor to the reference's spec;
``shard_bounds`` and ``agg_spec`` are the reference's.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.config as RC
import repro.launch.shardings as RSH
import repro.sharding as RSHD
from repro.models import build_model as r_build
import repro_torch.config as TC
import repro_torch.launch.shardings as TSH
import repro_torch.sharding as TSHD
from repro_torch.models import build_model as t_build
from repro_torch.utils.pytree import tree_flatten_with_paths

import repro_torch.configs  # noqa: E402,F401  (fills the registry)
ARCHS = sorted(TC.ARCH_REGISTRY)
MESHES = [(("data", "model"), (1, 1)), (("data", "model"), (2, 1)),
          (("data", "model"), (1, 2)), (("data", "model"), (2, 2)),
          (("data", "model"), (4, 8)), (("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16)),
          (("pod", "data", "model"), (2, 2, 2))]
MESH_IDS = ["x".join(map(str, s)) for _, s in MESHES]


def _ref_mesh(names, shape):
    return SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _port_mesh(names, shape):
    # the port reads a DeviceMesh's mesh_dim_names / mesh.shape, or the
    # reference-shaped axis_names / devices
    return SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _configs(arch, smoke):
    rcfg = RC.get_model_config(arch, smoke=smoke)
    tcfg = TC.ModelConfig(**{f.name: getattr(rcfg, f.name)
                             for f in dataclasses.fields(rcfg)
                             if f.name not in ("moe", "mla")})
    return rcfg, tcfg


@pytest.fixture(autouse=True)
def _specs_only(monkeypatch):
    """The reference's shardings as their specs (a stand-in mesh has no
    devices for a ``NamedSharding``)."""
    monkeypatch.setattr(RSH, "_named", lambda mesh, spec: tuple(spec))


def _ref_tree(tree):
    """A reference tree of specs as nested dicts / tuples of plain
    tuples."""
    if isinstance(tree, dict):
        return {k: _ref_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return tuple(_ref_tree(v) for v in tree)
    return tuple(tree)


def _port_tree(tree):
    if isinstance(tree, dict):
        return {k: _port_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return tuple(_port_tree(v) for v in tree)
    if isinstance(tree, TSHD.NamedSharding):
        return tree.spec
    return tuple(tree)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh, smoke):
    rcfg, tcfg = _configs(arch, smoke)
    rm, tm = _ref_mesh(*mesh), _port_mesh(*mesh)
    rmodel, tmodel = r_build(rcfg), t_build(tcfg)
    # spec_for over every leaf, with and without fsdp, and the fallbacks
    # it records
    for fsdp in (True, False):
        RSHD.clear_fallbacks()
        TSHD.clear_fallbacks()
        shapes = jax.tree.map(lambda s: tuple(s.shape), rmodel.abstract())
        want = _ref_tree(RSHD.tree_specs(rmodel.axes(), shapes, rm,
                                         fsdp=fsdp))
        got = _port_tree(TSHD.tree_specs(tmodel.axes(), tmodel.abstract(),
                                         tm, fsdp=fsdp))
        assert got == want
    for name in ("embed", "heads", "kv_heads", "mlp", "vocab"):
        for dim in (1, 7, 32, 56, 2560, 32000, 256000):
            ax = (name, "embed", None)
            shp = (dim, 256, 3)
            assert TSHD.spec_for(ax, shp, tm, name="t") == tuple(
                RSHD.spec_for(ax, shp, rm, name="t"))
    assert TSHD.FALLBACKS == RSHD.FALLBACKS
    # params_shardings with the salvage pass, then the whole TrainState
    assert _port_tree(TSH.params_shardings(tmodel, tm)) == \
        _ref_tree(RSH.params_shardings(rmodel, rm))
    for opt in ("adamw", "sgd", "momentum", "adafactor"):
        rt = RC.TrainConfig(optimizer=opt)
        tt = TC.TrainConfig(optimizer=opt)
        want = _ref_tree(RSH.state_shardings(rmodel, rt, rm))
        got = _port_tree(TSH.state_shardings(tmodel, tt, tm))
        if opt in ("momentum", "adafactor"):
            # the replicated fallback: every leaf P()
            assert _flat_specs(got) == _flat_specs(want)
        else:
            assert got == want


def _flat_specs(tree):
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, tuple) and t and all(
                isinstance(e, (dict, tuple)) for e in t):
            for v in t:
                walk(v)
        else:
            out.append(t)
    walk(tree)
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_the_reference(arch, mesh):
    import jax.numpy as jnp

    rcfg, tcfg = _configs(arch, True)
    rm, tm = _ref_mesh(*mesh), _port_mesh(*mesh)
    for B, S in ((1, 16), (2, 16), (4, 64), (32, 8), (256, 4096)):
        want = RSH.batch_shardings(
            {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
             "labels": jax.ShapeDtypeStruct((B, S), jnp.int32)}, rm)
        got = TSH.batch_shardings({"tokens": (B, S), "labels": (B, S)}, tm)
        assert {k: v.spec for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}
        for shape in TC.INPUT_SHAPES.values():
            rules_r = RSH.rules_for_shape(RC.INPUT_SHAPES[shape.name])
            rules_t = TSH.rules_for_shape(shape)
            assert rules_t == rules_r
            want_c, _ = RSH.cache_shardings(r_build(rcfg), B, S, rm,
                                            rules=rules_r)
            got_c, cache = TSH.cache_shardings(t_build(tcfg), B, S, tm,
                                               rules=rules_t)
            assert _port_tree(got_c) == _ref_tree(want_c)
            assert all(x.device.type == "meta"
                       for _, x in tree_flatten_with_paths(cache))


def test_shard_bounds_and_agg_spec_are_the_reference():
    from repro_torch.fl import agg_kernels
    assert agg_kernels.shard_bounds is TSHD.shard_bounds
    for total in (0, 1, 7, 1000, 50_000_000, 442_000_123):
        for n in (1, 2, 3, 8, 16):
            for align in (1, 1024, 4096):
                assert TSHD.shard_bounds(total, n, align) == \
                    RSHD.shard_bounds(total, n, align)
    for names in (("data",), ("data", "model"), ("x",)):
        shape = (2,) * len(names)
        assert TSHD.agg_spec(_port_mesh(names, shape)) == tuple(
            RSHD.agg_spec(_ref_mesh(names, shape)))
    with pytest.raises(ValueError):
        TSHD.shard_bounds(10, 0)


def test_constraints_are_noops_without_an_activation_mesh():
    TSHD.set_activation_mesh(None)
    x = torch.randn(4, 8, 16)
    for fn in (TSHD.constrain_batch, TSHD.constrain_logits,
               TSHD.constrain_moe, TSHD.constrain_heads,
               TSHD.constrain_scores):
        assert fn(x) is x
    assert TSHD.model_axis_size() == 1
    w = torch.randn(16, 32)
    assert torch.equal(TSHD.cast_weight(w, torch.bfloat16, ("embed", "mlp")),
                       w.to(torch.bfloat16))


def test_constraints_redistribute_under_an_activation_mesh():
    """On a one-rank CPU mesh the placements follow the reference's specs
    (the mesh dims have size 1, so the values do not move)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, \
        distribute_tensor

    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(device="cpu")
    assert make_local_mesh(device="cpu") is mesh
    x = distribute_tensor(torch.randn(4, 8, 16), mesh,
                          [Replicate(), Replicate()])
    TSHD.set_activation_mesh(mesh, batch_axes=("data",))
    try:
        y = TSHD.constrain_batch(x)
        assert isinstance(y, DTensor)
        assert tuple(y.placements) == (Shard(0), Shard(1))
        assert torch.equal(y.full_tensor(), x.full_tensor())
        z = TSHD.constrain_logits(x)
        assert tuple(z.placements) == (Shard(0), Shard(2))
        # a "model" axis of size 1: the scores and the cast weight keep
        # their placements, as in the reference
        assert TSHD.constrain_scores(x) is x
        w = TSHD.cast_weight(distribute_tensor(torch.randn(8, 16), mesh,
                                               [Replicate(), Replicate()]),
                             torch.bfloat16, ("embed", "mlp"))
        assert w.dtype == torch.bfloat16
        assert tuple(w.placements) == (Replicate(), Replicate())
        with pytest.raises(TypeError, match="DTensor"):
            TSHD.constrain_batch(torch.randn(4, 8, 16))
    finally:
        TSHD.set_activation_mesh(None)


def test_placements_for_maps_specs_onto_mesh_dims():
    from torch.distributed.tensor import Replicate, Shard
    m = SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                        mesh=np.empty((2, 2, 2)))
    assert TSHD.placements_for(m, (("pod", "data"), None, "model")) == \
        [Shard(0), Shard(0), Shard(2)]
    assert TSHD.placements_for(m, (None, None)) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        TSHD.placements_for(m, (("model", "data"),))
