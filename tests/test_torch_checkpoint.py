"""The port's checkpoints against the reference's, on the CPU.

A training state (params, AdamW or Adafactor moments, step) saved by
either package restores in the other bitwise: the same file names, the
same npz keys (``jax.tree_util.keystr`` paths) and the same JSON manifest.
Also: a round trip in the port, bf16 leaves (stored as fp32, restored to
the ``like`` tree's dtype), a shape mismatch and a missing leaf raise, and
a write leaves no temporary file behind.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as RCK
import repro.config as RC
from repro.models import build_model as r_build
from repro.optim import make_optimizer as r_opt
from repro.train.steps import TrainState as RState
import repro_torch.checkpoint as TCK
from repro_torch.models import train_state_from_reference, train_state_to_arrays
from repro_torch.utils.pytree import tree_flatten_with_paths, tree_map


@pytest.fixture(scope="module", params=["adamw", "adafactor"])
def states(request):
    """(reference TrainState, the port's TrainState) with equal values:
    danube smoke params, moments made non-zero by one update, step 7."""
    cfg = RC.get_model_config("h2o-danube-1.8b", smoke=True)
    tcfg = RC.TrainConfig(optimizer=request.param)
    params = r_build(cfg).init(jax.random.key(0))
    opt = r_opt(tcfg)
    grads = jax.tree.map(lambda p: jnp.sin(p * 7.0), params)
    _, st = opt.update(grads, opt.init(params), params,
                       jnp.asarray(6, jnp.int32))
    ref = RState(params, st, jnp.asarray(7, jnp.int32))
    port = train_state_from_reference(jax.tree.map(np.asarray, ref),
                                      device="cpu")
    return ref, port


def _ref_leaves(tree):
    return {k: np.asarray(v)
            for k, v in tree_flatten_with_paths(jax.tree.map(np.asarray,
                                                             tree))}


def _port_leaves(tree):
    return dict(tree_flatten_with_paths(train_state_to_arrays(tree)))


def _bitwise(port_tree, ref_tree):
    got, want = _port_leaves(port_tree), _ref_leaves(ref_tree)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_paths_are_the_reference_s(states):
    ref, port = states
    rpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert [k for k, _ in tree_flatten_with_paths(port)] == rpaths
    assert ".params['embed']" in rpaths and ".step" in rpaths
    assert any(k.startswith(".opt_state.") and "['scan_0']['mix']['wq']" in k
               for k in rpaths)


def test_port_checkpoint_restores_in_the_reference(states, tmp_path):
    ref, port = states
    path = TCK.save_checkpoint(str(tmp_path), 7, port, extra={"round": 2})
    assert os.path.basename(path) == "ckpt_00000007.npz"
    assert RCK.latest_step(str(tmp_path)) == 7
    got, step = RCK.restore_checkpoint(str(tmp_path), ref)
    assert step == 7
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_reference_checkpoint_restores_in_the_port(states, tmp_path):
    ref, port = states
    RCK.save_checkpoint(str(tmp_path), 12, ref, extra={"round": 2})
    like = tree_map(torch.zeros_like, port)
    got, step = TCK.restore_checkpoint(str(tmp_path), like)
    assert step == 12 and TCK.latest_step(str(tmp_path)) == 12
    assert type(got) is type(port) and type(got.opt_state) is type(port.opt_state)
    _bitwise(got, ref)


def test_manifests_and_keys_are_the_reference_s(states, tmp_path):
    ref, port = states
    a, b = tmp_path / "port", tmp_path / "ref"
    TCK.save_checkpoint(str(a), 3, port, extra={"site": "site-1"})
    RCK.save_checkpoint(str(b), 3, ref, extra={"site": "site-1"})
    assert sorted(os.listdir(a)) == sorted(os.listdir(b)) \
        == ["ckpt_00000003.json", "ckpt_00000003.npz"]
    man = [json.loads((d / "ckpt_00000003.json").read_text()) for d in (a, b)]
    assert man[0] == man[1]
    with np.load(a / "ckpt_00000003.npz") as x, \
            np.load(b / "ckpt_00000003.npz") as y:
        assert sorted(x.files) == sorted(y.files) == man[0]["keys"]
        for k in x.files:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


def test_round_trip_and_latest_step(tmp_path):
    tree = {"w": torch.randn(3, 4, generator=torch.Generator().manual_seed(0)),
            "h": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3) / 7,
            "n": torch.tensor(5, dtype=torch.int32)}
    assert TCK.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        TCK.restore_checkpoint(str(tmp_path), tree)
    for step in (2, 10, 4):
        TCK.save_checkpoint(str(tmp_path), step, tree)
    assert TCK.latest_step(str(tmp_path)) == 10
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
    with np.load(tmp_path / "ckpt_00000010.npz") as data:
        assert data["['h']"].dtype == np.float32        # bf16 stored as fp32
    got, step = TCK.restore_checkpoint(str(tmp_path), tree, step=4)
    assert step == 4
    for k in tree:
        assert got[k].dtype == tree[k].dtype
        assert torch.equal(got[k], tree[k])


def test_shape_mismatch_and_missing_leaf_raise(tmp_path):
    TCK.save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(3, 4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        TCK.restore_checkpoint(str(tmp_path), {"w": torch.zeros(4, 3)})
    with pytest.raises(KeyError, match="missing leaf"):
        TCK.restore_checkpoint(str(tmp_path), {"w": torch.zeros(3, 4),
                                               "b": torch.zeros(4)})


def test_train_state_carries_across_both_ways(states):
    ref, port = states
    _bitwise(port, ref)
    assert port.step.dtype == torch.int32 and int(port.step) == 7
    back = train_state_to_arrays(port)
    again = train_state_from_reference(
        RState(back.params, type(ref.opt_state)(*back.opt_state), back.step),
        device="cpu")
    _bitwise(again, ref)
