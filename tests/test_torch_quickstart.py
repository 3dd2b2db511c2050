"""The port's quickstart client against the reference's (JAX) one.

Tolerances, measured on the CPU over seeds and sites: one ``fit`` (16 SGD
steps) leaves parameters at most 6e-8 apart and losses 2e-7 apart
(relative).  JAX and PyTorch sum the matrix products and the softmax in
different orders, and XLA:CPU contracts ``p - lr*g`` into a fused
multiply-add where the port rounds the product first, so fp32 rounding
differences, not algorithmic ones, remain.  The bounds below leave ~15x
headroom: parameters 1e-6 absolute, losses 1e-5 relative.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import jax
import numpy as np
import pytest
import torch

from repro.fl import quickstart as RQ
from repro_torch.fl import quickstart as TQ
from repro_torch.fl.messages import arrays_to_params, params_to_arrays

PARAM_ATOL = 1e-6
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def ref_init():
    return RQ.init_mlp(jax.random.key(0), 32, 64, 10)


def test_params_from_reference_roundtrip_is_exact(ref_init):
    model = TQ.params_from_reference(ref_init, device="cpu")
    assert isinstance(model, TQ.QuickstartMLP)
    back = model.to_arrays()
    assert [a.shape for a in back] == [a.shape for a in ref_init]
    for a, b in zip(back, ref_init):
        assert a.dtype == np.float32 and a.tobytes() == b.tobytes()


def test_forward_matches_reference_layout(ref_init):
    x = np.random.default_rng(1).normal(0, 1, (8, 32)).astype(np.float32)
    want = np.asarray(RQ._forward([jax.numpy.asarray(p) for p in ref_init],
                                  x))
    got = TQ.params_from_reference(ref_init, "cpu")(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=PARAM_ATOL)


@pytest.mark.parametrize("mu", [0.0, 0.1])
@pytest.mark.parametrize("site", ["site-1", "site-3"])
def test_fit_and_evaluate_match_reference(ref_init, mu, site):
    ref = RQ.QuickstartClient(site)
    port = TQ.QuickstartClient(site, device="cpu")
    cfg = {"proximal_mu": mu}
    pr, nr, mr = ref.fit(ref_init, cfg)
    pt, nt, mt = port.fit(ref_init, cfg)
    assert nr == nt == 512
    for a, b in zip(pr, pt):
        assert a.shape == b.shape and b.dtype == np.float32
        np.testing.assert_allclose(b, a, rtol=0, atol=PARAM_ATOL)
    np.testing.assert_allclose(mt["train_loss"], mr["train_loss"],
                               rtol=LOSS_RTOL)
    lr_, nr_, er = ref.evaluate(pr, {})
    lt_, nt_, et = port.evaluate(pr, {})
    assert nr_ == nt_ == 256
    np.testing.assert_allclose(lt_, lr_, rtol=LOSS_RTOL)
    assert abs(et["accuracy"] - er["accuracy"]) <= 1.0 / 256


def test_proximal_term_changes_the_update(ref_init):
    port = TQ.QuickstartClient("site-2", device="cpu")
    p0, _, _ = port.fit(ref_init, {"proximal_mu": 0.0})
    p1, _, _ = port.fit(ref_init, {"proximal_mu": 1.0})
    assert any(not np.array_equal(a, b) for a, b in zip(p0, p1))


def test_get_parameters_reference_scales_and_determinism():
    a = TQ.QuickstartClient("site-1", device="cpu").get_parameters({})
    b = TQ.QuickstartClient("site-2", device="cpu").get_parameters({})
    ref = RQ.QuickstartClient("site-1").get_parameters({})
    assert [x.shape for x in a] == [x.shape for x in ref]
    for x, y in zip(a, b):
        assert x.dtype == np.float32 and np.array_equal(x, y)
    assert abs(float(a[0].std()) - 32 ** -0.5) < 0.02
    assert not a[1].any() and not a[3].any() and not a[5].any()


def test_params_to_arrays_and_back_for_lists_and_state_dicts(ref_init):
    model = TQ.params_from_reference(ref_init, "cpu")
    arrays = params_to_arrays(model.state_dict())
    for a, b in zip(arrays, ref_init):
        assert a.tobytes() == b.tobytes()
    sd = arrays_to_params(arrays, model.state_dict())
    assert list(sd) == list(model.state_dict())
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    bf = [torch.tensor([1.5, -2.0, 3.25], dtype=torch.bfloat16)]
    back = arrays_to_params(params_to_arrays(bf), bf)
    assert back[0].dtype == torch.bfloat16 and torch.equal(back[0], bf[0])
