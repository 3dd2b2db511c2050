"""The paper's §5.1 demo workload, in PyTorch: a small classifier trained
federatedly (the PyTorch-CIFAR-quickstart analogue).

Port of ``repro/fl/quickstart.py``.  The MLP keeps the JAX package's
parameter layout — ``w`` is (in, out) and a layer is ``x @ w + b`` — so
its six arrays travel in the same wire frames, and
:func:`params_from_reference` / :meth:`QuickstartMLP.to_arrays` carry
weights between the two packages unchanged.  Deterministic end to end:
given (seed, site), fit() is a pure function of the incoming parameters,
so native and in-FLARE histories can be compared bitwise.  On a CUDA
device that needs deterministic cuBLAS (``CUBLAS_WORKSPACE_CONFIG`` set
before CUDA starts, ``torch.use_deterministic_algorithms(True)``): the
clients' fits run concurrently in SuperNode threads.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.data.synthetic import make_classification
from repro_torch.device import resolve_device
from repro_torch.fl.client import ClientApp, NumPyClient
from repro_torch.runtime.streaming import SummaryWriter

NDArrays = List[np.ndarray]

_NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")


# ---------------------------------------------------------------------------
# model: 2-hidden-layer MLP classifier
# ---------------------------------------------------------------------------
def init_mlp(seed: int, dim: int, hidden: int, classes: int) -> NDArrays:
    """Initial parameters at the reference's scales (normal weights times
    fan_in**-0.5, zero biases).  ``jax.random`` cannot be reproduced, so
    the draws come from ``np.random.default_rng(seed)``; runs compared with
    the reference inject its initial parameters instead."""
    rng = np.random.default_rng(seed)
    s1, s2, s3 = dim ** -0.5, hidden ** -0.5, hidden ** -0.5
    return [
        (rng.standard_normal((dim, hidden)) * s1).astype(np.float32),
        np.zeros((hidden,), np.float32),
        (rng.standard_normal((hidden, hidden)) * s2).astype(np.float32),
        np.zeros((hidden,), np.float32),
        (rng.standard_normal((hidden, classes)) * s3).astype(np.float32),
        np.zeros((classes,), np.float32),
    ]


class QuickstartMLP(nn.Module):
    """relu(x @ w1 + b1) -> relu(. @ w2 + b2) -> . @ w3 + b3."""

    def __init__(self, dim: int, hidden: int, classes: int,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        shapes = ((dim, hidden), (hidden,), (hidden, hidden), (hidden,),
                  (hidden, classes), (classes,))
        for name, shape in zip(_NAMES, shapes):
            self.register_parameter(name, nn.Parameter(
                torch.zeros(shape, dtype=torch.float32, device=dev)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(x @ self.w1 + self.b1)
        h = torch.relu(h @ self.w2 + self.b2)
        return h @ self.w3 + self.b3

    def load_arrays(self, arrays: NDArrays) -> None:
        """Copy six host arrays (the wire layout) into the parameters."""
        if len(arrays) != len(_NAMES):
            raise ValueError(f"expected {len(_NAMES)} arrays, got "
                             f"{len(arrays)}")
        with torch.no_grad():
            for p, a in zip(self.parameters(), arrays):
                a = np.asarray(a, np.float32)
                if tuple(a.shape) != tuple(p.shape):
                    raise ValueError(f"shape {a.shape} != {tuple(p.shape)}")
                p.copy_(torch.from_numpy(np.array(a)))

    def to_arrays(self) -> NDArrays:
        """The six parameters as host fp32 arrays, in the reference's
        order and layout."""
        return [p.detach().cpu().numpy().copy() for p in self.parameters()]


def params_from_reference(arrays: NDArrays, device=None) -> QuickstartMLP:
    """Build the port's MLP from the reference's six arrays (as made by
    ``repro.fl.quickstart.init_mlp`` or returned by its ``fit``)."""
    w1, _, _, _, w3, _ = arrays
    model = QuickstartMLP(w1.shape[0], w1.shape[1], w3.shape[1], device)
    model.load_arrays(arrays)
    return model


def _cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """mean(logsumexp(logits) - logits[y]), written as a product with a
    one-hot matrix made by comparison: the backward of ``gather`` on CUDA
    is a scatter-add whose order is not fixed, and ``one_hot`` scatters."""
    classes = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (y[:, None] == classes).to(logits.dtype)
    return -(nn.functional.log_softmax(logits, -1) * onehot).sum(-1).mean()


def _loss(model: QuickstartMLP, x, y, ref: List[torch.Tensor],
          mu: torch.Tensor) -> torch.Tensor:
    ce = _cross_entropy(model(x), y)
    prox = sum(torch.sum(torch.square(p - r))
               for p, r in zip(model.parameters(), ref))
    return ce + 0.5 * mu * prox      # mu == 0 => exact plain FedAvg grads


def _sgd_epoch(model: QuickstartMLP, x, y, lr: torch.Tensor,
               ref: List[torch.Tensor], mu: torch.Tensor) -> None:
    """One pass over ``n // 32`` minibatches of 32, in order, each doing
    ``p <- p - lr * g`` (two ops: the product, then the difference)."""
    params = list(model.parameters())
    for i in range(x.shape[0] // 32):
        sl = slice(32 * i, 32 * (i + 1))
        grads = torch.autograd.grad(_loss(model, x[sl], y[sl], ref, mu),
                                    params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.copy_(p - lr * g)


@torch.no_grad()
def _evaluate(model: QuickstartMLP, x, y):
    logits = model(x)
    loss = _cross_entropy(logits, y)
    acc = (logits.argmax(-1) == y).to(torch.float32).mean()
    return float(loss), float(acc)


# ---------------------------------------------------------------------------
# the Flower-style client (paper Listing 2 shape)
# ---------------------------------------------------------------------------
class QuickstartClient(NumPyClient):
    def __init__(self, site: str, *, dim: int = 32, classes: int = 10,
                 n_train: int = 512, n_test: int = 256, seed: int = 7,
                 lr: float = 0.05, epochs: int = 1, skew: float = 0.3,
                 writer: Optional[SummaryWriter] = None, device=None):
        import re
        import zlib

        self.device = resolve_device(device)
        m = re.search(r"(\d+)$", site)
        site_idx = int(m.group(1)) if m else zlib.crc32(site.encode()) % 1000
        x_train, y_train = make_classification(
            n_train, dim, classes, seed=seed, site=site_idx, skew=skew,
            split=0)
        x_test, y_test = make_classification(
            n_test, dim, classes, seed=seed, site=site_idx, skew=skew,
            split=1)
        self.x_train = torch.from_numpy(x_train).to(self.device)
        self.y_train = torch.from_numpy(y_train).to(self.device)
        self.x_test = torch.from_numpy(x_test).to(self.device)
        self.y_test = torch.from_numpy(y_test).to(self.device)
        self.classes = int(y_train.max()) + 1
        self.model = QuickstartMLP(dim, 64, self.classes, self.device)
        self.lr = torch.tensor(lr, dtype=torch.float32, device=self.device)
        self.epochs = epochs
        self.writer = writer
        self._step = 0

    def get_parameters(self, config) -> NDArrays:
        return init_mlp(0, self.x_train.shape[1], 64, self.classes)

    def fit(self, parameters, config):
        self.model.load_arrays(parameters)
        ref = [p.detach().clone() for p in self.model.parameters()]
        mu = torch.tensor(float(config.get("proximal_mu", 0.0)),
                          dtype=torch.float32, device=self.device)
        for _ in range(self.epochs):
            _sgd_epoch(self.model, self.x_train, self.y_train, self.lr, ref,
                       mu)
        loss, acc = _evaluate(self.model, self.x_train, self.y_train)
        if self.writer is not None:    # §5.2 hybrid integration
            self.writer.add_scalar("train_loss", loss, self._step)
            self.writer.add_scalar("train_accuracy", acc, self._step)
            self._step += 1
        return (self.model.to_arrays(), int(self.x_train.shape[0]),
                {"train_loss": loss})

    def evaluate(self, parameters, config):
        self.model.load_arrays(parameters)
        loss, acc = _evaluate(self.model, self.x_test, self.y_test)
        if self.writer is not None:
            self.writer.add_scalar("test_accuracy", acc, self._step)
        return loss, int(self.x_test.shape[0]), {"accuracy": acc}


def make_client_app(site: str, mods=None, writer_fn=None,
                    **client_kw) -> ClientApp:
    """``client_kw`` reaches :class:`QuickstartClient` (``device=`` among
    them: None is the CUDA card)."""
    def client_fn(cid: str):
        writer = writer_fn(site) if writer_fn else None
        return QuickstartClient(site, writer=writer, **client_kw).to_client()

    return ClientApp(client_fn=client_fn, mods=mods)
