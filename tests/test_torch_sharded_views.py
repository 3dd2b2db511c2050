"""The five ``--all`` pairs whose sharded steps resharded views, on the CPU.

A view DTensor's strict rule refuses (torch 2.11's, on any torch through
``sharded_ranks.strict_flatten``) raises on real ranks; the dry-run
reshards it so the trace goes on, and counts it in the record's
``relaxed_views`` (``launch/dryrun.py``).  Before this change, on the
production 16x16 fake group at full width (the card's ``--all``, torch
2.11; the CPU's counts at the depths below in brackets):

- H2O-Danube-1.8B ``long_500k``: 24 (1 layer: 2), the decode scores'
  regrouping of a head dim split over "model" into 8 KV heads of 4
  (``models/attention_impl.py:204``) and ``wo``'s flatten;
- InternVL2-1B ``train_4k``: 30 (1 layer: 7) and ``prefill_32k``: 3 (1
  layer: 3), the residual after the prefix embeddings' ``torch.cat``
  left whole over the sequence, so every block took its plain path
  (``models/attention.py:98`` forward and backward, ``models/mlp.py:51``
  in the backward), and ``wo``'s flatten;
- RecurrentGemma-2B ``train_4k``: 80 (12 layers: 72), ``wo``'s
  flatten (2 an attention layer on the CPU) and, from 4 periods on, the
  block-diagonal gates' reshape into heads (``models/recurrent.py:79``,
  ``:80`` in the backward: 64 on the card at 26 layers), whose stacked
  weight, 8 MB or more from 4 periods, comes split inside the heads by
  ``params_shardings``' salvage pass;
- Yi-34B ``train_4k``: 60 (1 layer: 1), ``wo``'s flatten of the
  key-split attention's ctx (heads that do not divide 16), whose
  gradient came back split over "model" on the flattened heads.

Now the key-split attention reduce-scatters its ctx over the sequence and
``wo`` multiplies each rank's own rows (``attention._unproject``); the
residual takes its layout after the prefix; a decode against a cache
whose slots lie on "data" writes and attends on the rank's own slots with
the query heads split over "model" (``attention._decode_seq_split``); the
block-diagonal gates take their weight whole where the heads do not
divide "model".

- Each pair at full width and cut depth (danube ``long_500k``, InternVL2
  and Yi at 1 layer, RecurrentGemma at 12: 4 periods, its first depth
  whose gate weights the salvage pass splits) traces ``ok`` with no
  relaxed view, each dry-run in a process of its own, all at once
  (~50 s).
- The repaired paths on real gloo ranks (``tools/sharded_ranks.py``'s
  ``LAYOUTS``, one interpreter a rank, a FileStore a mesh) against the
  plain ones: the key-split ``wo`` in Yi's prefill and step and
  RecurrentGemma's step, InternVL2's prefix residual in a prefill and a
  step (3 heads of 1 KV on ``(1, 2)``), and 10 greedy decode steps at
  batch 1 under the ``long_500k`` rules (4 heads of 1 KV on ``(2, 2)``):
  the tool's tolerances, the same ids; the block-diagonal gates on 3
  heads over 2 ranks with the weight split inside the heads (raised on
  the parent under torch 2.11's rule): output and gradients within 1e-6.
- The dry-run names a backward view by the forward site that made its
  node where anomaly mode kept the stack.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch",
                                "tools"))
import inspect
import json
import subprocess

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import sharded_ranks as SR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_TORCH = os.path.join(ROOT, "src_torch")
RANK_TIMEOUT = 240

_DRYRUN = """
import json, sys
import sharded_ranks as SR
import repro_torch.launch.dryrun as D
from repro_torch.config import get_model_config

SR.strict_flatten()
arch, shape, layers = sys.argv[1], sys.argv[2], int(sys.argv[3])
D.get_model_config = lambda a: get_model_config(a).replace(num_layers=layers)
print(json.dumps(D.run_one(arch, shape, verbose=False, device="cpu")))
"""

#: pair -> (arch, shape, layers): full width on the 16x16 fake group
PAIRS = {
    "danube_long_500k": ("h2o-danube-1.8b", "long_500k", 1),
    "internvl2_prefill_32k": ("internvl2-1b", "prefill_32k", 1),
    "internvl2_train_4k": ("internvl2-1b", "train_4k", 1),
    "yi_train_4k": ("yi-34b", "train_4k", 1),
    "recurrentgemma_train_4k": ("recurrentgemma-2b", "train_4k", 12),
}


@pytest.fixture(scope="module")
def dryruns():
    """The dry-runs, each in a process of its own (a dry-run plays rank 0
    of a fake group), at once."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC_TORCH, os.path.join(SRC_TORCH, "tools")]), OMP_NUM_THREADS="1")
    procs = {k: subprocess.Popen([sys.executable, "-c", _DRYRUN, a, s,
                                  str(n)], env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, (a, s, n) in PAIRS.items()}
    out = {}
    try:
        for k, p in procs.items():
            stdout, stderr = p.communicate(timeout=600)
            assert p.returncode == 0, stderr[-3000:]
            out[k] = json.loads(stdout.strip().splitlines()[-1])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.mark.parametrize("pair", list(PAIRS))
def test_pair_traces_with_no_relaxed_view(pair, dryruns):
    rec = dryruns[pair]
    arch, shape, _ = PAIRS[pair]
    assert rec["status"] == "ok", rec
    assert (rec["arch"], rec["shape"], rec["mesh"]) == (arch, shape, "16x16")
    assert rec["relaxed_views"] == {}, rec["relaxed_views"]


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """``LAYOUTS``' checks on gloo ranks: a job a mesh, the meshes at once,
    each on a FileStore of its own."""
    return SR.run_all((), (), layouts=SR.LAYOUTS, timeout=RANK_TIMEOUT,
                      workdir=tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("arch,path,mesh,over", SR.LAYOUTS,
                         ids=[f"{a}-{p}" for a, p, _, _ in SR.LAYOUTS])
def test_layout_equals_the_plain_one_on_gloo_ranks(arch, path, mesh, over,
                                                   layouts):
    got = [r for r in layouts if (r["arch"], r["path"]) == (arch, path)
           and r["mesh"] == "x".join(map(str, mesh))]
    assert len(got) == 1 and got[0]["ok"], got
    r = got[0]
    assert r["over"] == over and r["max_err"] <= r["tol"], r
    if path == "long_decode":
        assert r["steps"] == SR.LONG_DECODE_STEPS == 10


class _BackwardViewSites(TorchDispatchMode):
    """The dry-run's site of each view a backward node runs."""

    def __init__(self):
        super().__init__()
        self.sites = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from repro_torch.launch import dryrun

        if (func in dryrun._VIEW_OPS
                and torch._C._current_autograd_node() is not None):
            self.sites.append(dryrun._port_site())
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("anomaly", [False, True])
def test_port_site_names_a_backward_view_by_its_forward_site(anomaly):
    from repro_torch.models import attention

    lines, first = inspect.getsourcelines(attention._unproject)
    at = first + max(i for i, line in enumerate(lines)
                     if ".view(B, S, d)" in line)
    ctx = torch.randn(2, 3, 4, 5, requires_grad=True)
    w = torch.randn(4, 5, 6, requires_grad=True)
    with torch.autograd.set_detect_anomaly(anomaly, check_nan=False):
        y = attention._unproject(ctx, w)
    seen = _BackwardViewSites()
    with seen:
        y.sum().backward()
    want = (f"models/attention.py:{at} (backward: ViewBackward0)" if anomaly
            else "unknown (backward: ViewBackward0)")
    assert want in seen.sites, seen.sites
