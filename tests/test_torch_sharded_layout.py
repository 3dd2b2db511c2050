"""The sharded step's layout under a ``"model"`` axis, on the CPU.

The reference pins the eager attention's scores to ``"model"``
(``src/repro/sharding.py`` ``constrain_scores``): each rank attends with
its own heads where they split over the axis (route 1), else with its own
keys, the softmax's row statistics and the value products reduced over
the axis (route 2).  The port places the operands itself and runs the
chunk loop on the rank's shards; the cross-entropy keeps a vocab split
over ``"model"``; RecurrentGemma's block-diagonal gates leave no pending
partial sum; the sLSTM's loop runs on local tensors.

- Fake process groups (``repro_torch.launch.dryrun``, smoke configs, each
  collective charged to its call site as ``src_torch/tools/dryrun_sites.py
  --forward-sites`` charges it, a backward's to the forward site that made
  it): H2O-Danube's train step on ``(2, 2)`` and ``(1, 4)`` (route 1: 2 of
  4 kv heads a rank; 1 q head a rank after the GQA -> MHA expansion) is
  charged no all-gather at the attention's sites or the cross-entropy's;
  on ``(1, 3)`` at 48 tokens (route 2: 3 divides neither 4 heads nor 2
  kv heads) the attention's only all-gather is each query tensor once
  (every rank scores its keys against every query, as the reference's
  key split does) and no score-shaped tensor is gathered.
  RecurrentGemma's and xLSTM's smoke train steps trace on ``(1, 3)`` and
  ``(2, 2)``; xLSTM's trace seconds are printed.
- The dry-run's sLSTM extrapolation (``launch/dryrun.py``): xLSTM's step
  at 80 tokens, traced with its loop cut to 16 and 32 steps, counts the
  FLOPs, collective bytes and peak of the whole loop.

The values on real ranks are ``tests/test_torch_sharded_ranks.py``'s.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import json
import subprocess

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_TORCH = os.path.join(ROOT, "src_torch")

_PROBE = """
import inspect, json, sys
sys.path.insert(0, {tools!r})
import torch
import repro_torch.launch.dryrun as D
from repro_torch.config import TrainConfig, get_model_config
from repro_torch.train import steps
import dryrun_sites

D.get_model_config = lambda a: get_model_config(a, smoke=True)
arch, mesh, seq = sys.argv[1], tuple(json.loads(sys.argv[2])), int(sys.argv[3])
tc = TrainConfig(global_batch=8, seq_len=seq, optimizer="adamw")
rec, calls = dryrun_sites.trace_sites(arch, "train_4k", mesh_shape=mesh,
                                      device="cpu", forward_sites=True,
                                      train_cfg=tc)
ce = []
for fn in (steps.cross_entropy_loss, steps._vocab_split_cross_entropy):
    lines, first = inspect.getsourcelines(fn)
    ce += [f"train/steps.py:{{n}}" for n in range(first, first + len(lines))]
print(json.dumps({{"rec": rec, "calls": calls, "ce_sites": ce}}))
"""

# xLSTM's train step at 80 tokens traced whole and from its loop cut to
# 16 and 32 sLSTM steps (``dryrun.SLSTM_TRACE_STEPS``)
_SCALED = """
import json
import repro_torch.launch.dryrun as D
from repro_torch.config import TrainConfig, get_model_config
D.get_model_config = lambda a: get_model_config(a, smoke=True)
tc = TrainConfig(global_batch=8, seq_len=80, optimizer="adamw")
out = {}
for name, steps in (("scaled", D.SLSTM_TRACE_STEPS), ("whole", (80, 160))):
    D.SLSTM_TRACE_STEPS = steps
    out[name] = D.run_one("xlstm-350m", "train_4k", verbose=False,
                          device="cpu", train_cfg=tc, mesh_shape=(2, 2))
print(json.dumps(out))
"""

PROBES = {
    "danube_2x2": ("h2o-danube-1.8b", (2, 2), 32),
    "danube_1x4": ("h2o-danube-1.8b", (1, 4), 32),
    "danube_1x3": ("h2o-danube-1.8b", (1, 3), 48),
    "rg_1x3": ("recurrentgemma-2b", (1, 3), 48),
    "xlstm_2x2": ("xlstm-350m", (2, 2), 32),
}


@pytest.fixture(scope="module")
def traces():
    """Each probe in a process of its own (a dry-run plays rank 0 of a
    fake group), all at once."""
    env = dict(os.environ, PYTHONPATH=SRC_TORCH, OMP_NUM_THREADS="1")
    code = _PROBE.format(tools=os.path.join(SRC_TORCH, "tools"))
    cmds = {k: [sys.executable, "-c", code, arch, json.dumps(mesh), str(seq)]
            for k, (arch, mesh, seq) in PROBES.items()}
    cmds["xlstm_scaled"] = [sys.executable, "-c", _SCALED]
    procs = {k: subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, c in cmds.items()}
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


def _gathers_at(got, pred):
    return [(where, nbytes) for name, where, nbytes in got["calls"]
            if name == "all-gather" and pred(where)]


def _attention_site(where):
    return "models/attention_impl.py" in where


def _ce_site(got):
    return lambda where: any(s in where.split(" < ") or
                             f"bwd {s}" in where.split(" < ")
                             for s in got["ce_sites"])


@pytest.mark.parametrize("probe", ["danube_2x2", "danube_1x4"])
def test_head_local_attention_gathers_nothing(traces, probe):
    got = traces[probe]
    assert got["rec"]["status"] == "ok", got["rec"]
    assert _gathers_at(got, _attention_site) == []
    assert _gathers_at(got, _ce_site(got)) == []


def test_key_split_attention_gathers_only_the_queries(traces):
    got = traces["danube_1x3"]
    assert got["rec"]["status"] == "ok", got["rec"]
    # smoke danube: 4 heads of 32, batch 8 over one data rank, 48 tokens
    q_bytes = 8 * 48 * 4 * 32 * 2
    gathers = _gathers_at(got, _attention_site)
    assert gathers and all(n == q_bytes for _, n in gathers), gathers
    # the softmax's row statistics and the value products are reduced
    assert any(name == "all-reduce" and _attention_site(where)
               for name, where, _ in got["calls"])
    assert _gathers_at(got, _ce_site(got)) == []


@pytest.mark.parametrize("probe", ["rg_1x3", "xlstm_2x2"])
def test_recurrent_families_trace_on_a_model_axis(traces, probe):
    got = traces[probe]
    assert got["rec"]["status"] == "ok", got["rec"]
    assert got["rec"]["per_device"]["counted_flops_raw"] > 0
    print(f"{probe}: trace {got['rec']['trace_s']} s")
    assert _gathers_at(got, _ce_site(got)) == []


def test_slstm_scaled_trace_counts_what_the_whole_loop_counts(traces):
    """The extrapolation from 16 and 32 traced steps to 80 gives the
    whole loop's FLOPs, collective bytes and peak: every step runs the
    same ops and keeps the same bytes for the backward."""
    scaled, whole = traces["xlstm_scaled"]["scaled"], \
        traces["xlstm_scaled"]["whole"]
    assert scaled["status"] == whole["status"] == "ok", (scaled, whole)
    assert scaled["scaled"] == {"slstm_steps": [32, 80]}
    assert "scaled" not in whole
    a, b = scaled["per_device"], whole["per_device"]
    assert a["counted_flops_raw"] == b["counted_flops_raw"] > 0
    assert a["collective_bytes"] == b["collective_bytes"]
    assert a["peak_bytes_est"] == b["peak_bytes_est"]
