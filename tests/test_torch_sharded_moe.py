"""The MoE families' sharded steps on real gloo ranks, experts on, on the
CPU.

Under an activation mesh the port's ``moe_apply`` runs on the rank's
shards (``models/mlp.py`` ``_moe_local``): expert parallelism over
``"model"`` (the banks' ``experts`` split, or a slice of them gathered
whole where the rank count does not divide the experts), every rank
routing the same tokens, one all-reduce of the outputs.  DTensor's
einsums over the dispatch-space tensors flattened a split dim and raised
on a ``(1, M)`` mesh (``aten.view`` at ``models/mlp.py``'s dispatch
einsum).

Through ``src_torch/tools/sharded_ranks.py`` (one interpreter a rank,
fp32 smoke configs, inputs from ``Model.make_batch``, torch 2.11's rule
for a flattening view on any torch), Granite-MoE (4
experts, top 2, no shared expert) and DeepSeek-V2 (MLA, a dense first
layer, a shared expert):

- 10 greedy decode steps under the ``decode_32k`` rules on ``(1, 2)``,
  ``(2, 2)`` and ``(1, 4)`` against the plain decode: logits within 2e-6
  of the largest (at least 1), the same ids;
- the prefill under the ``prefill_32k`` rules (last logits within 1e-5)
  and one train step (loss, grad norm and Adam moments at the sharded
  step's tolerances) on ``(1, 2)``;
- the dry-run (``launch/dryrun.py``, fake groups, torch 2.11's rule for
  a flattening view, ``sharded_ranks.strict_flatten``) of both MoE
  families' ``decode_32k`` at 8 rows on ``(1, 4)``, whose single routing
  group sits on a "data" axis of one rank, of Qwen3's and of danube's
  ``train_4k`` on ``(2, 2)``: ``ok`` with no view resharded by the
  relaxed rule (before this change DeepSeek-V2's trace took 7, Granite-
  MoE's 14: the dispatch, expert and combine einsums of each MoE layer;
  danube's 13: the MLP's products and the head, forward and backward);
- the dry-run counts each view the relaxed rule takes once, also where
  DTensor runs the rule for it again (a placement cache keyed finer
  than the count's);
- the dry-run's ``--mesh DxM`` traces a fake group of that shape, and its
  summary line names the pairs with relaxed views; the roofline report
  marks such a pair's row and lists its sites under the summary.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch",
                                "tools"))
import json
import subprocess

import pytest

import sharded_ranks as SR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_TORCH = os.path.join(ROOT, "src_torch")
RANK_TIMEOUT = 240
MOE = ("granite-moe-1b-a400m", "deepseek-v2-236b")


@pytest.mark.parametrize("data,model", [(1, 2), (2, 2), (1, 4)])
def test_moe_decode_equals_the_plain_one_on_gloo_ranks(data, model,
                                                       tmp_path):
    SR.run_ranks(f"""
for arch in {MOE!r}:
    res = SR.check_decode(mesh, arch, steps=10)
    assert res["steps"] == 10, res
""", data, model, tmp_path, RANK_TIMEOUT)


def test_moe_prefill_and_train_step_equal_the_plain_ones(tmp_path):
    SR.run_ranks(f"""
for arch in {MOE!r}:
    SR.check_prefill(mesh, arch)
    SR.check_step(mesh, arch, 32)
""", 1, 2, tmp_path, RANK_TIMEOUT)


_DRYRUN = """
import dataclasses, json, sys
import sharded_ranks as SR
import repro_torch.launch.dryrun as D
from repro_torch.config import TrainConfig, get_model_config

SR.strict_flatten()
D.get_model_config = lambda a: get_model_config(a, smoke=True)
# decode at 8 rows: one routing group (its capacity keeps >= 16 tokens a
# group)
D.INPUT_SHAPES = dict(D.INPUT_SHAPES, decode_32k=dataclasses.replace(
    D.INPUT_SHAPES["decode_32k"], global_batch=8))
arch, shape, mesh = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
tc = (TrainConfig(global_batch=8, seq_len=64, optimizer="adamw")
      if shape == "train_4k" else None)
rec = D.run_one(arch, shape, verbose=False, device="cpu",
                mesh_shape=tuple(mesh), train_cfg=tc)
print(json.dumps(rec))
"""

#: (arch, shape, mesh): both MoE families' decode on one node, a dense
#: decode, and a dense train step (its MLP, head and backward)
DRYRUNS = {
    "deepseek-v2-236b": ("deepseek-v2-236b", "decode_32k", (1, 4)),
    "granite-moe-1b-a400m": ("granite-moe-1b-a400m", "decode_32k", (1, 4)),
    "qwen3-32b": ("qwen3-32b", "decode_32k", (1, 4)),
    "h2o-danube-1.8b-train": ("h2o-danube-1.8b", "train_4k", (2, 2)),
}


@pytest.fixture(scope="module")
def dryruns():
    """The dry-runs, each in a process of its own (a dry-run plays rank 0
    of a fake group), at once."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC_TORCH, os.path.join(SRC_TORCH, "tools")]), OMP_NUM_THREADS="1")
    procs = {k: subprocess.Popen([sys.executable, "-c", _DRYRUN, a, s,
                                  json.dumps(m)], env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, (a, s, m) in DRYRUNS.items()}
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


@pytest.mark.parametrize("pair", list(DRYRUNS))
def test_dryrun_reshards_no_view(pair, dryruns):
    rec = dryruns[pair]
    arch, shape, mesh = DRYRUNS[pair]
    assert rec["status"] == "ok", rec
    assert rec["mesh"] == "x".join(map(str, mesh)) and rec["shape"] == shape
    assert rec["global_batch"] == 8
    assert rec["relaxed_views"] == {}, rec["relaxed_views"]


_COUNT_ONCE = """
import json
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
import sharded_ranks as SR
import repro_torch.launch.dryrun as D

SR.strict_flatten()
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
x, y = (distribute_tensor(torch.zeros(2, 8, dtype=dt), mesh,
                          [Replicate(), Shard(1)])
        for dt in (torch.float32, torch.float64))
seen = D.RelaxedViews()
with D._views_may_reshard(seen), seen:
    # the first view is refused; the second has the first's key in the
    # mode but not in DTensor's cache (another dtype), so the rule runs
    # again; the third hits DTensor's cache
    for t in (x, y, x):
        assert t.view(16).shape == (16,)
print(json.dumps({"sites": seen.sites, "none": None in D._REFUSED}))
dist.destroy_process_group()
"""


def test_relaxed_views_counts_each_view_once():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC_TORCH, os.path.join(SRC_TORCH, "tools")]), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _COUNT_ONCE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"sites": {"unknown": 3}, "none": False}, got


_MAIN = """
import repro_torch.launch.dryrun as D
from repro_torch.config import get_model_config

D.get_model_config = lambda a: get_model_config(a, smoke=True)
argv = ["--arch", "qwen3-32b", "--shape", "decode_32k", "--mesh", "1x2"]
runs = D.main(argv, device="cpu")
assert runs[0]["mesh"] == "1x2" and runs[0]["devices"] == 2, runs[0]
# a record with relaxed views, as a pair that reshards some would give
D.run_one = lambda *a, **k: dict(runs[0], relaxed_views={
    "models/mlp.py:42": 3})
D.main(argv, device="cpu")
"""


def test_dryrun_mesh_flag_and_summary_name_the_relaxed_pairs():
    env = dict(os.environ, PYTHONPATH=SRC_TORCH, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _MAIN], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [line for line in out.stdout.splitlines()
             if line.startswith("dry-run summary:")]
    assert lines == [
        "dry-run summary: 1 ok, 0 skipped, 0 FAILED, 0 with relaxed views",
        "dry-run summary: 1 ok, 0 skipped, 0 FAILED, 1 with relaxed views: "
        "qwen3-32bxdecode_32kx1x2 (3)"], lines


def test_roofline_marks_the_pairs_with_relaxed_views():
    from repro_torch.launch import roofline

    ok = {"arch": "a", "shape": "decode_32k", "mesh": "16x16",
          "fl_round": False, "status": "ok", "useful_flops_frac": 0.5,
          "roofline": {"t_compute_s": 1e-3, "t_memory_s": 2e-3,
                       "t_collective_s": 3e-3, "dominant": "collective"},
          "per_device": {"peak_bytes_est": 5e9, "fits_80GB": True},
          "relaxed_views": {}}
    bad = dict(ok, arch="b", relaxed_views={"models/mlp.py:42": 48,
                                            "models/mlp.py:44": 2})
    rows = roofline.make_table([ok, bad]).splitlines()[2:]
    assert rows[0].endswith("| Y |") and "relaxed" not in rows[0]
    assert rows[1].endswith("| Y (relaxed views: 50) |"), rows[1]
    summary = roofline.summarize([ok, bad]).splitlines()
    assert summary[-1] == (
        "relaxed views (resharded by the trace; each raises on real ranks): "
        "bxdecode_32kx16x16 models/mlp.py:42 x48, models/mlp.py:44 x2")
    assert not any("relaxed" in line
                   for line in roofline.summarize([ok]).splitlines())
