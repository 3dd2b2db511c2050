"""The run's last line, its refusals, and the import guard."""
import json
import os
import subprocess
import sys

import pytest

from portbench import harness
from portbench.harness import ROOT


def _result_keys(out):
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    json.dumps(out)                          # a JSON line
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("trace", [0, 1])
def test_the_result_line(smoke_root, trace):
    out = harness.run_cell("smoke.train-dense", 99, 0.0, trace, "cpu",
                           root=smoke_root)
    _result_keys(out)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    dev = out["device"]
    assert dev["count"] == 1 and "memory_peak_bytes" in dev
    if trace:
        # a CPU run reads no device: every per-layer metric stays silent
        assert out["metrics"] == {}
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == {"train_tokens_per_s", "setup_s"}
        for m in out["metrics"].values():
            assert m["value"] > 0 and set(m) == {"value", "unit"}


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, "portbench/run.py"] + args,
                          cwd=cwd, capture_output=True, text=True,
                          timeout=120, env=env)


def test_without_a_card_the_run_prints_nothing_and_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run(["--workload", "train.danube-1.8b", "--seed", "5",
              "--seconds", "1", "--trace", "0"], ROOT, env)
    assert p.returncode != 0 and p.stdout == ""
    assert "needs 1 CUDA card" in p.stderr


def test_with_the_benchmarks_files_alone_the_run_fails(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(["--workload", "fold.danube-1.8b-4l.topk5x8", "--seed", "5",
              "--seconds", "1", "--trace", "0"], tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_names_are_compared_whole(monkeypatch):
    # the program's own name begins with the JAX package's
    for name in list(sys.modules):
        if name.split(".")[0] == "repro":
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert harness.loaded(("repro",)) == []
    monkeypatch.setitem(sys.modules, "repro.fl", sys)
    assert harness.loaded(("repro",)) == ["repro"]


_GUARD = r"""
import sys, json
sys.path[0] = {root!r}
sys.path.insert(1, {src!r})
from portbench import harness
harness.guard_start()
print(json.dumps(harness.loaded(harness.FORBIDDEN + (harness.PROGRAM,))))
from portbench import smoke
import tempfile
cells = ("smoke.fold", "smoke.train-moe")
root = smoke.make_root(tempfile.mkdtemp(dir={tmp!r}), which=set(cells))
for cell in cells:
    out = harness.run_cell(cell, 3, 0.0, 1, "cpu", root=root)
    assert out["correct"], out
print(json.dumps(harness.loaded(harness.FORBIDDEN)))
"""


def test_the_import_guard_in_a_fresh_interpreter(tmp_path):
    # the references load nothing of the program; a whole run loads
    # neither JAX nor the JAX package
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "-c", _GUARD.format(
            root=str(ROOT), src=str(ROOT / "src_torch"), tmp=str(tmp_path))],
        capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    before, after = [json.loads(x) for x in p.stdout.strip().splitlines()[-2:]]
    assert before == [] and after == []


def test_guard_start_refuses_a_forbidden_module(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    with pytest.raises(harness.Refused):
        harness.guard_start()
