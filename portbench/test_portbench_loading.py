"""Every file the benchmark names loads by its name, ``BENCHMARK.json``
keeps to the benchmark's contract, and a cell added as files alone runs."""
import json
import re

import pytest

from portbench import harness
from portbench.harness import HERE, ROOT, load_cell, load_module

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_loads_by_name(cell):
    c = load_cell(cell)
    assert c.entry["traffic"] == c.workload["traffic"]
    assert (HERE / "traffic" / f"{c.entry['traffic']}.py").is_file()
    driver = load_module(HERE / "traffic" / f"{c.entry['traffic']}.py",
                         "t_" + c.entry["traffic"])
    assert callable(driver.run)
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    e2e = {m["name"] for m in c.metrics("end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.metrics("per_layer")


@pytest.mark.parametrize("metric", METRICS)
def test_each_metric_has_a_reader(metric):
    reader = load_module(HERE / "metrics" / f"{metric}.py",
                         "m_" + metric.replace(".", "_"))
    assert reader.read({}) is None


def test_the_contracts_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert 1 <= BENCH["run_seconds"] <= 51
    n = len(BENCH["workloads"])
    # the full check of 24 cells fits 43200 s at this length
    per_run = BENCH["run_seconds"] + 60
    assert (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= n <= 24 and sum(w["chips"] == 4 for w in
                                BENCH["workloads"]) <= max(1, n // 4)
    names = [x["name"] for s in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[s]]
    assert all(NAME.match(x) for x in names)
    for s in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[s]}) == len(BENCH[s])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_configs_are_files_under_the_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
        assert c["source"] == conf["source"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        # no width is ever cut
        assert not any(k.endswith(("_dim", "_rank", "_size")) or
                       k in ("num_experts_per_tok", "num_attention_heads",
                             "num_key_value_heads")
                       for k in c["reduced"])
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        # what the program fixes is told apart from the cuts of scale:
        # each departure is a key of ``reduced``, the rest cut depth
        assert set(conf.get("departures", {})) <= set(c["reduced"])
        assert set(c["reduced"]) - set(conf.get("departures", {})) <= \
            {"num_hidden_layers"}


def test_metrics_keep_to_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        # the metric's cells each report the end-to-end metric it moves
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", CELLS)
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert "kernels" in layers


def test_a_cell_added_as_files_alone_runs(smoke_root):
    # the smoke cells are new workload and configuration files and new
    # entries in BENCHMARK.json, written by the test; no file changed
    out = harness.run_cell("smoke.fold", 17, 0.0, True, "cpu",
                           root=smoke_root)
    assert out["correct"]
    assert set(out["metrics"]) == {"decode_ms.fold", "fold_add_ms",
                                   "fold_finalize_ms"}
    for name in ("portbench/traffic", "portbench/metrics",
                 "portbench/reference"):
        for f in (ROOT / name).glob("*.py"):
            assert (smoke_root / name / f.name).read_bytes() == \
                f.read_bytes()


def test_a_workload_that_disagrees_with_the_index_is_refused(tmp_path):
    from portbench import smoke

    root = smoke.make_root(tmp_path, which={"smoke.fold"})
    path = root / "portbench" / "workloads" / "smoke.fold.json"
    wl = json.loads(path.read_text())
    path.write_text(json.dumps(dict(wl, traffic="train_steps")))
    with pytest.raises(harness.Refused):
        load_cell("smoke.fold", root)
    with pytest.raises(harness.Refused):
        load_cell("no.such.cell", root)
