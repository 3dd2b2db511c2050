"""The port's launch tools against the reference's (``repro/launch/``).

- ``analytic.estimate``, ``model_flops``, ``Model.active_param_count`` and
  ``Model.input_struct`` (keys, shapes, dtypes) equal the reference's
  exactly, for every arch x shape x (devices, model axis) in (1, 1),
  (256, 16) and (512, 16); every pair is supported or skipped alike, and
  the skip records are the reference's.
- ``roofline``: ``load``, ``fmt_s``, ``summarize`` and ``make_table`` give
  the reference's output on the same records, the two HBM columns aside
  (the reference's v5e ``peak(TPU)GB`` / ``fits16GB``, the port's
  ``peakGB`` / ``fits80GB``).
- ``dryrun``: in processes of their own, the smoke configs of
  H2O-Danube-1.8B and Granite-MoE-1B-A400M trace their train step on a
  fake 4-rank ``(2, 2)`` CPU group; the fake trace's FLOPs and collective
  bytes equal those of the same step on real tensors on the same group,
  its peak lies within 2% of ``MemTracker``'s on real tensors, a one-rank
  ``(1, 1)`` group moves no collective bytes, and the dry-run refuses to
  start in a process that has a process group.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` (512 host
devices) when imported; the test puts the variable back at once, before
JAX's backend starts.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import dataclasses
import json
import subprocess
from pathlib import Path

import pytest

from repro.config import INPUT_SHAPES as REF_SHAPES
from repro.config import get_model_config as ref_config
from repro.config import list_archs as ref_archs
from repro.config import shape_supported as ref_supported
from repro.launch import analytic as ref_analytic
from repro.launch import roofline as ref_roofline
from repro.models.api import build_model as ref_build

from repro_torch.config import INPUT_SHAPES, get_model_config, list_archs
from repro_torch.config import shape_supported
from repro_torch.launch import analytic, dryrun, roofline
from repro_torch.models.api import build_model

SRC_TORCH = Path(__file__).resolve().parent.parent / "src_torch"
ARCHS = list_archs()
SHAPES = list(INPUT_SHAPES)
MESHES = ((1, 1), (256, 16), (512, 16))


@pytest.fixture(scope="module")
def ref_dryrun():
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


def test_the_registries_and_shapes_are_the_references():
    assert ARCHS == ref_archs()
    assert {k: dataclasses.astuple(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in REF_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_estimate_equals_the_references(arch):
    cfg, rcfg = get_model_config(arch), ref_config(arch)
    for s in SHAPES:
        for n, m in MESHES:
            got = analytic.estimate(cfg, INPUT_SHAPES[s], n, model_axis=m)
            want = ref_analytic.estimate(rcfg, REF_SHAPES[s], n,
                                         model_axis=m)
            assert dataclasses.astuple(got) == dataclasses.astuple(want), \
                (arch, s, n, m)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_active_params_equal_the_references(arch,
                                                            ref_dryrun):
    cfg, rcfg = get_model_config(arch), ref_config(arch)
    assert build_model(cfg).active_param_count() == \
        ref_build(rcfg).active_param_count()
    assert build_model(cfg).param_count() == ref_build(rcfg).param_count()
    for s in SHAPES:
        assert dryrun.model_flops(cfg, INPUT_SHAPES[s]) == \
            ref_dryrun.model_flops(rcfg, REF_SHAPES[s]), (arch, s)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_struct_equals_the_references(arch):
    model, ref = build_model(get_model_config(arch)), ref_build(
        ref_config(arch))
    for s in SHAPES:
        got = model.input_struct(INPUT_SHAPES[s])
        want = ref.input_struct(REF_SHAPES[s])
        assert list(got) == list(want), (arch, s)
        for k in want:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(want[k].shape), (arch, s, k)
            assert str(got[k].dtype).removeprefix("torch.") == \
                str(want[k].dtype), (arch, s, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_supported_pairs_and_skip_records_equal_the_references(arch,
                                                               ref_dryrun):
    cfg, rcfg = get_model_config(arch), ref_config(arch)
    for s in SHAPES:
        ok, why = shape_supported(cfg, INPUT_SHAPES[s])
        assert (ok, why) == ref_supported(rcfg, REF_SHAPES[s]), (arch, s)
        if ok:
            continue
        for mp in (False, True):
            got = dryrun.run_one(arch, s, multi_pod=mp, device="cpu")
            assert got == ref_dryrun.run_one(arch, s, multi_pod=mp), \
                (arch, s, mp)


# ---------------------------------------------------------------- roofline
def _records():
    """Records of every status and dominant term, with the reference's HBM
    fields and the port's side by side."""
    recs = [{"arch": "a-skip", "shape": "long_500k", "mesh": "16x16",
             "fl_round": False, "status": "skipped",
             "skip_reason": "full attention is quadratic at 500k context"},
            {"arch": "b-failed", "shape": "train_4k", "mesh": "2x16x16",
             "fl_round": False, "status": "FAILED", "error": "boom"}]
    terms = [(3e-1, 2e-4, 5e-2), (2e-7, 4e-3, 1e-5), (5e-10, 0.0, 7.0),
             (1.5, 2.5, 0.9), (1e-3, 1e-3, 2e-3)]
    for i, (c, m, k) in enumerate(terms):
        dom = max(("compute", c), ("memory", m), ("collective", k),
                  key=lambda kv: kv[1])[0]
        peak = (i + 1) * 13.7e9
        recs.append({
            "arch": f"arch-{i}", "shape": SHAPES[i % len(SHAPES)],
            "mesh": ("16x16", "2x16x16")[i % 2], "fl_round": i == 3,
            "status": "ok",
            "roofline": {"t_compute_s": c, "t_memory_s": m,
                         "t_collective_s": k, "dominant": dom},
            "useful_flops_frac": (None, 0.0, 0.37, 1.25, 0.991)[i],
            "per_device": {"peak_bytes_est": peak,
                           "peak_bytes_tpu_est": peak,
                           "fits_16GB": peak <= 16e9,
                           "fits_80GB": peak <= 80e9}})
    # a later record of the same key replaces the earlier one
    recs.append(dict(recs[-1], useful_flops_frac=0.5))
    return recs


def test_roofline_report_equals_the_references(tmp_path):
    path = tmp_path / "dryrun_results.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in _records()))
    recs = roofline.load(str(path))
    assert recs == ref_roofline.load(str(path))
    assert len(recs) == len(_records()) - 1
    assert roofline.summarize(recs) == ref_roofline.summarize(recs)
    for md in (True, False):
        got = roofline.make_table(recs, md=md).splitlines()
        want = ref_roofline.make_table(recs, md=md).splitlines()
        assert len(got) == len(want)
        if md:
            assert got[0].split(" | ")[-2:] == ["peakGB", "fits80GB |"]
            rows = [(g.split(" | "), w.split(" | "))
                    for g, w in zip(got, want)]
            assert all(g[:-2] == w[:-2] for g, w in rows[2:])
            assert got[0].split(" | ")[:-2] == want[0].split(" | ")[:-2]
        else:
            assert [g.split()[:7] for g in got] == \
                [w.split()[:7] for w in want]
    for x in (0, 3e-10, 4.2e-7, 5e-4, 0.25, 7.5, 1234.0):
        assert roofline.fmt_s(x) == ref_roofline.fmt_s(x)


def test_roofline_main_prints_the_table_and_summary(tmp_path, capsys):
    path = tmp_path / "r.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in _records()))
    roofline.main(["--in", str(path), "--md", "--mesh", "16x16"])
    out = capsys.readouterr().out
    assert "| arch | shape | mesh |" in out and "2x16x16" not in out
    assert "collective-bound:" in out


# ------------------------------------------------------------------ dry-run
_PROBE = """
import dataclasses, json, sys
import torch, torch.distributed as dist
import repro_torch.launch.dryrun as D
from repro_torch import sharding as shlib
from repro_torch.config import INPUT_SHAPES, TrainConfig, get_model_config
D.get_model_config = lambda a: get_model_config(a, smoke=True)
arch = sys.argv[1]
tc = TrainConfig(global_batch=8, seq_len=32, optimizer="adamw")
cpu = torch.device("cpu")
out = {m: D.run_one(arch, "train_4k", verbose=False, device="cpu",
                    train_cfg=tc, mesh_shape=shape)
       for m, shape in (("fake", (2, 2)), ("one_rank", (1, 1)))}
shape = dataclasses.replace(INPUT_SHAPES["train_4k"], global_batch=8,
                            seq_len=32)
D._start_group(4)
try:
    mesh = D._make_mesh(False, (2, 2), cpu)
    shlib.set_activation_mesh(mesh, batch_axes=("data",))
    fn, args, sh = D.build_step(arch, shape, mesh, train_cfg=tc)
    out["real"] = D.trace_step(fn, args, sh, cpu, fake=False)
finally:
    shlib.set_activation_mesh(None)
    dist.destroy_process_group()
print(json.dumps(out))
"""

_REFUSE = """
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh
make_local_mesh(device="cpu")
for call in (lambda: dryrun.run_one("h2o-danube-1.8b", "train_4k",
                                    device="cpu"),
             lambda: dryrun.main(["--arch", "h2o-danube-1.8b", "--shape",
                                  "train_4k"], device="cpu")):
    try:
        call()
        print("ran")
    except RuntimeError as e:
        print("refused:", e)
"""

DRYRUN_ARCHS = ("h2o-danube-1.8b", "granite-moe-1b-a400m")


@pytest.fixture(scope="module")
def probes():
    """Each probe in a process of its own, all at once."""
    env = dict(os.environ, PYTHONPATH=str(SRC_TORCH), OMP_NUM_THREADS="2")
    cmds = {a: [sys.executable, "-c", _PROBE, a] for a in DRYRUN_ARCHS}
    cmds["refuse"] = [sys.executable, "-c", _REFUSE]
    procs = {k: subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, c in cmds.items()}
    out = {}
    try:
        for k, p in procs.items():
            stdout, stderr = p.communicate(timeout=600)
            assert p.returncode == 0, stderr[-3000:]
            out[k] = stdout
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.mark.parametrize("arch", DRYRUN_ARCHS)
def test_fake_trace_counts_what_real_tensors_count(arch, probes):
    got = json.loads(probes[arch].strip().splitlines()[-1])
    fake, real = got["fake"], got["real"]
    assert fake["status"] == "ok", fake
    assert fake["devices"] == 4 and fake["mesh"] == "2x2"
    pd = fake["per_device"]
    assert pd["counted_flops_raw"] == real["counted_flops_raw"] > 0
    assert pd["collective_bytes"] == real["collective_bytes"]
    assert set(pd["collective_bytes"]) >= {"all-gather", "reduce-scatter"}
    assert abs(pd["peak_bytes_est"] / real["peak_bytes_est"] - 1) <= 0.02
    assert pd["peak_bytes_est"] > pd["argument_bytes"] > 0
    assert pd["fits_80GB"] is True
    assert set(fake["roofline"]) == {"t_compute_s", "t_memory_s",
                                     "t_collective_s", "dominant"}


@pytest.mark.parametrize("arch", DRYRUN_ARCHS)
def test_one_rank_moves_no_collective_bytes(arch, probes):
    one = json.loads(probes[arch].strip().splitlines()[-1])["one_rank"]
    assert one["status"] == "ok", one
    assert one["devices"] == 1 and one["mesh"] == "1x1"
    assert one["per_device"]["collective_bytes"] == {}
    assert one["roofline"]["t_collective_s"] == 0.0


def test_dryrun_refuses_to_start_beside_a_process_group(probes):
    lines = probes["refuse"].strip().splitlines()
    assert len(lines) == 2
    assert all(line.startswith("refused:") and "process group" in line
               for line in lines)


def test_roofline_terms_use_the_h100_constants():
    terms = dryrun.roofline_terms(989e12, 3.35e12,
                                  {"all-gather": 30e9, "all-reduce": 20e9})
    assert terms == {"t_compute_s": 1.0, "t_memory_s": 1.0,
                     "t_collective_s": 1.0, "dominant": "compute"}
    assert dryrun.roofline_terms(1.0, 1.0, {})["t_collective_s"] == 0.0
