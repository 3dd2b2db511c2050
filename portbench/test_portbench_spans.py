"""The reduction of a trace to the program's spans (``portbench/spans.py``):
backward ops linked to the span of their forward op by sequence number,
the recompute's work outside the spans left out; host and idle time in a
span; the idle gaps charged to the innermost span; and the benchmark's own
busy readings unchanged by program spans and their device-side shadows."""
import time
import types

import pytest
import torch
from torch.autograd import DeviceType

from portbench import harness, spans, trace
from portbench.harness import load_module

MOE = ("moe.route", "moe.dispatch", "moe.experts")


@pytest.fixture(scope="module")
def moe_step_events(smoke_root):
    from repro_torch import obs

    cell = harness.load_cell("smoke.train-moe", smoke_root)
    driver = load_module(smoke_root / "portbench" / "traffic" /
                         "train_steps.py", "t_spans_train_steps")
    run = harness.Run(cell, 2**31 + 7, 0.0, True, torch.device("cpu"),
                      time.perf_counter())
    step_fn, state, batches, _, _ = driver.setup(run)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step_fn(state, batches[0])
    return prof.events(), obs.SPANS


def _node(e):
    return e.name[len(spans.BACKWARD):]


def test_backward_ops_go_to_the_span_of_their_forward_op(moe_step_events):
    events, names = moe_step_events
    got = spans.owners(events, names,
                       lambda e: e.name.startswith(spans.BACKWARD))
    by_span = {}
    for e, name in got:
        by_span.setdefault(name, set()).add(_node(e))
    # each MoE span and the attention core get the backward of their ops
    assert {"SoftmaxBackward0", "LogsumexpBackward0"} <= by_span["moe.route"]
    assert "BmmBackward0" in by_span["moe.dispatch"]
    assert {"BmmBackward0", "SiluBackward0"} <= by_span["moe.experts"]
    assert {"SoftmaxBackward0", "BmmBackward0"} <= by_span["attention.core"]
    # the norms, the rope and the head are no span's
    linked = {_node(e) for e, _ in got}
    free = {_node(e) for e in events
            if e.name.startswith(spans.BACKWARD)} - linked
    assert {"RsqrtBackward0", "EmbeddingBackward0"} <= free


def test_the_recompute_outside_the_spans_is_no_spans(moe_step_events):
    events, names = moe_step_events
    # the period's recompute runs inside the backward of the combine's
    # einsum (moe.dispatch) when it first unpacks a saved tensor: the
    # norms recomputed there stay outside every span, while the attention
    # recomputed there runs its own span
    rsqrt = [e for e in events if e.name == "aten::rsqrt"]
    inside = [e for e in rsqrt if any(
        a.name.startswith(spans.BACKWARD) for a in _chain(e))]
    assert inside, "no recompute in the traced step"
    got = dict((id(e), n) for e, n in spans.owners(
        events, names, lambda e: e.name == "aten::rsqrt"))
    assert not got
    cores = [e for e in events if e.name == "attention.core"]
    assert any(any(a.name.startswith(spans.BACKWARD) for a in _chain(e))
               for e in cores)


def _chain(e):
    e = e.cpu_parent
    while e is not None:
        yield e
        e = e.cpu_parent


def test_the_moe_spans_hold_their_forward_ops(moe_step_events):
    events, names = moe_step_events
    got = spans.owners(events, names, lambda e: e.name.startswith("aten::")
                       and not any(a.name.startswith(spans.BACKWARD)
                                   for a in _chain(e)))
    by_span = {}
    for e, name in got:
        by_span.setdefault(name, set()).add(e.name)
    assert "aten::sort" in by_span["moe.route"]
    assert "aten::cumsum" in by_span["moe.route"]
    assert "aten::einsum" in by_span["moe.dispatch"]
    assert "aten::silu" in by_span["moe.experts"]
    assert not set(by_span) - set(MOE) - {"attention.core",
                                          "train_step.update"}


def _cpu(name, a, b, parent=None, **kw):
    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CPU, cpu_parent=parent,
        time_range=types.SimpleNamespace(start=a, end=b),
        is_user_annotation=kw.get("note", False), kernels=kw.get("k", []),
        sequence_nr=kw.get("seq", -1), thread=1, fwd_thread=1)


def _dev(name, a, b, note=False):
    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CUDA, cpu_parent=None,
        time_range=types.SimpleNamespace(start=a, end=b),
        is_user_annotation=note)


def _fold_trace(shadows: bool, flagged: bool):
    """A round: decode on the host (0-400 us, the card idle), finalize
    (400-1000): an upload 450-550, host assembly 550-800, the download
    800-950; with the program's spans and, if asked, their device-side
    shadows (the first device op to the last inside each)."""
    win = _cpu("portbench.window", 0, 1000, note=True)
    dec = _cpu("portbench.decode", 0, 400, win, note=True)
    fin = _cpu("portbench.finalize", 400, 1000, win, note=True)
    events = [win, dec, fin,
              _cpu("fl.decode", 10, 390, dec, note=True),
              _cpu("fl.decode.check", 100, 300, dec, note=True),
              _cpu("fold.finalize", 410, 990, fin, note=True),
              _cpu("fold.finalize.close", 420, 560, fin, note=True),
              _cpu("fold.finalize.assemble", 560, 790, fin, note=True),
              _cpu("fold.finalize.download", 790, 980, fin, note=True),
              _dev("Memcpy HtoD (Pageable -> Device)", 450, 550),
              _dev("Memcpy DtoH (Device -> Pageable)", 800, 950)]
    if shadows:
        events += [_dev("fold.finalize", 450, 950, flagged),
                   _dev("fold.finalize.download", 800, 950, flagged)]
    return events


@pytest.mark.parametrize("flagged", [False, True])
def test_the_benchmark_busy_readings_ignore_program_spans(flagged):
    from repro_torch import obs

    plain = _fold_trace(False, False)
    shadowed = _fold_trace(True, flagged)
    # the breakdown: host spans are annotations, so their shadows are too
    assert trace.busy(shadowed) == trace.busy(plain)
    assert trace.busy(plain)["busy_s"] == pytest.approx(250e-6)
    # a trace of the device alone, as the traffic drivers' busy pass reads it,
    # with the program's spans skipped
    dev_plain = [e for e in plain if e.device_type != DeviceType.CPU]
    dev_shadowed = [e for e in shadowed if e.device_type != DeviceType.CPU]
    skip = (trace.SPAN,) + obs.SPANS
    assert trace.device_busy(dev_shadowed, skip) == pytest.approx(250e-6)
    assert trace.device_busy(dev_plain, (trace.SPAN,)) == pytest.approx(
        250e-6)


def test_gaps_go_to_the_innermost_program_span():
    from repro_torch import obs

    events = _fold_trace(True, True)
    b = spans.busy(events, obs.SPANS)
    assert b["busy_s"] == trace.busy(events)["busy_s"]
    gaps = {k: v * 1e6 for k, v in b["idle_gaps"].items()}
    assert gaps == pytest.approx({
        "fl.decode.check": 450.0,      # 0-450: the decode, then close
        "fold.finalize.assemble": 250.0,
        "fold.finalize.download": 50.0})
    assert {k: v * 1e6 for k, v in trace.busy(events)["idle_gaps"].items()
            } == pytest.approx({"decode": 450.0, "finalize": 300.0})


def test_host_and_idle_time_inside_spans():
    from repro_torch import obs

    events = _fold_trace(True, True)
    host = spans.host_seconds(events, obs.SPANS)
    idle = spans.idle_seconds(events, obs.SPANS)
    us = lambda d: {k: round(v * 1e6, 6) for k, v in d.items() if v}  # noqa
    assert us(host) == {"fl.decode": 380, "fl.decode.check": 200,
                        "fold.finalize": 580, "fold.finalize.close": 140,
                        "fold.finalize.assemble": 230,
                        "fold.finalize.download": 190}
    assert us(idle) == {"fl.decode": 380, "fl.decode.check": 200,
                        "fold.finalize": 330, "fold.finalize.close": 40,
                        "fold.finalize.assemble": 230,
                        "fold.finalize.download": 40}


def test_device_work_no_host_op_carries_is_named():
    copy = types.SimpleNamespace(name="Memcpy HtoD", duration=8.0)
    events = [_cpu("aten::copy_", 0, 10, k=[copy]),
              _dev("Memcpy HtoD", 1, 9), _dev("scatter_wsum_kernel", 20, 32),
              _dev("fold.finalize", 0, 40, note=True)]
    got = spans.unlinked_seconds(events)
    assert got == pytest.approx({"scatter_wsum_kernel": 12e-6})


def test_readings_of_a_fold_and_a_train_step():
    dev = {"copy.h2d": 0.5, "copy.d2h": 0.8, "attention.core": 0.0}
    counts = {"copy.h2d_bytes.pageable": 1.77e9,
              "copy.h2d_bytes.pinned": 1.6e9,
              "copy.d2h_bytes.pageable": 1.77e9}
    got = spans.readings(dev, {"fl.decode.check": 0.6},
                         {"fold.finalize": 0.9}, counts, 3, train=False)
    assert got == pytest.approx({
        "decode_check_ms.fold": 200.0, "finalize_idle_ms.fold": 300.0,
        "d2h_gbps.fold": 1.77 / 0.8, "h2d_gbps.fold": 3.37 / 0.5})
    dev = {"attention.core": 5.0, "moe.route": 0.5, "moe.dispatch": 0.7,
           "moe.experts": 0.9}
    assert spans.readings(dev, {}, {}, {}, 2, train=True) == pytest.approx({
        "attention_core_ms.train": 2500.0, "moe_dispatch_ms.train": 600.0,
        "moe_experts_ms.train": 450.0})
    # a dense model has no MoE: those readings are left out
    assert set(spans.readings({"attention.core": 1.0}, {}, {}, {}, 1,
                              train=True)) == {"attention_core_ms.train"}


def test_the_probe_reads_a_fold_on_the_cpu(smoke_root):
    out = spans.probe("smoke.fold", 2**31 + 99, 0.2, device="cpu",
                      root=smoke_root)
    assert out["correct"]
    prog = out["program"]
    per = prog["per_pass"]["host_s"]
    for name in ("fl.decode", "fl.decode.header", "fl.decode.check",
                 "fold.add", "fold.add.stage", "fold.add.scatter",
                 "fold.finalize", "fold.finalize.close",
                 "fold.finalize.download", "fold.finalize.assemble",
                 "copy.h2d", "copy.d2h"):
        assert per[name] > 0, name
    assert per["fl.decode.check"] < per["fl.decode"]
    assert set(prog["readings"]) == {"decode_check_ms.fold",
                                     "finalize_idle_ms.fold"}
    # nothing crosses a host link on the CPU
    assert prog["counts_per_pass"] == {}


def test_the_probe_runs_on_a_program_without_spans(smoke_root,
                                                   monkeypatch):
    # the parent of this change has no tracing module: the probe reads
    # the update span alone and no counters
    import sys

    import repro_torch

    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    monkeypatch.delattr(repro_torch, "obs")
    assert spans._program()[0] == ("train_step.update",)
    out = spans.probe("smoke.fold", 2**31 + 5, 0.2, device="cpu",
                      root=smoke_root)
    assert out["correct"]
    prog = out["program"]
    assert prog["readings"] == {}
    assert prog["counts_per_pass"] == {}
