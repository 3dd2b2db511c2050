"""The reduction of traces to the per-layer metrics: the split by kind,
the rule that finds the attention's score ops, the device's busy time,
and the harness's refusal of a reader that finds nothing on a card."""
import time
import types

import pytest
import torch

from portbench import harness, trace
from portbench.harness import Cell, HERE, load_module
from torch.autograd import DeviceType


def _op(name, shapes=(), kernels=(), parent=None, device_total=0.0):
    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CPU, input_shapes=list(shapes),
        cpu_parent=parent, device_time_total=device_total,
        kernels=[types.SimpleNamespace(name=k, duration=d)
                 for k, d in kernels])


def test_split_by_kind():
    scores = [1, 8, 4, 1024, 4096]
    einsum = _op("aten::einsum", [scores, [1, 4096, 8, 80]])
    events = [
        _op("aten::mm", [[4096, 2560], [2560, 6912]],
            [("nvjet_tst_bf16_gemm", 300.0)]),
        _op("aten::bmm", [[32, 1024, 80], [32, 80, 4096]],
            [("ampere_sgemm_128x64_nn", 200.0)]),
        # under the value product's einsum: its copy reads the scores
        _op("aten::copy_", [[32, 1024, 4096]], [("elementwise_copy", 7.0)],
            parent=einsum),
        _op("aten::where", [[1024, 4096], scores, []],
            [("where_kernel", 50.0)]),
        _op("aten::_softmax_backward_data", [scores, scores, [], []],
            [("softmax_bwd", 20.0)]),
        # the MLP's activations are 3-D; the MoE's masks 4-D
        _op("aten::silu", [[1, 4096, 6912]], [("silu", 11.0)]),
        _op("aten::mul", [[2, 4096, 32, 2560]], [("mul", 13.0)]),
        _op("train_step.update", device_total=400.0),
    ]
    split = trace.device_split(events, "train_step.update", 4096)
    assert split == pytest.approx({
        "bf16_matmul": 300e-6, "fp32_attention_einsum": 200e-6,
        "attention_elementwise": 77e-6, "optimizer_update": 400e-6})


def test_the_score_rule_on_a_profiled_step(smoke_root):
    # the program's own ops, profiled on the CPU: the rule finds the mask,
    # the softmax forward and backward, and nothing of the trunk or MLP
    cell = harness.load_cell("smoke.train-dense", smoke_root)
    driver = load_module(smoke_root / "portbench" / "traffic" /
                         "train_steps.py", "t_trace_train_steps")
    run = harness.Run(cell, 11, 0.0, True, torch.device("cpu"),
                      time.perf_counter())
    step_fn, state, batches, _, _ = driver.setup(run)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof:
        step_fn(state, batches[0])
    hit = {e.name for e in prof.events()
           if trace.reads_scores(e, cell.workload["params"]["seq_len"])}
    assert {"aten::where", "aten::_softmax",
            "aten::_softmax_backward_data"} <= hit
    assert not hit & {"aten::embedding", "aten::silu", "aten::rsqrt",
                      "aten::linear", "aten::nll_loss_forward"}


def test_device_busy_is_the_union_of_the_intervals():
    def dev(name, a, b):
        return types.SimpleNamespace(
            name=name, device_type=DeviceType.CUDA,
            time_range=types.SimpleNamespace(start=a, end=b))

    events = [dev("k1", 0, 100), dev("k2", 50, 150), dev("k3", 300, 400),
              dev("portbench.step", 0, 1000)]
    assert trace.device_busy(events, (trace.SPAN,)) == pytest.approx(250e-6)


def test_a_silent_reader_refuses_on_a_card():
    silent = types.SimpleNamespace(read=lambda rec: None)
    assert harness.read_layer(silent, {}, "x_roofline", False) is None
    with pytest.raises(harness.Refused, match="x_roofline"):
        harness.read_layer(silent, {}, "x_roofline", True)
    # a metric the cells report reads nothing from a trace without
    # the kernel it counts
    reader = load_module(HERE / "metrics" / "scatter_wsum_roofline.py",
                         "m_scatter_wsum_roofline_silent")
    rec = {"traced": {"rounds": 3, "scatter_s": 0.0},
           "scatter_bound_s_per_round": 1e-3}
    with pytest.raises(harness.Refused):
        harness.read_layer(reader, rec, "scatter_wsum_roofline", True)


def test_a_metric_that_lists_no_cells_follows_what_it_moves():
    bench = {"end_to_end": [
        {"name": "setup_s"},
        {"name": "fold_ms", "workloads": ["f"]},
        {"name": "rate", "workloads": ["t"]}],
        "per_layer": [{"name": "a", "moves": "rate"},
                      {"name": "b", "moves": "fold_ms", "workloads": ["f"]}]}
    names = {c: [m["name"] for m in Cell(c, {}, {}, {}, bench)
                 .metrics("per_layer")] for c in ("f", "t")}
    assert names == {"f": ["b"], "t": ["a"]}
    assert [m["name"] for m in Cell("t", {}, {}, {}, bench)
            .metrics("end_to_end")] == ["setup_s", "rate"]

