"""The yardstick's arithmetic against counts made by hand."""
import json
import math

import pytest

from portbench import counts
from portbench.harness import HERE, load_module
from portbench.reference import transformer as ref


def conf(name):
    with open(HERE / "configs" / f"{name}.json") as f:
        return json.load(f)


def test_band_pairs_by_hand():
    # 10 queries, causal: 1 + 2 + ... + 10
    assert counts.band_pairs(10, True, 0) == 55
    # a window of 3: 1 + 2 + 3 x 8
    assert counts.band_pairs(10, True, 3) == 27
    # not causal: every pair
    assert counts.band_pairs(10, False, 0) == 100
    # a window as long as the sequence masks nothing more than causality
    assert counts.band_pairs(4096, True, 4096) == 4096 * 4097 // 2


@pytest.mark.parametrize("name, batch, per_layer, head, attn_pair", [
    # danube: q, o 2560 x 32 x 80, k, v 2560 x 8 x 80; SwiGLU 3 x 2560 x
    # 6912; the untied head 2560 x 32000; 4 x 80 FLOPs a pair, 32 heads
    ("h2o-danube-1.8b", 4, 13_107_200 + 3_276_800 + 53_084_160,
     81_920_000, 320 * 32),
    # granite: q, o 1024 x 16 x 64, k, v 1024 x 8 x 64; 8 of 32 experts
    # of 3 x 1024 x 512 and the 1024 x 32 router; the tied head over
    # 49155 tokens once
    ("granite-moe-1b-a400m", 8, 2_097_152 + 1_048_576 + 12_582_912 + 32_768,
     50_334_720, 256 * 16),
])
def test_train_model_flops_by_hand(name, batch, per_layer, head, attn_pair):
    seq = 4096
    n = 24 * per_layer + head
    pairs = 4096 * 4097 // 2                 # causal; danube's window 4096
    want = 6 * n * batch * seq + 3 * 24 * attn_pair * batch * pairs
    assert counts.train_model_flops(conf(name), batch, seq) == want


def test_train_model_flops_magnitudes():
    # the issue's figures: ~196.6 TFLOP a danube step, ~104 a granite one
    assert counts.train_model_flops(conf("h2o-danube-1.8b"), 4, 4096) \
        == pytest.approx(1.9669e14, rel=1e-4)
    assert counts.train_model_flops(conf("granite-moe-1b-a400m"), 8,
                                    4096) == pytest.approx(1.0406e14,
                                                           rel=1e-4)


def test_fold_model_is_442m_parameters():
    layout = ref.param_layout(conf("h2o-danube-1.8b-4l"))
    n = sum(math.prod(shape) for shape, _, _ in layout.values())
    # embedding and head 32000 x 2560 each, the final norm, and 4 layers
    # of two norms, q/k/v/o and the SwiGLU
    assert n == 2 * 81_920_000 + 2560 + 4 * (
        2 * 2560 + 13_107_200 + 3_276_800 + 53_084_160)
    assert math.ceil(0.05 * n) == 22_086_784


def test_scatter_bytes_and_bound_by_hand():
    # 1000 int8 values, their int64 indices, 16 B of fp64 accumulator a
    # coordinate, one fp32 scale
    assert counts.scatter_bytes(1000, True, 1) == 1000 * 25 + 4
    assert counts.scatter_bytes(1000, False, 0) == 1000 * 28
    kind = "NVIDIA H100 80GB HBM3"
    assert counts.scatter_bound_s(22_086_784, kind, True, 21_570) == \
        pytest.approx((22_086_784 * 25 + 21_570 * 4) / 3.35e12)
    assert counts.scatter_bound_s(1000, "a card not in the table") is None


def _reader(name):
    return load_module(HERE / "metrics" / f"{name}.py",
                       "t_" + name.replace(".", "_"))


def test_readers_from_a_record_by_hand():
    kind = "NVIDIA H100 80GB HBM3"
    rec = {"window_steps": 10, "window_s": 42.0, "device_kind": kind,
           "model_flops_per_step": 1.9669e14,
           "peak_window_bytes": 58_134_179_840,
           # the traced steps' own window (the tracer's) is not read
           "traced": {"steps": 2, "busy_s": 8.0, "window_s": 8.5,
                      "window_step_s": 4.25,
                      "split": {"fp32_attention_einsum": 1.94,
                                "attention_elementwise": 3.74,
                                "bf16_matmul": 0.876,
                                "optimizer_update": 0.276}}}
    assert _reader("train_mfu").read(rec) == pytest.approx(
        100 * 1.9669e14 * 10 / 42.0 / 989e12)
    assert _reader("attention_ms.train").read(rec) == pytest.approx(970.0)
    assert _reader("attention_elementwise_ms.train").read(rec) == \
        pytest.approx(1870.0)
    assert _reader("matmul_ms.train").read(rec) == pytest.approx(438.0)
    assert _reader("optimizer_ms.train").read(rec) == pytest.approx(138.0)
    assert _reader("peak_gb.train").read(rec) == pytest.approx(58.13418)
    assert _reader("idle_share.train").read(rec) == pytest.approx(
        100 * (1 - 4.0 / 4.25))
    fold = {"window_s": 48.0, "window_rounds": 16,
            "host_s_per_round": {"decode": 0.9, "add": 0.001,
                                 "finalize": 1.8},
            "scatter_bound_s_per_round": 8 * 0.000165,
            "traced": {"rounds": 3, "scatter_s": 3 * 8 * 0.00125,
                       "busy_s": 3.0, "window_s": 8.0}}
    assert _reader("decode_ms.fold").read(fold) == pytest.approx(900.0)
    assert _reader("fold_add_ms").read(fold) == pytest.approx(1.0)
    assert _reader("fold_finalize_ms").read(fold) == pytest.approx(1800.0)
    assert _reader("scatter_wsum_roofline").read(fold) == pytest.approx(
        13.2)
    # 1.0 device s a traced round against a 3.0 s round in the window
    assert _reader("idle_share.fold").read(fold) == pytest.approx(
        100 * 2 / 3)


@pytest.mark.parametrize("name", [
    "train_mfu", "attention_ms.train", "attention_elementwise_ms.train",
    "matmul_ms.train", "optimizer_ms.train", "peak_gb.train",
    "idle_share.train",
    "decode_ms.fold", "fold_add_ms", "fold_finalize_ms",
    "scatter_wsum_roofline", "idle_share.fold"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    # a CPU run's record: no card in the peak table, no device activity
    rec = {"device_kind": "cpu", "window_steps": 3, "window_s": 1.0,
           "model_flops_per_step": 1e9, "peak_window_bytes": 0,
           "scatter_bound_s_per_round": None,
           "traced": {"steps": 1, "rounds": 1, "busy_s": 0.0,
                      "window_s": 0.1, "scatter_s": 0.0,
                      "split": {"fp32_attention_einsum": 0.0,
                                "attention_elementwise": 0.0,
                                "bf16_matmul": 0.0,
                                "optimizer_update": 0.0}}}
    assert _reader(name).read(rec) is None
