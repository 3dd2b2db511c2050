"""Reduction of a ``torch.profiler`` trace of the traced window to what the
per-layer metrics and the result's ``breakdown`` read.

- :func:`device_split`: device seconds by kind, a frozen copy of
  ``chip_smoke.py``'s ``_profile_split`` (the GEMM kernels under the GEMM
  ops by their names: bf16, or the eager attention's fp32 einsums; the
  kernels under the program's update span), extended by the other kernels
  of the ops that read the eager attention's score tensor;
- :func:`device_busy`: the union of the device's kernel, copy and set
  intervals in a trace of device activity alone, whose window the caller
  takes by the host clock (recording the host's ops lengthens a step
  whose host work is many small ops);
- :func:`busy`: the same inside the window span of a trace of host and
  device, and the idle gaps between them, each charged to the benchmark's
  own span (``portbench.<name>``) the host was in at the gap's middle;
- :func:`top_ops`: device seconds by kernel name.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

#: the benchmark's spans around its calls into the program
SPAN = "portbench."
_GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm",
             "aten::matmul", "aten::linear", "aten::einsum")
_FP32_GEMM_NAMES = ("f32f32", "sgemm", "nvjet_s")
_BF16_GEMM_NAMES = ("bf16", "nvjet_t")


def _is_cpu(e) -> bool:
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CPU


def reads_scores(e, key_len: int) -> bool:
    """Whether op ``e`` or an op that called it reads the eager
    attention's score tensor: 5-D (batch, kv head, group, query, key)
    with its last dim the key length ``key_len`` (the trace records
    shapes)."""
    while e is not None:
        for s in e.input_shapes or ():
            if len(s) == 5 and s[-1] == key_len \
                    and all(isinstance(x, int) for x in s):
                return True
        e = e.cpu_parent
    return False


def device_split(events, update_span: str, key_len: int
                 ) -> Dict[str, float]:
    """Device seconds of ``events`` (``prof.events()`` recorded with
    shapes) by kind: the bf16 and the fp32 GEMM kernels under the GEMM ops,
    the other kernels of ops that read the attention's scores (masking,
    softmax forward and backward, the weights' casts, the gradients'
    products), and the kernels under ``update_span``."""
    split = {"bf16_matmul": 0.0, "fp32_attention_einsum": 0.0,
             "attention_elementwise": 0.0, "optimizer_update": 0.0}
    for e in events:
        if not _is_cpu(e):
            continue
        if e.name == update_span:
            split["optimizer_update"] += e.device_time_total / 1e6
        if not e.kernels:
            continue
        if e.name in _GEMM_OPS:
            for k in e.kernels:
                n = k.name.lower()
                if any(t in n for t in _BF16_GEMM_NAMES):
                    split["bf16_matmul"] += k.duration / 1e6
                elif any(t in n for t in _FP32_GEMM_NAMES):
                    split["fp32_attention_einsum"] += k.duration / 1e6
        elif reads_scores(e, key_len):
            split["attention_elementwise"] += sum(
                k.duration for k in e.kernels) / 1e6
    return split


def _annotations(events) -> set:
    return {e.name for e in events
            if _is_cpu(e) and getattr(e, "is_user_annotation", False)}


def device_intervals(events, skip: Tuple[str, ...] = ()
                     ) -> List[Tuple[float, float, str]]:
    """``(start_s, end_s, name)`` of every device activity: kernels,
    copies and sets (the device-side shadows of the host's annotations,
    and names that begin with one of ``skip``, are left out)."""
    notes = _annotations(events)
    out = []
    for e in events:
        if _is_cpu(e) or e.name in notes \
                or getattr(e, "is_user_annotation", False) \
                or (skip and e.name.startswith(skip)):
            continue
        tr = e.time_range
        out.append((tr.start / 1e6, tr.end / 1e6, e.name))
    return out


def device_busy(events, skip: Tuple[str, ...] = ()) -> float:
    """Seconds in which the device ran a kernel, copy or set: the union
    of all its intervals in ``events``, a trace of device activity alone
    over a window the caller bounds by device syncs."""
    return sum(b - a for a, b in _union(
        [(a, b) for a, b, _ in device_intervals(events, skip)]))


def spans(events) -> List[Tuple[float, float, str]]:
    """The benchmark's own host spans, ``(start_s, end_s, name)``."""
    return [(e.time_range.start / 1e6, e.time_range.end / 1e6,
             e.name[len(SPAN):])
            for e in events if _is_cpu(e) and e.name.startswith(SPAN)]


def _union(iv: List[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy(events, window: str = "window") -> Dict:
    """Device busy seconds inside the span ``portbench.<window>``, its
    length, and the idle gaps charged to the innermost other benchmark
    span that covers each gap's middle (``"none"`` where none does)."""
    sp = spans(events)
    win = [s for s in sp if s[2] == window]
    if not win:
        return {}
    lo, hi = win[0][0], win[0][1]
    dev = _union([(max(a, lo), min(b, hi))
                  for a, b, _ in device_intervals(events)
                  if b > lo and a < hi])
    busy_s = sum(b - a for a, b in dev)
    inner = sorted((s for s in sp if s[2] != window),
                   key=lambda s: s[1] - s[0])
    gaps: Dict[str, float] = {}
    edges = [lo] + [x for iv in dev for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = next((s[2] for s in inner if s[0] <= mid <= s[1]), "none")
        gaps[name] = gaps.get(name, 0.0) + (b - a)
    return {"busy_s": busy_s, "window_s": hi - lo, "idle_gaps": gaps}


def top_ops(events, n: int = 10) -> List[List]:
    """The ``n`` device activities that took most time, by name."""
    acc: Dict[str, float] = {}
    for a, b, name in device_intervals(events):
        acc[name] = acc.get(name, 0.0) + (b - a)
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])
            [:n]]


def kernel_seconds(events, needle: str) -> float:
    """Device seconds of the activities whose name holds ``needle``."""
    return sum(b - a for a, b, name in device_intervals(events)
               if needle in name)


def device_pass(fn, dev, skip: Tuple[str, ...] = ()) -> Dict[str, float]:
    """Run ``fn`` under a trace of device activity alone, between two
    device syncs: the device's busy seconds and the window's length by the
    host clock.  Off a card, nothing is traced and nothing is busy."""
    import time

    import torch

    if dev.type != "cuda":
        t = time.perf_counter()
        fn()
        return {"busy_s": 0.0, "window_s": time.perf_counter() - t}
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        window_s = time.perf_counter() - t
    return {"busy_s": device_busy(prof.events(), skip),
            "window_s": window_s}


def top_gaps(b: Dict, n: int = 10) -> List[List]:
    """The ``n`` largest of :func:`busy`'s idle gaps, by host span."""
    return sorted(([k, v] for k, v in b.get("idle_gaps", {}).items()),
                  key=lambda kv: -kv[1])[:n]
