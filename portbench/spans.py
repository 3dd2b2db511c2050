"""The program's own spans (``repro_torch.obs``) in a ``torch.profiler``
trace of host and device, and a probe that reads them from a cell's traced
pass.

- :func:`device_seconds`: device seconds of the kernels and copies
  launched under each named span (the innermost one).  A backward op
  counts for the span of the forward op whose autograd node it runs,
  linked by the forward thread and ``sequence_nr``; the recompute under
  ``torch.utils.checkpoint`` runs the span itself.  One pass over the
  events.
- :func:`host_seconds`: the host duration of each named span.
- :func:`idle_seconds`: the time inside each named span in which the
  device ran nothing.
- :func:`busy`: :func:`portbench.trace.busy` with the idle gaps charged to
  the innermost of the benchmark's spans and the named program spans.

The probe runs a cell's traced run as the benchmark does
(:func:`portbench.harness.run_cell`) and reduces the same traced pass to
the program's spans and counters besides:

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

It prints the harness's result line with a ``"program"`` entry: per span
the device, host and idle ms a step or round, the counters' deltas over
the traced pass, the readings a traffic driver would store for the per-layer
metrics that read them, and what program spans a trace of the device
alone holds.  The benchmark's own runs never run it.
"""
from __future__ import annotations

import bisect
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from portbench import trace  # noqa: E402

#: the autograd engine's record around the backward of one node
BACKWARD = "autograd::engine::evaluate_function: "


def _is_node(e) -> bool:
    """Whether ``e`` is the record of an autograd node inside the
    engine's call of it (its parent names the same node)."""
    p = e.cpu_parent
    return p is not None and p.name == BACKWARD + e.name


def _owner(e, names) -> Tuple[str, object]:
    """``("span", name)`` if op ``e`` runs under span ``name`` (the
    innermost), ``("node", key)`` if it runs in the backward of the
    autograd node ``key`` (forward thread, sequence number) outside any
    span, else ``("", None)``: forward work outside the spans, a
    recompute's included."""
    forward = False
    a = e
    while a is not None:
        if a.name in names:
            return "span", a.name
        if a.name.startswith(BACKWARD):
            if forward:
                return "", None
            return "node", (a.fwd_thread, a.sequence_nr)
        if a.sequence_nr >= 0 and not _is_node(a):
            forward = True
        a = a.cpu_parent
    return "", None


def owners(events, names: Sequence[str], keep) -> List[Tuple[object, str]]:
    """``(op, span)`` for each host op of ``events`` for which
    ``keep(op)`` holds and that runs under a span of ``names`` (the
    innermost), or in the backward of a forward op that does.  One pass
    over the events."""
    names = frozenset(names)
    out: List[Tuple[object, str]] = []
    by_seq: Dict[object, str] = {}
    pending: List[Tuple[object, object]] = []
    for e in events:
        if not trace._is_cpu(e):
            continue
        seq = e.sequence_nr >= 0 and not _is_node(e)
        wanted = keep(e)
        if not (seq or wanted):
            continue
        kind, who = _owner(e, names)
        if kind == "span" and seq:
            by_seq[(e.thread, e.sequence_nr)] = who
        if not wanted:
            continue
        if kind == "span":
            out.append((e, who))
        elif kind == "node":
            pending.append((e, who))
    for e, key in pending:
        name = by_seq.get(key)
        if name is not None:
            out.append((e, name))
    return out


def device_seconds(events, names: Sequence[str]) -> Dict[str, float]:
    """Device seconds of the kernels, copies and sets launched under each
    span of ``names`` (the innermost such span takes them), the backward
    of each forward op inside the span included."""
    out = {n: 0.0 for n in names}
    for e, name in owners(events, names, lambda e: e.kernels):
        out[name] += sum(k.duration for k in e.kernels) / 1e6
    return out


def unlinked_seconds(events) -> Dict[str, float]:
    """Device seconds, by name, of the activities that no host op
    carries among its kernels: what :func:`device_seconds` cannot charge
    to any span."""
    out: Dict[str, float] = {}
    for a, b, name in trace.device_intervals(events):
        out[name] = out.get(name, 0.0) + (b - a)
    for e in events:
        if trace._is_cpu(e):
            for k in e.kernels:
                out[k.name] = out.get(k.name, 0.0) - k.duration / 1e6
    return {k: v for k, v in out.items() if v > 1e-6}


def _instances(events, names) -> List[Tuple[float, float, str]]:
    """``(start_s, end_s, name)`` of every host span named in
    ``names``."""
    return [(e.time_range.start / 1e6, e.time_range.end / 1e6, e.name)
            for e in events if trace._is_cpu(e) and e.name in names]


def host_seconds(events, names: Sequence[str]) -> Dict[str, float]:
    """Host seconds in each span of ``names``, summed over its
    instances."""
    out = {n: 0.0 for n in names}
    for a, b, n in _instances(events, frozenset(names)):
        out[n] += b - a
    return out


def idle_seconds(events, names: Sequence[str]) -> Dict[str, float]:
    """Seconds inside each span of ``names`` in which the device ran no
    kernel, copy or set, summed over the span's instances."""
    dev = trace._union([(a, b) for a, b, _ in trace.device_intervals(events)])
    starts = [a for a, _ in dev]
    out = {n: 0.0 for n in names}
    for lo, hi, n in _instances(events, frozenset(names)):
        covered = 0.0
        i = max(bisect.bisect_right(starts, lo) - 1, 0)
        while i < len(dev) and dev[i][0] < hi:
            covered += max(0.0, min(dev[i][1], hi) - max(dev[i][0], lo))
            i += 1
        out[n] += (hi - lo) - covered
    return out


def busy(events, names: Sequence[str], window: str = "window") -> Dict:
    """:func:`portbench.trace.busy`, each idle gap charged to the
    innermost of the benchmark's spans and the program's spans ``names``
    that covers its middle."""
    sp = trace.spans(events)
    win = [s for s in sp if s[2] == window]
    if not win:
        return {}
    lo, hi = win[0][0], win[0][1]
    dev = trace._union([(max(a, lo), min(b, hi))
                        for a, b, _ in trace.device_intervals(events)
                        if b > lo and a < hi])
    inner = sorted([s for s in sp if s[2] != window]
                   + _instances(events, frozenset(names)),
                   key=lambda s: s[1] - s[0])
    gaps: Dict[str, float] = {}
    edges = [lo] + [x for iv in dev for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = next((s[2] for s in inner if s[0] <= mid <= s[1]), "none")
        gaps[name] = gaps.get(name, 0.0) + (b - a)
    return {"busy_s": sum(b - a for a, b in dev), "window_s": hi - lo,
            "idle_gaps": gaps}


def readings(dev_s: Dict[str, float], host_s: Dict[str, float],
             idle_s: Dict[str, float], counts: Dict[str, int], n: int,
             train: bool) -> Dict[str, float]:
    """The per-layer metrics that read the program's spans and counters,
    from one traced pass of ``n`` steps (``train``) or rounds; a reading
    whose span or counter holds nothing is left out."""
    out: Dict[str, float] = {}

    def put(name, value):
        if value:
            out[name] = value

    if train:
        put("attention_core_ms.train",
            dev_s.get("attention.core", 0.0) / n * 1e3)
        put("moe_dispatch_ms.train", (dev_s.get("moe.route", 0.0)
                                      + dev_s.get("moe.dispatch", 0.0))
            / n * 1e3)
        put("moe_experts_ms.train", dev_s.get("moe.experts", 0.0) / n * 1e3)
        return out
    put("decode_check_ms.fold",
        host_s.get("fl.decode.check", 0.0) / n * 1e3)
    put("finalize_idle_ms.fold", idle_s.get("fold.finalize", 0.0) / n * 1e3)
    for way in ("d2h", "h2d"):
        nbytes = sum(v for k, v in counts.items()
                     if k.startswith(f"copy.{way}_bytes."))
        secs = dev_s.get(f"copy.{way}", 0.0)
        if nbytes and secs:
            out[f"{way}_gbps.fold"] = nbytes / secs / 1e9
    return out


def _program():
    """``(span names, counters)`` of the program: the update span alone
    and no counters where it has no tracing module."""
    try:
        from repro_torch import obs
    except ImportError:
        from repro_torch.train.steps import UPDATE_SPAN

        return (UPDATE_SPAN,), dict
    return obs.SPANS, obs.counts


class _Capture:
    """Patches ``torch.profiler.profile`` so that each profile the run
    opens is reduced to the program's spans when it closes, with the
    counters' deltas over it."""

    def __init__(self):
        import torch

        self.names, self.counts = _program()
        self.done = []
        self._orig = torch.profiler.profile
        cap = self

        class Profile(self._orig):
            def __enter__(self):
                self._counts = cap.counts()
                self._t = time.perf_counter()
                return super().__enter__()

            def __exit__(self, *exc):
                out = super().__exit__(*exc)
                cap.reduce(self)
                return out

        self.Profile = Profile

    def __enter__(self):
        import torch

        torch.profiler.profile = self.Profile
        return self

    def __exit__(self, *exc):
        import torch

        torch.profiler.profile = self._orig

    def reduce(self, prof) -> None:
        import torch

        wall = time.perf_counter() - prof._t
        now = self.counts()
        counts = {k: v - prof._counts.get(k, 0) for k, v in now.items()
                  if v != prof._counts.get(k, 0)}
        t = time.perf_counter()
        events = prof.events()
        cpu = torch.profiler.ProfilerActivity.CPU in prof.activities
        rec = {"activities": sorted(str(a).split(".")[-1]
                                    for a in prof.activities),
               "wall_s": wall, "parse_s": time.perf_counter() - t,
               "counts": counts}
        t = time.perf_counter()
        if cpu:
            rec.update(device_s=device_seconds(events, self.names),
                       host_s=host_seconds(events, self.names),
                       idle_s=idle_seconds(events, self.names),
                       idle_gaps=trace.top_gaps(busy(events, self.names),
                                                20),
                       unlinked_s=sorted(
                           unlinked_seconds(events).items(),
                           key=lambda kv: -kv[1])[:10])
        else:
            # the program's spans that a trace of the device alone holds:
            # the busy pass would count them as busy
            rec["shadows"] = sum(e.name in self.names for e in events)
        rec["reduce_s"] = time.perf_counter() - t
        self.done.append(rec)


def probe(name: str, seed: int, seconds: float, device: str = "cuda",
          root: Optional[Path] = None) -> Dict:
    """Cell ``name``'s traced run (:func:`portbench.harness.run_cell`)
    with the program's spans and counters read from its traced pass."""
    from portbench import harness

    root = harness.ROOT if root is None else root
    cell = harness.load_cell(name, root)
    p = cell.workload["params"]
    train = cell.entry["traffic"] == "train_steps"
    n = p["trace_steps"] if train else p["trace_rounds"]
    with _Capture() as cap:
        out = harness.run_cell(name, seed, seconds, True, device, root=root)
    full = [r for r in cap.done if "device_s" in r]
    prog = {"passes": cap.done}
    if full:
        r = full[-1]
        prog["per_pass"] = {
            k: {s: v / n * 1e3 for s, v in r[k].items() if v}
            for k in ("device_s", "host_s", "idle_s")}
        prog["readings"] = readings(r["device_s"], r["host_s"], r["idle_s"],
                                    r["counts"], n, train)
        prog["counts_per_pass"] = {k: v / n for k, v in r["counts"].items()}
    out["program"] = prog
    return out


def main(argv=None) -> int:
    import argparse

    from portbench import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    sys.path.insert(0, str(harness.ROOT / "src_torch"))
    out = probe(args.workload, args.seed, args.seconds)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
